"""Sharding policies: logical axis rules -> placements over a named mesh (the
`repro.parallel.sharding` counterpart).

Mesh axes: ``pod`` (the outer data axis), ``data`` (in-pod data parallelism
and FSDP) and ``model`` (tensor / expert / sequence parallelism).  Models
call ``shard(x, logical_name)`` at the reference's sites; the call returns
``x`` unless a `ShardingPolicy` is active, and under one it looks the name
up (an unknown name raises `KeyError`, as in the reference) and returns
``x`` itself: on one card a placement constraint changes no value.  What a
policy does change is `models.moe`'s dispatch groups, one a data shard.

A spec is a tuple of mesh-axis entries, one a tensor dim: None
(replicated), an axis name, or a tuple of names (the dim split over their
product, row-major) — equal, entry for entry, to the reference's
`PartitionSpec`.  `tree_specs` fits the reference's weight rules to each
leaf (`fit_spec`), and `tree_shardings` gives each leaf a `NamedSharding`:
its mesh and spec, which can cut the leaf into its blocks on the mesh's
grid (`blocks`), each block what the device at that grid coordinate would
hold.  Over a grid `procmesh.ProcMesh` (one rank a process) `local` is the
one block this rank holds, at its coordinate, and `held` what this
process keeps of a leaf on either mesh.  A policy builds on either mesh.

**A model step split over processes.**  Under a policy whose mesh is a
`procmesh.ProcMesh` with a ``model`` axis of tp > 1 (`splits_model`) a
rank holds only its blocks of the weights (`local_params`, or
`models.registry.params_from_jax(..., policy=)`) and the dense model step
computes with them: attention over its own heads, the MLP over its own
slice of F, the embedding and the LM head over its own block of the
vocabulary.  `splits` says, from a leaf's fitted spec, whether a dim is
split over ``model``: a projection whose contraction dim is split leaves
a partial sum that `all_reduce` completes, and the LM head's block of the
vocabulary is joined by `all_gather`.  Both run over the axis's view
(`ProcMesh.along`) through the one-sided ring collectives
(`core.collectives`), whose puts are the peer kernels' on the card: the
collectives XLA's partitioner inserts into the reference's split
forward.  A leaf whose spec fits no split (6 q heads but 3 KV heads at
tp = 2: ``wk`` / ``wv`` replicated) is whole on every rank, and a sum over
a whole leaf is never reduced.  What such a split does not carry yet is
refused by `check_model_split` (ROADMAP item 12c).  A policy on a stacked
`Mesh`, or over processes without a ``model`` axis of more than one,
changes no value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import re
from typing import Any, Optional

import torch

from ..ckpt.checkpoint import _unflatten_like, flatten
from ..core import collectives
from ..mesh import Mesh, MeshError
from ..procmesh import ProcMesh, as_bytes

DP = ("pod", "data")  # the combined data axes (pod may be absent)


class PartitionSpec(tuple):
    """``P("model", None)``: a tuple of per-dim mesh-axis entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _dp(mesh: Mesh):
    """The data axes present in this mesh (the pod axis is optional)."""
    return tuple(a for a in DP if a in mesh.axis_names) or None


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Mesh
    # sequence-parallel activations: shard the seq dim over `model`
    seq_parallel: bool = False
    # shard the KV cache's sequence (rather than its heads) over `model`
    kv_seq_shard: bool = False
    # no FSDP weight sharding (pure TP, for small models)
    fsdp: bool = True

    # ------------------------------------------------------- activations
    def act_spec(self, name: str) -> P:
        dp = _dp(self.mesh)
        sp = "model" if self.seq_parallel else None
        table = {
            "act_btd": P(dp, sp, None),              # [B, S, D]
            "act_btf": P(dp, sp, "model"),           # [B, S, F] ffn hidden
            "act_bthd": P(dp, None, "model", None),  # [B, S, H, hd] heads
            "act_bhsd": P(dp, "model", None, None),  # [B, H, S, hd]
            "logits": P(dp, sp, "model"),            # [B, S, V] vocab-parallel
            "tokens": P(dp, None),                   # [B, S]
            "token": P(dp),                          # [B]
            "act_bd": P(dp, None),                   # [B, D]
            "experts_ecd": P(None, "model", None, None),
        }
        if name not in table:
            raise KeyError(f"unknown logical activation {name!r}")
        return table[name]

    def kv_cache_spec(self, n_kv_heads: int) -> P:
        """[B, S, Hkv, hd] cache layout."""
        dp = _dp(self.mesh)
        tp = self.mesh.shape.get("model", 1)
        if self.kv_seq_shard or n_kv_heads < tp:
            return P(dp, "model", None, None)  # sequence parallelism
        return P(dp, None, "model", None)      # head parallelism

    def ssm_state_spec(self) -> P:
        """[B, d_inner, N] SSM state: channels over model."""
        return P(_dp(self.mesh), "model", None)

    # ----------------------------------------------------------- weights
    _WEIGHT_RULES: tuple = (
        # (regex on the param path, the spec it gives a leaf)
        (r"embed$",            lambda fs: P("model", fs)),         # [V, D]
        (r"lm_head$",          lambda fs: P(fs, "model")),         # [D, V]
        (r"pos_embed$",        lambda fs: P(None, None)),          # [S, D]
        (r"(wq|wk|wv)$",       lambda fs: P(fs, "model", None)),   # [D, H, hd]
        (r"(bq|bk|bv)$",       lambda fs: P("model", None)),       # [H, hd]
        (r"wo$",               lambda fs: P("model", None, fs)),   # [H, hd, D]
        (r"(w_gate|w_in)$",    lambda fs: P(fs, "model")),         # [D, F]
        (r"w_out$",            lambda fs: P("model", fs)),         # [F, D]
        (r"router$",           lambda fs: P(fs, None)),            # [D, E]
        (r"experts/(w_gate|w_in)$", lambda fs: P("model", fs, None)),  # [E, D, F]
        (r"experts/w_out$",    lambda fs: P("model", None, fs)),   # [E, F, D]
        (r"in_proj$",          lambda fs: P(fs, "model")),         # mamba [D, 2di]
        (r"conv_w$",           lambda fs: P(None, "model")),       # [W, di]
        (r"(x_proj|dt_proj)$", lambda fs: P("model", fs)),         # [di, ...]
        (r"out_proj$",         lambda fs: P("model", fs)),         # [di, D]
        (r"(A_log|conv_b|dt_bias|D_skip)$", lambda fs: P("model",)),  # [di, ...]
        (r"(up_proj)$",        lambda fs: P(fs, "model")),         # xlstm [D, 2di]
        (r"(wq_blk|wk_blk|wv_blk)$", lambda fs: P("model", None, None)),  # [nh, d, d]
        (r"down_proj$",        lambda fs: P("model", fs)),         # [di, D]
        (r"(w_i|w_f|w_o|w_z)$", lambda fs: P(fs, "model")),        # slstm in [D, D]
        (r"(r_i|r_f|r_o|r_z)$", lambda fs: P("model", None, None)),  # slstm rec blockdiag
        (r"(norm|scale|bias|gate_scale|gate_bias|b_i|b_f|b_o|b_z|ln)", lambda fs: P()),
    )

    def param_spec(self, path: str, ndim: int) -> P:
        fs = "data" if self.fsdp else None
        for pat, make in self._WEIGHT_RULES:
            if re.search(pat, path):
                spec = make(fs)
                # pad the spec to the tensor's rank (stacked-layer dims -> None)
                return P(*((None,) * (ndim - len(spec))), *spec)
        return P()  # replicated by default

    def tree_specs(self, tree: Any) -> Any:
        """A spec for each leaf of `tree` (tensors, or anything with a
        ``shape``), fitted to the leaf's shape; the leaf paths are the
        reference's (``blocks/attn/wq``, ``1/.mu/...``)."""
        return _unflatten_like(tree, self._specs(tree))

    def tree_shardings(self, tree: Any) -> Any:
        """One `NamedSharding` (this mesh, the leaf's spec) a leaf."""
        return _unflatten_like(tree, {path: NamedSharding(self.mesh, spec)
                                      for path, spec in self._specs(tree).items()})

    def _specs(self, tree: Any) -> dict:
        return {path: fit_spec(self.param_spec(path, len(leaf.shape)), tuple(leaf.shape),
                               self.mesh)
                for path, leaf in flatten(tree)}

    # ------------------------------------ the model step split over processes
    @property
    def splits_model(self) -> bool:
        """Whether this policy splits the model step over processes: a
        `ProcMesh` with a ``model`` axis of more than one rank."""
        return isinstance(self.mesh, ProcMesh) and self.mesh.shape.get("model", 1) > 1

    @property
    def tp(self) -> int:
        """The size of the ``model`` axis (1 without one)."""
        return self.mesh.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the ``model`` axis."""
        return self.mesh.along("model").rank

    def splits(self, path: str, shape, dim: int) -> bool:
        """Whether the fitted spec of a leaf at `path` of the whole `shape`
        splits its dim `dim` over ``model``."""
        entry = fit_spec(self.param_spec(path, len(shape)), tuple(shape), self.mesh)[dim]
        return "model" in (entry if isinstance(entry, tuple) else (entry,))

    def local_size(self, path: str, shape, dim: int) -> int:
        """The size of dim `dim` of this rank's block of that leaf."""
        return shape[dim] // self.tp if self.splits(path, shape, dim) else shape[dim]

    def check_model_split(self, cfg=None) -> None:
        """Raise for what a model step split over processes does not carry
        yet, naming its ROADMAP item; a no-op unless `splits_model`.
        Without `cfg` only the policy's own options are checked."""
        if not self.splits_model:
            return
        if self.fsdp:
            raise NotImplementedError(
                "FSDP over `data` under a model split over processes is ROADMAP item "
                "12c.2; build the policy with fsdp=False")
        if self.seq_parallel:
            raise NotImplementedError(
                "sequence-parallel activations over processes are ROADMAP item 12c.3")
        if cfg is None:
            return
        if self.kv_seq_shard or cfg.n_kv_heads < self.tp:
            raise NotImplementedError(
                f"{cfg.name}: a KV cache split on its sequence ({cfg.n_kv_heads} KV heads "
                f"over model = {self.tp}, kv_seq_shard={self.kv_seq_shard}) is ROADMAP item "
                "12c.3")
        if cfg.family != "dense":
            item = {"moe": "12c.4 (experts over `model`)",
                    "hybrid": "12c.4 and 12c.5 (experts and Mamba channels over `model`)",
                    "ssm": "12c.5 (xLSTM channels over `model`)"}.get(cfg.family, "12c")
            raise NotImplementedError(
                f"{cfg.name}: only the dense family splits over processes; the "
                f"{cfg.family} family's split is ROADMAP item {item}")

    def local_params(self, tree: Any) -> Any:
        """This rank's block of every leaf of `tree`: ``tree_shardings(tree)``,
        then each one's `NamedSharding.local`.  A tensor's block is a copy,
        so that the whole leaf may go; any other leaf's (numpy) a view."""
        self.check_model_split()
        specs = self._specs(tree)

        def block(path, leaf):
            got = NamedSharding(self.mesh, specs[path]).local(leaf)
            if isinstance(got, torch.Tensor):
                return got.clone(memory_format=torch.contiguous_format)
            return got

        return _unflatten_like(tree, {path: block(path, leaf) for path, leaf in flatten(tree)})

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Each rank's partial sum y -> the sum over the ``model`` axis: the
        one-sided ring all-reduce (`core.collectives.all_reduce`), summed
        in f32 (in y's dtype where that is wider) and returned in y's."""
        _no_backward(y)
        acc = y if y.dtype.itemsize >= 4 else y.float()
        out = collectives.all_reduce(acc.contiguous()[None], self.mesh.along("model"))
        return out[0].to(y.dtype)

    def all_gather(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Each rank's block y -> the ``model`` axis's blocks in its order,
        concatenated along `dim`: the one-sided ring all-gather
        (`core.collectives.ring_all_gather`) of y's bytes as 32-bit words."""
        _no_backward(y)
        sub = self.mesh.along("model")
        raw = as_bytes(y)
        words = torch.nn.functional.pad(raw, (0, -raw.numel() % 4)).view(torch.int32)
        got = collectives.ring_all_gather(words[None], sub)[0]          # [p, words]
        blocks = got.view(torch.uint8)[:, :raw.numel()].contiguous().view(y.dtype)
        return torch.cat(list(blocks.reshape((sub.p,) + tuple(y.shape))), dim=dim)


def _no_backward(y: torch.Tensor) -> None:
    """The split step's collectives have no backward: a gradient through one
    would be silently wrong, so a tensor that needs one is refused."""
    if torch.is_grad_enabled() and y.requires_grad:
        raise NotImplementedError("the train step split over `model` is ROADMAP item 12c.1: "
                                  "these collectives have no backward")


def fit_spec(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Drop mesh axes that do not divide their dim evenly.

    A placement must tile its tensor exactly: 5 KV heads over a 4-way
    `model` axis, or batch 1 over `data`, fall back to replication on that
    dim.  Tuple entries are trimmed from the right, so ('pod', 'data') on a
    dim of 16 keeps 'pod' alone when 32 does not divide it."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        while axes:
            prod = 1
            for a in axes:
                prod *= mesh.shape.get(a, 1)
            if prod and dim % prod == 0:
                break
            axes.pop()  # trim from the right
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its spec over `mesh`'s grid of named axes."""

    mesh: Mesh
    spec: P

    def _axes(self, d: int) -> tuple:
        entry = self.spec[d] if d < len(self.spec) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    def check(self, shape) -> None:
        """Raise unless the spec tiles `shape` exactly on the mesh."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        for d, n in enumerate(shape):
            axes = self._axes(d)
            unknown = [a for a in axes if a not in self.mesh.shape]
            if unknown:
                raise ValueError(f"spec {self.spec} names axes {unknown} the mesh "
                                 f"{self.mesh.shape} lacks")
            k = 1
            for a in axes:
                k *= self.mesh.shape[a]
            if n % k:
                raise ValueError(f"spec {self.spec} does not tile shape {tuple(shape)} "
                                 f"on the mesh {self.mesh.shape}: dim {d} of {n} over {k}")

    def index(self, coord: tuple, shape) -> tuple:
        """The slices of the block that grid coordinate `coord` (one index
        an axis, in `mesh.axis_names` order) holds."""
        at = dict(zip(self.mesh.axis_names, coord))
        out = []
        for d, n in enumerate(shape):
            k, i = 1, 0
            for a in self._axes(d):                       # row-major over the entry
                i, k = i * self.mesh.shape[a] + at[a], k * self.mesh.shape[a]
            out.append(slice(i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    def blocks(self, x: torch.Tensor) -> dict:
        """{grid coordinate: the block of x there} for every coordinate of
        the mesh (views of x)."""
        self.check(x.shape)
        grid = itertools.product(*(range(n) for n in self.mesh.shape.values()))
        return {c: x[self.index(c, x.shape)] for c in grid}

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The block of x this rank holds on a `ProcMesh`: the one at its
        grid coordinate (a view of x)."""
        if not isinstance(self.mesh, ProcMesh):
            raise MeshError("a stacked mesh holds every block of a leaf: use blocks(x)")
        self.check(x.shape)
        return x[self.index(self.mesh.coords, x.shape)]

    def held(self, x: torch.Tensor) -> torch.Tensor:
        """What this process keeps of x: the whole leaf on a stacked mesh,
        its own block (`local`) over processes."""
        return self.local(x) if isinstance(self.mesh, ProcMesh) else x


# ------------------------------------------------------- ambient policy API
_ACTIVE: list[ShardingPolicy] = []


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    if policy is None:
        yield
        return
    _ACTIVE.append(policy)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_policy() -> Optional[ShardingPolicy]:
    return _ACTIVE[-1] if _ACTIVE else None


def tensor_parallel() -> Optional[ShardingPolicy]:
    """The active policy where it splits the model step over processes
    (`ShardingPolicy.splits_model`), else None."""
    pol = current_policy()
    return pol if pol is not None and pol.splits_model else None


def shard(x, logical_name: str):
    """The reference's activation sharding constraint: `x` itself, after the
    active policy (if any) has looked the name up."""
    pol = current_policy()
    if pol is not None:
        pol.act_spec(logical_name)
    return x


def shard_spec(x, spec: P):
    """A constraint by explicit spec: `x` itself on one card."""
    return x
