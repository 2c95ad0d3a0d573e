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
process keeps of a leaf on either mesh.  A policy builds on either mesh;
its model forward is never split over processes (the reference's comes
from XLA's partitioner, which has no counterpart here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import re
from typing import Any, Optional

import torch

from ..ckpt.checkpoint import _unflatten_like, flatten
from ..mesh import Mesh, MeshError
from ..procmesh import ProcMesh

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
