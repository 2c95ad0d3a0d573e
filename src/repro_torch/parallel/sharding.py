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
slice of F, an MoE layer over its own slice of every expert's F (the
moe family serves and trains split; `models.moe`), the embedding and the
LM head over its own block of the vocabulary.  `splits` says, from a
leaf's fitted spec, whether a dim is split over ``model``: a projection
whose contraction dim is split leaves a partial sum that `all_reduce`
completes, and the LM head's block of the vocabulary is joined by
`all_gather`.  Both run over the axis's view
(`ProcMesh.along`) through the one-sided ring collectives
(`core.collectives`), whose puts are the peer kernels' on the card: the
collectives XLA's partitioner inserts into the reference's split
forward.  A leaf whose spec fits no split (6 q heads but 3 KV heads at
tp = 2: ``wk`` / ``wv`` replicated) is whole on every rank, and a sum over
a whole leaf is never reduced.

**Its backward.**  Each collective is a `torch.autograd.Function`, so the
train step differentiates the split forward (Megatron's pairs): the
row-parallel sum (`all_reduce`) passes its cotangent to every rank's
partial unchanged; the column-parallel entry (`enter`), the identity
forward, all-reduces over ``model`` the cotangent of a replicated
activation entering split heads or a split F, of a leaf whole on every
rank but used there in part (the mixed fit's ``wk`` / ``wv`` / ``bk`` /
``bv``), and of the MoE gates that weigh each rank's partial expert
output (entered with the experts' input: one all-reduce for both); the
vocabulary gather hands each rank its slice of the cotangent.  With
``fsdp=True`` a leaf's fitted spec may also split a dim over ``data``:
`gather_data` all-gathers it over that axis at its use
(FSDP), and its backward reduce-scatters the gathered leaf's cotangent
over ``data``, so a rank's gradient block is already summed over the
``data`` ranks; `sum_over` sums the rest (`train.train_step`), and
`norm_sq` counts every block once in the clip's global norm.  What such a
split does not carry yet is refused by `check_model_split` (ROADMAP items
12c.3b, 12c.5b, 12c.6).  A policy on a stacked `Mesh`, or over processes
without a ``model`` axis of more than one, changes no value.

**The recurrent families.**  The hybrid (Jamba) and ssm (xLSTM) families
serve split (not train: item 12c.5b).  A Mamba layer computes its block of
the channels, an mLSTM its block of the heads and an sLSTM its block of
the heads' channels, and the recurrent state is that block
(`state_sharding`, the reference's `_cache_specs`).  Where a fitted block
does not line up with them (``in_proj`` / ``up_proj`` split across the
concatenated ``x ‖ z``, ``dt_proj`` on its rank R, ``A_log`` on N, the
sLSTM FFN's ``w_in`` across gate ‖ up) the rank moves activations by
`all_gather` and `all_to_all`, never a whole weight (`models.mamba`,
`models.xlstm` say which).

**A KV cache split on its sequence.**  Where `kv_cache_spec` puts the
cache's sequence on ``model`` (``kv_seq_shard``, or fewer KV heads than
ranks) and ``model`` divides max_seq, rank r holds positions [r S / tp,
(r + 1) S / tp) of every KV head (`kv_cache_sharding`, `kv_seq_blocks`).
Each rank attends every q head over its block and `all_to_all` hands each
rank the partial softmax results of its own heads, which it merges
(`models.layers.attention`): the reference's GSPMD partition of the same
attention over a sequence-split cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
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
        return _unflatten_like(tree, self.flat_specs(tree))

    def tree_shardings(self, tree: Any) -> Any:
        """One `NamedSharding` (this mesh, the leaf's spec) a leaf."""
        return _unflatten_like(tree, {path: NamedSharding(self.mesh, spec)
                                      for path, spec in self.flat_specs(tree).items()})

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch by the reference's batch specs
        (`launch/dryrun.py` `_batch_specs`): ``tokens`` / ``labels``,
        ``frames`` / ``patches`` and ``token`` split over the data axes
        (fitted), anything else whole."""
        dp = _dp(self.mesh)
        out = {}
        for k, v in batch.items():
            spec = P(dp) if k in ("tokens", "labels", "frames", "patches", "token") else P()
            out[k] = NamedSharding(self.mesh, fit_spec(spec, tuple(v.shape), self.mesh)).local(v)
        return out

    @staticmethod
    def names(spec: P, axis: str) -> bool:
        """Whether `spec` splits a dim over `axis`."""
        return any(axis in _axes_of(entry) for entry in spec)

    def flat_specs(self, tree: Any) -> dict:
        """{leaf path: its fitted spec} for every leaf of `tree`."""
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

    def check_model_split(self, cfg=None, train: bool = False) -> None:
        """Raise for what a model step split over processes does not carry
        yet, naming its ROADMAP item; a no-op unless `splits_model`.
        Without `cfg` only the policy's own options are checked; `train`
        asks for a train step: the dense and moe families serve and train
        split, the hybrid and ssm families only serve (12c.5b).  A hybrid
        whose Mamba channels, or an ssm model whose heads, ``model`` does
        not divide is refused: its fitted leaves and state would not split
        by whole channels or heads."""
        if not self.splits_model:
            return
        if self.seq_parallel:
            raise NotImplementedError(
                "sequence-parallel activations over processes are ROADMAP item 12c.3b")
        if cfg is None:
            return
        if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: only the dense, moe, hybrid and ssm families split over "
                f"processes; the {cfg.family} family's split is ROADMAP item 12c")
        if train and cfg.family in ("hybrid", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family serves split over processes; its "
                "train step's split is ROADMAP item 12c.5b")
        what = {"hybrid": ("Mamba channels", cfg.ssm_expand * cfg.d_model),
                "ssm": ("xLSTM heads", cfg.n_heads)}.get(cfg.family)
        if what is not None and what[1] % self.tp:
            raise NotImplementedError(
                f"{cfg.name}: {what[1]} {what[0]} over {self.tp} model ranks do not split "
                "evenly (ROADMAP item 12c.5 splits whole blocks)")

    def state_sharding(self, kind: str, leaf: str, shape) -> "NamedSharding":
        """The placement of a recurrent state leaf of whole `shape` (the
        reference's `_cache_specs`, fitted): ``kind`` "mamba" (``h`` [n_p,
        n_m, B, di, N], ``conv`` [n_p, n_m, B, W-1, di]: the channels over
        ``model``), "mlstm" (``C`` / ``n`` / ``m`` [n_p, P-1, B, nh, ...]:
        the heads) or "slstm" (``c`` / ``n`` / ``h`` / ``m`` [n_p, B, D]:
        D, whole heads' channels); the rows over the data axes."""
        dp = _dp(self.mesh)
        nd = len(shape)
        if kind == "mamba":
            spec = (P(None, None, dp, "model", None) if leaf == "h"
                    else P(None, None, dp, None, "model"))
        elif kind == "mlstm":
            spec = P(None, None, dp, "model", *((None,) * (nd - 4)))
        elif kind == "slstm":
            spec = P(*((None,) * (nd - 2)), dp, "model")
        else:
            raise KeyError(f"unknown recurrent state {kind!r}")
        return NamedSharding(self.mesh, fit_spec(spec, tuple(shape), self.mesh))

    def row_blocks(self, rows: int) -> int:
        """Into how many blocks the reference's batch spec (``P(("pod",
        "data"))``, fitted as `local_batch` fits it) cuts a global batch of
        `rows`: each rank then holds rows / row_blocks of them."""
        entry = fit_spec(P(_dp(self.mesh)), (rows,), self.mesh)[0]
        return math.prod(self.mesh.shape[a] for a in _axes_of(entry))

    def kv_cache_sharding(self, n_kv_heads: int, shape) -> "NamedSharding":
        """The placement of a K/V cache leaf of whole `shape` [L, B,
        max_seq, Hkv, hd]: `kv_cache_spec` behind the stacked layers' dim,
        fitted to `shape` (the reference's `_cache_specs`), so that a
        max_seq that ``model`` does not divide keeps the sequence whole."""
        spec = fit_spec(P(None, *self.kv_cache_spec(n_kv_heads)), tuple(shape), self.mesh)
        return NamedSharding(self.mesh, spec)

    def kv_seq_split(self, n_kv_heads: int) -> bool:
        """Whether `kv_cache_spec` puts a cache's sequence on ``model``
        (before it is fitted to a length)."""
        return "model" in _axes_of(self.kv_cache_spec(n_kv_heads)[1])

    def kv_seq_blocks(self, n_kv_heads: int, shape) -> int:
        """How many blocks over ``model`` that leaf's sequence is cut into:
        tp where its fitted spec splits the sequence, else 1.  Rank r of
        the axis then holds positions [r S / tp, (r + 1) S / tp)."""
        spec = self.kv_cache_sharding(n_kv_heads, shape).spec
        return self.tp if "model" in _axes_of(spec[2]) else 1

    def local_params(self, tree: Any) -> Any:
        """This rank's block of every leaf of `tree`: ``tree_shardings(tree)``,
        then each one's `NamedSharding.local`.  A tensor's block is a copy,
        so that the whole leaf may go; any other leaf's (numpy) a view."""
        self.check_model_split()
        specs = self.flat_specs(tree)

        def block(path, leaf):
            got = NamedSharding(self.mesh, specs[path]).local(leaf)
            if isinstance(got, torch.Tensor):
                return got.clone(memory_format=torch.contiguous_format)
            return got

        return _unflatten_like(tree, {path: block(path, leaf) for path, leaf in flatten(tree)})

    # ------------------------------------- the split step's collectives
    @property
    def gathers_data(self) -> bool:
        """Whether the split step gathers FSDP blocks over ``data``: fsdp on a
        model split whose ``data`` axis has more than one rank."""
        return self.splits_model and self.fsdp and self.mesh.shape.get("data", 1) > 1

    @property
    def data_axes(self) -> tuple:
        """The data axes of more than one rank: the batch's rows are split
        over them and a gradient is summed over them."""
        return tuple(a for a in (_dp(self.mesh) or ()) if self.mesh.shape[a] > 1)

    def data_dim(self, path: str, shape) -> Optional[int]:
        """The dim of the leaf of whole `shape` at `path` that its fitted
        spec splits over ``data`` (None where it splits none, or where this
        policy gathers nothing over ``data``)."""
        if not self.gathers_data:
            return None
        spec = fit_spec(self.param_spec(path, len(shape)), tuple(shape), self.mesh)
        return next((d for d, entry in enumerate(spec) if "data" in _axes_of(entry)), None)

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Each rank's partial sum y -> the sum over the ``model`` axis: the
        one-sided ring all-reduce (`core.collectives.all_reduce`), summed
        in f32 (in y's dtype where that is wider) and returned in y's.  Its
        backward is the identity into each rank's partial."""
        return _RowSum.apply(y, self.mesh.along("model"))

    def enter(self, x: torch.Tensor, *more: torch.Tensor):
        """The column-parallel entry of `x` (replicated over ``model``) into
        this rank's split part: x itself; its backward all-reduces x's
        cotangent over ``model``, each rank's part of it being partial.
        Given more tensors it returns them all, and their cotangents are
        summed by one all-reduce of their f32 concatenation."""
        xs = (x, *more)
        if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
            xs = _Enter.apply(self.mesh.along("model"), *xs)
        return xs if more else xs[0]

    def all_gather(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Each rank's block y -> the ``model`` axis's blocks in its order,
        concatenated along `dim`: the one-sided ring all-gather
        (`core.collectives.ring_all_gather`) of y's bytes as 32-bit words.
        Its backward is this rank's slice of the cotangent (the whole
        tensor's use is replicated over ``model``)."""
        return _VocabGather.apply(y, self.mesh.along("model"), dim % y.ndim)

    def gather_data(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's FSDP block y of a leaf -> the ``data`` axis's blocks
        along `dim`, joined (the ring all-gather); its backward reduce-
        scatters the cotangent over ``data`` (summed in f32, returned in
        y's dtype where that is wider)."""
        return _FsdpGather.apply(y, self.mesh.along("data"), dim % y.ndim)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [tp, ...], block d for the ``model`` axis's rank d -> [tp, ...],
        block s from its rank s: `core.collectives.all_to_all`, one-sided
        puts (row 4's peer form on the card for blocks of whole words).  No
        backward: the split decode's partial softmax results move by it."""
        return collectives.all_to_all(x.contiguous()[None], self.mesh.along("model"))[0]

    def sum_over(self, axis: str, tensors: list) -> list:
        """Each tensor summed over `axis`: one ring all-reduce of their f32
        concatenation (every rank of the axis gets the same bits), each
        returned in its dtype."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
        got = collectives.all_reduce(flat[None], self.mesh.along(axis))[0]
        return [part.view(t.shape).to(t.dtype)
                for part, t in zip(got.split([t.numel() for t in tensors]), tensors)]

    def norm_sq(self, leaves: list, specs: list) -> torch.Tensor:
        """The sum of squares of a tree of blocks over the whole grid, each
        block counted once: a leaf's squares count on the ranks whose
        coordinate is 0 on every axis its spec does not split, and the sum
        is one ring all-reduce over every rank of the grid (f32)."""
        at = dict(zip(self.mesh.axis_names, self.mesh.coords))
        own = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for g, spec in zip(leaves, specs):
            if all(c == 0 for a, c in at.items() if not self.names(spec, a)):
                own = own + g.float().square().sum()
        grid = self.mesh.regrid({"grid": self.mesh.p})
        return collectives.all_reduce(own.reshape(1, 1), grid).reshape(())


def _axes_of(entry) -> tuple:
    """A spec entry's mesh axes (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _ring_sum(y: torch.Tensor, sub: Mesh) -> torch.Tensor:
    acc = y if y.dtype.itemsize >= 4 else y.float()
    return collectives.all_reduce(acc.contiguous()[None], sub)[0].to(y.dtype)


def _ring_gather(y: torch.Tensor, sub: Mesh, dim: int, bidirectional: bool = True
                 ) -> torch.Tensor:
    raw = as_bytes(y)
    words = torch.nn.functional.pad(raw, (0, -raw.numel() % 4)).view(torch.int32)
    got = collectives.ring_all_gather(words[None], sub, bidirectional)[0]   # [p, words]
    blocks = got.view(torch.uint8)[:, :raw.numel()].contiguous().view(y.dtype)
    return torch.cat(list(blocks.reshape((sub.p,) + tuple(y.shape))), dim=dim)


class _RowSum(torch.autograd.Function):
    """The row-parallel sum: the ring all-reduce; backward the identity."""

    @staticmethod
    def forward(ctx, y, sub):
        return _ring_sum(y, sub)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The column-parallel entry of one or more tensors: the identity;
    backward one ring all-reduce of their cotangents' concatenation, in f32
    (or wider), each part returned in its tensor's dtype."""

    @staticmethod
    def forward(ctx, sub, *xs):
        ctx.sub = sub
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        dt = functools.reduce(torch.promote_types, [g.dtype for g in gs], torch.float32)
        flat = torch.cat([g.to(dt).reshape(-1) for g in gs])
        got = collectives.all_reduce(flat[None], ctx.sub)[0]
        return (None, *(part.view(g.shape).to(g.dtype)
                        for part, g in zip(got.split([g.numel() for g in gs]), gs)))


class _VocabGather(torch.autograd.Function):
    """The vocabulary all-gather; backward this rank's slice."""

    @staticmethod
    def forward(ctx, y, sub, dim):
        ctx.sub, ctx.dim, ctx.n = sub, dim, y.shape[dim]
        return _ring_gather(y, sub, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.sub.rank * ctx.n, ctx.n), None, None


class _FsdpGather(torch.autograd.Function):
    """The FSDP gather over ``data``: the ring all-gather (one direction at
    two ranks, where both directions reach the same neighbour); backward
    the ring reduce-scatter, in f32 or wider.  It keeps no tensor for the
    backward, so a recomputation under checkpointing replaces nothing it
    holds."""

    @staticmethod
    def forward(ctx, y, sub, dim):
        ctx.sub, ctx.dim = sub, dim
        return _ring_gather(y, sub, dim, bidirectional=sub.p > 2)

    @staticmethod
    def backward(ctx, g):
        p, dim = ctx.sub.p, ctx.dim
        acc = g if g.dtype.itemsize >= 4 else g.float()
        chunks = acc.unflatten(dim, (p, g.shape[dim] // p)).movedim(dim, 0)
        got = collectives.ring_reduce_scatter(chunks.contiguous()[None], ctx.sub)[0]
        return got.to(g.dtype), None, None


def fit_spec(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Drop mesh axes that do not divide their dim evenly.

    A placement must tile its tensor exactly: 5 KV heads over a 4-way
    `model` axis, or batch 1 over `data`, fall back to replication on that
    dim.  Tuple entries are trimmed from the right, so ('pod', 'data') on a
    dim of 16 keeps 'pod' alone when 32 does not divide it.  An axis the
    mesh lacks is dropped too (the reference keeps it, an axis of one rank:
    the same blocks), so that the FSDP rules fit a mesh with no ``data``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        # an axis the mesh lacks is one rank: the dim stays whole on it
        axes = [a for a in _axes_of(entry) if a in mesh.shape]
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
        return _axes_of(self.spec[d] if d < len(self.spec) else None)

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
