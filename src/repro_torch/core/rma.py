"""One-sided communication functions on the stacked rank axis (the
`repro.core.rma` counterpart) and their accounting.

Every eager op is a thin wrapper over a single-op `repro_torch.core.plan`
plan: record one descriptor, flush at once, so eager call sites keep the
reference's message counts while multi-op call sites use epoch-scoped plans.
Each op takes the global view ``x [p, ...]`` (rank r's block is ``x[r]``)
and a `Mesh` in place of the reference's axis name.

Accumulate uses the slotted protocol: each origin's contribution lands in
its own slot at the target and the owner reduces it, so no remote atomic is
needed.

The counter distinguishes **raw** messages (ops as recorded — what the
program meant) from **coalesced** messages (wire transfers actually issued
after plan aggregation).  Coalesced ops are attributed to their originating
kind: a fused transfer carrying 3 puts and 1 accumulate counts puts += 3,
accs += 1, raw_msgs += 4, coalesced_msgs += 1.  Per-plan aggregation detail
accumulates in `.plans`.  The snapshot keys are the reference's, so one
ledger schema reads both packages.

Counts are per rank, as in the reference where one trace is one rank's
program: a plan over the stacked ``[p, ...]`` view is counted once.  On a
`ProcMesh` (one rank a process) every op takes this rank's ``[1, ...]``
block and returns its row of the stacked result; each process counts its
own rank's ops, the same counts as the stacked run's.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from ..mesh import Mesh
from ..obs import trace as obs_trace
from ..procmesh import ProcMesh
from ..obs.metrics import snapshot_delta


def _plan(mesh: Mesh):
    """One single-op plan (lazy import: plan.py imports OpCounter from here)."""
    from . import plan as plan_mod

    return plan_mod.RmaPlan(mesh)


def _one(mesh: Mesh, record) -> torch.Tensor:
    plan = _plan(mesh)
    h = record(plan)
    plan.flush()
    return h.result()


def rank(mesh: Mesh) -> torch.Tensor:
    """[p]: each rank's index within the window axis."""
    return mesh.axis_index()


# --------------------------------------------------------------------- put
def put_shift(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """Put rank r's block to rank (r + shift) mod p; returns what was put
    into each rank."""
    return _one(mesh, lambda p: p.put_shift(x, shift))


def put_perm(x: torch.Tensor, perm: Sequence[tuple[int, int]],
             mesh: Mesh) -> torch.Tensor:
    """Put along an arbitrary (src, dst) permutation.  Ranks absent as
    destinations receive zeros (their window region is not written)."""
    return _one(mesh, lambda p: p.put_perm(x, perm))


# --------------------------------------------------------------------- get
def get_shift(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """Get from rank (r + shift) mod p."""
    return _one(mesh, lambda p: p.get_shift(x, shift))


def get_index(x: torch.Tensor, src: int, mesh: Mesh) -> torch.Tensor:
    """Every rank gets rank `src`'s block (a broadcast get)."""
    full = _one(mesh, lambda p: p.all_gather(x, kind="gets"))   # [p, p, ...]
    return full[:, src]


def get_gather(x: torch.Tensor, src_per_rank: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """Rank r gets the block of rank ``src_per_rank[r]`` (a gather-get);
    on a `ProcMesh`, src_per_rank holds this rank's source."""
    full = _one(mesh, lambda p: p.all_gather(x, kind="gets"))
    rows = torch.arange(full.shape[0], device=full.device)
    return full[rows, src_per_rank.to(device=full.device, dtype=torch.int64)]


# -------------------------------------------------------------- accumulate
def accumulate_shift(x: torch.Tensor, acc: torch.Tensor, shift: int,
                     mesh: Mesh, op: Callable = torch.add) -> torch.Tensor:
    """Accumulate to rank r + shift with reduction `op` (slotted protocol):
    returns each target's accumulator updated with its one incoming
    contribution."""
    return _one(mesh, lambda p: p.accumulate_shift(x, acc, shift, op))


def accumulate_perm(x: torch.Tensor, acc: torch.Tensor,
                    perm: Sequence[tuple[int, int]], mesh: Mesh,
                    op: Callable = torch.add) -> torch.Tensor:
    return _one(mesh, lambda p: p.accumulate_perm(x, acc, perm, op))


def accumulate_slots(contributions: torch.Tensor, acc: torch.Tensor,
                     op: Callable = torch.add) -> torch.Tensor:
    """Owner-side reduction over the slot buffer at epoch completion:
    contributions [p, k, ...] (one slot per neighbour, zeros where unused),
    acc [p, ...]."""
    if op is torch.add:
        return op(acc, contributions.sum(dim=1))
    return functools.reduce(op, [contributions[:, i] for i in range(contributions.shape[1])], acc)


def fetch_and_op(x: torch.Tensor, target: torch.Tensor, mesh: Mesh,
                 op: Callable = torch.add) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch-and-op on the window axis: returns (old value, new target).
    Serialisation is the epoch's; `mesh` names the window whose per-axis
    AMO counter it tags."""
    OpCounter.record("accs", axis=mesh.axis)
    return target, op(target, x)


# ------------------------------------------------------------- bulk moves
def put_all_to_all(x: torch.Tensor, mesh: Mesh, tiled: bool = False) -> torch.Tensor:
    """Personalised all-to-all built on one-sided puts.  Untiled: x
    [p_src, p_dst, ...] -> [p_dst, p_src, ...].  Tiled: x [p, p*k, ...],
    chunk b of each rank's block goes to rank b, concatenated in source
    order (one collective, counted as such).  On a `ProcMesh` both forms
    take a plan group's route (`core.plan._route`): the peer put kernel
    for blocks of whole words on the card."""
    if tiled:
        OpCounter.record("colls")
        p = mesh.p
        mesh._check(x)
        blocks = x.reshape((x.shape[0], p, x.shape[1] // p) + tuple(x.shape[2:]))
        if isinstance(mesh, ProcMesh):
            from . import plan as plan_mod

            return plan_mod.issue_all_to_all(mesh, blocks).reshape(x.shape)
        return blocks.transpose(0, 1).reshape(x.shape)
    return _one(mesh, lambda p: p.put_all_to_all(x, kind="colls"))


def put_bcast(x: torch.Tensor, root: int, mesh: Mesh) -> torch.Tensor:
    """Root puts its block to every rank: ONE collective, not a collective
    plus a get (so the instrumented `get_index` is not called)."""
    OpCounter.record("colls")
    return mesh.all_gather(x)[:, root]


class OpCounter:
    """Counts one-sided ops issued while active (``with OpCounter() as c``)."""

    _active: list["OpCounter"] = []

    def __init__(self) -> None:
        self.puts = 0
        self.gets = 0
        self.accs = 0
        self.colls = 0
        self.raw_msgs = 0        # logical messages recorded
        self.coalesced_msgs = 0  # wire transfers actually issued
        self.plans: list[dict] = []  # per-plan aggregation stats
        self.by_axis: dict = {}  # {axis: {kind: count}}

    def __enter__(self) -> "OpCounter":
        OpCounter._active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        OpCounter._active.remove(self)

    @property
    def aggregation_factor(self) -> float:
        return self.raw_msgs / self.coalesced_msgs if self.coalesced_msgs else 1.0

    def snapshot(self) -> dict:
        return {
            "puts": self.puts,
            "gets": self.gets,
            "accs": self.accs,
            "colls": self.colls,
            "raw_msgs": self.raw_msgs,
            "coalesced_msgs": self.coalesced_msgs,
            "by_axis": {a: dict(sorted(k.items())) for a, k in sorted(self.by_axis.items())},
        }

    def delta(self, prev) -> dict:
        """Snapshot diff against `prev` (a snapshot dict or an OpCounter)."""
        if hasattr(prev, "snapshot"):
            prev = prev.snapshot()
        return snapshot_delta(self.snapshot(), prev)

    @classmethod
    def record(cls, kind: str, n: int = 1, axis: str | None = None) -> None:
        """Eager-path record: one logical op == one wire transfer."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("rma.op", kind=kind, n=n, axis=axis or "")
        for c in cls._active:
            setattr(c, kind, getattr(c, kind) + n)
            c.raw_msgs += n
            c.coalesced_msgs += n
            if axis is not None:
                per = c.by_axis.setdefault(axis, {})
                per[kind] = per.get(kind, 0) + n

    @classmethod
    def record_plan(cls, kinds: dict[tuple[str, str], int], raw: int,
                    coalesced: int, info: dict | None = None) -> None:
        """Plan-flush record: each recorded op counts toward its kind (raw),
        wire transfers are accounted separately."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("rma.plan", raw=raw, coalesced=coalesced)
        for c in cls._active:
            for (kind, axis), n in kinds.items():
                setattr(c, kind, getattr(c, kind) + n)
                per = c.by_axis.setdefault(axis, {})
                per[kind] = per.get(kind, 0) + n
            c.raw_msgs += raw
            c.coalesced_msgs += coalesced
            if info is not None:
                c.plans.append(dict(info))
