"""Access IR: lowering recorded RMA programs to a normalized form (§14).

Three sources lower into one normalized stream of

    ``(rank, window, byte-interval, kind, epoch-id)`` accesses
  + ``(kind, rank)`` sync edges
  + ``(rank, mode, target, phase)`` lock events

which `analysis.races.check_ir` replays through the same vector-clock
engine the runtime shadow uses:

  1. **Live plans** — `from_plan(plan)` expands every recorded
     `core.plan._RecordedOp` descriptor into per-(src, dst) accesses.  By
     default each op owns a *disjoint slot* of the fused wire buffer (the
     §8 coalescing layout), so a default plan is race-free by
     construction; ops recorded with an explicit ``at=(lo, hi)`` target
     interval model protocols that alias window bytes, and conflicting
     overlaps are reported with both descriptors' provenance.
  2. **Exported obs traces** — `from_trace(events)` consumes a
     `obs.trace.Tracer` event list.  Traces carry epoch/sync/lock
     structure but not byte intervals (those exist only plan- or
     shadow-side), so trace-sourced IR checks synchronization shape: lock
     acquire/release pairing, shared→exclusive upgrades, fence/flush
     ordering.  This is the documented coarse mode.
  3. **The runtime shadow** — `races.RaceChecker` consumes fabric ops
     directly (no IR materialization) but shares the engine and rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple


@dataclass(frozen=True)
class IRAccess:
    """One normalized access: `seq` orders it against the sync stream."""

    seq: int
    rank: int
    window: str
    dst: int
    kind: str  # put | get | acc | fao | local-read | local-write
    lo: int
    hi: int
    epoch: int
    prov: str


@dataclass(frozen=True)
class IRSync:
    seq: int
    kind: str  # flush | flush_remote | fence
    rank: int


@dataclass(frozen=True)
class IRLockEvent:
    seq: int
    rank: int
    phase: str   # acquire | release
    mode: str    # shared | exclusive | all
    target: int  # -1 for lock_all


@dataclass
class AccessIR:
    """The normalized program `races.check_ir` replays."""

    p: int
    accesses: List[IRAccess] = field(default_factory=list)
    syncs: List[IRSync] = field(default_factory=list)
    lock_events: List[IRLockEvent] = field(default_factory=list)


_KIND_MAP = {"puts": "put", "gets": "get", "accs": "acc", "colls": "put",
             None: "put"}


def _plan_p(plan: Any) -> int:
    p = 0
    for op in plan.ops:
        if op.sig[0] == "ppermute":
            for s, d in op.sig[1]:
                p = max(p, int(s) + 1, int(d) + 1)
    return p


def from_plan(plan: Any, p: Optional[int] = None) -> AccessIR:
    """Lower an (unflushed or flushed) `RmaPlan`'s descriptors to IR.

    Each recorded op defaults to its own disjoint slot of the fused wire
    buffer — the §8 layout — unless it was recorded with an explicit
    ``at=(lo, hi)`` byte interval on the target window.  A collective's
    default slot holds one block per source (an all-to-all's block s and an
    all-gather's rank-s block land in slot s at every receiver), so its
    sources never alias one another; the reference gives every source the
    whole slot, which flags any all-to-all put at p > 1.
    """
    if p is None:
        p = _plan_p(plan)
        if p == 0:
            p = 1
    ir = AccessIR(p=p)
    seq = 0
    off = 0  # running default-slot offset (bytes) in the fused buffer
    for j, op in enumerate(plan.ops):
        kind = _KIND_MAP.get(op.kind, "put")
        nbytes = int(op.nbytes)
        block = max(nbytes, 1)
        if op.at is not None:
            lo, hi = int(op.at[0]), int(op.at[1])
        else:
            lo, hi = off, off + block
        per_src = op.at is None and op.sig[0] not in ("ppermute", "local")
        off += block * (p if per_src else 1)
        if op.sig[0] == "ppermute":
            pairs: Iterable[Tuple[int, int]] = op.sig[1]
        elif op.sig[0] == "local":
            kind = "fao"
            pairs = [(r, r) for r in range(p)]
        else:  # all_to_all / all_gather: every (src, dst) pair moves data
            pairs = [(s, d) for s in range(p) for d in range(p)]
        for s, d in pairs:
            a, b = lo, hi
            if per_src:                 # source s's block of the slot
                a, b = lo + int(s) * block, lo + (int(s) + 1) * block
            ir.accesses.append(IRAccess(
                seq=seq, rank=int(s), window=op.axis, dst=int(d), kind=kind,
                lo=a, hi=b, epoch=0,
                prov=(f"plan[{j}] kind={op.kind or 'rider'} sig={op.sig[0]} "
                      f"axis={op.axis!r} bytes=[{a}:{b}) src={int(s)} "
                      f"dst={int(d)}")))
            seq += 1
    return ir


# trace event names understood by the coarse trace lowering
_SYNC_NAMES = {"sync.flush": "flush", "sync.flush_local": "flush",
               "fabric.flush": "flush", "fabric.fence": "fence"}


def from_trace(events: Iterable[Dict[str, Any]],
               p: Optional[int] = None) -> AccessIR:
    """Lower an exported `obs` trace to IR (coarse mode: sync + locks).

    Understands ``lock.acquire`` / ``lock.release`` (emitted by
    `core.locks_sim.LockOrigin`), the module-level ``sync.flush`` events
    and the fabric's ``fabric.op`` stream.  Byte intervals are not present
    in traces, so data accesses lower with a degenerate [0, 0) interval —
    conflict detection needs plan or shadow mode; lock-discipline and
    sync-structure rules work fully here.
    """
    ir = AccessIR(p=0)
    seq = 0
    max_rank = -1
    for ev in events:
        name = ev.get("name", "")
        rank = int(ev.get("rank", 0))
        args = ev.get("args", {})
        max_rank = max(max_rank, rank)
        if name in ("lock.acquire", "lock.release"):
            ir.lock_events.append(IRLockEvent(
                seq=seq, rank=rank,
                phase="acquire" if name == "lock.acquire" else "release",
                mode=str(args.get("mode", "exclusive")),
                target=int(args.get("target", -1))))
        elif name in _SYNC_NAMES:
            ir.syncs.append(IRSync(seq=seq, kind=_SYNC_NAMES[name],
                                   rank=rank))
        elif name == "fabric.op":
            src = int(args.get("src", rank))
            dst = int(args.get("dst", src))
            max_rank = max(max_rank, src, dst)
            kind = {"puts": "put", "gets": "get",
                    "accs": "acc"}.get(str(args.get("kind", "")), None)
            if kind is not None:
                ir.accesses.append(IRAccess(
                    seq=seq, rank=src, window=str(args.get("region", "")),
                    dst=dst, kind=kind, lo=0, hi=0, epoch=0,
                    prov=f"trace[{seq}] fabric.op {args!r}"))
        seq += 1
    ir.p = p if p is not None else max_rank + 1
    return ir
