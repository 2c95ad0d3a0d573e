"""Window synchronisation: fence, PSCW, shared locks, flush (the
`repro.core.epoch` counterpart on the stacked rank axis).

MPI separates exposure epochs (a target allows access) from access epochs
(an origin may communicate).  The paper implements the four families with
O(log p) (fence) or O(k) (PSCW) messages and O(1) locks.  Here every rank
is a row of one device tensor and the eager ops run in program order on
one CUDA stream, so an epoch boundary needs no barrier of its own: the
reference's scheduling barrier (`lax.optimization_barrier`) becomes a
no-op.  The epochs still count their synchronisation messages exactly as
the reference does, so the paper's complexity claims can be asserted, and
they consult the perf model to choose fence or PSCW.

Every epoch is also a plan scope: `begin_plan()` hands out an `RmaPlan`
whose recorded ops are flushed when the epoch closes, and the epoch's
`SyncStats` counts both raw (recorded) and coalesced (wire) messages.
`flush`/`flush_local` record into the active `SyncStats` ledgers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Optional, Sequence

from ..mesh import Mesh
from ..obs import causal as obs_causal
from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta
from .perfmodel import DEFAULT_MODEL, PerfModel
from .plan import PlanError, RmaPlan
from .rma import OpCounter


def _barrier_all(tree: Any) -> Any:
    """The reference pins values at an epoch boundary so XLA cannot move an
    RMA op across it.  Eager ops on one stream already run in program
    order, so there is nothing to pin."""
    return tree


@dataclasses.dataclass(eq=False)
class SyncStats:
    """Messages issued by synchronisation calls (not payload ops).

    A context manager: while active it also receives the module-level
    `flush`/`flush_local` accounting.  Identity (not value) equality, so
    two all-zero ledgers stay distinct in the active list.
    """

    post_msgs: int = 0
    complete_msgs: int = 0
    start_msgs: int = 0
    wait_msgs: int = 0
    barrier_stages: int = 0
    flush_msgs: int = 0
    flush_local_msgs: int = 0
    # payload ops recorded in this epoch's plan vs wire transfers issued
    raw_msgs: int = 0
    coalesced_msgs: int = 0

    _ACTIVE: ClassVar[list["SyncStats"]] = []

    def __enter__(self) -> "SyncStats":
        SyncStats._ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        SyncStats._ACTIVE.remove(self)

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def delta(self, prev) -> dict:
        """Snapshot diff against `prev` (a snapshot dict or a SyncStats)."""
        if hasattr(prev, "snapshot"):
            prev = prev.snapshot()
        return snapshot_delta(self.snapshot(), prev)

    @classmethod
    def record(cls, field: str, n: int = 1,
               also: Optional["SyncStats"] = None) -> None:
        targets = list(cls._ACTIVE)
        if also is not None and also not in targets:
            targets.append(also)
        for s in targets:
            setattr(s, field, getattr(s, field) + n)


class _PlanScope:
    """Mixin making an epoch a recording scope for a deferred `RmaPlan`:
    ops recorded through `begin_plan()` are issued when the epoch closes,
    and the epoch's stats pick up the raw/coalesced message counts."""

    _plan = None

    def begin_plan(self):
        # replacing an unflushed plan would drop its recorded ops
        if self._plan is not None and not self._plan.flushed:
            raise PlanError(
                f"begin_plan on axis {self.axis!r}: the epoch's previous "
                f"plan still holds {len(self._plan.ops)} unflushed recorded "
                "op(s) — close the epoch (or flush the plan) before "
                "beginning a new one")
        self._plan = RmaPlan(self.mesh, model=self.model)
        return self._plan

    @property
    def plan(self):
        return self._plan

    def _flush_plan(self, aggregate: Optional[bool] = None,
                    backend: str = "auto") -> None:
        if self._plan is not None and not self._plan.flushed:
            ps = self._plan.flush(aggregate=aggregate, backend=backend)
            self.stats.raw_msgs += ps.raw
            self.stats.coalesced_msgs += ps.coalesced


# ------------------------------------------------------------------- fence
class FenceEpoch(_PlanScope):
    """MPI_Win_fence ... MPI_Win_fence: bulk-synchronous, O(log p) stages.

        ep = FenceEpoch(mesh)
        x = ep.open(x)           # fence: close previous epoch, open this one
        ... RMA ops on x (eager, or recorded via ep.begin_plan()) ...
        x = ep.close(x)          # plan flush + fence commit
    """

    def __init__(self, mesh: Mesh, model: PerfModel = DEFAULT_MODEL):
        self.mesh = mesh
        self.axis = mesh.axis
        self.p = mesh.p
        self.model = model
        self.stats = SyncStats()
        self._open = False

    def open(self, tree: Any) -> Any:
        if self._open:
            raise PlanError(
                f"fence epoch on axis {self.axis!r} is already open — "
                "close() the current epoch before opening another")
        self._open = True
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("epoch.fence.open", axis=self.axis, p=self.p)
        return _barrier_all(tree)

    def close(self, tree: Any) -> Any:
        if not self._open:
            raise PlanError(
                f"double fence on axis {self.axis!r}: close() called with "
                "no open epoch — every close must pair with one open()")
        self._open = False
        with obs_trace.TRACER.span("epoch.fence.close", axis=self.axis, p=self.p) as sp:
            self._flush_plan()
            tree = _barrier_all(tree)
            self.stats.barrier_stages += max(1, int(math.ceil(math.log2(max(self.p, 2)))))
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs,
                   barrier_stages=self.stats.barrier_stages)
        return tree

    def predicted_cost(self) -> float:
        return self.model.p_fence(self.p)


# -------------------------------------------------------------------- PSCW
class PSCWEpoch(_PlanScope):
    """General active-target sync (post/start/complete/wait), O(k) messages:
    each poster announces itself to the k members of its access group, and
    complete bumps a completion counter at each exposed target.  Start and
    wait issue no messages."""

    def __init__(self, mesh: Mesh, group: Sequence[int],
                 model: PerfModel = DEFAULT_MODEL):
        self.mesh = mesh
        self.axis = mesh.axis
        self.group = list(group)
        self.k = len(self.group)
        self.model = model
        self.stats = SyncStats()

    # exposure side
    def post(self, tree: Any) -> Any:
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("epoch.pscw.post", axis=self.axis, k=self.k)
        self.stats.post_msgs += self.k
        return _barrier_all(tree)

    def wait(self, tree: Any) -> Any:
        return _barrier_all(tree)

    # access side
    def start(self, tree: Any) -> Any:
        return _barrier_all(tree)

    def complete(self, tree: Any) -> Any:
        with obs_trace.TRACER.span("epoch.pscw.complete", axis=self.axis, k=self.k) as sp:
            self._flush_plan()
            self.stats.complete_msgs += self.k
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs)
            return _barrier_all(tree)

    def predicted_cost(self) -> float:
        return self.model.p_pscw(self.k)


# ------------------------------------------------------------------- locks
class SharedLockEpoch(_PlanScope):
    """Passive-target shared lock: one atomic increment of the reader count
    to lock, one decrement to unlock (O(1))."""

    def __init__(self, mesh: Mesh, model: PerfModel = DEFAULT_MODEL):
        self.mesh = mesh
        self.axis = mesh.axis
        self.model = model
        self.locked = False
        self.stats = SyncStats()

    def lock(self, tree: Any) -> Any:
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("epoch.lock.open", axis=self.axis)
        self.locked = True
        OpCounter.record("accs")
        return _barrier_all(tree)

    def unlock(self, tree: Any) -> Any:
        with obs_trace.TRACER.span("epoch.lock.close", axis=self.axis) as sp:
            self._flush_plan()
            self.locked = False
            OpCounter.record("accs")
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs)
            return _barrier_all(tree)

    def predicted_cost(self) -> float:
        return self.model.p_lock_shared() + self.model.p_unlock()


# ------------------------------------------------------------------- flush
def flush(tree: Any, stats: Optional[SyncStats] = None) -> Any:
    """MPI_Win_flush: remote completion of this origin's pending ops.  Eager
    ops are complete in stream order, so this only records one flush
    message into the active `SyncStats` ledgers (and `stats` when given)."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("sync.flush", rid=obs_causal.current_rid(), wait=0,
                 rids=obs_causal.current_epoch_rids())
    SyncStats.record("flush_msgs", also=stats)
    return _barrier_all(tree)


def flush_local(tree: Any, stats: Optional[SyncStats] = None) -> Any:
    """MPI_Win_flush_local: local buffer reuse safety — the same lowering."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("sync.flush_local", rid=obs_causal.current_rid(), wait=0,
                 rids=obs_causal.current_epoch_rids())
    SyncStats.record("flush_local_msgs", also=stats)
    return _barrier_all(tree)


# --------------------------------------------------- model-guided selection
def choose_sync(k_neighbors: int, p: int, model: PerfModel = DEFAULT_MODEL) -> str:
    """Paper §6: fence if P_fence < P_pscw (large groups), else PSCW."""
    return model.select_sync_mode(k_neighbors, p)
