"""Window synchronisation: fence, PSCW, shared locks, flush (the
`repro.core.epoch` counterpart on the stacked rank axis).

MPI separates exposure epochs (a target allows access) from access epochs
(an origin may communicate).  The paper implements the four families with
O(log p) (fence) or O(k) (PSCW) messages and O(1) locks.  On a stacked
`Mesh` every rank is a row of one device tensor and the eager ops run in
program order on one CUDA stream, so an epoch boundary needs no barrier of
its own: the reference's scheduling barrier (`lax.optimization_barrier`)
becomes a no-op.  On a `ProcMesh` (one rank a process) the synchronisation
is real.  An eager op is its own round and fences (`ProcMesh.fence`: the
stream drained, a barrier of every process).  A plan flushed in a fence or
PSCW epoch stores its puts with no fence and the epoch's closing sync
makes them visible: a fence is one barrier across the processes that also
drains this rank's stream; PSCW exchanges tokens with the group's k ring
neighbours only (+1, -1, +2, ...: post and complete send, start and
complete receive), so a MILC step takes 2k tokens and no barrier.  A
shared lock's unlock and `flush` / `flush_local` drain the stream (remote
completion).  The epochs count their synchronisation messages exactly as
the reference does, on either mesh, so the paper's complexity claims can
be asserted, and they consult the perf model to choose fence or PSCW.

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
from ..procmesh import ProcMesh, neighbour_offsets
from .perfmodel import DEFAULT_MODEL, PerfModel
from .plan import PlanError, RmaPlan
from .rma import OpCounter

# the PSCW tokens' tags (plus the neighbour's index in the group)
TAG_POST, TAG_COMPLETE = 1 << 12, 2 << 12


def _barrier_all(tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """The reference pins values at an epoch boundary so XLA cannot move an
    RMA op across it.  Eager ops on one stream already run in program
    order, so there is nothing to pin; on a `ProcMesh` it is the fence
    across processes."""
    if isinstance(mesh, ProcMesh):
        mesh.fence()
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
    and the epoch's stats pick up the raw/coalesced message counts.

    It is also the synchronisation a plan flushes into
    (`RmaPlan.flush(sync=epoch)`): on a `ProcMesh` the puts that the
    epoch's closing sync reaches (`admits`) are stored with no fence of
    their own, and the epoch resolves their handles (`defer`) once that
    sync has made every peer's stores visible.  One such round is pending
    at a time; a later flush in the same epoch issues its own fences."""

    _plan = None
    _pending = None

    def admits(self, shifts: Sequence[int]) -> bool:
        """Whether this epoch's closing sync makes puts at `shifts` visible
        without a fence of their own (a lock's never does)."""
        return False

    def defer(self, resolve) -> None:
        self._pending = (self._pending or []) + [resolve]

    def _resolve(self) -> None:
        """After the closing sync: the deferred puts' handles resolve (the
        copies out of this rank's window), and the stream is marked so
        that the next opening sync waits for those copies."""
        pending, self._pending = self._pending, None
        if pending:
            for resolve in pending:
                resolve()
            self.mesh.mark_reads()

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
            ps = self._plan.flush(aggregate=aggregate, backend=backend, sync=self)
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
        return _barrier_all(tree, self.mesh)

    def close(self, tree: Any) -> Any:
        if not self._open:
            raise PlanError(
                f"double fence on axis {self.axis!r}: close() called with "
                "no open epoch — every close must pair with one open()")
        self._open = False
        with obs_trace.TRACER.span("epoch.fence.close", axis=self.axis, p=self.p) as sp:
            self._flush_plan()
            tree = _barrier_all(tree, self.mesh)
            self._resolve()
            self.stats.barrier_stages += max(1, int(math.ceil(math.log2(max(self.p, 2)))))
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs,
                   barrier_stages=self.stats.barrier_stages)
        return tree

    def admits(self, shifts: Sequence[int]) -> bool:
        """Any shift: the closing fence is a barrier of every rank."""
        return self._open and not self._pending and isinstance(self.mesh, ProcMesh)

    def predicted_cost(self) -> float:
        return self.model.p_fence(self.p)


# -------------------------------------------------------------------- PSCW
class PSCWEpoch(_PlanScope):
    """General active-target sync (post/start/complete/wait), O(k) messages:
    each poster announces itself to the k members of its access group, and
    complete bumps a completion counter at each exposed target.  Start and
    wait issue no messages.

    On a `ProcMesh` the k members of rank r's group are its ring neighbours
    r + o, o in +1, -1, +2, ... (MILC's two T neighbours at k = 2), and the
    tokens are the epoch's only synchronisation: post waits until this
    rank's window has been read out of its last epoch and sends one to
    each, start receives theirs, complete drains the stream (every put
    stored into a neighbour has landed), sends one to each and, if this
    rank posted, receives theirs, after which the puts stored here are
    visible and the deferred handles resolve (every rank is origin and
    target of the same SPMD program, so the exposure closes with the access
    epoch; a `wait` before `complete` has nothing to block on yet and
    defers to it).  A plan flushed in the epoch stores its puts at shifts
    in the group with no fence of its own; any other put fences."""

    def __init__(self, mesh: Mesh, group: Sequence[int],
                 model: PerfModel = DEFAULT_MODEL):
        self.mesh = mesh
        self.axis = mesh.axis
        self.group = list(group)
        self.k = len(self.group)
        self.model = model
        self.stats = SyncStats()
        self._peers = neighbour_offsets(self.k) if isinstance(mesh, ProcMesh) else None
        self._posted = self._started = False

    # exposure side
    def post(self, tree: Any) -> Any:
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("epoch.pscw.post", axis=self.axis, k=self.k)
        self.stats.post_msgs += self.k
        if self._peers is not None:
            self.mesh.reads_done()
            self.mesh.notify(self._peers, TAG_POST)
            self._posted, self._started = True, False
        return _barrier_all(tree)

    def wait(self, tree: Any) -> Any:
        self._receive_posts()
        return _barrier_all(tree)

    # access side
    def start(self, tree: Any) -> Any:
        self._receive_posts()
        return _barrier_all(tree)

    def _receive_posts(self) -> None:
        if self._posted and not self._started:
            self.mesh.await_tokens(self._peers, TAG_POST)
            self._started = True

    def complete(self, tree: Any) -> Any:
        with obs_trace.TRACER.span("epoch.pscw.complete", axis=self.axis, k=self.k) as sp:
            self._receive_posts()
            self._flush_plan()
            self.stats.complete_msgs += self.k
            if self._posted:
                self.mesh.flush()
                self.mesh.notify(self._peers, TAG_COMPLETE)
                self.mesh.await_tokens(self._peers, TAG_COMPLETE)
                self._posted = False
                self._resolve()
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs)
            return _barrier_all(tree)

    def admits(self, shifts: Sequence[int]) -> bool:
        """Puts at shifts in the group (their targets' complete tokens come
        back here); the targets' posts are received first (start)."""
        if not self._posted or self._pending:
            return False
        reach = {o % self.mesh.p for o in self._peers} | {0}
        if any(s % self.mesh.p not in reach for s in shifts):
            return False
        self._receive_posts()
        return True

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
            if isinstance(self.mesh, ProcMesh):
                self.mesh.flush()
            self.locked = False
            OpCounter.record("accs")
            sp.set(raw=self.stats.raw_msgs, coalesced=self.stats.coalesced_msgs)
            return _barrier_all(tree)

    def predicted_cost(self) -> float:
        return self.model.p_lock_shared() + self.model.p_unlock()


# ------------------------------------------------------------------- flush
def flush(tree: Any, stats: Optional[SyncStats] = None,
          mesh: Optional[Mesh] = None) -> Any:
    """MPI_Win_flush: remote completion of this origin's pending ops.  Eager
    ops are complete in stream order, so this records one flush message
    into the active `SyncStats` ledgers (and `stats` when given); on a
    `ProcMesh` (`mesh`) it also drains this rank's stream, so every store
    it issued into a peer's memory has landed."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("sync.flush", rid=obs_causal.current_rid(), wait=0,
                 rids=obs_causal.current_epoch_rids())
    SyncStats.record("flush_msgs", also=stats)
    if isinstance(mesh, ProcMesh):
        mesh.flush()
    return _barrier_all(tree)


def flush_local(tree: Any, stats: Optional[SyncStats] = None,
                mesh: Optional[Mesh] = None) -> Any:
    """MPI_Win_flush_local: local buffer reuse safety — the same lowering."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("sync.flush_local", rid=obs_causal.current_rid(), wait=0,
                 rids=obs_causal.current_epoch_rids())
    SyncStats.record("flush_local_msgs", also=stats)
    if isinstance(mesh, ProcMesh):
        mesh.flush()
    return _barrier_all(tree)


# --------------------------------------------------- model-guided selection
def choose_sync(k_neighbors: int, p: int, model: PerfModel = DEFAULT_MODEL) -> str:
    """Paper §6: fence if P_fence < P_pscw (large groups), else PSCW.  Both
    arms send the same tokens, so ranks on different cards (a token
    crossing the link, `PerfModel.p_crossing`) leave the choice as it is."""
    return model.select_sync_mode(k_neighbors, p)
