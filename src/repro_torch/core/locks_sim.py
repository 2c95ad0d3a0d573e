"""The paper's scalable lock protocol (§2.3, Fig. 3), host side (copy of
`repro.core.locks_sim`).

A two-level hierarchy: one global lock word at a master rank plus one
local lock word per rank, all updates by fetch-and-add / compare-and-swap
on 64-bit words, with every AMO counted (`LockWindow.total_amos`).  The
host page pool arbitrates on `_AtomicWord`; the continuous-batching
`serve.engine.ServeEngine` takes its admission control from `LockOrigin`:
shared locks for per-lane cache appends, the exclusive lock for slot-table
writes.

Lock-variable layout (64-bit, paper Fig. 3a):
  local  lock: bit 63 = writer bit; bits 0..62 = reader count
  global lock: high 32 bits = exclusive-count; low 32 bits = lockall-count
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

from ..obs import flight as obs_flight
from ..obs import trace as obs_trace


WRITER_BIT = 1 << 63
GLOBAL_EXCL_UNIT = 1 << 32
GLOBAL_SHRD_MASK = (1 << 32) - 1

# Bounded busy-wait: with backoff doubling from 1µs and capping at 1ms, the
# default bound spends ~30s before giving up — a protocol bug (e.g. a
# refcount path that never releases its writer) fails loudly with held-state
# diagnostics instead of hanging the tier-1 run forever.
DEFAULT_MAX_RETRIES = 30_000


class LockStateError(RuntimeError):
    """A release that does not match any lock this origin holds.

    Without this guard a double-release silently corrupts the shared
    reader count / writer bit and the corruption surfaces later as an
    unrelated timeout; the race checker's lock-discipline rule flags the
    same pattern fabric-side."""


class LockTimeout(RuntimeError):
    """A lock acquisition exhausted its retry bound (likely deadlock).

    Carries how long the origin waited (`wait_s`, wall seconds) and how many
    acquisition attempts it made (`attempts`) alongside the held-state dump
    in the message — the same fields the tracer surfaces as span attributes
    on the ``lock.timeout`` event."""

    def __init__(self, message: str, wait_s: float = 0.0, attempts: int = 0):
        super().__init__(message)
        self.wait_s = wait_s
        self.attempts = attempts


def _held_state(win: "LockWindow", target: int | None = None) -> str:
    """Human-readable dump of the lock words for timeout diagnostics —
    including WHICH rank holds a writer lock, so a deadlock report points
    at the offender instead of just the contended word."""
    m = win.master.v
    parts = [f"master: excl={m >> 32}, lockall={m & GLOBAL_SHRD_MASK}"]
    ranks = range(win.p) if target is None else [target]
    for r in ranks:
        v = win.local[r].v
        fields = [f"writer={bool(v & WRITER_BIT)}"]
        if v & WRITER_BIT:
            holder = win.holder[r]
            fields.append(f"held_by=rank {holder}" if holder >= 0
                          else "held_by=?")
        fields.append(f"readers={v & ~WRITER_BIT}")
        parts.append(f"local[{r}]: " + ", ".join(fields))
    return "; ".join(parts)


class _AtomicWord:
    """A 64-bit word supporting the three DMAPP AMOs the paper needs."""

    __slots__ = ("v", "_mu", "amo_count")

    def __init__(self) -> None:
        self.v = 0
        self._mu = threading.Lock()
        self.amo_count = 0

    def fetch_add(self, delta: int) -> int:
        with self._mu:
            old = self.v
            self.v = (self.v + delta) & ((1 << 64) - 1)
            self.amo_count += 1
            return old

    def cas(self, expected: int, new: int) -> int:
        with self._mu:
            old = self.v
            if old == expected:
                self.v = new
            self.amo_count += 1
            return old

    def read(self) -> int:
        with self._mu:
            self.amo_count += 1
            return self.v


@dataclass
class LockWindow:
    """Per-window lock state: one global word (master) + one word per rank."""

    p: int
    master: _AtomicWord = field(default_factory=_AtomicWord)
    local: list = field(default_factory=list)
    holder: list = field(default_factory=list)   # rank holding each writer bit

    def __post_init__(self) -> None:
        self.local = [_AtomicWord() for _ in range(self.p)]
        # diagnostic only (written by the winner, read on timeout): -1 = free
        self.holder = [-1] * self.p

    @property
    def total_amos(self) -> int:
        return self.master.amo_count + sum(w.amo_count for w in self.local)


class LockOrigin:
    """Origin-side lock operations for one process (paper §2.3 protocol)."""

    def __init__(self, win: LockWindow, rank: int):
        self.win = win
        self.rank = rank
        self.excl_held = 0  # nesting count of exclusive locks held
        self.shr_held: dict[int, int] = {}  # shared holds per target
        self.all_held = 0   # nesting count of lock_all holds

    def _lock_event(self, phase: str, mode: str, target: int) -> None:
        """Success-path trace: `analysis.ir.from_trace` lowers these into
        `IRLockEvent`s for the static lock-discipline pass."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event(f"lock.{phase}", rank=self.rank, mode=mode,
                     target=target)

    def _timeout(self, op: str, target: int | None, t0: float,
                 attempts: int) -> LockTimeout:
        """Build the satellite diagnostics: wait duration + attempt count
        alongside the held-rank dump, mirrored onto the tracer as a
        ``lock.timeout`` event (span attributes in the exported trace)."""
        wait_s = time.perf_counter() - t0
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("lock.timeout", rank=self.rank, op=op,
                     target=-1 if target is None else target,
                     wait_us=int(wait_s * 1e6), attempts=attempts)
        where = "" if target is None else str(target)
        err = LockTimeout(
            f"rank {self.rank}: {op}({where}) gave up after {attempts} "
            f"retries ({wait_s * 1e3:.2f} ms waiting) — "
            f"{_held_state(self.win, target)}",
            wait_s=wait_s, attempts=attempts,
        )
        # likely deadlock: dump the flight-recorder ring (if one is
        # installed) so the post-mortem has the acquisition interleaving
        obs_flight.on_error(err, tag=op)
        return err

    def _contended(self, op: str, target: int | None, t0: float,
                   attempts: int) -> None:
        """Trace a success that needed retries (contention visibility)."""
        tr = obs_trace.TRACER
        if tr.enabled and attempts > 1:
            tr.event("lock.contended", rank=self.rank, op=op,
                     target=-1 if target is None else target,
                     wait_us=int((time.perf_counter() - t0) * 1e6),
                     attempts=attempts)

    # ------------------------------------------------------------- shared
    def lock_shared(self, target: int, backoff: float = 1e-6,
                    max_retries: int = DEFAULT_MAX_RETRIES) -> None:
        """MPI_Win_lock(SHARED): one AMO if no writer (paper: P=2.7µs).

        Bounded busy-wait: raises `LockTimeout` (with the held lock words)
        after `max_retries` failed attempts instead of spinning forever.
        """
        t0 = time.perf_counter()
        for attempt in range(1, max_retries + 1):
            old = self.win.local[target].fetch_add(1)
            if not (old & WRITER_BIT):
                self._contended("lock_shared", target, t0, attempt)
                self.shr_held[target] = self.shr_held.get(target, 0) + 1
                self._lock_event("acquire", "shared", target)
                return  # acquired
            # writer active: back off and retry (paper: remote reads + backoff)
            self.win.local[target].fetch_add(-1)
            time.sleep(backoff)
            backoff = min(backoff * 2, 1e-3)
        raise self._timeout("lock_shared", target, t0, max_retries)

    def unlock_shared(self, target: int) -> None:
        if self.shr_held.get(target, 0) <= 0:
            raise LockStateError(
                f"rank {self.rank}: unlock_shared({target}) without a "
                "matching lock_shared — releasing would corrupt the "
                "reader count")
        self.shr_held[target] -= 1
        self.win.local[target].fetch_add(-1)
        self._lock_event("release", "shared", target)

    # ---------------------------------------------------------- exclusive
    def lock_exclusive(self, target: int, backoff: float = 1e-6,
                       max_retries: int = DEFAULT_MAX_RETRIES) -> None:
        """Invariant 1: no global lockall; invariant 2: exclusive local CAS.

        Bounded busy-wait (both invariants share one retry budget): raises
        `LockTimeout` with the held lock words instead of spinning forever.
        """
        t0 = time.perf_counter()
        for attempt in range(1, max_retries + 1):
            # Invariant 1 — register wish for exclusive lock at the master.
            if self.excl_held == 0:
                old = self.win.master.fetch_add(GLOBAL_EXCL_UNIT)
                if old & GLOBAL_SHRD_MASK:
                    # lockall readers present: back off the global registration
                    self.win.master.fetch_add(-GLOBAL_EXCL_UNIT)
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 1e-3)
                    continue
            # Invariant 2 — CAS the local lock from 0 to writer.
            old = self.win.local[target].cas(0, WRITER_BIT)
            if old == 0:
                self.win.holder[target] = self.rank   # diagnostics (§ timeout)
                self.excl_held += 1
                self._contended("lock_exclusive", target, t0, attempt)
                self._lock_event("acquire", "exclusive", target)
                return
            # failed: release global registration and retry both invariants
            if self.excl_held == 0:
                self.win.master.fetch_add(-GLOBAL_EXCL_UNIT)
            time.sleep(backoff)
            backoff = min(backoff * 2, 1e-3)
        raise self._timeout("lock_exclusive", target, t0, max_retries)

    def unlock_exclusive(self, target: int) -> None:
        if self.excl_held <= 0 or self.win.holder[target] != self.rank:
            raise LockStateError(
                f"rank {self.rank}: unlock_exclusive({target}) without "
                "holding the writer bit (holder: "
                f"{self.win.holder[target]}) — releasing would hand the "
                "lock to nobody")
        self.win.holder[target] = -1
        self.win.local[target].fetch_add(-WRITER_BIT)
        self.excl_held -= 1
        if self.excl_held == 0:
            self.win.master.fetch_add(-GLOBAL_EXCL_UNIT)
        self._lock_event("release", "exclusive", target)

    # -------------------------------------------------------------- lockall
    def lock_all(self, backoff: float = 1e-6,
                 max_retries: int = DEFAULT_MAX_RETRIES) -> None:
        """MPI_Win_lock_all: global shared — one AMO if no exclusives.

        Bounded busy-wait: raises `LockTimeout` with the held lock words
        after `max_retries` failed attempts."""
        t0 = time.perf_counter()
        for attempt in range(1, max_retries + 1):
            old = self.win.master.fetch_add(1)
            if old < GLOBAL_EXCL_UNIT:  # no exclusive holders
                self._contended("lock_all", None, t0, attempt)
                self.all_held += 1
                self._lock_event("acquire", "all", -1)
                return
            self.win.master.fetch_add(-1)
            time.sleep(backoff)
            backoff = min(backoff * 2, 1e-3)
        raise self._timeout("lock_all", None, t0, max_retries)

    def unlock_all(self) -> None:
        if self.all_held <= 0:
            raise LockStateError(
                f"rank {self.rank}: unlock_all without a matching "
                "lock_all — releasing would corrupt the lockall count")
        self.all_held -= 1
        self.win.master.fetch_add(-1)
        self._lock_event("release", "all", -1)

    # --------------------------------------------- exception-safe wrappers
    @contextmanager
    def exclusive(self, target: int, **kw) -> Iterator["LockOrigin"]:
        """``with origin.exclusive(t):`` — release guaranteed on ANY exit
        path; the lint rule ANL002 accepts only this form or an explicit
        try/finally."""
        self.lock_exclusive(target, **kw)
        try:
            yield self
        finally:
            self.unlock_exclusive(target)

    @contextmanager
    def shared(self, target: int, **kw) -> Iterator["LockOrigin"]:
        self.lock_shared(target, **kw)
        try:
            yield self
        finally:
            self.unlock_shared(target)

    @contextmanager
    def all_shared(self, **kw) -> Iterator["LockOrigin"]:
        self.lock_all(**kw)
        try:
            yield self
        finally:
            self.unlock_all()
