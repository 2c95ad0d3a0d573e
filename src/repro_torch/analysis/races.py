"""Vector-clock happens-before race analysis for MPI-3 RMA programs (§14).

The MPI-3 one-sided memory model makes two accesses *conflict* when they
touch overlapping bytes of the same window and at least one of them is a
non-atomic write.  A conflicting pair is legal only when the two accesses
are separated by an epoch boundary (``fence``) or ordered by a
synchronization edge (remote completion + an acquire/release chain through
an atomic word).  `RaceChecker` verifies this online: it is attached to a
`core.fabric.Fabric` as a *shadow* (`fab.attach_shadow(checker)`) and
observes every one-sided op, AMO, notification and sync call the fabric
executes, flagging violations with the exact provenance of both
conflicting descriptors.

Happens-before machinery (FastTrack-flavored):

  * every rank ``r`` owns a vector clock ``VC[r]`` (a sparse dict); each
    access ticks ``VC[r][r]``.
  * a **deferred** write (``put``/``acc`` with ``src != dst``) completes
    only at ``flush_remote(src)`` or ``fence`` — its *completion stamp*
    ``cts`` is assigned then.  ``get``/AMO/local ops complete at issue
    (``cts = ts``).  Earlier access A is ordered before later access B iff
    ``A.cts is not None and VC[B.rank][A.rank] >= A.cts`` — an in-flight
    put is ordered before *nothing*, which is exactly why "unlock without
    flush_remote" publishes nothing.
  * every AMO word ``(bank, i)`` carries its own clock ``Wc``: an AMO by
    ``r`` first *acquires* (``VC[r] |= Wc``) and, when it actually applied
    (fetch_add, or a CAS that succeeded), *releases* (``Wc |= VC[r]``).
    This is the release/acquire edge the paper's lock and queue protocols
    rely on.
  * ``fence`` completes all in-flight writes, joins every clock, clears
    the access history, and bumps the epoch id — the MPI epoch boundary.

Conflict matrix (MPI-3 §11.7): reads don't conflict with reads, atomics
(``get`` is modeled as an atomic read, matching ``MPI_Get_accumulate`` with
``MPI_NO_OP``; ``acc``/``fao`` are accumulates) don't conflict with
atomics; everything else — any pair involving a ``put`` or a local
``local-write`` — conflicts.

The checker is passive: it never mutates fabric state and the fabric's
`OpCounter`/`SyncStats` ledgers are byte-identical with or without a
shadow attached (pinned by the golden-trace tests).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# the raw-AMO lock word layout (shared with core.locks_sim / run_lock)
from ..core.locks_sim import GLOBAL_EXCL_UNIT, WRITER_BIT

_READS = frozenset({"get", "local-read"})
_ATOMICS = frozenset({"get", "acc", "fao"})


def conflicts(a: str, b: str) -> bool:
    """MPI-3 conflict predicate over access kinds (see module docstring)."""
    if a in _READS and b in _READS:
        return False
    if a in _ATOMICS and b in _ATOMICS:
        return False
    return True


@dataclass(frozen=True)
class RaceViolation:
    """One flagged violation: rule id, human message, both provenances."""

    rule: str
    message: str
    a: str
    b: str

    def __str__(self) -> str:
        return (f"[{self.rule}] {self.message}\n"
                f"      A: {self.a}\n"
                f"      B: {self.b}")


class RaceError(RuntimeError):
    """Raised by `RaceChecker.raise_if_any` when violations were recorded."""

    def __init__(self, violations: List[RaceViolation], context: str = ""):
        self.violations = list(violations)
        head = context or f"{len(violations)} RMA memory-model violation(s)"
        body = "\n  ".join(str(v) for v in self.violations)
        super().__init__(f"{head}\n  {body}")


@dataclass
class _Rec:
    """One recorded access in a window's history (cleared at each fence)."""

    rank: int
    ts: int
    kind: str
    lo: int
    hi: int
    epoch: int
    cts: Optional[int]  # completion stamp; None while the write is in flight
    prov: str


@dataclass
class _LockState:
    """Delta-decoded lock word state (banks registered semantics='lock')."""

    shared: Dict[int, int] = field(default_factory=dict)
    excl_reg: Dict[int, int] = field(default_factory=dict)
    writer: int = -1
    writer_prov: str = ""


class RaceChecker:
    """Online MPI-3 RMA race checker; attach with `fab.attach_shadow(self)`.

    Single-threaded by design: the simulated fabrics drive all ranks from
    one cooperative scheduler thread, so no internal locking is needed.
    """

    def __init__(self, p: int, max_violations: int = 64):
        self.p = int(p)
        self.max_violations = int(max_violations)
        self.violations: List[RaceViolation] = []
        self.events = 0  # total shadow hooks observed (overhead benchmarks)
        self._fab: Any = None
        # per-rank scalar tick + sparse vector clocks
        self._ts: Dict[int, int] = {}
        self._vc: Dict[int, Dict[int, int]] = {}
        # access history per (region, dst-rank); cleared at every fence
        self._hist: Dict[Tuple[str, int], List[_Rec]] = {}
        # deferred writes per origin awaiting flush_remote/fence completion
        self._inflight: Dict[int, List[_Rec]] = {}
        # AMO word clocks per (bank, i)
        self._wc: Dict[Tuple[str, int], Dict[int, int]] = {}
        # wire-payload tracking for the notify-before-payload rule
        self._unapplied: Dict[int, Tuple[int, int, str]] = {}  # id -> dst,epoch,prov
        self._unbound: Dict[Tuple[int, int], deque] = {}  # (src,dst) -> ids FIFO
        self._seq_ids: Dict[int, List[int]] = {}
        self._next_id = 0
        # lock-discipline state per (bank, i) for semantics='lock' banks
        self._locks: Dict[Tuple[str, int], _LockState] = {}
        # registered source-buffer spans per origin: (buf id, lo, hi, prov)
        self._src_spans: Dict[int, List[Tuple[int, int, int, str]]] = {}
        self._flat_cache: Dict[str, np.ndarray] = {}
        self.epoch = 0

    # ------------------------------------------------------------ wiring
    def bind(self, fab: Any) -> None:
        """Called by `Fabric.attach_shadow`; gives access to region shapes."""
        self._fab = fab

    def _flag(self, rule: str, message: str, a: str, b: str) -> None:
        if len(self.violations) < self.max_violations:
            self.violations.append(RaceViolation(rule, message, a, b))

    # ------------------------------------------------------ clock plumbing
    def _tick(self, r: int) -> int:
        t = self._ts.get(r, 0) + 1
        self._ts[r] = t
        self._vc.setdefault(r, {})[r] = t
        return t

    def _ordered(self, a: _Rec, later_rank: int) -> bool:
        """hb(A, B): A remote-complete and its completion visible to B."""
        if a.cts is None:
            return False
        return self._vc.get(later_rank, {}).get(a.rank, 0) >= a.cts

    # ------------------------------------------------------ byte intervals
    def _interval(self, region: str, idx: Any) -> Tuple[int, int]:
        store = self._fab.regions[region]
        shape = tuple(store.shape[1:])
        isz = int(store.itemsize)
        size = 1
        for d in shape:
            size *= int(d)
        if idx is None or idx == ():
            return 0, size * isz
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) <= len(shape) and all(
                isinstance(c, (int, np.integer)) for c in idx):
            lo, stride = 0, size
            for d, c in enumerate(idx):
                stride //= int(shape[d])
                lo += (int(c) % int(shape[d])) * stride
            return lo * isz, (lo + stride) * isz
        # general fancy/slice indexing: conservative byte-interval hull
        flat = self._flat_cache.get(region)
        if flat is None:
            flat = np.arange(size, dtype=np.int64).reshape(shape)
            self._flat_cache[region] = flat
        picked = np.asarray(flat[idx])
        if picked.size == 0:
            return 0, 0
        return int(picked.min()) * isz, (int(picked.max()) + 1) * isz

    # ------------------------------------------------------- access plane
    def access(self, kind: str, src: int, dst: int, region: str,
               idx: Any = None, *, interval: Optional[Tuple[int, int]] = None,
               wire: bool = False,
               src_span: Optional[Tuple[int, int, int]] = None,
               prov: Optional[str] = None) -> str:
        """Record one access; returns its provenance string.

        ``wire=True`` marks a payload that rides a simulated transfer batch
        (bound to a batch seq via `staged`/`applied` for the
        notify-before-payload rule).
        """
        self.events += 1
        ts = self._tick(src)
        if interval is not None:
            lo, hi = int(interval[0]), int(interval[1])
        else:
            lo, hi = self._interval(region, idx)
        immediate = src == dst or kind in ("get", "fao", "local-read",
                                           "local-write")
        if prov is None:
            prov = (f"{kind}(src={src}, dst={dst}, region={region!r}, "
                    f"idx={idx!r}, bytes=[{lo}:{hi}), ts={ts}, "
                    f"epoch={self.epoch})")
        rec = _Rec(src, ts, kind, lo, hi, self.epoch,
                   ts if immediate else None, prov)
        key = (region, dst)
        hist = self._hist.get(key)
        if hist:
            for a in hist:
                if a.hi <= lo or hi <= a.lo:
                    continue
                if not conflicts(a.kind, kind):
                    continue
                if self._ordered(a, src):
                    continue
                if a.rank == src:
                    self._flag(
                        "same-origin-overlap",
                        f"{a.kind}/{kind} from rank {src} overlap on "
                        f"region {region!r} @ rank {dst} bytes "
                        f"[{max(lo, a.lo)}:{min(hi, a.hi)}) with no "
                        "flush_remote/fence between them (the earlier "
                        "write is still in flight)", a.prov, prov)
                else:
                    self._flag(
                        "unsynchronized-conflict",
                        f"conflicting {a.kind}/{kind} overlap on region "
                        f"{region!r} @ rank {dst} bytes "
                        f"[{max(lo, a.lo)}:{min(hi, a.hi)}) inside one "
                        "epoch with no sync edge ordering them", a.prov,
                        prov)
        self._hist.setdefault(key, []).append(rec)
        if rec.cts is None:
            self._inflight.setdefault(src, []).append(rec)
        if src_span is not None:
            self._src_spans.setdefault(src, []).append(
                (int(src_span[0]), int(src_span[1]), int(src_span[2]), prov))
        if wire:
            wid = self._next_id
            self._next_id += 1
            self._unapplied[wid] = (dst, self.epoch, prov)
            self._unbound.setdefault((src, dst), deque()).append(wid)
        return prov

    def read_all(self, src: int, region: str) -> None:
        """A gather: an atomic read of every rank's row of `region`."""
        store = self._fab.regions[region]
        for dst in range(store.shape[0]):
            self.access("get", src, dst, region, ())

    def local_write(self, rank: int, buf: Any, lo: int, hi: int,
                    what: str = "local-write") -> None:
        """Declare a local store into a put's source buffer.

        Flags src-buffer reuse before `flush(rank)` completed the transfer
        locally.  (The in-process fabrics copy payloads at issue, so this
        rule only fires through explicit declarations — it models the
        zero-copy MPI backend.)
        """
        self.events += 1
        bufid = id(buf)
        for bid, slo, shi, prov in self._src_spans.get(rank, ()):
            if bid == bufid and not (shi <= lo or hi <= slo):
                self._flag(
                    "src-buffer-reuse",
                    f"rank {rank} rewrote bytes [{max(lo, slo)}:"
                    f"{min(hi, shi)}) of a put's source buffer before "
                    "flush() completed the transfer locally", prov,
                    f"{what}(rank={rank}, bytes=[{lo}:{hi}))")

    # --------------------------------------------------------- AMO plane
    def amo(self, src: int, bank: str, i: int, op: str, *,
            applied: bool = True, expected: Optional[int] = None,
            result: Optional[int] = None, value: Optional[int] = None,
            delta: Optional[int] = None) -> None:
        """One AMO on word ``(bank, i)``: acquire, maybe release, maybe lock.

        ``applied=False`` marks a simulated spurious CAS failure: the word
        was read (acquire) but nothing was written (no release edge).
        """
        self.events += 1
        self._tick(src)
        wkey = (bank, i)
        wc = self._wc.get(wkey)
        if wc:
            mine = self._vc.setdefault(src, {})
            for r, t in wc.items():
                if mine.get(r, 0) < t:
                    mine[r] = t
        publish = applied and (
            op == "fetch_add" or (op == "cas" and result == expected))
        if publish:
            out = self._wc.setdefault(wkey, {})
            for r, t in self._vc.get(src, {}).items():
                if out.get(r, 0) < t:
                    out[r] = t
        fab = self._fab
        if fab is not None and getattr(fab, "bank_semantics", {}).get(
                bank) == "lock":
            self._lock_amo(src, bank, i, op, applied=applied,
                           expected=expected, result=result, value=value,
                           delta=delta)

    def _lock_amo(self, src: int, bank: str, i: int, op: str, *,
                  applied: bool, expected: Optional[int],
                  result: Optional[int], value: Optional[int],
                  delta: Optional[int]) -> None:
        if not applied:
            return
        st = self._locks.setdefault((bank, i), _LockState())
        prov = (f"{op}(src={src}, bank={bank!r}, i={i}, "
                f"delta={delta}, expected={expected}, value={value})")
        if op == "fetch_add" and delta is not None:
            if delta == 1:
                st.shared[src] = st.shared.get(src, 0) + 1
            elif delta == -1:
                n = st.shared.get(src, 0) - 1
                if n < 0:
                    self._flag("lock-discipline",
                               f"rank {src} released a shared lock on "
                               f"({bank!r}, {i}) it does not hold",
                               "(no matching acquire)", prov)
                    n = 0
                st.shared[src] = n
            elif delta == -WRITER_BIT:
                if st.writer != src:
                    self._flag("lock-discipline",
                               f"rank {src} released the writer bit on "
                               f"({bank!r}, {i}) without holding it "
                               f"(holder: {st.writer})",
                               st.writer_prov or "(no matching acquire)",
                               prov)
                else:
                    st.writer, st.writer_prov = -1, ""
            elif delta == GLOBAL_EXCL_UNIT:
                st.excl_reg[src] = st.excl_reg.get(src, 0) + 1
            elif delta == -GLOBAL_EXCL_UNIT:
                n = st.excl_reg.get(src, 0) - 1
                if n < 0:
                    self._flag("lock-discipline",
                               f"rank {src} dropped an exclusive "
                               f"registration on ({bank!r}, {i}) it never "
                               "made", "(no matching acquire)", prov)
                    n = 0
                st.excl_reg[src] = n
        elif op == "cas" and value is not None and value & WRITER_BIT:
            # flag the upgrade *attempt*: with its own shared hold in the
            # word, this CAS can never succeed — a livelock, not a race
            if st.shared.get(src, 0) > 0:
                self._flag("lock-discipline",
                           f"rank {src} attempted a shared→exclusive "
                           f"upgrade on ({bank!r}, {i}) while still "
                           f"holding {st.shared[src]} shared hold(s) — "
                           "deadlock-prone", f"shared hold by rank {src}",
                           prov)
            if result == expected:
                st.writer, st.writer_prov = src, prov

    # ------------------------------------------------- notification plane
    def staged(self, src: int, dst: int, seq: int, n_ops: int) -> None:
        """Bind the next `n_ops` wire payloads for (src, dst) to batch `seq`."""
        fifo = self._unbound.get((src, dst))
        if not fifo:
            return
        ids = self._seq_ids.setdefault(seq, [])
        for _ in range(min(n_ops, len(fifo))):
            ids.append(fifo.popleft())

    def applied(self, seq: int) -> None:
        """Batch `seq` landed at its target: its payloads are applied."""
        for wid in self._seq_ids.pop(seq, ()):
            self._unapplied.pop(wid, None)

    def notify(self, dst: int, epoch: int, prov: str = "") -> None:
        """A `fence_add` notification became visible at `dst`.

        MPI-3 semantics require the notification to order *after* the
        payload writes it gates; if same-epoch payloads to `dst` are still
        in flight, the consumer can observe the count before the data — the
        exact tear the `tear` chaos schedule injects.
        """
        self.events += 1
        stale = [w for w in self._unapplied.values()
                 if w[0] == dst and w[1] == epoch]
        if stale:
            self._flag(
                "notify-before-payload",
                f"fence_add notification applied at rank {dst} "
                f"(epoch {epoch}) while {len(stale)} gated payload "
                "write(s) to that rank are still in flight", stale[0][2],
                prov or f"fence_add(dst={dst}, epoch={epoch})")

    # ---------------------------------------------------------- sync plane
    def sync(self, kind: str, src: int = -1) -> None:
        """A sync edge: 'flush' (local), 'flush_remote', or 'fence'."""
        self.events += 1
        if kind == "flush":
            self._src_spans.pop(src, None)
        elif kind == "flush_remote":
            self._src_spans.pop(src, None)
            recs = self._inflight.pop(src, None)
            if recs:
                t = self._tick(src)
                for rec in recs:
                    rec.cts = t
        elif kind == "fence":
            self._src_spans.clear()
            for r, recs in self._inflight.items():
                t = self._tick(r)
                for rec in recs:
                    rec.cts = t
            self._inflight.clear()
            join: Dict[int, int] = {}
            for vc in self._vc.values():
                for r, t in vc.items():
                    if join.get(r, 0) < t:
                        join[r] = t
            for r in self._vc:
                self._vc[r] = dict(join)
            self._hist.clear()
            self.epoch += 1

    # ------------------------------------------------------------ verdict
    def finish(self) -> List[RaceViolation]:
        """End-of-run checks (locks still held); returns all violations."""
        for (bank, i), st in sorted(self._locks.items()):
            if st.writer != -1:
                self._flag("lock-discipline",
                           f"rank {st.writer} still holds the writer bit "
                           f"on ({bank!r}, {i}) at run end — acquire "
                           "without matching release", st.writer_prov,
                           "(end of run)")
            for r, n in sorted(st.shared.items()):
                if n > 0:
                    self._flag("lock-discipline",
                               f"rank {r} still holds {n} shared lock(s) "
                               f"on ({bank!r}, {i}) at run end",
                               f"shared acquire by rank {r}",
                               "(end of run)")
            for r, n in sorted(st.excl_reg.items()):
                if n > 0:
                    self._flag("lock-discipline",
                               f"rank {r} left {n} exclusive "
                               f"registration(s) on ({bank!r}, {i}) at "
                               "run end", f"registration by rank {r}",
                               "(end of run)")
        return self.violations

    def raise_if_any(self, context: str = "") -> None:
        if self.violations:
            raise RaceError(self.violations, context)


def check_lock_events(events: Any,
                      out: Optional[List[RaceViolation]] = None
                      ) -> List[RaceViolation]:
    """Lock-discipline pass over trace-sourced `ir.IRLockEvent`s.

    Flags: release without a matching acquire, acquire never released by
    run end, and a shared→exclusive upgrade on the same target (the
    deadlock-prone pattern the fabric-level rule also catches).
    """
    if out is None:
        out = []
    held: Dict[Tuple[int, str, int], List[str]] = {}  # (rank,mode,target)
    for ev in events:
        key = (ev.rank, ev.mode, ev.target)
        prov = (f"trace[{ev.seq}] lock.{ev.phase}(rank={ev.rank}, "
                f"mode={ev.mode}, target={ev.target})")
        if ev.phase == "acquire":
            if ev.mode == "exclusive":
                shr = held.get((ev.rank, "shared", ev.target))
                if shr:
                    out.append(RaceViolation(
                        "lock-discipline",
                        f"rank {ev.rank} acquired exclusive on target "
                        f"{ev.target} while holding shared — "
                        "shared→exclusive upgrade", shr[-1], prov))
            held.setdefault(key, []).append(prov)
        else:
            stack = held.get(key)
            if not stack:
                out.append(RaceViolation(
                    "lock-discipline",
                    f"rank {ev.rank} released a {ev.mode} lock on target "
                    f"{ev.target} it does not hold",
                    "(no matching acquire)", prov))
            else:
                stack.pop()
    for (rank, mode, target), stack in sorted(held.items()):
        for prov in stack:
            out.append(RaceViolation(
                "lock-discipline",
                f"rank {rank} never released its {mode} lock on target "
                f"{target} — acquire without matching release", prov,
                "(end of run)"))
    return out


def check_ir(ir: Any) -> List[RaceViolation]:
    """Run the happens-before engine over a static `analysis.ir.AccessIR`.

    Accesses and sync edges are interleaved by their `seq` position and
    replayed through a fresh `RaceChecker`; lock events (trace-sourced)
    run through the `check_lock_events` state machine.
    """
    chk = RaceChecker(ir.p)
    stream = sorted(
        [(a.seq, "a", a) for a in ir.accesses]
        + [(s.seq, "s", s) for s in ir.syncs],
        key=lambda t: (t[0], 0 if t[1] == "s" else 1))
    for _, tag, item in stream:
        if tag == "s":
            chk.sync(item.kind, item.rank)
        else:
            chk.access(item.kind, item.rank, item.dst, item.window,
                       idx=None, interval=(item.lo, item.hi),
                       prov=item.prov)
    chk.finish()
    return check_lock_events(ir.lock_events, out=chk.violations)
