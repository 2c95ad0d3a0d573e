"""SimFabric: deterministic virtual-time chaos transport (DESIGN.md §11).

Implements the `repro_torch.core.fabric.Fabric` interface the host protocol
mirrors were refactored onto, but defers delivery: one-way ops staged by
`put`/`add` become per-link **transfer batches** at `flush`, scheduled on a
virtual clock with seeded chaos:

  * **delay** — each batch draws a per-link latency from ``[delay_min,
    delay_max]`` ticks;
  * **reorder** — batches on the *same* link may overtake each other
    (bounded by the delay window); without it per-link FIFO is enforced.
    Cross-link ordering is always arbitrary, as on real fabrics;
  * **duplicate** — a batch may be delivered twice; the receiver dedups by
    transfer sequence number (exactly-once apply), so duplication chaos
    exercises the dedup machinery, not the protocols' tolerance of
    double-applied accumulates (real NICs dedup too);
  * **drop + retransmit** — a batch's first copy is lost; the retransmit
    hook re-schedules the same sequence number after a timeout, so the
    message is late, never gone;
  * **cas_fail** — spurious CAS contention: a CAS may fail without
    applying (returning a value != expected), forcing the caller's retry
    loop — the adversarial schedule for the free-list/lock AMO paths.

**Atomicity guarantee**: a batch applies whole, in issue order — it models
ONE fused wire transfer (DESIGN.md §8), which is what makes reordering and
duplication survivable.  `fence_add` (the notification publish) applies
only after every batch of the current epoch addressed to that target has
been applied: payload visible ⇒ notification visible (§6.1).

**Fault injection**: ``tear=True`` deliberately BREAKS both guarantees —
each op travels alone and notifications are not gated on payload delivery.
This models an RMA transport that violates the standard's completion
semantics (the Quo-Vadis-RMA divergence class); the conformance suite must
catch it from the invariants, and the failure must reproduce from its
``(seed, schedule)`` pair.

Two flush flavours, mirroring MPI's pair:

  * ``flush(src)``       — *local* completion: batches leave the origin
    and are in flight (MPI_Win_flush_local);
  * ``flush_remote(src)``— *remote* completion: blocks (in virtual time)
    until every src-originated in-flight batch has applied
    (MPI_Win_flush); lock epochs use it before unlock.

Everything is a pure function of ``(seed, chaos config)`` — no wall clock,
no unordered-dict iteration on a path that matters.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Optional

import numpy as np

from ..core.fabric import Fabric, FabricError, apply_add
from ..obs import causal as obs_causal
from ..obs import trace as obs_trace
from .sched import VirtualClock


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs of one chaos schedule (see SCHEDULES for the named presets)."""

    name: str = "none"
    delay_min: int = 0
    delay_max: int = 0
    reorder: bool = False        # same-link batches may overtake
    duplicate_p: float = 0.0     # P(batch delivered twice; receiver dedups)
    drop_p: float = 0.0          # P(first copy lost; retransmitted later)
    retransmit_after: int = 6    # ticks before the retransmit copy lands
    cas_fail_p: float = 0.0      # P(spurious CAS contention failure)
    tear: bool = False           # FAULT: per-op delivery, ungated notify


SCHEDULES: dict[str, ChaosConfig] = {
    "none": ChaosConfig("none"),
    "reorder": ChaosConfig("reorder", delay_min=0, delay_max=3, reorder=True),
    "delay": ChaosConfig("delay", delay_min=1, delay_max=8),
    "duplicate": ChaosConfig("duplicate", delay_min=0, delay_max=2,
                             reorder=True, duplicate_p=0.35),
    "drop": ChaosConfig("drop", delay_min=0, delay_max=2, drop_p=0.3),
    "cas-storm": ChaosConfig("cas-storm", delay_min=0, delay_max=1,
                             cas_fail_p=0.5),
    # fault-injection schedules: the conformance suite must FAIL under these
    "tear": ChaosConfig("tear", delay_min=0, delay_max=3, reorder=True,
                        tear=True),
}


class SimFabric(Fabric):
    """Virtual-time chaos implementation of the host `Fabric` interface."""

    def __init__(self, p: int, chaos: ChaosConfig, seed: int,
                 clock: Optional[VirtualClock] = None) -> None:
        super().__init__(p=p)
        self.chaos = chaos
        self.seed = seed
        self.rng = random.Random(seed * 7919 + 13)
        self.clock = clock if clock is not None else VirtualClock()
        self.on_deliver = None            # set by Scheduler.attach
        self._pending: dict[int, list] = {}      # src -> [(dst, region, idx, value, mode)]
        self._inflight: list = []                # heap of (due, tiebreak, seq, entry)
        self._seq = 0
        self._tie = 0
        self._applied: set[int] = set()          # batch seqs applied (dedup)
        self._last_due: dict[tuple[int, int], int] = {}   # per-link FIFO floor
        self._outstanding: dict[tuple[int, int], int] = {}  # (dst, epoch) -> batches
        self._gated: dict[tuple[int, int], list] = {}       # (dst, epoch) -> fence_adds
        # chaos accounting
        self.transfers = 0
        self.dropped = 0
        self.retransmits = 0
        self.duplicates = 0
        self.dup_discarded = 0
        self.torn_ops = 0

    # ------------------------------------------------------------- regions
    # (payload-op accounting is the shared Fabric._count — byte-identical
    # to LocalFabric by construction)

    def _apply_op(self, op) -> None:
        dst, region, idx, value, mode = op
        store = self._store(region)[dst]
        if mode == "put":
            store[idx] = value
        else:  # add: the shared accumulate body (byte-identical to Local)
            apply_add(store, idx, value)

    def put(self, src: int, dst: int, region: str, idx, value) -> None:
        self._count("puts", src=src, dst=dst, region=region)
        if self.shadow is not None:
            # wire=True binds the payload to its transfer batch (staged/
            # applied hooks) for the notify-before-payload rule
            self.shadow.access("put", src, dst, region, idx,
                               wire=(src != dst))
        op = (dst, region, idx, np.copy(value) if isinstance(value, np.ndarray) else value, "put")
        if src == dst:
            self._apply_op(op)          # local memory: no wire
            return
        self._pending.setdefault(src, []).append(op)

    def add(self, src: int, dst: int, region: str, idx, delta) -> None:
        self._count("accs", src=src, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("acc", src, dst, region, idx,
                               wire=(src != dst))
        op = (dst, region, idx, delta, "add")
        if src == dst:
            self._apply_op(op)
            return
        self._pending.setdefault(src, []).append(op)

    def get(self, src: int, dst: int, region: str, idx=()):
        """Round-trip read of the *target-visible* (delivered) state."""
        self._count("gets", src=src, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("get", src, dst, region, idx)
        out = self._store(region)[dst][idx] if idx != () else self._store(region)[dst]
        return np.copy(out)

    def gather(self, src: int, region: str):
        self._count("gets", src=src, region=region)
        if self.shadow is not None:
            self.shadow.read_all(src, region)
        return np.copy(self._store(region))

    # ------------------------------------------------------------ transfers
    def _schedule_batch(self, src: int, dst: int, ops: list) -> None:
        self._seq += 1
        seq = self._seq
        self.transfers += 1
        c = self.chaos
        delay = self.rng.randint(c.delay_min, c.delay_max) if c.delay_max else 0
        due = self.clock.now + delay
        if not c.reorder:  # enforce per-link FIFO: never overtake a prior batch
            due = max(due, self._last_due.get((src, dst), 0))
        epoch = self.epoch
        self._outstanding[(dst, epoch)] = self._outstanding.get((dst, epoch), 0) + 1
        entry = {"src": src, "dst": dst, "ops": ops, "epoch": epoch, "seq": seq}
        if self.shadow is not None:
            self.shadow.staged(src, dst, seq, len(ops))
        if c.drop_p and self.rng.random() < c.drop_p:
            # first copy lost on the wire; the retransmit hook re-sends the
            # SAME sequence number after a timeout — late, never gone.  The
            # retransmit time is this batch's effective arrival, so it (not
            # the lost copy's due) is the link's FIFO floor.
            self.dropped += 1
            self.retransmits += 1
            due = due + c.retransmit_after
            self._push(due, seq, entry)
        else:
            self._push(due, seq, entry)
            if c.duplicate_p and self.rng.random() < c.duplicate_p:
                self.duplicates += 1
                self._push(due + self.rng.randint(1, 3), seq, entry)
        self._last_due[(src, dst)] = due
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("sim.xfer.stage", rank=src, dst=dst, seq=seq, due=due,
                     n_ops=len(ops))

    def _push(self, due: int, seq: int, entry: dict) -> None:
        self._tie += 1
        tiebreak = self.rng.randrange(1 << 30) if self.chaos.reorder else self._tie
        heapq.heappush(self._inflight, (due, tiebreak, self._tie, seq, entry))

    def _pending_to(self, dst: int) -> bool:
        """Any staged (issued, unflushed) one-way op addressed to `dst`."""
        return any(op[0] == dst for ops in self._pending.values() for op in ops)

    def _apply_batch(self, seq: int, entry: dict) -> bool:
        """Apply one transfer exactly once; returns False for a dup copy."""
        tr = obs_trace.TRACER
        if seq in self._applied:
            self.dup_discarded += 1
            if tr.enabled:
                tr.event("sim.xfer.dup_discard", rank=entry["dst"],
                         src=entry["src"], seq=seq)
            return False
        self._applied.add(seq)
        if tr.enabled:
            tr.event("sim.xfer.deliver", rank=entry["dst"], src=entry["src"],
                     seq=seq, n_ops=len(entry["ops"]))
        for op in entry["ops"]:
            self._apply_op(op)
        if self.shadow is not None:
            self.shadow.applied(seq)
        key = (entry["dst"], entry["epoch"])
        left = self._outstanding.get(key, 0) - 1
        if left > 0:
            self._outstanding[key] = left
        else:
            self._outstanding.pop(key, None)
            # release the gate only when NOTHING addressed to dst is still
            # staged: a second producer's pending (unflushed) payload must
            # keep holding the notification, symmetric to the check at
            # fence_add time.  The held gate re-resolves when that payload's
            # batch applies (flush -> outstanding -> this path again) or at
            # the fence, which flushes and drains everything.
            if not self._pending_to(entry["dst"]):
                for dst, region, idx, delta in self._gated.pop(key, []):
                    self._apply_op((dst, region, idx, delta, "add"))
                    if self.shadow is not None:
                        self.shadow.notify(dst, entry["epoch"])
                    self._notify({"kind": "notify", "src": dst, "dst": dst,
                                  "epoch": entry["epoch"]})
        return True

    def _notify(self, info: dict) -> None:
        if self.on_deliver is not None:
            self.on_deliver(info)

    def deliver_due(self, now: int) -> int:
        """Apply every in-flight transfer whose due time has arrived."""
        n = 0
        while self._inflight and self._inflight[0][0] <= now:
            _, _, _, seq, entry = heapq.heappop(self._inflight)
            if self._apply_batch(seq, entry):
                n += 1
                self._notify({"kind": "deliver", "src": entry["src"],
                              "dst": entry["dst"], "epoch": entry["epoch"],
                              "n_ops": len(entry["ops"])})
        return n

    def next_due(self) -> Optional[int]:
        return self._inflight[0][0] if self._inflight else None

    def _drain_inflight(self, src: Optional[int] = None) -> None:
        """Force-deliver in-flight transfers (all, or one origin's) now, in
        due/chaos order."""
        keep = []
        batch = []
        while self._inflight:
            item = heapq.heappop(self._inflight)
            entry = item[4]
            if src is None or entry["src"] == src:
                batch.append(item)
            else:
                keep.append(item)
        for item in keep:
            heapq.heappush(self._inflight, item)
        for _, _, _, seq, entry in sorted(batch, key=lambda i: (i[0], i[1], i[2])):
            if self._apply_batch(seq, entry):
                self._notify({"kind": "deliver", "src": entry["src"],
                              "dst": entry["dst"], "epoch": entry["epoch"],
                              "n_ops": len(entry["ops"])})

    # ------------------------------------------------------ completion plane
    def _dst_has_epoch_traffic(self, dst: int) -> bool:
        """Any same-epoch one-way op addressed to `dst` still unapplied —
        in flight (a scheduled batch) OR still staged in a pending buffer
        (issued but not yet flushed)."""
        if self._outstanding.get((dst, self.epoch), 0) > 0:
            return True
        return any(op[0] == dst for ops in self._pending.values() for op in ops)

    def fence_add(self, dst: int, region: str, idx, delta) -> None:
        self._count("accs", src=dst, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("acc", dst, dst, region, idx)
        if self.chaos.tear or not self._dst_has_epoch_traffic(dst):
            # tear fault: publish the notification WITHOUT waiting for the
            # payloads it advertises — the §6.1 guarantee, violated
            self._apply_op((dst, region, idx, delta, "add"))
            if self.shadow is not None:
                self.shadow.notify(dst, self.epoch)
        else:
            self._gated.setdefault((dst, self.epoch), []).append(
                (dst, region, idx, delta))

    # -------------------------------------------------------------- AMOs
    def read_word(self, src: int, bank: str, i: int) -> int:
        self._count_amo("read", src, bank, i)
        out = self._word(bank, i).read()
        if self.shadow is not None:
            self.shadow.amo(src, bank, i, "read", result=out)
        return out

    def fetch_add(self, src: int, bank: str, i: int, delta: int) -> int:
        self._count_amo("fetch_add", src, bank, i)
        out = self._word(bank, i).fetch_add(delta)
        if self.shadow is not None:
            self.shadow.amo(src, bank, i, "fetch_add", delta=delta,
                            result=out)
        return out

    def cas(self, src: int, bank: str, i: int, expected: int, new: int) -> int:
        self._count_amo("cas", src, bank, i)
        if self.chaos.cas_fail_p and self.rng.random() < self.chaos.cas_fail_p:
            # spurious contention: fail without applying, reporting a value
            # that cannot equal `expected` — the caller's loop re-reads
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("sim.cas_spurious_fail", rank=src, bank=bank, i=i)
            if self.shadow is not None:
                # applied=False: the word was not written — acquire-only
                self.shadow.amo(src, bank, i, "cas", expected=expected,
                                value=new, result=(expected + 1),
                                applied=False)
            return (expected + 1) & ((1 << 64) - 1)
        out = self._word(bank, i).cas(expected, new)
        if self.shadow is not None:
            self.shadow.amo(src, bank, i, "cas", expected=expected,
                            value=new, result=out)
        return out

    def _sync_wait(self, src: Optional[int] = None) -> int:
        """Virtual ticks a remote-completion sync would block: how far past
        `clock.now` the last relevant in-flight batch is due.  Trace-only
        attribution for the sync-plane ledger — the drain itself is
        unchanged, so interleavings (and ledger snapshots) stay identical
        whether or not anyone is measuring."""
        due = [item[0] for item in self._inflight
               if src is None or item[4]["src"] == src]
        return max(0, max(due) - self.clock.now) if due else 0

    # -------------------------------------------------------------- sync
    def flush(self, src: int) -> None:
        """Local completion (MPI_Win_flush_local): stage src's pending ops
        as in-flight transfer batches — one batch per (src, dst) link, the
        fused-transfer unit chaos operates on."""
        from ..core.epoch import SyncStats

        tr = obs_trace.TRACER
        if tr.enabled:
            # wait=0: local completion never blocks on remote delivery
            tr.event("fabric.flush", rank=src, epoch=self.epoch, wait=0,
                     rids=obs_causal.current_epoch_rids())
        SyncStats.record("flush_msgs", also=self.sync)
        if self.shadow is not None:
            self.shadow.sync("flush", src)
        pending = self._pending.pop(src, [])
        if not pending:
            return
        by_dst: dict[int, list] = {}
        for op in pending:
            by_dst.setdefault(op[0], []).append(op)
        for dst in sorted(by_dst):
            if self.chaos.tear:
                self.torn_ops += len(by_dst[dst])
                for op in by_dst[dst]:          # FAULT: every op rides alone
                    self._schedule_batch(src, dst, [op])
            else:
                self._schedule_batch(src, dst, by_dst[dst])

    def flush_remote(self, src: int) -> None:
        """Remote completion (MPI_Win_flush): every src-originated op is
        applied at its target before this returns."""
        self.flush(src)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.flush_remote", rank=src, epoch=self.epoch,
                     wait=self._sync_wait(src),
                     rids=obs_causal.current_epoch_rids())
        self._drain_inflight(src)
        if self.shadow is not None:
            self.shadow.sync("flush_remote", src)

    def fence(self) -> None:
        """Epoch close: complete everything, everywhere, then advance."""
        for src in sorted(self._pending):
            self.flush(src)
        # measured before the drain consumes the heap; skipped untraced
        wait = self._sync_wait() if obs_trace.TRACER.enabled else 0
        self._drain_inflight()
        # every batch applied -> every gate fired; anything left is a bug
        if any(self._gated.values()):
            raise FabricError(f"fence left gated notifications: {self._gated}")
        self._account_fence(wait=wait)
        if self.shadow is not None:
            self.shadow.sync("fence")

    # ---------------------------------------------------------- inspection
    def chaos_stats(self) -> dict:
        return {
            "schedule": self.chaos.name,
            "seed": self.seed,
            "transfers": self.transfers,
            "dropped": self.dropped,
            "retransmits": self.retransmits,
            "duplicates": self.duplicates,
            "dup_discarded": self.dup_discarded,
            "torn_ops": self.torn_ops,
            "inflight": len(self._inflight),
        }
