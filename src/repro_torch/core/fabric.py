"""Host-side one-sided transport: the `Fabric` interface (DESIGN.md §11).

The host mirrors of the device protocols (`rmaq.queue.HostQueueGroup`,
`rmaq.flow.HostFlowChannel`, `rmem.heap.HostPagePool`,
`window.DescriptorCache`) historically mutated shared host state directly —
a producer "putting" into a remote ring was a plain numpy store.  That is
behaviorally right for the in-process case but leaves the transport
implicit: there is no seam where delivery can be delayed, reordered,
duplicated, or dropped, so the protocols were only ever exercised under the
single happy-path interleaving the Python interpreter happens to produce.

This module makes the transport explicit.  A `Fabric` carries four planes:

  * **region plane** — named stores indexed ``[rank, ...]`` (ring buffers,
    counter blocks, credit tables).  `put`/`add` are one-way ops that
    complete at `flush`; `get`/`gather` are round-trip reads of the
    *target-visible* state.
  * **AMO plane** — named banks of `locks_sim._AtomicWord` (free-list
    heads, refcounts, lock words).  `fetch_add`/`cas`/`read_word` are
    round-trip atomics; accounting stays on the words' own ``amo_count``
    so the host stress tests keep their exact AMO-complexity assertions.
  * **completion plane** — `fence_add` is an accumulate ordered *after*
    every one-way op of the current epoch addressed to the same target:
    the write-with-notification guarantee (payload visible ⇒ counter
    visible), stated in the transport instead of implied by the caller.
  * **sync plane** — `flush(src)` completes src's pending ops
    (MPI_Win_flush); `fence()` closes the epoch for everyone
    (MPI_Win_fence).  Counted in a private `SyncStats` ledger.

`LocalFabric` is the default: every op applies immediately, in issue
order — byte-identical to the pre-fabric direct mutation (the diff test in
`tests/test_torch_sim.py` pins this against golden traces).  `repro_torch.sim.fabric`
subclasses it with a virtual-time chaos transport; the protocols themselves
are unchanged between the two, which is the point.

Payload/AMO ops are counted in a private `OpCounter` (``fabric.ops``) —
NOT the global active-ledger list, so device-path accounting is untouched.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..obs import causal as obs_causal
from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta

from .epoch import SyncStats
from .locks_sim import _AtomicWord
from .rma import OpCounter


class FabricError(RuntimeError):
    pass


def apply_add(store, idx, delta) -> None:
    """The one accumulate body every fabric shares (Local apply, Sim batch
    apply, fence_add): dtype-preserving in-place add on a region store."""
    store[idx] = store[idx] + np.asarray(delta, dtype=np.asarray(store[idx]).dtype)


class Fabric:
    """Registry + accounting shared by every fabric implementation."""

    def __init__(self, p: int = 1) -> None:
        self.p = p
        self.regions: dict[str, Any] = {}       # name -> array indexed [rank, ...]
        self.banks: dict[str, list] = {}        # name -> [_AtomicWord, ...]
        self.bank_owner: dict[str, int] = {}
        self.bank_semantics: dict[str, str] = {}  # name -> "amo" | "lock"
        self.ops = OpCounter()                  # payload-plane accounting (private)
        self.sync = SyncStats()                 # sync-plane accounting (private)
        self.epoch = 0                          # fences completed
        # optional passive observer (analysis.races.RaceChecker): sees every
        # op/AMO/notification/sync but never touches the ledgers — snapshots
        # are byte-identical with or without a shadow attached
        self.shadow: Any = None

    def attach_shadow(self, shadow: Any) -> Any:
        """Attach a shadow checker; returns it (for chaining)."""
        self.shadow = shadow
        if shadow is not None and hasattr(shadow, "bind"):
            shadow.bind(self)
        return shadow

    # ------------------------------------------------------------ registry
    def register(self, name: str, store) -> None:
        """Expose a host array (indexed ``[rank, ...]``) as a window region."""
        if name in self.regions:
            raise FabricError(f"region {name!r} already registered")
        self.regions[name] = store

    def register_words(self, name: str, words: list, owner: int = 0,
                       semantics: str = "amo") -> list:
        """Expose a bank of `_AtomicWord`s (an AMO-addressable window).

        The caller keeps (and may share) the word objects — `LocalFabric`
        operates on them directly, preserving thread-safety and per-word
        ``amo_count`` for the O(1)-expected-AMOs assertions.

        ``semantics="lock"`` declares the bank's words as lock words in the
        paper's Fig. 3 layout; a shadow race checker then decodes the AMO
        deltas into acquire/release state and enforces lock discipline.
        """
        if name in self.banks:
            raise FabricError(f"bank {name!r} already registered")
        if not all(isinstance(w, _AtomicWord) for w in words):
            raise FabricError("banks hold locks_sim._AtomicWord instances")
        self.banks[name] = list(words)
        self.bank_owner[name] = owner
        self.bank_semantics[name] = semantics
        return self.banks[name]

    def _store(self, name: str):
        try:
            return self.regions[name]
        except KeyError:
            raise FabricError(f"unknown region {name!r}") from None

    def _word(self, bank: str, i: int) -> _AtomicWord:
        try:
            return self.banks[bank][i]
        except KeyError:
            raise FabricError(f"unknown bank {bank!r}") from None

    def _count(self, kind: str, n: int = 1, src: int = -1, dst: int = -1,
               region: str = "") -> None:
        """Shared payload-op accounting: one logical op == one wire transfer
        (both fabrics MUST stay byte-identical here — the diff tests pin it).
        `src`/`dst`/`region` are trace-only attribution and never touch the
        ledger."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.op", rank=src, kind=kind, n=n, dst=dst,
                     region=region)
        setattr(self.ops, kind, getattr(self.ops, kind) + n)
        self.ops.raw_msgs += n
        self.ops.coalesced_msgs += n

    def _count_amo(self, op: str, src: int, bank: str, i: int) -> None:
        """Trace-only AMO attribution (the ledger stays on the words'
        ``amo_count``, exactly as before the fabric seam)."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.amo", rank=src, op=op, bank=bank, i=i)

    def _account_fence(self, wait: int = 0) -> None:
        """Shared fence accounting: epoch advance + O(log p) barrier stages
        (both fabrics MUST stay byte-identical here — the diff tests pin it).
        `wait` is trace-only: the virtual time this fence blocked on
        in-flight delivery (always 0 on the immediate LocalFabric), which
        the sync-plane ledger (`obs.critpath.SyncLedger`) attributes to the
        epoch and the requests riding it."""
        import math

        self.epoch += 1
        self.sync.barrier_stages += max(1, int(math.ceil(math.log2(max(self.p, 2)))))
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.fence", rank=-1, epoch=self.epoch, wait=wait,
                     rids=obs_causal.current_epoch_rids())

    # --------------------------------------------------------- inspection
    def snapshot(self) -> dict:
        """Fingerprint of everything this fabric moved (for diff tests)."""
        out = self.ops.snapshot()
        out.update({f"sync_{k}": v for k, v in self.sync.snapshot().items()})
        out["epoch"] = self.epoch
        return out

    def delta(self, prev) -> dict:
        """Snapshot diff against `prev` (a snapshot dict or a Fabric)."""
        if hasattr(prev, "snapshot"):
            prev = prev.snapshot()
        return snapshot_delta(self.snapshot(), prev)


class LocalFabric(Fabric):
    """The in-process transport: ops apply immediately, in issue order.

    This is exactly the behavior the host protocol mirrors had before the
    fabric seam existed — `flush`/`fence` only account sync messages, and
    `fence_add` degenerates to an immediate accumulate (everything prior
    has already been applied).
    """

    # ----------------------------------------------------------- regions
    def put(self, src: int, dst: int, region: str, idx, value) -> None:
        self._store(region)[dst][idx] = value
        self._count("puts", src=src, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("put", src, dst, region, idx)

    def add(self, src: int, dst: int, region: str, idx, delta) -> None:
        apply_add(self._store(region)[dst], idx, delta)
        self._count("accs", src=src, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("acc", src, dst, region, idx)

    def fence_add(self, dst: int, region: str, idx, delta) -> None:
        """Accumulate ordered after this epoch's one-way ops to `dst`
        (write-with-notification: counter visibility implies payload
        visibility).  Locally everything already applied, so: a plain add
        (inlined so the shadow sees one acc + one notification, with the
        ledger accounting byte-identical to the delegated form)."""
        apply_add(self._store(region)[dst], idx, delta)
        self._count("accs", src=dst, dst=dst, region=region)
        if self.shadow is not None:
            prov = self.shadow.access("acc", dst, dst, region, idx)
            self.shadow.notify(dst, self.epoch, prov=prov)

    def get(self, src: int, dst: int, region: str, idx=()):
        out = self._store(region)[dst][idx] if idx != () else self._store(region)[dst]
        self._count("gets", src=src, dst=dst, region=region)
        if self.shadow is not None:
            self.shadow.access("get", src, dst, region, idx)
        return np.copy(out)

    def gather(self, src: int, region: str):
        """Window-wide read (the reservation gather): one fused transfer."""
        self._count("gets", src=src, region=region)
        if self.shadow is not None:
            self.shadow.read_all(src, region)
        return np.copy(self._store(region))

    # -------------------------------------------------------------- AMOs
    # AMO accounting lives on the words themselves (``amo_count``), exactly
    # as before the fabric seam — `HostPagePool.total_amos` is unchanged.
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
        out = self._word(bank, i).cas(expected, new)
        if self.shadow is not None:
            self.shadow.amo(src, bank, i, "cas", expected=expected,
                            value=new, result=out)
        return out

    # -------------------------------------------------------------- sync
    def flush(self, src: int) -> None:
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.flush", rank=src, epoch=self.epoch, wait=0,
                     rids=obs_causal.current_epoch_rids())
        SyncStats.record("flush_msgs", also=self.sync)
        if self.shadow is not None:
            self.shadow.sync("flush", src)

    def flush_remote(self, src: int) -> None:
        """MPI_Win_flush: locally everything is already remotely complete."""
        self.flush(src)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.flush_remote", rank=src, epoch=self.epoch,
                     wait=0, rids=obs_causal.current_epoch_rids())
        if self.shadow is not None:
            self.shadow.sync("flush_remote", src)

    def fence(self) -> None:
        self._account_fence()
        if self.shadow is not None:
            self.shadow.sync("fence")


def default_fabric(fabric: Optional[Fabric], p: int = 1) -> Fabric:
    """The existing in-process host transport unless one is supplied."""
    return fabric if fabric is not None else LocalFabric(p=p)
