"""Host-side one-sided transport: the AMO plane `HostPagePool` runs on and
the payload-plane op ledger `window.DescriptorCache` charges (copy of the
in-process part of `repro.core.fabric`).

A bank is a named list of `_AtomicWord`s (free-list heads, refcounts).
`LocalFabric` applies every atomic immediately, in issue order, on the words
themselves, so per-word ``amo_count`` stays the AMO ledger.  Payload ops
are counted in a private `OpCounter` (``fabric.ops``), not the active
ledgers, so device-path accounting is untouched.  The region, completion
and sync planes of the reference's fabric are not ported yet, so
`snapshot` holds the op ledger alone.
"""

from __future__ import annotations

from typing import Optional

from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta
from .locks_sim import _AtomicWord
from .rma import OpCounter


class FabricError(RuntimeError):
    pass


class Fabric:
    """Bank registry shared by fabric implementations."""

    def __init__(self) -> None:
        self.banks: dict[str, list] = {}
        self.bank_owner: dict[str, int] = {}
        self.ops = OpCounter()                  # payload-plane accounting (private)

    def register_words(self, name: str, words: list, owner: int = 0) -> list:
        """Expose a bank of `_AtomicWord`s (an AMO-addressable window)."""
        if name in self.banks:
            raise FabricError(f"bank {name!r} already registered")
        if not all(isinstance(w, _AtomicWord) for w in words):
            raise FabricError("banks hold locks_sim._AtomicWord instances")
        self.banks[name] = list(words)
        self.bank_owner[name] = owner
        return self.banks[name]

    def _word(self, bank: str, i: int) -> _AtomicWord:
        try:
            return self.banks[bank][i]
        except KeyError:
            raise FabricError(f"unknown bank {bank!r}") from None

    def _count(self, kind: str, n: int = 1, src: int = -1, dst: int = -1,
               region: str = "") -> None:
        """Payload-op accounting: one logical op == one wire transfer.
        `src`/`dst`/`region` are trace-only attribution."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.op", rank=src, kind=kind, n=n, dst=dst,
                     region=region)
        setattr(self.ops, kind, getattr(self.ops, kind) + n)
        self.ops.raw_msgs += n
        self.ops.coalesced_msgs += n

    def _count_amo(self, op: str, src: int, bank: str, i: int) -> None:
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("fabric.amo", rank=src, op=op, bank=bank, i=i)

    def snapshot(self) -> dict:
        """Fingerprint of what this fabric moved: the op ledger."""
        return self.ops.snapshot()

    def delta(self, prev) -> dict:
        """Snapshot diff against `prev` (a snapshot dict or a Fabric)."""
        if hasattr(prev, "snapshot"):
            prev = prev.snapshot()
        return snapshot_delta(self.snapshot(), prev)


class LocalFabric(Fabric):
    """The in-process transport: atomics apply immediately."""

    def read_word(self, src: int, bank: str, i: int) -> int:
        self._count_amo("read", src, bank, i)
        return self._word(bank, i).read()

    def fetch_add(self, src: int, bank: str, i: int, delta: int) -> int:
        self._count_amo("fetch_add", src, bank, i)
        return self._word(bank, i).fetch_add(delta)

    def cas(self, src: int, bank: str, i: int, expected: int, new: int) -> int:
        self._count_amo("cas", src, bank, i)
        return self._word(bank, i).cas(expected, new)


def default_fabric(fabric: Optional[Fabric]) -> Fabric:
    """The in-process host transport unless one is supplied."""
    return fabric if fabric is not None else LocalFabric()
