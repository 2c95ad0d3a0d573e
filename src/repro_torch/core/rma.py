"""One-sided op accounting (copy of `repro.core.rma.OpCounter`).

The counter distinguishes **raw** messages (ops as recorded — what the
program meant) from **coalesced** messages (wire transfers actually issued
after plan aggregation).  Coalesced ops are attributed to their originating
kind: a fused transfer carrying 3 puts and 1 accumulate counts puts += 3,
accs += 1, raw_msgs += 4, coalesced_msgs += 1.  Per-plan aggregation detail
accumulates in `.plans`.  The snapshot keys are the reference's, so one
ledger schema reads both packages.

Counts are per rank, as in the reference where one trace is one rank's
program: a plan over the stacked ``[p, ...]`` view is counted once.
"""

from __future__ import annotations

from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta


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
