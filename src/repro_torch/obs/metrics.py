"""Labeled metrics registry over the repo's ledger snapshots (§12).

The stack already measures everything the paper's models predict — OpCounter
(message counts), SyncStats (synchronization traffic), PlanStats (coalescing),
`Fabric.snapshot()` (the seam's combined view), flow/heap/chaos stat dicts —
but as five separately-shaped dicts.  This registry gives them one home:

  * `counter/gauge/histogram(name, **labels)` — get-or-create a metric keyed
    by ``(kind, name, sorted labels)``, Prometheus-style.
  * `ingest(prefix, snapshot, **labels)` — walk any of the snapshot dicts and
    mirror every numeric leaf into a gauge named ``prefix.path.to.leaf``.
    Nested dicts recurse (``rma.by_axis.w.puts``); lists (e.g. per-plan info
    records) are skipped — they belong in the tracer, not the registry.
  * `flat()` — deterministic flat ``{name{labels}: value}`` dict for JSON
    export; histograms flatten to their summary stats.

The shared schema is the snapshots' own key naming — `raw_msgs` /
`coalesced_msgs` appear identically in OpCounter, SyncStats, PlanStats and
`Fabric.snapshot()` (the latter prefixes sync fields with ``sync_``), so
`ingest` needs no per-source adapters.  `snapshot_delta` is the common
implementation behind each ledger's `delta(prev)` helper.
"""

from __future__ import annotations

import numbers
from typing import Optional


def snapshot_delta(cur: dict, prev: Optional[dict]) -> dict:
    """Recursive numeric difference of two snapshot dicts (cur - prev).

    Keys present only in `cur` diff against 0; non-numeric leaves pass
    through unchanged.  This is the shared engine behind the ledgers'
    `delta(prev)` helpers (OpCounter, SyncStats, PlanStats, Fabric).

    Histograms participate via `Histogram.snapshot()`'s append-only
    ``{"__hist__": [...]}`` form: percentiles don't subtract, so the delta
    of two histogram snapshots is the summary of the observations recorded
    *between* them (the suffix `prev` hadn't seen yet).
    """
    prev = prev or {}
    out: dict = {}
    for k, v in cur.items():
        if isinstance(v, dict) and "__hist__" in v:
            p = prev.get(k)
            seen = len(p["__hist__"]) if isinstance(p, dict) and "__hist__" in p else 0
            out[k] = _summarize(v["__hist__"][seen:])
        elif isinstance(v, dict):
            p = prev.get(k)
            out[k] = snapshot_delta(v, p if isinstance(p, dict) else {})
        elif isinstance(v, bool) or not isinstance(v, numbers.Number):
            out[k] = v
        else:
            p = prev.get(k, 0)
            out[k] = v - (p if isinstance(p, numbers.Number) else 0)
    return out


def _percentile(xs: list, q: float) -> float:
    """Exact q-th percentile (nearest-rank) of pre-sorted `xs`."""
    if not xs:
        return 0.0
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[rank]


def _summarize(values: list) -> dict:
    if not values:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p90": 0.0, "p99": 0.0}
    xs = sorted(values)
    return {
        "count": len(xs),
        "sum": sum(xs),
        "min": xs[0],
        "max": xs[-1],
        "p50": _percentile(xs, 50),
        "p90": _percentile(xs, 90),
        "p99": _percentile(xs, 99),
    }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Value-retaining histogram with exact percentiles and exemplars.

    Runs are small (thousands of observations, not millions), so we keep the
    raw values and compute exact order statistics — no bucket-boundary error
    in the TTFT/TBT numbers the trajectory tracks per commit.

    An observation may carry an **exemplar** — an opaque sample reference,
    by convention a request id — so a percentile is not just a number but a
    pointer: ``p99_exemplar`` in the summary names a concrete request whose
    causal DAG (`obs.causal.build_dags`) explains that tail.
    """

    __slots__ = ("values", "exemplars")

    def __init__(self):
        self.values: list[float] = []
        self.exemplars: dict[float, object] = {}  # value -> latest exemplar

    def observe(self, v: float, exemplar=None) -> None:
        v = float(v)
        self.values.append(v)
        if exemplar is not None:
            self.exemplars[v] = exemplar

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (nearest-rank), q in [0, 100]."""
        return _percentile(sorted(self.values), q)

    def summary(self) -> dict:
        out = _summarize(self.values)
        if self.exemplars:
            # the exemplar of the observation sitting at the p99 rank (the
            # request to go look at); absent entirely when none were given,
            # so exemplar-free summaries keep their exact prior shape
            ex = self.exemplars.get(out["p99"])
            if ex is not None:
                out["p99_exemplar"] = ex
        return out

    def snapshot(self) -> dict:
        """Append-only snapshot form understood by `snapshot_delta`."""
        return {"__hist__": list(self.values)}


class MetricsRegistry:
    """Get-or-create registry of labeled counters/gauges/histograms."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}

    def _get(self, kind: str, cls, name: str, labels: dict):
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls()
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    # -------------------------------------------------------------- ingestion
    def ingest(self, prefix: str, snapshot: dict, **labels) -> None:
        """Mirror every numeric leaf of a snapshot dict into gauges.

        Works unmodified on OpCounter/SyncStats/PlanStats/Fabric snapshots
        and on the flow/heap/chaos stat dicts — the shared schema
        unification means no per-source adapter code lives here.
        """
        for k, v in snapshot.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                self.ingest(name, v, **labels)
            elif isinstance(v, bool):
                self.gauge(name, **labels).set(int(v))
            elif isinstance(v, numbers.Number):
                self.gauge(name, **labels).set(v)
            # lists / strings: trace-side detail, not a metric

    # ---------------------------------------------------------------- export
    def flat(self) -> dict:
        """Deterministic flat dict: ``name{labels}`` -> value/summary."""
        out = {}
        for (kind, name, labels) in sorted(self._metrics, key=lambda k: (k[1], k[2], k[0])):
            m = self._metrics[(kind, name, labels)]
            full = name + _label_str(labels)
            if kind == "histogram":
                out[full] = m.summary()
            else:
                out[full] = m.value
        return out
