"""Histograms and snapshot deltas (copy of the part of `repro.obs.metrics`
the serving path and the ledgers use).

`snapshot_delta` is the shared engine behind each ledger's `delta(prev)`;
`MetricsRegistry.histogram` keeps raw values for exact percentiles
(runs are thousands of observations, not millions).
"""

from __future__ import annotations

import numbers
from typing import Optional


def snapshot_delta(cur: dict, prev: Optional[dict]) -> dict:
    """Recursive numeric difference of two snapshot dicts (cur - prev).
    Keys only in `cur` diff against 0; non-numeric leaves pass through."""
    prev = prev or {}
    out: dict = {}
    for k, v in cur.items():
        if isinstance(v, dict):
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


class Histogram:
    """Value-retaining histogram with exact percentiles and exemplars (an
    exemplar is by convention a request id: ``p99_exemplar`` names one)."""

    __slots__ = ("values", "exemplars")

    def __init__(self):
        self.values: list[float] = []
        self.exemplars: dict[float, object] = {}

    def observe(self, v: float, exemplar=None) -> None:
        v = float(v)
        self.values.append(v)
        if exemplar is not None:
            self.exemplars[v] = exemplar

    def summary(self) -> dict:
        out = _summarize(self.values)
        if self.exemplars:
            ex = self.exemplars.get(out["p99"])
            if ex is not None:
                out["p99_exemplar"] = ex
        return out


class MetricsRegistry:
    """Get-or-create registry of labeled histograms."""

    def __init__(self):
        self._metrics: dict[tuple, Histogram] = {}

    def histogram(self, name: str, **labels) -> Histogram:
        key = (name, tuple(sorted(labels.items())))
        h = self._metrics.get(key)
        if h is None:
            h = self._metrics[key] = Histogram()
        return h
