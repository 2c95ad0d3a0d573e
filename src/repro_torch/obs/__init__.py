"""repro_torch.obs — the slice of `repro.obs` the serving path calls.

  * `trace`   — the process-wide tracer seam (`TRACER.event`), no-op default;
  * `metrics` — `MetricsRegistry.histogram(...).observe/summary` and
    `snapshot_delta`;
  * `causal`  — deterministic per-hop edge ids (`edge`);
  * `flight`  — the bounded ring recorder and its `on_error` dump.
"""

from . import causal, flight, metrics, trace  # noqa: F401

__all__ = ["causal", "flight", "metrics", "trace"]
