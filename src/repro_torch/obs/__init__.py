"""repro_torch.obs — span tracing, metrics, causal stitching, export (copy of
`repro.obs`).

  * `trace`    — the process-wide tracer seam (`TRACER.event`), no-op
    default, with a virtual-clock seam (`attach_clock`);
  * `metrics`  — `MetricsRegistry` (counters, gauges, histograms, `ingest`,
    `flat`) and `snapshot_delta`;
  * `causal`   — deterministic per-hop edge ids, the request / epoch scopes,
    and `build_dags`, which stitches a flat trace into per-request DAGs;
  * `critpath` — critical paths, the TTFT segment breakdown and the
    sync-plane wait ledger over those DAGs;
  * `export`   — Chrome / Perfetto trace and metrics JSON;
  * `flight`   — the bounded ring recorder and its `on_error` dump;
  * `cost`     — the hooks through which the mesh, the kernels' wrappers
    and the models report to a running `launch.hlo_cost` counter.

Layering: `trace`, `metrics` and `cost` import nothing of `repro_torch.core`, so
instrumented hot paths reach the global tracer with one attribute load.
`drift` (the model-vs-measured count gate) and `drift_docs` (the count
documents it reads) look upward, into the perf model and the engines, and
are imported only by their users, never from here.
"""

from . import causal, critpath, export, flight, metrics, trace  # noqa: F401
from .causal import (  # noqa: F401
    build_dags,
    current_epoch_rids,
    current_rid,
    edge,
    epoch_scope,
    request_scope,
)
from .flight import FlightRecorder  # noqa: F401
from .trace import NULL_TRACER, NullTracer, Tracer, get_tracer, set_tracer  # noqa: F401

__all__ = ["causal", "critpath", "export", "flight", "metrics", "trace"]
