"""Exporters: Chrome-trace/Perfetto JSON and flat metrics JSON (§12).

The trace format is the Chrome trace event JSON (`traceEvents` array), which
Perfetto's UI (https://ui.perfetto.dev) opens directly: one process, one
thread *track per rank* (tid = rank; the scheduler/control track renders as
"control").  Spans are complete events (``ph: "X"``, ts + dur), instants are
``ph: "i"`` with thread scope; span attributes land in ``args``.

Byte-identical replays are a contract, not an accident: `dumps_chrome_trace`
serializes with sorted keys and fixed separators, ranks are emitted in
sorted order, and a virtual-clock trace contains no wall-time anywhere — so
the same ``(seed, schedule)`` conformance run always produces the same
bytes (tested in tests/test_torch_obs.py).

Truncation is never silent: a `max_events` cap (for multi-thousand-rank sim
traces) keeps only the **newest** events and inserts a ``trace.truncated``
metadata instant saying how many were cut, and a ring-buffer tracer
(`obs.flight.FlightRecorder`) that already dropped events at record time
surfaces its ``dropped`` count the same way.  `dump_chrome_trace` logs what
was cut to stderr.  The marker rides `traceEvents` with ``ts`` equal to the
oldest surviving event, so Perfetto shows *where* history begins.
"""

from __future__ import annotations

import gzip as _gzip
import json
import sys

# tid for the scheduler/control track (rank -1): rendered after real ranks
_CONTROL_TID = 1_000_000


def _tid(rank: int) -> int:
    return _CONTROL_TID if rank < 0 else rank


def chrome_trace(tracer, process_name: str = "repro_torch",
                 max_events: int = 0) -> dict:
    """Build a Chrome trace event document from a Tracer's buffer.

    `max_events` > 0 keeps only the newest that many tracer events (plus
    metadata); anything cut — by the cap here or earlier by a ring-buffer
    tracer — is declared by a ``trace.truncated`` marker event.
    """
    recs = list(tracer.events)
    cut = 0
    if max_events and len(recs) > max_events:
        cut = len(recs) - max_events
        recs = recs[-max_events:]
    dropped = cut + getattr(tracer, "dropped", 0)

    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": process_name}},
    ]
    for rank in sorted({ev["rank"] for ev in recs}):
        label = "control" if rank < 0 else f"rank {rank}"
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": _tid(rank), "args": {"name": label}})
    if dropped:
        events.append({"ph": "i", "name": "trace.truncated", "pid": 0,
                       "tid": _CONTROL_TID, "s": "t",
                       "ts": recs[0]["ts"] if recs else 0,
                       "args": {"dropped": dropped, "kept": len(recs)}})
    for ev in recs:
        rec = {
            "ph": ev["ph"],
            "name": ev["name"],
            "ts": ev["ts"],
            "pid": 0,
            "tid": _tid(ev["rank"]),
            "args": ev["args"],
        }
        if ev["ph"] == "X":
            rec["dur"] = ev["dur"]
        elif ev["ph"] == "i":
            rec["s"] = "t"  # thread-scoped instant
        events.append(rec)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"clock_domain": tracer.clock_domain,
                     "dropped_events": dropped},
    }


def dumps_chrome_trace(tracer, process_name: str = "repro_torch",
                       max_events: int = 0) -> str:
    """Canonical serialization — the unit of byte-identical replay."""
    return json.dumps(chrome_trace(tracer, process_name, max_events),
                      sort_keys=True, separators=(",", ":"))


def dump_chrome_trace(tracer, path: str, process_name: str = "repro_torch",
                      max_events: int = 0, gzipped: bool = False) -> str:
    """Write the trace; ``gzipped=True`` writes ``<path>.gz`` (Perfetto
    opens gzipped traces natively).  Logs any truncation to stderr."""
    payload = dumps_chrome_trace(tracer, process_name, max_events)
    dropped = getattr(tracer, "dropped", 0)
    if max_events and len(tracer.events) > max_events:
        dropped += len(tracer.events) - max_events
    if dropped:
        sys.stderr.write(
            f"[obs.export] {path}: truncated — {dropped} oldest events cut "
            f"(marked in-trace as trace.truncated)\n")
    if gzipped:
        if not path.endswith(".gz"):
            path += ".gz"
        # mtime=0 + no embedded filename: the .gz bytes stay a pure
        # function of the payload, preserving the byte-identity contract
        with open(path, "wb") as raw:
            with _gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                                mtime=0) as f:
                f.write(payload.encode("utf-8"))
    else:
        with open(path, "w") as f:
            f.write(payload)
    return path


def metrics_json(registry) -> dict:
    """Flat metrics document for benchmarks: ``{"metrics": {name: value}}``."""
    return {"metrics": registry.flat()}


def dump_metrics(registry, path: str) -> str:
    with open(path, "w") as f:
        json.dump(metrics_json(registry), f, indent=2, sort_keys=True)
        f.write("\n")
    return path
