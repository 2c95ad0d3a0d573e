"""Always-on flight recorder: bounded ring tracer + post-mortem dumps (§15).

A full `Tracer` keeps every event — fine for a conformance run, unusable as
a default on a long-lived serving process.  `FlightRecorder` is the
always-on-able variant: a fixed-capacity ring that retains only the newest
`capacity` records (O(1) memory, O(1) per record) and counts what it shed.
When a terminal error fires — `DrainError`, `LockTimeout`, `HeapError`,
`ConformanceError` — `on_error` dumps the ring as a Perfetto trace plus a
critical-path report, giving the post-mortem the exact event interleaving
and TTFT attribution leading up to the failure.

Determinism carries over: under a virtual clock the ring's contents are a
pure function of ``(seed, chaos schedule)``, dump filenames contain no
timestamps (error class + tag + per-recorder dump ordinal), and the trace
serialization is the canonical byte-identical form — so a flight dump from
a failing sim run *replays byte-identically* from its repro line.

`on_error` never raises: a diagnostics failure must not mask the error
being diagnosed.
"""

from __future__ import annotations

import collections
import os
from typing import Optional

from . import critpath, trace
from .export import dump_chrome_trace
from .trace import Tracer

DEFAULT_CAPACITY = 65536


class FlightRecorder(Tracer):
    """A `Tracer` whose buffer is a bounded ring.

    Drop-in everywhere a `Tracer` goes (export, causal stitching, the
    global install) — only retention differs: the oldest record is shed
    once `capacity` is reached and `dropped` counts the shed, which
    `obs.export` surfaces as an in-trace ``trace.truncated`` marker.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=None,
                 dump_dir: Optional[str] = None):
        super().__init__(clock=clock)
        self.capacity = int(capacity)
        # replaces the unbounded list installed by Tracer.__init__; every
        # read path (export, ranks/by_rank/named) only iterates, so the
        # deque is transparent to them
        self.events = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.dump_dir = dump_dir
        self.dumps = 0

    def _record(self, rec: dict) -> None:
        with self._mu:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(rec)

    def clear(self) -> None:
        with self._mu:
            self.events.clear()
            self.dropped = 0

    # --------------------------------------------------------------- dumping
    def dump(self, stem: str, reason: str = "") -> tuple:
        """Write ``<stem>.trace.json`` (Perfetto) and ``<stem>.critpath.txt``
        (critical-path report); returns both paths."""
        trace_path = dump_chrome_trace(self, f"{stem}.trace.json")
        rep = critpath.report(list(self.events))
        report_path = f"{stem}.critpath.txt"
        with open(report_path, "w") as f:
            if reason:
                f.write(f"reason: {reason}\n")
            f.write(f"ring: kept={len(self.events)} dropped={self.dropped} "
                    f"capacity={self.capacity} "
                    f"clock={self.clock_domain}\n")
            f.write(critpath.format_report(rep))
            f.write("\n")
        return trace_path, report_path


def on_error(err: BaseException, tag: str = "",
             dump_dir: Optional[str] = None) -> Optional[tuple]:
    """Dump the installed flight recorder's ring in response to `err`.

    Called at terminal raise sites (`serve.run_until_drained`, the sim lock
    table, the remote heap, the conformance driver).  A no-op unless the
    process-wide tracer is a `FlightRecorder` with a dump directory (its
    own or the `dump_dir` override).  Returns the (trace, report) paths, or
    None — and swallows every internal exception so the original error
    always propagates unchanged.
    """
    tr = trace.TRACER
    if not isinstance(tr, FlightRecorder):
        return None
    d = dump_dir or tr.dump_dir
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        tr.dumps += 1
        parts = ["flight", type(err).__name__.lower()]
        if tag:
            parts.append(tag)
        if tr.dumps > 1:
            parts.append(str(tr.dumps))
        return tr.dump(os.path.join(d, "-".join(parts)), reason=str(err))
    except Exception:
        return None
