"""Always-on flight recorder: a bounded ring tracer and its post-mortem dump.

`FlightRecorder` keeps only the newest `capacity` records (O(1) memory) and
counts what it shed.  `on_error`, called at terminal raise sites such as
`run_until_drained`'s `DrainError`, writes the ring as one JSON file when the
installed tracer is a `FlightRecorder` with a dump directory.  It never
raises: a diagnostics failure must not mask the error being diagnosed.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Optional

from . import trace
from .trace import Tracer

DEFAULT_CAPACITY = 65536


class FlightRecorder(Tracer):
    """A `Tracer` whose buffer is a bounded ring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: Optional[str] = None):
        super().__init__()
        self.capacity = int(capacity)
        self.events = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.dump_dir = dump_dir
        self.dumps = 0

    def _record(self, rec: dict) -> None:
        with self._mu:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(rec)

    def dump(self, stem: str, reason: str = "") -> str:
        """Write ``<stem>.flight.json`` (reason, drop count, events)."""
        path = f"{stem}.flight.json"
        with open(path, "w") as f:
            json.dump({"reason": reason, "dropped": self.dropped,
                       "capacity": self.capacity,
                       "events": list(self.events)}, f, default=str)
        return path


def on_error(err: BaseException, tag: str = "",
             dump_dir: Optional[str] = None) -> Optional[str]:
    """Dump the installed flight recorder's ring in response to `err`;
    returns the dump path, or None (no recorder, no directory, or a failed
    dump — every internal exception is swallowed)."""
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
