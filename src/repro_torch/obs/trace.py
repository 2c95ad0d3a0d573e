"""Span/event tracer with a no-op default (copy of `repro.obs.trace`'s core).

The module global `TRACER` is a `NullTracer` by default; hot paths guard
with ``tr = trace.TRACER`` / ``if tr.enabled:`` so the disabled cost is one
attribute load and a falsy branch.  Every event carries an integer ``rank``
(``-1`` is the control track).  ``edge`` and ``cause`` (see `obs.causal`)
are causal links and are only valid on instant events, so `Tracer.span`
rejects them.
"""

from __future__ import annotations

import threading
import time

_RESERVED_SPAN_ATTRS = frozenset({"edge", "cause"})


class _NullSpan:
    """Shared no-op span: absorbs `.set()` and works as a context manager."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Default tracer: every operation is a no-op."""

    enabled = False

    def event(self, name: str, rank: int = 0, **attrs) -> None:
        pass

    def span(self, name: str, rank: int = 0, **attrs) -> _NullSpan:
        return NULL_SPAN


NULL_TRACER = NullTracer()

# The process-wide tracer; read at call time (`trace.TRACER`), never bound
# by `from ... import TRACER`, so installation is late-bound.
TRACER = NULL_TRACER


def set_tracer(tracer) -> object:
    """Install `tracer` globally; returns the previous one for restoration."""
    global TRACER
    prev = TRACER
    TRACER = NULL_TRACER if tracer is None else tracer
    return prev


class Span:
    """An open span; closed by its `with` block (or `close()`)."""

    __slots__ = ("_tracer", "name", "rank", "attrs", "t0", "_open")

    def __init__(self, tracer: "Tracer", name: str, rank: int, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.rank = rank
        self.attrs = attrs
        self.t0 = tracer.now()
        self._open = True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def close(self) -> None:
        if self._open:
            self._open = False
            self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Tracer:
    """Recording tracer: flat event list, wall-clock microseconds since
    construction.  ``with Tracer() as tr:`` installs it process-wide and
    restores the previous tracer on exit."""

    enabled = True

    def __init__(self):
        self._wall0 = time.perf_counter_ns()
        self.events: list[dict] = []
        self._mu = threading.Lock()
        self._prev = None

    def now(self) -> int:
        return (time.perf_counter_ns() - self._wall0) // 1000

    def _record(self, rec: dict) -> None:
        """Single funnel for finished records (subclasses change retention)."""
        with self._mu:
            self.events.append(rec)

    def event(self, name: str, rank: int = 0, **attrs) -> None:
        self._record({"ph": "i", "name": name, "ts": self.now(),
                      "rank": int(rank), "args": attrs})

    def span(self, name: str, rank: int = 0, **attrs) -> Span:
        bad = _RESERVED_SPAN_ATTRS.intersection(attrs)
        if bad:
            raise ValueError(
                f"span {name!r}: reserved causal attrs {sorted(bad)} are only "
                f"valid on instant events (tracer.event)")
        return Span(self, name, int(rank), attrs)

    def _finish(self, sp: Span) -> None:
        self._record({"ph": "X", "name": sp.name, "ts": sp.t0,
                      "dur": self.now() - sp.t0, "rank": sp.rank,
                      "args": sp.attrs})

    def __enter__(self) -> "Tracer":
        self._prev = set_tracer(self)
        return self

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev)
        self._prev = None
        return False
