"""Span/event tracer with a no-op default and a virtual-clock seam (§12).

The tracer answers the question PAPERS.md's "Quo Vadis MPI RMA?" says matters
most for one-sided programs — *where did the synchronization go?* — by
stamping every epoch open/close, plan flush, fabric op, queue step, heap
alloc and serve-request milestone onto a per-rank timeline.

Design constraints, in order:

  1. **Zero cost when off.**  The module global `TRACER` is a `NullTracer`
     by default.  Hot paths guard with ``tr = trace.TRACER`` / ``if
     tr.enabled:`` so the disabled cost is one attribute load and a falsy
     branch — no kwargs dict is ever built.  Cooler paths (epoch close, host
     protocol steps) may use the always-on ``with TRACER.span(...)`` form;
     the null tracer hands back a shared no-op span singleton.
  2. **Replay-exact virtual time.**  `attach_clock(clock)` switches the
     timestamp source from the wall (µs since tracer construction) to a
     `sim.sched.VirtualClock`.  `Scheduler.__init__` attaches the installed
     tracer automatically, so a traced conformance run contains *only*
     virtual timestamps and the exported trace is a pure function of
     ``(seed, chaos schedule)`` — byte-identical across replays.
  3. **Per-rank tracks.**  Every event carries an integer ``rank`` (``-1``
     is the control/scheduler track); `obs.export` turns ranks into Chrome
     trace ``tid``s so Perfetto renders one swimlane per rank.

Spans nest per (thread, rank) the way Chrome complete events do: a span's
interval contains its children's, and Perfetto reconstructs the stack from
interval containment on each track.  `Span.set(**attrs)` adds attributes
discovered mid-flight (e.g. a plan flush learns its raw→coalesced counts
only after grouping).

**The disabled-span contract.**  `NullTracer.span` returns one shared
`NULL_SPAN` singleton whose `.set(**attrs)` discards everything — including
attrs computed inside nested spans.  That discard is the *point*: it is
what makes ``with TRACER.span(...) as sp: ... sp.set(x=cost())`` free when
tracing is off, but it also means code MUST NOT use span attrs as a data
channel back to the caller (they vanish under the null tracer) and MUST
NOT compute expensive values eagerly in `.set()` arguments on hot paths —
guard with ``if tr.enabled:`` first.  `tests/test_torch_obs.py` pins the
disabled-path cost to roughly one attribute load.

**Reserved attrs.**  ``edge`` and ``cause`` (see `obs.causal`) are causal
stitching links and are only valid on instant *events* — a link fires at a
point in time, whereas a span covers an interval and its `set()` calls can
land at any moment inside it.  `Tracer.span` raises ``ValueError`` on
them so a stitching bug fails loudly at the producer, not as a silently
disconnected DAG at analysis time.
"""

from __future__ import annotations

import threading
import time

# Causal-link keys (obs.causal.RESERVED_SPAN_ATTRS mirrors this; duplicated
# literally here so the hot tracer module never imports the causal layer).
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
    """Default tracer: every operation is a no-op.

    Mirrors the `Tracer` surface exactly so instrumented code never branches
    on tracer *type* — only on the `enabled` flag when it wants to skip
    building attribute dicts on a hot path.
    """

    enabled = False

    def event(self, name: str, rank: int = 0, **attrs) -> None:
        pass

    def span(self, name: str, rank: int = 0, **attrs) -> _NullSpan:
        return NULL_SPAN

    def attach_clock(self, clock) -> None:
        pass

    def detach_clock(self) -> None:
        pass


NULL_TRACER = NullTracer()

# The process-wide tracer.  Instrumented modules read this at call time
# (`trace.TRACER`), never `from ... import TRACER`, so installation is
# late-bound and costs nothing to flip.
TRACER = NULL_TRACER


def get_tracer():
    return TRACER


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
    """Recording tracer: flat event list + per-rank attribution.

    Timestamps are integers.  On the wall clock they are microseconds since
    tracer construction; with a virtual clock attached they are virtual
    ticks.  `clock_domain` records which, so exporters (and tests) can tell
    a replay-exact trace from a wall-time one.

    Usable as a context manager: ``with Tracer() as tr:`` installs it as the
    process-wide tracer and restores the previous one on exit.
    """

    enabled = True

    def __init__(self, clock=None):
        self._wall0 = time.perf_counter_ns()
        self._vclock = None
        self.clock_domain = "wall_us"
        self.events: list[dict] = []
        self._mu = threading.Lock()  # serve engines trace from request threads
        self._prev = None
        if clock is not None:
            self.attach_clock(clock)

    # ------------------------------------------------------------ clock seam
    def attach_clock(self, clock) -> None:
        """Stamp events with `clock.now` (virtual ticks) instead of the wall."""
        self._vclock = clock
        self.clock_domain = "virtual"

    def detach_clock(self) -> None:
        self._vclock = None
        self.clock_domain = "wall_us"

    def now(self) -> int:
        if self._vclock is not None:
            return int(self._vclock.now)
        return (time.perf_counter_ns() - self._wall0) // 1000

    # ------------------------------------------------------------- recording
    def _record(self, rec: dict) -> None:
        """Single funnel every finished record passes through.

        Subclasses override this to change retention policy — e.g. the
        flight recorder's bounded ring (`obs.flight.FlightRecorder`) —
        without touching the event/span call sites.
        """
        with self._mu:
            self.events.append(rec)

    def event(self, name: str, rank: int = 0, **attrs) -> None:
        """Record an instant event on `rank`'s track."""
        self._record({"ph": "i", "name": name, "ts": self.now(),
                      "rank": int(rank), "args": attrs})

    def span(self, name: str, rank: int = 0, **attrs) -> Span:
        """Open a span on `rank`'s track; close it with the `with` block.

        Rejects the reserved causal-link attrs (``edge``/``cause``): links
        belong on instant events, where they fire at a defined point in
        time — see the module docstring and `obs.causal`.
        """
        bad = _RESERVED_SPAN_ATTRS.intersection(attrs)
        if bad:
            raise ValueError(
                f"span {name!r}: reserved causal attrs {sorted(bad)} are only "
                f"valid on instant events (tracer.event); see obs.causal")
        return Span(self, name, int(rank), attrs)

    def _finish(self, sp: Span) -> None:
        self._record({
            "ph": "X",
            "name": sp.name,
            "ts": sp.t0,
            "dur": self.now() - sp.t0,
            "rank": sp.rank,
            "args": sp.attrs,
        })

    # ------------------------------------------------------------- inspection
    def ranks(self) -> list[int]:
        return sorted({ev["rank"] for ev in self.events})

    def by_rank(self, rank: int) -> list[dict]:
        return [ev for ev in self.events if ev["rank"] == rank]

    def named(self, name: str) -> list[dict]:
        return [ev for ev in self.events if ev["name"] == name]

    def clear(self) -> None:
        with self._mu:
            self.events.clear()

    # ------------------------------------------------- global install (with)
    def __enter__(self) -> "Tracer":
        self._prev = set_tracer(self)
        return self

    def __exit__(self, *exc) -> bool:
        set_tracer(self._prev)
        self._prev = None
        return False
