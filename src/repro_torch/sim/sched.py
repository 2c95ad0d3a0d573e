"""Virtual-time cooperative scheduler for simulated protocol ranks (§11).

Simulated ranks are **cooperative tasks**: plain Python generators that
``yield`` at every protocol step (a send staged, a ring drained, a lock
retried).  The scheduler repeatedly picks one runnable task with a seeded
RNG and advances it one step, interleaving fabric deliveries as the
virtual clock moves — so the entire interleaving of a run is a pure
function of ``(seed, chaos schedule)`` and any failure replays exactly.

Event model:

  * **task step** — one ``next()`` on a task generator; costs one virtual
    tick.
  * **delivery** — an in-flight `SimFabric` transfer whose due time has
    arrived is applied to the target's memory.
  * **quiescence** — no runnable task and no in-flight transfer.  If
    transfers remain but no task can run, the clock jumps to the next due
    time (the "everyone is waiting on the network" state).

`on_event` is the conformance hook: it fires after every event with the
event kind and a monotonically increasing event index — the "after every
simulated step" point where the global invariants are asserted.
"""

from __future__ import annotations

import bisect
import random
from typing import Callable, Optional

from ..obs import trace as obs_trace


class VirtualClock:
    """Monotonic virtual time; nothing in the sim reads the wall clock."""

    def __init__(self) -> None:
        self.now = 0

    def advance(self, dt: int = 1) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.now += dt


class SchedulerError(RuntimeError):
    pass


class Scheduler:
    """Seeded run-to-quiescence scheduler over cooperative rank tasks."""

    def __init__(self, seed: int, clock: Optional[VirtualClock] = None,
                 on_event: Optional[Callable] = None) -> None:
        self.seed = seed
        self.rng = random.Random(seed ^ 0x9E3779B9)
        self.clock = clock if clock is not None else VirtualClock()
        # clock seam (§12): an installed tracer timestamps with THIS run's
        # virtual clock from here on, so traced chaos runs replay exactly
        obs_trace.TRACER.attach_clock(self.clock)
        self.on_event = on_event
        self.tasks: dict[str, object] = {}     # name -> generator (runnable)
        self._order: list[str] = []            # runnable names, kept sorted
        self.fabrics: list = []
        self.events = 0
        self.trace: list[tuple[int, str, str]] = []  # (virtual time, kind, who)

    # ------------------------------------------------------------- plumbing
    def spawn(self, name: str, gen) -> None:
        if name in self.tasks:
            raise SchedulerError(f"task {name!r} already spawned")
        self.tasks[name] = gen
        bisect.insort(self._order, name)

    def attach(self, fabric) -> None:
        """Couple a `SimFabric`: its deliveries become scheduler events."""
        fabric.on_deliver = self._deliver_event
        self.fabrics.append(fabric)

    def _fire(self, kind: str, who: str) -> None:
        self.events += 1
        self.trace.append((self.clock.now, kind, who))
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event(f"sched.{kind}", rank=-1, who=who, index=self.events)
        if self.on_event is not None:
            self.on_event(kind, who, self)

    def _deliver_event(self, info: dict) -> None:
        self._fire(info.get("kind", "deliver"),
                   f"{info.get('src', '?')}->{info.get('dst', '?')}")

    # ------------------------------------------------------------ main loop
    def _deliver_due(self) -> None:
        for fab in self.fabrics:
            fab.deliver_due(self.clock.now)

    def _next_due(self) -> Optional[int]:
        dues = [d for d in (fab.next_due() for fab in self.fabrics)
                if d is not None]
        return min(dues) if dues else None

    def run(self, max_events: int = 2_000_000) -> dict:
        """Run to quiescence; returns a run report.

        Raises `SchedulerError` on livelock (max_events exhausted with
        tasks still runnable — a protocol waiting on a condition no other
        task will ever establish).
        """
        while True:
            self._deliver_due()
            if self.events > max_events:
                raise SchedulerError(
                    f"no quiescence after {max_events} events "
                    f"(runnable: {sorted(self.tasks)[:8]}...)"
                )
            if self.tasks:
                # _order is kept sorted incrementally: picking by index is
                # O(1) vs re-sorting ~p names on every event at 1024 ranks
                name = self._order[self.rng.randrange(len(self._order))]
                gen = self.tasks[name]
                try:
                    next(gen)
                except StopIteration:
                    del self.tasks[name]
                    self._order.remove(name)
                self._fire("task", name)
                self.clock.advance(1)
                continue
            # no runnable task: jump to the next delivery, or we're done
            due = self._next_due()
            if due is None:
                break
            self.clock.advance(max(1, due - self.clock.now))
        return {
            "events": self.events,
            "virtual_time": self.clock.now,
            "seed": self.seed,
        }
