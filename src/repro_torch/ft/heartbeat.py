"""Failure detection and straggler mitigation, the host-side control plane
(the counterpart of `repro.ft.heartbeat`; pure Python).

Liveness is decided by observed progress counters, each node's step as the
one-sided "put" of a window every node exposes, never by a synchronous
RPC, so a slow node never blocks the detector.  A node with no progress for
`timeout_s` is dead; a node whose last step took more than
`straggler_factor` x the fleet's median for `straggler_patience` checks in
a row is a straggler.  The clock is injectable, so tests drive both
decisions on one clock.  `ChannelHeartbeat` carries the beats as notified
puts into the monitor's ring over `rmaq.channel.HostChannel` (numpy, no
device).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional

from ..rmaq.channel import HostChannel, Lane
from ..rmaq.queue import DROP


@dataclasses.dataclass
class HeartbeatConfig:
    timeout_s: float = 30.0             # no progress for this long -> dead
    straggler_factor: float = 2.0       # x p50 step time
    straggler_patience: int = 3


class HeartbeatMonitor:
    """Tracks per-node progress counters (the 'window' every node exposes)."""

    def __init__(self, n_nodes: int, cfg: HeartbeatConfig = HeartbeatConfig(),
                 clock=time.monotonic):
        self.n = n_nodes
        self.cfg = cfg
        self.clock = clock
        self.last_beat = [clock()] * n_nodes
        self.last_step = [0] * n_nodes
        self.step_times: dict[int, deque] = defaultdict(lambda: deque(maxlen=16))
        self.dead: set[int] = set()
        self.straggler_strikes = [0] * n_nodes

    # each node "puts" its step counter — one-sided, non-blocking
    def beat(self, node: int, step: int) -> None:
        now = self.clock()
        if step > self.last_step[node]:
            self.step_times[node].append(now - self.last_beat[node])
        self.last_beat[node] = now
        self.last_step[node] = step

    # ---------------------------------------------------------- queries
    def check_dead(self) -> set[int]:
        now = self.clock()
        for i in range(self.n):
            if i not in self.dead and now - self.last_beat[i] > self.cfg.timeout_s:
                self.dead.add(i)
        return set(self.dead)

    def fleet_p50(self) -> Optional[float]:
        all_t = sorted(t for i in range(self.n) if i not in self.dead
                       for t in self.step_times[i])
        return all_t[len(all_t) // 2] if all_t else None

    def check_stragglers(self) -> set[int]:
        p50 = self.fleet_p50()
        out = set()
        if p50 is None:
            return out
        for i in range(self.n):
            if i in self.dead or not self.step_times[i]:
                continue
            if self.step_times[i][-1] > self.cfg.straggler_factor * p50:
                self.straggler_strikes[i] += 1
            else:
                self.straggler_strikes[i] = 0
            if self.straggler_strikes[i] >= self.cfg.straggler_patience:
                out.add(i)
        return out

    def healthy_nodes(self) -> list[int]:
        self.check_dead()
        return [i for i in range(self.n) if i not in self.dead]


# --------------------------------------------------------- channel transport
class ChannelHeartbeat:
    """Heartbeats carried as rmaq channel messages (DESIGN.md §6.6).

    Every node is a producer into the monitor rank's MPSC ring: `beat()`
    stages a (node, step) message on the "beat" lane; `poll()` runs one
    enqueue epoch, drains the monitor's ring, and feeds the monitor — the
    one-sided philosophy of the module docstring made literal: a beat is a
    notified put into the monitor's window, never an RPC, so a slow node
    can never block detection.

    Backpressure is a *feature* here: if the monitor's ring fills because
    poll() stalls, beats are rejected at the origin and the nodes simply
    look stale — precisely the failure signal a control plane should see
    (queue stats expose the drops for debugging).
    """

    LANE = "beat"
    MONITOR_RANK = 0

    def __init__(self, monitor: HeartbeatMonitor, capacity: int = 64):
        self.monitor = monitor
        self.channel = HostChannel(
            p=monitor.n + 1,  # nodes 1..n produce; rank 0 is the monitor
            capacity=capacity,
            lanes=[Lane(self.LANE, (2,), "int32")],
        )

    def beat(self, node: int, step: int) -> None:
        """Stage node's heartbeat (one-sided; delivered at next poll)."""
        self.channel.send(
            src=node + 1, name=self.LANE, payload=[node, step],
            tag=step, dest=self.MONITOR_RANK,
        )

    def poll(self) -> int:
        """One epoch: flush staged beats, drain the monitor ring, feed the
        detector.  Returns the number of beats delivered."""
        self.channel.flush()
        msgs = self.channel.recv(self.MONITOR_RANK)
        for m in msgs:
            node, step = int(m["payload"][0]), int(m["payload"][1])
            self.monitor.beat(node, step)
        return len(msgs)

    def stats(self) -> dict:
        out = self.channel.stats(self.MONITOR_RANK)
        out["dropped_total"] = int(self.channel.group.ctrs[:, DROP].sum())
        return out
