"""Closed-form cost models for the one-sided layer on one H100 (the
`repro.core.perfmodel` counterpart, rebuilt for the card).

The paper's models price each RMA function by its latency and bandwidth on
a network.  Here every rank is a row of one stacked device tensor, so a put
between ranks is an HBM-to-HBM copy on one card: its price is one kernel
launch plus the bytes it reads and writes at the card's copy rate.  NVLink
enters only with a multi-card mesh.  The same objects drive the plan's and
the epochs' decisions:

  * `select_aggregation` — pack a same-signature group into one transfer or
    issue its ops one by one;
  * `select_sync_mode` — fence or PSCW for k neighbours out of p ranks.

All sizes are the bytes the card moves (every rank's block), all results
seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One NVIDIA H100 SXM.  The HBM rate is NVIDIA's H100 SXM data sheet
    (`chip_smoke.py` takes its bytes bounds from it); the rest was measured
    by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
    the median of three runs (PERF.md, "H100 model constants")."""

    hbm_bandwidth: float = 3.35e12          # B/s, HBM3 (data sheet)
    launch_latency: float = 10.1e-6         # s per PyTorch op, back to back
    event_latency: float = 15.3e-6          # s: record an event + wait on it
    copy_bandwidth: float = 3.00e12         # B/s read + written by Tensor.copy_


H100 = HardwareSpec()


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Parametrised cost functions; all return seconds."""

    hw: HardwareSpec = H100

    def _rw(self, nbytes: float, passes: float = 2.0) -> float:
        """Time to move `nbytes` `passes` times through device memory."""
        return passes * nbytes / self.hw.copy_bandwidth

    # -- communication functions ------------------------------------------
    def p_put(self, nbytes: float) -> float:
        """A put between stacked ranks: one copy kernel, read + write."""
        return self.hw.launch_latency + self._rw(nbytes)

    def p_get(self, nbytes: float) -> float:
        """A get is the same copy with the shift negated: on one card there
        is no request round trip."""
        return self.p_put(nbytes)

    def p_accumulate(self, nbytes: float) -> float:
        """Slotted accumulate: the put into the slot, then the owner's add
        (read slot + read acc + write)."""
        return self.p_put(nbytes) + self.hw.launch_latency + self._rw(nbytes, 3.0)

    def p_message_rate(self, nbytes: float = 8.0) -> float:
        """Per-message cost of back-to-back transfers: launch-bound for small
        payloads, copy-bound for large."""
        return max(self.hw.launch_latency, self._rw(nbytes))

    # -- plan aggregation ---------------------------------------------------
    def p_direct_transfers(self, n_msgs: int, msg_bytes: float) -> float:
        """n transfers, one kernel each."""
        return n_msgs * self.p_message_rate(msg_bytes)

    def p_packed_transfer(self, n_msgs: int, msg_bytes: float) -> float:
        """One fused transfer as the plan issues it: a concatenation into
        the word buffer, the move, and one decode copy per message — n + 2
        launches and three passes over the payload."""
        total = n_msgs * msg_bytes
        return (n_msgs + 2) * self.hw.launch_latency + self._rw(total, 6.0)

    def select_aggregation(self, n_msgs: int,
                           msg_bytes: float) -> Literal["pack", "direct"]:
        """Pack a same-signature group into one transfer, or not.  On a
        network packing saves per-message injections; on one card every
        message is one launch either way and packing adds the pack and
        decode passes, so the direct transfers win at every size."""
        if n_msgs <= 1:
            return "direct"
        packed = self.p_packed_transfer(n_msgs, msg_bytes)
        direct = self.p_direct_transfers(n_msgs, msg_bytes)
        return "pack" if packed < direct else "direct"

    def aggregation_crossover_bytes(self, n_msgs: int = 16) -> float:
        """Smallest message size (geometric scan from 8 B) where packing
        stops winning."""
        s = 8.0
        while s < 64 * 2**20:
            if self.select_aggregation(n_msgs, s) == "direct":
                return s
            s *= 2.0
        return s

    # -- synchronisation ----------------------------------------------------
    # Each synchronisation message is priced as one event handoff (record +
    # wait).  On one card stream order already orders the ops, so this is
    # what the protocol's messages cost once ranks run on their own streams
    # or cards; the fence-vs-PSCW decision does not depend on the constant.
    def p_fence(self, p: int) -> float:
        """Dissemination barrier: ceil(log2 p) stages."""
        return self.hw.event_latency * max(1, math.ceil(math.log2(max(p, 2))))

    def p_post(self, k: int) -> float:
        return self.hw.event_latency * k

    def p_complete(self, k: int) -> float:
        return self.hw.event_latency * k

    def p_start(self) -> float:
        return self.hw.event_latency

    def p_wait(self) -> float:
        return self.hw.event_latency

    def p_pscw(self, k: int) -> float:
        """post + complete + start + wait: 2k + 2 handoffs, counted in whole
        messages so a tie with the fence stays a tie."""
        return self.hw.event_latency * (2 * k + 2)

    def p_lock_shared(self) -> float:
        """One atomic increment of the reader count: one small kernel."""
        return self.hw.launch_latency

    def p_unlock(self) -> float:
        return self.hw.launch_latency

    def select_sync_mode(self, k: int, p: int) -> Literal["pscw", "fence"]:
        """Paper §6: PSCW iff P_post + P_complete + P_start + P_wait < P_fence."""
        return "pscw" if self.p_pscw(k) < self.p_fence(p) else "fence"

    # -- collective schedules (composed from the primitives) ----------------
    def ring_all_gather(self, shard_bytes: float, n: int,
                        bidirectional: bool = True) -> float:
        """The ring's puts, each moving every rank's shard on the card:
        n - 1 of them, or two per step over ceil((n - 1) / 2) steps."""
        puts = 2 * math.ceil((n - 1) / 2) if bidirectional else n - 1
        return puts * self.p_put(n * shard_bytes)

    def ring_reduce_scatter(self, shard_bytes: float, n: int) -> float:
        """n - 1 ring steps, each a put and the owner's add."""
        return (n - 1) * self.p_accumulate(n * shard_bytes)

    def all_reduce(self, nbytes: float, n: int) -> float:
        """Reduce-scatter then all-gather of `nbytes` a rank over n ranks."""
        shard = nbytes / n
        return self.ring_reduce_scatter(shard, n) + self.ring_all_gather(shard, n)


DEFAULT_MODEL = PerfModel()
