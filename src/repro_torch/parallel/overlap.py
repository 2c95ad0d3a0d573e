"""Model-guided strategy selection: the `repro.parallel.overlap`
`CollectiveStrategist`, for the decisions the one-card model can price.

It asks `core.perfmodel.PerfModel` (H100 constants) which synchronisation
family an epoch should use, whether a plan should pack a group, which KV
transfer protocol a serving block should take, whether a sparse exchange
goes through the queue or one all-to-all, and whether an FSDP contraction
runs as the fused ring matmul (`kernels.ring_matmul`) or as an all-gather
followed by a matmul.  The reference's other choices wait for a second
rank axis (ROADMAP item 12): hierarchical all-reduce, the backend choice,
and the bucketed gradient-sync overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from ..core.perfmodel import DEFAULT_MODEL, PerfModel


@dataclasses.dataclass(frozen=True)
class CollectiveStrategist:
    model: PerfModel = DEFAULT_MODEL

    def allgather_matmul_plan(self, m: int, k: int, n: int, shards: int,
                              dtype_bytes: int = 2) -> Literal["unfused", "fused_ring"]:
        """Fuse iff the per-step matmul hides the per-step put (overlap
        §3.1.1): the step's product of x [m, k/shards] with a W shard
        [k/shards, n] at the bf16 peak, against half the put of that shard."""
        shard_bytes = k * n * dtype_bytes / shards
        t_put = self.model.p_put(shard_bytes)
        t_mm = 2.0 * m * (k / shards) * n / self.model.hw.peak_flops_bf16
        return "fused_ring" if t_mm >= 0.5 * t_put else "unfused"

    def sync_plan(self, k_neighbors: int, p: int) -> Literal["pscw", "fence"]:
        return self.model.select_sync_mode(k_neighbors, p)

    def dispatch_plan(self, n_msgs: int, msg_bytes: float, p: int,
                      capacity_per_pair: int) -> Literal["queue", "alltoall"]:
        """Sparse-exchange dispatch (DSDE, MoE): per-message notified puts
        through an rmaq queue vs the dense capacity-padded all-to-all."""
        return self.model.select_dispatch(n_msgs, msg_bytes, p, capacity_per_pair)

    def aggregation_plan(self, n_msgs: int, msg_bytes: float
                         ) -> Literal["pack", "direct"]:
        """Pack a same-signature group into one transfer, or not."""
        return self.model.select_aggregation(n_msgs, msg_bytes)

    def transfer_plan(self, block_bytes: float, pages_per_block: int,
                      reuse_fraction: float = 0.0) -> dict:
        """KV-block transfer protocol — eager push through the ring,
        rendezvous descriptor + consumer pull, or the paged table — with
        the modelled per-append times and the eager/rendezvous crossover,
        so callers can log the decision."""
        m = self.model
        return {
            "protocol": m.select_transfer_protocol(
                block_bytes, pages_per_block, reuse_fraction),
            "eager_s": m.p_append_eager(block_bytes),
            "rendezvous_s": m.p_append_rendezvous(block_bytes, pages_per_block),
            "paged_s": m.p_append_paged_e2e(
                block_bytes, pages_per_block, reuse_fraction),
            "crossover_bytes": m.rendezvous_crossover_bytes(pages_per_block),
        }
