"""Model-guided strategy selection and the bucketed gradient sync (the
`repro.parallel.overlap` counterpart).

1. `CollectiveStrategist` asks `core.perfmodel.PerfModel` (H100 constants)
   which synchronisation family an epoch should use, whether a plan should
   pack a group and on which backend it runs, which KV transfer protocol a
   serving block should take, whether a sparse exchange goes through the
   queue or one all-to-all, whether an FSDP contraction runs as the fused
   ring matmul (`kernels.ring_matmul`) or as an all-gather followed by a
   matmul, and whether an all-reduce over a (pod, data) grid runs as one
   flat ring or hierarchically.

2. `overlapped_grad_sync` reduces a gradient tree bucket by bucket over a
   mesh's named axes: each bucket's leaves go through
   `core.collectives.hierarchical_all_reduce` (or one ring over the inner
   axis), and every bucket closes with `core.epoch.flush`, so the sync
   ledger counts one flush a bucket.  PyTorch runs eagerly in stream order,
   so the buckets run one after another; the bucketing keeps the
   reference's epoch boundaries and ledger.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal, Optional

from ..ckpt.checkpoint import _unflatten_like, flatten
from ..core import collectives, epoch as epoch_mod
from ..core import plan as plan_mod
from ..core.epoch import SyncStats
from ..core.perfmodel import DEFAULT_MODEL, PerfModel
from ..mesh import Mesh
from ..train.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class CollectiveStrategist:
    model: PerfModel = DEFAULT_MODEL

    def allgather_matmul_plan(self, m: int, k: int, n: int, shards: int,
                              dtype_bytes: int = 2) -> Literal["unfused", "fused_ring"]:
        """Y = x [m, k] @ W [k, n], W sharded on k over `shards` ranks: the
        fused ring kernel (`PerfModel.p_ring_matmul`) iff its price is
        below the all-gather then GEMM's (`p_allgather_matmul`), both
        priced from what the card measured.  On one card the all-gather is
        one short HBM copy while the ring forwards W once a 128-row tile of
        m, so the fused arm wins only where W's copies outweigh its ring: a
        few tokens against a large W.  No code path of the package acts on
        the answer yet (the port runs no sharded contraction);
        chip_smoke.py's ring phase holds it to both arms measured."""
        fused = self.model.p_ring_matmul(m, k, n, shards, dtype_bytes)
        unfused = self.model.p_allgather_matmul(m, k, n, shards, dtype_bytes)
        return "fused_ring" if fused < unfused else "unfused"

    def allreduce_plan(self, nbytes: float, pods: int, per_pod: int
                       ) -> Literal["flat_ring", "hierarchical"]:
        return self.model.select_allreduce(nbytes, pods, per_pod)

    def backend_plan(self, nbytes: float, shift_eligible: bool = True
                     ) -> Literal["torch", "cuda"]:
        """A plan group's backend: the mesh's indexing collectives or the
        put kernel of `kernels.rma` (`core.plan.choose_backend`)."""
        return plan_mod.choose_backend(self.model, nbytes, shift_eligible)

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


# ----------------------------------------------------- gradient-sync overlap
def bucket_grads(grads: Any, bucket_bytes: int = 32 * 2**20,
                 mesh: Optional[Mesh] = None) -> list[list]:
    """Greedy size-bucketing of the gradient leaves (the reduction
    granularity): leaf indices in `tree_leaves` order.  A leaf's size is
    its bytes a rank: the whole tensor, or over `mesh` one rank's block,
    the leaf over the rank blocks it holds (every rank's of the stacked
    global view; on a `ProcMesh` the leaf is this rank's own block)."""
    ranks = 1 if mesh is None else mesh.local_ranks
    buckets, cur, cur_bytes = [], [], 0
    for i, g in enumerate(tree_leaves(grads)):
        nb = g.numel() // ranks * g.element_size()
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def overlapped_grad_sync(grads: Any, mesh: Mesh, inner_axis: str = "data",
                         outer_axis: Optional[str] = "pod",
                         bucket_bytes: int = 32 * 2**20,
                         compress_outer: bool = False,
                         stats: Optional[SyncStats] = None) -> Any:
    """Sum a tree of stacked gradients ``[ranks..., ...]`` over `mesh`
    (over a grid `ProcMesh`, this rank's ``[1, 1, ...]`` blocks), bucket by
    bucket: every leaf of a bucket through
    `collectives.hierarchical_all_reduce` (`inner_axis` in the pod,
    `outer_axis` across pods), or through one ring over `inner_axis` when
    `outer_axis` is None.  Every bucket boundary is an `epoch.flush`
    (MPI_Win_flush), so the sync ledger sees one flush a bucket (pass
    `stats` or open a `SyncStats` scope to collect them).

    `compress_outer` is accepted and, as in the reference, not applied: the
    cross-pod hop always carries f32 (ROADMAP §3; `parallel.compression`
    is the round trip a caller would place around it)."""
    paths, leaves = zip(*flatten(grads))     # `tree_leaves`'s order
    out = list(leaves)
    for bucket in bucket_grads(grads, bucket_bytes, mesh):
        for i in bucket:
            if outer_axis is not None:
                out[i] = collectives.hierarchical_all_reduce(leaves[i], mesh, inner_axis,
                                                             outer_axis)
            else:
                out[i] = collectives.all_reduce(leaves[i], mesh, axis=inner_axis)
        # the bucket boundary: flush the epoch before the next bucket
        pinned = epoch_mod.flush(tuple(out[i] for i in bucket), stats=stats, mesh=mesh)
        for j, i in enumerate(bucket):
            out[i] = pinned[j]
    return _unflatten_like(grads, dict(zip(paths, out)))
