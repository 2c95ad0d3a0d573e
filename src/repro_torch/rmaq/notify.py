"""Put-with-notification primitives (the `repro.rmaq.notify` counterpart
over the stacked rank axis).

A *notified put* moves a payload with a one-sided put and, in the same
epoch, accumulates a per-target notification counter, so the target learns
"k messages arrived" without a two-sided message.  Payload and doorbell are
recorded into ONE epoch-scoped `RmaPlan` and flushed as a single fused
transfer: the counter rides the payload's wire message, so payload
visibility implies counter visibility by construction.  The kernel form of
the same primitives is `repro_torch.kernels.rmaq` (payload and count word
in one launch).

Every tensor is the global view ``[p, ...]``; on a `ProcMesh` (one rank a
process) its leading dim is this process's rank block (``[1, ...]``), and
every result is this rank's row of the stacked one.  Notification counters are
uint32 in the reference; here they are int64 holding uint32 values (as the
queue's counters are) and travel as 32-bit words, so the wire bytes match.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..core import plan as plan_mod
from ..core.plan import U32_MASK, u32_from_wire
from ..core.rma import OpCounter
from ..mesh import Mesh


def _doorbell(mesh: Mesh) -> torch.Tensor:
    """Each of this process's ranks' uint32 1, in its 4-byte wire form."""
    return torch.ones(mesh.local_ranks, dtype=torch.int32, device=mesh.device)


# ------------------------------------------------------------ notified puts
def notified_put_shift(x: torch.Tensor, counter: torch.Tensor, shift: int,
                       mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Put rank r's block of `x` to rank (r + shift) mod p and bump the
    target's message counter.

    Returns (payload delivered into each rank, each rank's counter plus the
    messages that arrived).  The doorbell is the accumulate half of the
    notified put and shares the payload's fused wire transfer: one put and
    one accumulate, the cost `PerfModel.p_notified_put` charges."""
    pl = plan_mod.RmaPlan(mesh)
    h_pay = pl.put_shift(x, shift, kind="puts")
    h_bell = pl.put_shift(_doorbell(mesh), shift, kind="accs")   # doorbell rider
    pl.flush(aggregate=True)
    return h_pay.result(), (counter + u32_from_wire(h_bell.result())) & U32_MASK


def notified_put_perm(x: torch.Tensor, counter: torch.Tensor,
                      perm: Sequence[tuple[int, int]],
                      mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Notified put along an arbitrary (src, dst) permutation.  Ranks that
    are not a destination observe zero payload and an unchanged counter."""
    pl = plan_mod.RmaPlan(mesh)
    h_pay = pl.put_perm(x, perm, kind="puts")
    h_bell = pl.put_perm(_doorbell(mesh), perm, kind="accs")     # doorbell rider
    pl.flush(aggregate=True)
    return h_pay.result(), (counter + u32_from_wire(h_bell.result())) & U32_MASK


def accumulate_counts(send_counts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Notification-counter exchange: rank r accumulates ``send_counts[r, t]``
    into rank t's counter window.  send_counts [p(src), p(dst)] -> [p(dst),
    p(src)]: who notified each rank, how many times (MPI_Accumulate on an
    int window by the slotted protocol: one all-to-all of counters)."""
    pl = plan_mod.RmaPlan(mesh)
    h = pl.put_all_to_all(send_counts, kind="accs")
    pl.flush()
    return h.result()


def fetch_and_add_ordered(x: torch.Tensor, mesh: Mesh
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-ordered MPI_Fetch_and_op on a shared counter.

    Every rank contributes ``x[r]``; serialisation is the epoch's rank
    order, so rank r fetches the exclusive prefix sum over lower ranks.
    Returns (old value of each of this process's ranks [R, ...], total
    [R, ...]): the queue's slot reservation, computed from one counter
    gather."""
    pl = plan_mod.RmaPlan(mesh)
    h = pl.all_gather(x, kind="gets")                # counter window read
    pl.flush()
    all_x = mesh.replicated(h.result())              # [p, ...]
    prefix = (torch.cumsum(all_x, dim=0, dtype=x.dtype) - all_x)[mesh.axis_index()]
    OpCounter.record("accs", axis=mesh.axis)
    total = all_x.sum(dim=0, dtype=x.dtype)
    return prefix, total.expand_as(x)


def fetch_credits(published: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One-sided read of every rank's published credit block:
    published [R, ...] -> [R(reader), p(owner), ...].

    This is the standalone refresh of an idle sender; on the hot path the
    refresh rides the enqueue epoch's reservation gather instead
    (`queue.enqueue_epoch`'s `reserve_riders`) at zero marginal transfers —
    `PerfModel.p_credit_refresh(fused=True)`."""
    pl = plan_mod.RmaPlan(mesh)
    h = pl.all_gather(published, kind="gets")
    pl.flush()
    return h.result()


def wait_notifications(tree: Any, counter: torch.Tensor, expected
                       ) -> tuple[Any, torch.Tensor]:
    """Epoch close for the notified-access pattern: returns (tree, counter
    >= expected).

    The reference also pins `tree` behind an XLA optimization barrier so the
    compiler cannot hoist an RMA op past the check.  Eager PyTorch has no
    such reordering to prevent: every op that carried the puts was issued,
    in program order on one stream, before this call, so the wait is the
    counter predicate alone."""
    return tree, counter >= expected
