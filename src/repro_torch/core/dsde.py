"""Dynamic Sparse Data Exchange (paper §4.2): the `repro.core.dsde`
counterpart over the stacked rank axis.

DSDE: every rank has items bound for arbitrary targets, and no rank knows
what it will receive.  The paper's winning protocol:

  1. every sender accumulates its per-target item *count* into a counter
     window at each target (MPI_Accumulate, one active-target epoch);
  2. after the epoch each target knows its receive volume and each sender
     its write offsets (the fetch-and-add results);
  3. senders put payloads straight into the target windows; one epoch
     completes the exchange.

Here the counter accumulate, the payload puts and the validity mask are
recorded into ONE epoch-scoped `RmaPlan` (whether it packs them is the H100
model's call: on one card it never does).  Beside it: the reference's
alltoall and reduce-scatter baselines, and the queue-backed exchange over
`rmaq.queue`.  `parallel.overlap.CollectiveStrategist.dispatch_plan`
chooses between the queue and the all-to-all.

Every tensor is the global view: data [p, n, d], targets [p, n]; results
carry a leading rank dim.  The reference's MoE dispatch and combine, which
feed `models/moe`, come with the model-serving slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..mesh import Mesh
from ..rmaq import queue as rq
from . import collectives, plan as plan_mod


class DSDEResult(NamedTuple):
    recv_data: torch.Tensor     # [p, slots, item]  payload each rank received
    recv_valid: torch.Tensor    # [p, slots] bool   which slots hold real items
    recv_counts: torch.Tensor   # [p, p]            items received from each rank
    sent_dropped: torch.Tensor  # [p]               items dropped by the bound


def _send_counts(targets: torch.Tensor, p: int) -> torch.Tensor:
    """[p(src), p(dst)] int32: how many items each rank sends each target."""
    return F.one_hot(targets.long(), p).sum(dim=1, dtype=torch.int32)


# --------------------------------------------------------------- protocols
def exchange_accumulate(data: torch.Tensor, targets: torch.Tensor, mesh: Mesh,
                        capacity_per_pair: int) -> DSDEResult:
    """The paper's protocol: counter accumulate plus one-sided puts.

    Each (origin, target) pair owns a private range of `capacity_per_pair`
    slots in the target window (the slotted accumulate); an item past its
    pair's range is dropped at the origin and counted.  Items are packed in
    target order, program order within a target — the value a fetch-and-add
    would return.

    One difference from the reference: there a dropped item is scattered to
    send slot 0 with slot 0's old value, which overwrites the first item
    bound for rank 0 when that item exists (while its slot stays valid).
    Here a dropped item writes nothing, so every valid slot holds its item.
    """
    p = mesh.p
    cap = capacity_per_pair
    n, d = data.shape[1], data.shape[2]
    dev = data.device
    xplan = plan_mod.RmaPlan(mesh)

    # ---- step 1: per-target counts into each target's counter window
    h_counts = xplan.put_all_to_all(_send_counts(targets, p), kind="accs")

    # ---- step 2: pack items into per-target slot ranges (origin side)
    sorted_tgt, order = torch.sort(targets.long(), dim=1, stable=True)
    sorted_data = torch.gather(data, 1, order[..., None].expand(p, n, d))
    first = torch.searchsorted(sorted_tgt, sorted_tgt, side="left")
    idx_in_group = torch.arange(n, device=dev) - first
    ok = idx_in_group < cap
    dropped = (~ok).sum(dim=1)
    rows = torch.arange(p, device=dev)[:, None].expand(p, n)
    slot = sorted_tgt * cap + idx_in_group
    slots = torch.zeros((p, p * cap, d), dtype=data.dtype, device=dev)
    valid = torch.zeros((p, p * cap), dtype=torch.bool, device=dev)
    slots[rows[ok], slot[ok]] = sorted_data[ok]
    valid[rows[ok], slot[ok]] = True

    # ---- step 3: one-sided puts of each slot range into its target window
    h_recv = xplan.put_all_to_all(slots.reshape(p, p, cap, d), kind="puts")
    h_valid = xplan.put_all_to_all(valid.reshape(p, p, cap), kind=None)
    xplan.flush()
    return DSDEResult(
        recv_data=h_recv.result().reshape(p, p * cap, d),
        recv_valid=h_valid.result().reshape(p, p * cap),
        recv_counts=h_counts.result(),
        sent_dropped=dropped,
    )


def exchange_alltoall_baseline(data: torch.Tensor, targets: torch.Tensor,
                               mesh: Mesh, capacity_per_pair: int) -> DSDEResult:
    """Baseline 1 (paper Fig. 7b "alltoall"): the same packing, always the
    full capacity, after a dense count all-to-all of its own round — the
    message-passing formulation with no one-sided counter trick."""
    res = exchange_accumulate(data, targets, mesh, capacity_per_pair)
    # the extra dense count round (the payload movement is identical)
    collectives.all_to_all(
        torch.zeros((mesh.p, mesh.p), dtype=torch.int32, device=data.device), mesh)
    return res


def exchange_reduce_scatter_baseline(data: torch.Tensor, targets: torch.Tensor,
                                     mesh: Mesh, capacity_per_pair: int) -> DSDEResult:
    """Baseline 2: a reduce-scatter of the counts (each rank learns only its
    receive total), then the personalised sends."""
    totals = mesh.psum_scatter(_send_counts(targets, mesh.p))        # [p, 1]
    res = exchange_accumulate(data, targets, mesh, capacity_per_pair)
    return res._replace(recv_counts=totals.expand_as(res.recv_counts))


def exchange_queue(data: torch.Tensor, targets: torch.Tensor, mesh: Mesh,
                   capacity_per_pair: int) -> DSDEResult:
    """Queue-backed DSDE: items stream into each target's MPSC ring
    (`rmaq.queue`) in one enqueue epoch and each target drains its ring.

    Same contract as `exchange_accumulate`, other layout economics: the
    ring holds the *total* expected receive volume (p * capacity_per_pair,
    rounded up to a power of two), so a rank may take far more than
    `capacity_per_pair` from one hot producer as long as the total fits."""
    p = mesh.p
    d = data.shape[2]
    cap = max(2, p * capacity_per_pair)
    cap = 1 << (cap - 1).bit_length()                 # next power of two
    desc, state = rq.queue_allocate(mesh, cap, (d,), data.dtype)
    state, receipt = rq.enqueue(desc, state, data, targets)
    state, items, valid = rq.drain(desc, state)
    return DSDEResult(
        recv_data=items,
        recv_valid=valid,
        recv_counts=receipt.incoming,
        sent_dropped=receipt.n_dropped,
    )
