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
carry a leading rank dim.  On a `ProcMesh` (one rank a process) the
leading dim is this process's one rank block (R = ``mesh.local_ranks``):
data [1, n, d], and a rank's rows are ``arange(R)`` while only the dims a
peer indexes (targets, source ranks, slot ranges) keep p.  Each rank's
results are its row of the stacked run's, bit for bit.  `moe_dispatch` and `moe_combine` are the same
exchange with experts as targets (expert parallelism over the rank axis),
the explicit form of `models.moe.moe_ffn`'s dispatch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mesh import Mesh
from ..rmaq import queue as rq
from . import collectives, plan as plan_mod


class DSDEResult(NamedTuple):
    recv_data: torch.Tensor     # [R, slots, item]  payload each rank received
    recv_valid: torch.Tensor    # [R, slots] bool   which slots hold real items
    recv_counts: torch.Tensor   # [R, p]            items received from each rank
    sent_dropped: torch.Tensor  # [R]               items dropped by the bound


def _send_counts(targets: torch.Tensor, p: int) -> torch.Tensor:
    """[R(src), p(dst)] int32: how many items each rank sends each target.
    Counted by one scatter-add into the [R, p] result: a one-hot [p, n, p]
    form would take p * n * p words (128 GiB at p = 1024, n = 16,384)."""
    counts = torch.zeros((targets.shape[0], p), dtype=torch.int32, device=targets.device)
    return counts.scatter_add_(1, targets.long(),
                               torch.ones(targets.shape, dtype=torch.int32,
                                          device=targets.device))


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
    p, R = mesh.p, mesh.local_ranks
    cap = capacity_per_pair
    n, d = data.shape[1], data.shape[2]
    dev = data.device
    xplan = plan_mod.RmaPlan(mesh)

    # ---- step 1: per-target counts into each target's counter window
    h_counts = xplan.put_all_to_all(_send_counts(targets, p), kind="accs")

    # ---- step 2: pack items into per-target slot ranges (origin side)
    sorted_tgt, order = torch.sort(targets.long(), dim=1, stable=True)
    sorted_data = torch.gather(data, 1, order[..., None].expand(R, n, d))
    first = torch.searchsorted(sorted_tgt, sorted_tgt, side="left")
    idx_in_group = torch.arange(n, device=dev) - first
    ok = idx_in_group < cap
    dropped = (~ok).sum(dim=1)
    rows = torch.arange(R, device=dev)[:, None].expand(R, n)
    slot = sorted_tgt * cap + idx_in_group
    slots = torch.zeros((R, p * cap, d), dtype=data.dtype, device=dev)
    valid = torch.zeros((R, p * cap), dtype=torch.bool, device=dev)
    slots[rows[ok], slot[ok]] = sorted_data[ok]
    valid[rows[ok], slot[ok]] = True

    # ---- step 3: one-sided puts of each slot range into its target window
    h_recv = xplan.put_all_to_all(slots.reshape(R, p, cap, d), kind="puts")
    h_valid = xplan.put_all_to_all(valid.reshape(R, p, cap), kind=None)
    xplan.flush()
    return DSDEResult(
        recv_data=h_recv.result().reshape(R, p * cap, d),
        recv_valid=h_valid.result().reshape(R, p * cap),
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
        torch.zeros((mesh.local_ranks, mesh.p), dtype=torch.int32, device=data.device), mesh)
    return res


def exchange_reduce_scatter_baseline(data: torch.Tensor, targets: torch.Tensor,
                                     mesh: Mesh, capacity_per_pair: int) -> DSDEResult:
    """Baseline 2: a reduce-scatter of the counts (each rank learns only its
    receive total), then the personalised sends."""
    totals = mesh.psum_scatter(_send_counts(targets, mesh.p))        # [R, 1]
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


# -------------------------------------------------------------- MoE dispatch
class MoEDispatch(NamedTuple):
    expert_inputs: torch.Tensor   # [R, local_e, p*cap, d]
    combine_idx: torch.Tensor     # [R, local_e, p*cap] flat source token (src_rank * n_tok + t)
    combine_valid: torch.Tensor   # [R, local_e, p*cap] bool
    gate_weights: torch.Tensor    # [R, local_e, p*cap]


def moe_dispatch(tokens: torch.Tensor, expert_idx: torch.Tensor, gate_w: torch.Tensor,
                 n_experts: int, mesh: Mesh, capacity_factor: float = 1.25) -> MoEDispatch:
    """Expert-parallel token dispatch = DSDE with experts as targets.

    tokens [R, n_tok, d], expert_idx and gate_w [R, n_tok, top_k] (global
    expert ids); each rank owns n_experts / p experts.  Every rank packs
    its (token, expert) items into [p, local_e, cap] slot ranges — a stable
    sort by expert, an item's position in its expert's range from
    `searchsorted`, items past `cap` dropped — and one plan's all-to-all
    (tokens, gates, source indices, validity) moves each range to the rank
    that owns its experts."""
    p, R = mesh.p, mesh.local_ranks
    _, n_tok, d = tokens.shape
    top_k = expert_idx.shape[2]
    local_e = n_experts // p
    cap = int(capacity_factor * n_tok * top_k / n_experts) + 1
    dev = tokens.device

    flat_exp = expert_idx.reshape(R, n_tok * top_k).long()
    flat_gate = gate_w.reshape(R, n_tok * top_k)
    s_exp, order = torch.sort(flat_exp, dim=1, stable=True)
    src = torch.arange(n_tok, device=dev).repeat_interleave(top_k)[order]   # [R, n*k]
    s_tok = torch.gather(tokens, 1, src[..., None].expand(R, n_tok * top_k, d))
    s_gate = torch.gather(flat_gate, 1, order)
    pos = torch.arange(n_tok * top_k, device=dev) - torch.searchsorted(s_exp, s_exp,
                                                                       side="left")
    ok = pos < cap
    n_slots = p * local_e * cap
    # slot layout [p(target rank), local_e, cap]; over-capacity items go to
    # the overflow column n_slots and never clobber a valid slot
    slot = (s_exp // local_e) * (local_e * cap) + (s_exp % local_e) * cap + pos
    slot = torch.where(ok, slot, torch.full_like(slot, n_slots))
    rows = torch.arange(R, device=dev)[:, None]

    def scatter(vals, shape, dtype):
        buf = torch.zeros((R, n_slots + 1) + shape, dtype=dtype, device=dev)
        buf[rows, slot] = vals.to(dtype)
        return buf[:, :n_slots].reshape((R, p, local_e * cap) + shape)

    dplan = plan_mod.RmaPlan(mesh)
    h_t = dplan.put_all_to_all(scatter(s_tok, (d,), tokens.dtype), kind="puts")
    h_g = dplan.put_all_to_all(scatter(s_gate, (), gate_w.dtype), kind=None)
    h_s = dplan.put_all_to_all(scatter(src, (), torch.int32), kind=None)
    h_v = dplan.put_all_to_all(scatter(ok, (), torch.bool), kind=None)
    dplan.flush()

    def regroup(a):     # [R, p_src, local_e*cap, ...] -> [R, local_e, p_src*cap, ...]
        rest = tuple(a.shape[3:])
        return (a.reshape((R, p, local_e, cap) + rest).transpose(1, 2)
                .reshape((R, local_e, p * cap) + rest))

    recv, recv_s = regroup(h_t.result()), regroup(h_s.result())
    src_rank = torch.arange(p, device=dev).repeat_interleave(cap)
    combine_idx = src_rank * n_tok + recv_s.long()
    return MoEDispatch(recv, combine_idx, regroup(h_v.result()), regroup(h_g.result()))


def moe_combine(expert_outputs: torch.Tensor, dispatch: MoEDispatch, n_tok: int,
                mesh: Mesh) -> torch.Tensor:
    """Return the experts' outputs [R, local_e, p*cap, d] to their source
    ranks and combine: the same exchange reversed, then a gate-weighted
    scatter-add into each rank's token buffer (the slotted accumulate).
    Returns [R, n_tok, d]."""
    p, R = mesh.p, mesh.local_ranks
    _, local_e, slots, d = expert_outputs.shape
    cap = slots // p
    dev = expert_outputs.device
    weighted = expert_outputs * dispatch.gate_weights[..., None]
    weighted = torch.where(dispatch.combine_valid[..., None], weighted,
                           torch.zeros_like(weighted))

    def back(a):        # [R, local_e, p_dst*cap, ...] -> [R, p_dst, local_e*cap, ...]
        rest = tuple(a.shape[3:])
        return (a.reshape((R, local_e, p, cap) + rest).transpose(1, 2)
                .reshape((R, p, local_e * cap) + rest))

    cplan = plan_mod.RmaPlan(mesh)
    h_b = cplan.put_all_to_all(back(weighted), kind="puts")
    h_i = cplan.put_all_to_all(back(dispatch.combine_idx % n_tok), kind=None)
    h_v = cplan.put_all_to_all(back(dispatch.combine_valid), kind=None)
    cplan.flush()
    flat = h_b.result().reshape(R, -1, d)
    fidx = h_i.result().reshape(R, -1)
    fval = h_v.result().reshape(R, -1)
    out = torch.zeros(R, n_tok + 1, d, dtype=expert_outputs.dtype, device=dev)
    rows = torch.arange(R, device=dev)[:, None].expand_as(fidx)
    out.index_put_((rows, torch.where(fval, fidx, torch.full_like(fidx, n_tok))), flat,
                   accumulate=True)
    return out[:, :n_tok]

