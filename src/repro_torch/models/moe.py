"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch (the
counterpart of `repro.models.moe`).

Expert parallelism is the paper's DSDE motif (§4.2): tokens are items,
experts are targets.  Tokens are bucketed into per-expert slot ranges (the
slotted one-sided accumulate), the experts run on their slot buffers, and
each token sums its k gate-weighted results in the router's order (the
reference scatter-adds them; a sum in a fixed order repeats bit for bit on
the card, where a scatter-add's atomics do not); `core.dsde.moe_dispatch`
and `moe_combine` run the same exchange explicitly on the rank axis.

Grouped dispatch: under an active `parallel.sharding` policy the tokens
are split into G dispatch groups, one a data shard (`_n_groups`: the pod x
data size, halved until it divides B), and each group is routed, capped
and dropped on its own, as the reference does; capacity is per group, so
a policy changes which tokens drop.  With no policy G = 1.  The
reference's placement constraints change no value on one card.

Under a policy that splits the model over processes
(`parallel.sharding.tensor_parallel`) the experts are tensor-parallel, as
the reference's fitted specs place them: every rank holds every expert's
block of F (``w_in`` / ``w_gate`` [E, D, F / tp], ``w_out`` [E, F / tp,
D]) and the whole router.  Each rank routes every one of its tokens with
the whole router (its input is a ring all-reduce's output, the same bits
on every rank, so every rank routes alike), dispatches every slot
locally, runs its slice of F (SwiGLU acts column by column, so a slice is
exact), combines its partial output in f32, adds the shared expert's
partial, and one ring all-reduce over ``model`` sums them.  The dispatch
groups are the reference's over the GLOBAL batch (`dispatch_groups`):
where a rank's rows are its data shard they are G / (data blocks) of
them, so the caller gives the global row count (``rows``).  The losses
and the drop fraction are then those of the rank's rows, a share of the
batch's, and are returned as None.  Routing follows the reference
exactly, since a different tie-break moves a token to another expert:

  * top-k by a stable descending sort: ties go to the lower expert index,
    as `lax.top_k` breaks them;
  * the dispatch order is a stable sort by expert, and a token's position
    in its expert's range is its index minus the first of its expert
    (`searchsorted(side="left")`);
  * capacity ``max(int(cf * T * k / E), 4, min(T, 16))`` over the T tokens
    of a group; items past it go to an overflow row and are dropped (they
    fall through on the residual path).

The router, its softmax and the losses are f32; the experts run in the
activations' dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import ShardingPolicy, current_policy, tensor_parallel
from . import layers as L


class MoEMetrics(NamedTuple):
    """Each None where a split's rank routes a share of the batch."""
    aux_loss: Optional[torch.Tensor]        # load-balance loss (Switch-style)
    router_z_loss: Optional[torch.Tensor]
    drop_fraction: Optional[torch.Tensor]


class Routing(NamedTuple):
    """One call's routing, in the dispatch (expert-sorted) order."""

    logits: torch.Tensor          # [T, E] f32 router logits
    probs: torch.Tensor           # [T, E] f32
    expert_idx: torch.Tensor      # [T, k] int64, the top-k experts of each token
    gate: torch.Tensor            # [T, k] f32, renormalised over the top k
    slot: torch.Tensor            # [T*k] int64, E*cap for a dropped item
    src: torch.Tensor             # [T*k] int64, the token of each item
    s_gate: torch.Tensor          # [T*k] f32, the gate of each item
    ok: torch.Tensor              # [T*k] bool, within capacity
    capacity: int
    order: torch.Tensor           # [T*k] int64, each item's index in token-major order


def init_moe(gen, d_model: int, n_experts: int, d_ff: int, mlp_type: str = "swiglu",
             shared_ff: int = 0, dtype=torch.bfloat16, device=None, lead=()) -> dict:
    """The reference's leaves and scales; `lead` prepends stacked-layer
    axes.  The router stays f32 whatever `dtype` is."""
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    n = L._normal
    p = {
        "router": n(gen, lead + (d_model, n_experts), s_in, torch.float32, device),
        "experts": {
            "w_in": n(gen, lead + (n_experts, d_model, d_ff), s_in, dtype, device),
            "w_out": n(gen, lead + (n_experts, d_ff, d_model), s_out, dtype, device),
        },
    }
    if mlp_type == "swiglu":
        p["experts"]["w_gate"] = n(gen, lead + (n_experts, d_model, d_ff), s_in, dtype,
                                   device)
    if shared_ff:
        p["shared"] = L.init_mlp(gen, d_model, shared_ff, mlp_type, dtype, device, lead)
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Slots an expert; the floor of min(T, 16) keeps short calls dropless."""
    return max(int(capacity_factor * n_tokens * top_k / n_experts), 4, min(n_tokens, 16))


def select_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k`: the k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: dict, xt: torch.Tensor, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """Router, top-k and the sort dispatch of xt [T, D]."""
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    return sort_dispatch(logits, probs, select_top_k(probs, top_k)[1], capacity_factor)


def sort_dispatch(logits: torch.Tensor, probs: torch.Tensor, expert_idx: torch.Tensor,
                  capacity_factor: float = 1.25) -> Routing:
    """The dispatch of the chosen experts [T, k]: their probabilities
    renormalised over the k as gates, a stable sort by expert, each item's
    position in its expert's range, and its slot (E * cap past capacity)."""
    T, top_k = expert_idx.shape
    E = probs.shape[1]
    gate = probs.gather(-1, expert_idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(T, top_k, E, capacity_factor)
    flat_e = expert_idx.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_src = torch.arange(T, device=probs.device).repeat_interleave(top_k)
    s_e, order = torch.sort(flat_e, stable=True)
    pos = torch.arange(T * top_k, device=probs.device) - torch.searchsorted(s_e, s_e,
                                                                            side="left")
    ok = pos < cap
    slot = torch.where(ok, s_e * cap + pos, torch.full_like(pos, E * cap))
    return Routing(logits, probs, expert_idx, gate, slot, flat_src[order], flat_g[order],
                   ok, cap, order)


def _n_groups(B: int, pol: Optional[ShardingPolicy] = None) -> int:
    """Dispatch groups: the data shards when a policy (`pol`, else the
    active one) is given (else 1)."""
    pol = pol or current_policy()
    if pol is None:
        return 1
    g = 1
    for ax in ("pod", "data"):
        g *= pol.mesh.shape.get(ax, 1)
    while g > 1 and B % g:
        g //= 2
    return max(g, 1)


def dispatch_groups(tp: ShardingPolicy, b: int, rows: Optional[int]) -> tuple[int, bool]:
    """(the dispatch groups among this rank's `b` rows, whether they are a
    share of the batch) under a model split over processes: the
    reference's G over the global batch of `rows` (`_n_groups`), of which
    a rank's data block holds G / blocks.  Without data axes of more than
    one rank a rank holds the global batch and `rows` is not needed; with
    them it is (a rank's row count cannot tell a split batch from a whole
    one).  A group that would span ranks is refused."""
    if not tp.data_axes:
        return _n_groups(b, tp), False
    if rows is None:
        raise ValueError("an MoE layer under a split with data axes needs the global row "
                         "count (rows=; a cache made by init_cache under the policy keeps it)")
    blocks = tp.row_blocks(rows)
    if b * blocks != rows:
        raise ValueError(f"{b} rows on this rank for a global batch of {rows} in {blocks} "
                         "data blocks")
    g = _n_groups(rows, tp)
    if g % blocks:
        raise NotImplementedError(f"a dispatch group of {rows // g} rows spans {blocks} data "
                                  "blocks of a rank's rows")
    return g // blocks, blocks > 1


def _experts_split(tp: ShardingPolicy, params: dict, d_ff: Optional[int], D: int) -> bool:
    """Whether this rank's experts are its block of F (else whole); whole
    weights where blocks are due are refused (`layers._is_split`)."""
    if d_ff is None:
        raise ValueError("moe_ffn under a model split over processes needs d_ff=")
    E, ex = params["router"].shape[-1], params["experts"]
    for k in ("w_in", "w_gate"):
        if k in ex:
            L._is_split(tp, f"experts/{k}", ex[k], (E, D, d_ff), 2)
    return L._is_split(tp, "experts/w_out", ex["w_out"], (E, d_ff, D), 1)


def _group_ffn(params: dict, xt: torch.Tensor, r: Routing, mlp_type: str) -> torch.Tensor:
    """One group's dispatch, experts and combine: xt [T, D] -> y [T, D] f32."""
    T, D = xt.shape
    E = params["router"].shape[1]
    cap, n_slots = r.capacity, E * r.capacity

    # dispatch: each item to its slot; row n_slots is the overflow row
    disp = torch.zeros(n_slots + 1, D, dtype=xt.dtype, device=xt.device)
    disp[r.slot] = xt[r.src]
    disp = disp[:n_slots].reshape(E, cap, D)

    # the experts on their slot buffers
    ex = params["experts"]
    h = torch.einsum("ecd,edf->ecf", disp, ex["w_in"])
    if mlp_type == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", disp, ex["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, ex["w_out"]).reshape(n_slots, D)

    # combine: each item's gate-weighted output back to its token (f32),
    # dropped items as zeros, summed over the token's k items in the router's
    # order.  No scatter-add: a CUDA index_add_ adds in whatever order its
    # atomics land, so a call would not repeat bit for bit.
    got = out[r.slot.clamp(max=n_slots - 1)].float() * r.s_gate[:, None]
    got = torch.where(r.ok[:, None], got, torch.zeros_like(got))
    per = torch.empty_like(got)
    per[r.order] = got
    return per.reshape(T, -1, D).sum(1)


def moe_ffn(params: dict, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
            mlp_type: str = "swiglu", d_ff: Optional[int] = None,
            shared_ff: Optional[int] = None,
            rows: Optional[int] = None) -> tuple[torch.Tensor, MoEMetrics]:
    """x [B, S, D] -> (y [B, S, D], metrics), in G dispatch groups of
    B * S / G tokens (`_n_groups`); the losses and the drop fraction are
    over every token.  Under a model split over processes the experts' F
    (`d_ff`) and the shared expert's (`shared_ff`) are the model's whole
    sizes, `rows` the global batch (`dispatch_groups`), and y is summed
    over ``model`` by one all-reduce."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    tp = tensor_parallel()
    share = split = False
    if tp is None:
        G = _n_groups(B)
    else:
        G, share = dispatch_groups(tp, B, rows)
        split = _experts_split(tp, params, d_ff, D)
    xt = x.reshape(G, B * S // G, D)
    rs = [route(params, xt[g], top_k, capacity_factor) for g in range(G)]
    # the experts' input enters their split F (the router's use is whole)
    xe = tp.enter(xt) if split else xt
    ys = [_group_ffn(params, xe[g], r, mlp_type) for g, r in enumerate(rs)]

    def cat(ts):
        return ts[0] if G == 1 else torch.cat(ts)

    if share:
        met = MoEMetrics(None, None, None)
    else:
        # aux losses, over all groups
        probs, logits = cat([r.probs for r in rs]), cat([r.logits for r in rs])
        idx, ok = cat([r.expert_idx for r in rs]), cat([r.ok for r in rs])
        n = idx.numel()
        me = probs.mean(0)
        ce = torch.zeros(E, device=x.device).index_add_(
            0, idx.reshape(-1), torch.ones(n, device=x.device)) / n
        met = MoEMetrics(E * torch.sum(me * ce),
                         torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
                         1.0 - ok.float().mean())

    if tp is None:
        y = cat(ys).to(x.dtype).reshape(B, S, D)
        if "shared" in params:
            y = y + L.mlp(params["shared"], x, mlp_type)
        return y, met

    # this rank's partial sum (F split) in f32, the shared expert's partial
    # added, then one all-reduce
    y = cat(ys).reshape(B, S, D)
    if "shared" in params:
        if shared_ff is None:
            raise ValueError("a shared expert under a model split over processes needs "
                             "shared_ff=")
        if tp.splits("shared/w_out", (shared_ff, D), 0) != split:
            raise NotImplementedError("the shared expert's F and the experts' split unlike "
                                      "over `model`")
        y = y + L.mlp(params["shared"], x, mlp_type, shared_ff, reduce=False).float()
    if split:
        y = tp.all_reduce(y)
    return y.to(x.dtype), met
