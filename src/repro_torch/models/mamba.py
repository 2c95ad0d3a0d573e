"""Mamba (selective SSM) block: the prefill through the selective-scan
kernel and the O(1) recurrent decode (Jamba's sequence mixer; the
counterpart of `repro.models.mamba`).

Recurrence (per channel c, state dim N):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t
    y_t = C_t . h_t + D x_t

The reference's prefill runs `lax.associative_scan` over time and seeds the
chunked prefill with ``h + d_cum * h0``.  Here `mamba_prefill` hands decay,
drive, C and h0 to `kernels.ssm_scan.ops.selective_scan`, which launches
the CUDA kernel on the card (the recurrence from h0, returning y and the
last state) and runs the plain associative-scan version on the CPU.  The
decode step stays the O(1) state update, as in the reference.

State: ``h`` [B, di, N] f32 and ``conv`` [B, W-1, di], the causal conv's
trailing window of raw inputs (bf16 in the cache, as the reference keeps
it).  The projections run in the activations' dtype; dt, the scan and the
gating in f32; ``A_log`` and ``D_skip`` are f32 leaves.

**Split over a `ProcMesh`'s ``model`` axis** (serving; `parallel.sharding.
tensor_parallel`).  Rank r computes channels [r di/tp, (r + 1) di/tp): its
blocks of ``conv_w``, ``conv_b``, ``dt_bias``, ``D_skip`` and ``out_proj``
and its state (``h`` and ``conv``, the reference's `_cache_specs`) are
those channels.  The reference's fitted specs do not line up with them in
four leaves, and the activation moves instead of the weight:

  * ``in_proj`` [D, 2di] is split on its columns, which hold x ‖ z: at tp
    = 4 rank 0 holds x's first half, rank 2 z's; at tp = 2 rank 0 all of
    x, rank 1 all of z.  Its product is all-gathered over ``model``
    (`ShardingPolicy.all_gather`) and the rank takes its channels of x
    and of z;
  * ``x_proj`` [di, R + 2N] is split on di, the contraction: the product
    is a partial sum, which one all-reduce completes ([B, S, R + 2N]);
  * ``dt_proj`` [R, di] is split on R and ``A_log`` [di, N] on N (the
    reference's spec ``P("model",)`` is padded at the front).  Each rank's
    partial dt of every channel (its R rows) and its N columns of
    ``A_log`` go, a channel block to its owner, in one all-to-all
    (`ShardingPolicy.all_to_all`); the owner sums the partials (a
    reduce-scatter of [B, S, di] in f32) and joins the N blocks.  Gathering
    ``dt_proj``'s R blocks instead would move a weight (4 MiB a layer at
    full width in bf16) to save an activation that a decode step keeps
    small ([B, 1, di]), and it would put a whole weight on every rank;
  * ``out_proj``'s rows are the rank's channels: a partial sum, one
    all-reduce.

The scan runs on the rank's [B, S, di/tp, N] through the kernel, so a
Mamba layer is four collectives over ``model`` (the collectives' puts the
peer kernels' on the card).  A leaf that `fit_spec` keeps whole (R or N
that ``model`` does not divide) is sliced to the rank's channels instead.
Training the split is ROADMAP item 12c.5b: the all-gather's backward is a
slice, not this use's sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ops as ssm_ops
from ..parallel.sharding import ShardingPolicy, shard, tensor_parallel
from . import layers as L


def init_mamba(gen, d_model: int, expand: int = 2, state_dim: int = 16,
               conv_width: int = 4, dtype=torch.bfloat16, device=None, lead=()) -> dict:
    """The reference's leaves and scales (S4D-real A); `lead` prepends
    stacked-layer axes."""
    lead = tuple(lead)
    di = expand * d_model
    dt_rank = max(d_model // 16, 1)
    s, si = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(di)
    n = L._normal
    A = torch.arange(1, state_dim + 1, dtype=torch.float32, device=device)
    dt_bias = math.log(math.expm1(0.01))                    # softplus^-1(0.01)
    return {
        "in_proj": n(gen, lead + (d_model, 2 * di), s, dtype, device),
        "conv_w": n(gen, lead + (conv_width, di), si, dtype, device),
        "conv_b": torch.zeros(*lead, di, dtype=dtype, device=device),
        "x_proj": n(gen, lead + (di, dt_rank + 2 * state_dim), si, dtype, device),
        "dt_proj": n(gen, lead + (dt_rank, di), 1.0 / math.sqrt(dt_rank), dtype, device),
        "dt_bias": torch.full((*lead, di), dt_bias, dtype=dtype, device=device),
        "A_log": torch.log(A).expand(*lead, di, state_dim).contiguous(),
        "D_skip": torch.ones(*lead, di, dtype=torch.float32, device=device),
        "out_proj": n(gen, lead + (di, d_model), si, dtype, device),
    }


class _Channels(NamedTuple):
    """A rank's Mamba channels under a model split over processes: the
    policy, its first channel and count, and the model's d_inner and
    state size."""
    tp: ShardingPolicy
    c0: int
    dc: int
    di: int
    N: int


def _channels(params: dict, D: int, d_inner: Optional[int],
              state_dim: Optional[int]) -> Optional[_Channels]:
    """This rank's channels under a model split (None without one)."""
    tp = tensor_parallel()
    if tp is None:
        return None
    if d_inner is None or state_dim is None:
        raise ValueError("a Mamba layer under a model split over processes needs d_inner= "
                         "and state_dim=")
    W = params["conv_w"].shape[0]
    if not L._is_split(tp, "conv_w", params["conv_w"], (W, d_inner), 1):
        raise NotImplementedError(f"{d_inner} Mamba channels over {tp.tp} model ranks do not "
                                  "split evenly")
    dc = d_inner // tp.tp
    return _Channels(tp, tp.model_rank * dc, dc, d_inner, state_dim)


def _xz(params: dict, xin: torch.Tensor, ch: Optional[_Channels]):
    """The in-projection's x and z of this rank's channels.  ``in_proj``'s
    block is a block of the concatenated x ‖ z columns, not this rank's
    channels of each: its product is all-gathered over ``model``."""
    D = xin.shape[-1]
    xz = shard(torch.einsum("bsd,de->bse", xin, params["in_proj"]), "act_btf")
    if ch is None:
        di = params["conv_w"].shape[1]
        return xz[..., :di], xz[..., di:]
    if L._is_split(ch.tp, "in_proj", params["in_proj"], (D, 2 * ch.di), 1):
        xz = ch.tp.all_gather(xz, dim=-1)
    lo, hi = ch.c0, ch.c0 + ch.dc
    return xz[..., lo:hi], xz[..., ch.di + lo:ch.di + hi]


def _dt_and_A(params: dict, dtr: torch.Tensor, ch: Optional[_Channels]):
    """(the dt projection before its bias, f32; A_log) for this rank's
    channels.  Under a split ``dt_proj`` [R, di] may be split on R and
    ``A_log`` [di, N] on N: each rank's partial dt of every channel
    (its R rows) and its N columns of ``A_log`` for every channel go, a
    channel block to the rank that owns it, in one all-to-all over
    ``model``; the rank sums the dt partials (a reduce-scatter) and joins
    the N blocks.  A leaf whose fit keeps it whole is sliced instead."""
    if ch is None:
        return (torch.einsum("bsr,rd->bsd", dtr, params["dt_proj"]).float(), params["A_log"])
    tp, c0, dc, di, N = ch
    B, S, R = dtr.shape
    lo, hi = c0, c0 + dc
    sends, dt, A_log = [], None, None
    if L._is_split(tp, "dt_proj", params["dt_proj"], (R, di), 0):
        r0, rn = tp.model_rank * (R // tp.tp), R // tp.tp
        part = torch.einsum("bsr,rd->bsd", dtr[..., r0:r0 + rn], params["dt_proj"]).float()
        sends.append(part.unflatten(-1, (tp.tp, dc)).movedim(-2, 0).reshape(tp.tp, -1))
    else:
        dt = torch.einsum("bsr,rd->bsd", dtr, params["dt_proj"][:, lo:hi]).float()
    if L._is_split(tp, "A_log", params["A_log"], (di, N), 1):
        sends.append(params["A_log"].float().unflatten(0, (tp.tp, dc)).reshape(tp.tp, -1))
    else:
        A_log = params["A_log"][lo:hi]
    if sends:
        got = tp.all_to_all(torch.cat(sends, dim=1))          # [tp (source), ...]
        if dt is None:
            n = B * S * dc
            dt, got = got[:, :n].sum(0).view(B, S, dc), got[:, n:]
        if A_log is None:
            A_log = got.view(tp.tp, dc, N // tp.tp).movedim(0, 1).reshape(dc, N)
    return dt, A_log


def _ssm_inputs(params: dict, xin: torch.Tensor, conv_state: Optional[torch.Tensor],
                ch: Optional[_Channels] = None):
    """In-projection, conv and projections: xin [B,S,D] -> (x, z, dt, Bm,
    Cm, A_log, conv state), of this rank's channels under a split (`ch`).

    `conv_state` [B, W-1, di] seeds the causal conv window (None = zeros);
    the returned conv state is the trailing window of raw inputs.  Under a
    split ``x_proj`` [di, R+2N] is split on di, the contraction: its
    product is a partial sum that one all-reduce over ``model`` completes."""
    x, z = _xz(params, xin, ch)
    di = x.shape[-1]
    W = params["conv_w"].shape[0]
    B, S = x.shape[0], x.shape[1]
    if conv_state is None:
        prefix = torch.zeros(B, W - 1, di, dtype=x.dtype, device=x.device)
    else:
        prefix = conv_state.to(x.dtype)
    xp = torch.cat([prefix, x], dim=1)                       # [B, S+W-1, di]
    new_conv = xp[:, S:]                                     # the last W-1 rows
    x = sum(xp[:, i:i + S] * params["conv_w"][i] for i in range(W))
    x = F.silu(x + params["conv_b"])

    proj = torch.einsum("bsd,de->bse", x, params["x_proj"])
    if ch is None:
        R = params["dt_proj"].shape[0]
        N = (proj.shape[-1] - R) // 2
    else:
        proj = ch.tp.all_reduce(proj)
        N = ch.N
        R = proj.shape[-1] - 2 * N
    Bm = proj[..., R:R + N].float()                          # [B,S,N]
    Cm = proj[..., R + N:].float()
    dt, A_log = _dt_and_A(params, proj[..., :R], ch)
    dt = F.softplus(dt + params["dt_bias"].float())          # [B,S,di]
    return x, z, dt, Bm, Cm, A_log, new_conv


def _gate_out(params: dict, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    y = y + params["D_skip"] * x.float()
    return (y * F.silu(z.float())).to(dtype)


def _out(params: dict, y: torch.Tensor, ch: Optional[_Channels]) -> torch.Tensor:
    """``out_proj`` [di, D], its rows this rank's channels under a split: a
    partial sum that one all-reduce over ``model`` completes."""
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    return out if ch is None else ch.tp.all_reduce(out)


def mamba_prefill(params: dict, xin: torch.Tensor, state: Optional[dict],
                  d_inner: Optional[int] = None, state_dim: Optional[int] = None):
    """[B,S,D] -> ([B,S,D], new state).  With `state` the scan is seeded by
    its h and conv window (the chunked prefill) and the new state is
    returned; without, fresh zeros and None.  Under a model split over
    processes `d_inner` and `state_dim` are the model's, and the state is
    this rank's block of the channels."""
    ch = _channels(params, xin.shape[-1], d_inner, state_dim)
    x, z, dt, Bm, Cm, A_log, conv_out = _ssm_inputs(
        params, xin, state["conv"] if state is not None else None, ch)
    A = -torch.exp(A_log)                                    # [di, N]
    decay = torch.exp(dt[..., None] * A)                     # [B,S,di,N]
    drive = (dt * x.float())[..., None] * Bm[:, :, None, :]  # [B,S,di,N]
    y, h_last = ssm_ops.selective_scan(decay, drive, Cm,
                                       state["h"] if state is not None else None)
    y = _gate_out(params, y, x, z, xin.dtype)
    out = shard(_out(params, y, ch), "act_btd")
    return out, ({"h": h_last, "conv": conv_out} if state is not None else None)


def mamba_forward(params: dict, xin: torch.Tensor, d_inner: Optional[int] = None,
                  state_dim: Optional[int] = None) -> torch.Tensor:
    """Training: [B,S,D] -> [B,S,D] (stateless)."""
    return mamba_prefill(params, xin, None, d_inner, state_dim)[0]


def init_mamba_state(batch: int, d_model: int, expand: int, state_dim: int,
                     conv_width: int, dtype=torch.bfloat16, device=None, lead=()) -> dict:
    di = expand * d_model
    return {
        "h": torch.zeros(*lead, batch, di, state_dim, dtype=torch.float32, device=device),
        "conv": torch.zeros(*lead, batch, conv_width - 1, di, dtype=dtype, device=device),
    }


def mamba_decode(params: dict, xin: torch.Tensor, state: dict,
                 d_inner: Optional[int] = None,
                 state_dim: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """One-token step: xin [B,1,D] -> ([B,1,D], new state); under a model
    split as `mamba_prefill`."""
    ch = _channels(params, xin.shape[-1], d_inner, state_dim)
    x, z, dt, Bm, Cm, A_log, conv = _ssm_inputs(params, xin, state["conv"], ch)
    A = -torch.exp(A_log)
    decay = torch.exp(dt[:, 0, :, None] * A)                 # [B,di,N]
    drive = (dt[:, 0] * x[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = state["h"] * decay + drive
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = _gate_out(params, y, x[:, 0], z[:, 0], xin.dtype)
    out = (y @ params["out_proj"])[:, None]
    if ch is not None:
        out = ch.tp.all_reduce(out)
    return out, {"h": h, "conv": conv}
