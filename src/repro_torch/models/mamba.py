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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ops as ssm_ops
from ..parallel.sharding import shard
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


def _ssm_inputs(params: dict, xz: torch.Tensor, conv_state: Optional[torch.Tensor]):
    """Conv and projections: xz [B,S,2di] -> (x, z, dt, Bm, Cm, conv state).

    `conv_state` [B, W-1, di] seeds the causal conv window (None = zeros);
    the returned conv state is the trailing window of raw inputs."""
    di = params["conv_w"].shape[1]
    x, z = xz[..., :di], xz[..., di:]
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
    R = params["dt_proj"].shape[0]
    N = (proj.shape[-1] - R) // 2
    Bm = proj[..., R:R + N].float()                          # [B,S,N]
    Cm = proj[..., R + N:].float()
    dt = F.softplus(torch.einsum("bsr,rd->bsd", proj[..., :R], params["dt_proj"]).float()
                    + params["dt_bias"].float())             # [B,S,di]
    return x, z, dt, Bm, Cm, new_conv


def _gate_out(params: dict, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    y = y + params["D_skip"] * x.float()
    return (y * F.silu(z.float())).to(dtype)


def mamba_prefill(params: dict, xin: torch.Tensor, state: Optional[dict]):
    """[B,S,D] -> ([B,S,D], new state).  With `state` the scan is seeded by
    its h and conv window (the chunked prefill) and the new state is
    returned; without, fresh zeros and None."""
    xz = shard(torch.einsum("bsd,de->bse", xin, params["in_proj"]), "act_btf")
    x, z, dt, Bm, Cm, conv_out = _ssm_inputs(
        params, xz, state["conv"] if state is not None else None)
    A = -torch.exp(params["A_log"])                          # [di, N]
    decay = torch.exp(dt[..., None] * A)                     # [B,S,di,N]
    drive = (dt * x.float())[..., None] * Bm[:, :, None, :]  # [B,S,di,N]
    y, h_last = ssm_ops.selective_scan(decay, drive, Cm,
                                       state["h"] if state is not None else None)
    y = _gate_out(params, y, x, z, xin.dtype)
    out = shard(torch.einsum("bse,ed->bsd", y, params["out_proj"]), "act_btd")
    return out, ({"h": h_last, "conv": conv_out} if state is not None else None)


def mamba_forward(params: dict, xin: torch.Tensor) -> torch.Tensor:
    """Training: [B,S,D] -> [B,S,D] (stateless)."""
    return mamba_prefill(params, xin, None)[0]


def init_mamba_state(batch: int, d_model: int, expand: int, state_dim: int,
                     conv_width: int, dtype=torch.bfloat16, device=None, lead=()) -> dict:
    di = expand * d_model
    return {
        "h": torch.zeros(*lead, batch, di, state_dim, dtype=torch.float32, device=device),
        "conv": torch.zeros(*lead, batch, conv_width - 1, di, dtype=dtype, device=device),
    }


def mamba_decode(params: dict, xin: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
    """One-token step: xin [B,1,D] -> ([B,1,D], new state)."""
    xz = torch.einsum("bsd,de->bse", xin, params["in_proj"])
    x, z, dt, Bm, Cm, conv = _ssm_inputs(params, xz, state["conv"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt[:, 0, :, None] * A)                 # [B,di,N]
    drive = (dt[:, 0] * x[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = state["h"] * decay + drive
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = _gate_out(params, y, x[:, 0], z[:, 0], xin.dtype)
    out = (y @ params["out_proj"])[:, None]
    return out, {"h": h, "conv": conv}
