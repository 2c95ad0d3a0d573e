"""The selective scan: the `repro.kernels.ssm_scan.ops` surface plus the
seeded form the Mamba layers use.

On CPU tensors both entries compute the plain PyTorch version
(`ref.ssm_scan_ref`); on CUDA tensors they launch the hand-written kernel
(``csrc/ssm_scan.cu``) or raise — there is no fallback.  The kernel takes
any S >= 1 and any d (the Pallas kernel asks both to be multiples of its
blocks), a seed h0, and writes the last state.  Where an input needs a
gradient the scan is a `torch.autograd.Function` whose backward recomputes
through the plain version, as `flash_attention` does: no backward kernel
exists.  `launches` counts kernel launches and nothing else, so a run can
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...obs import cost
from .. import common
from .ref import ssm_scan_ref

_NAME = "ssm_scan"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32                  # N: one channel's states share a warp

launches = 0                    # kernel launches by `selective_scan` / `ssm_scan`


_SCAN = common.Entry(_NAME, "ssm_scan_fwd", [_P] * 6 + [ctypes.c_int, _L, _L, _L, ctypes.c_int])


def _check(decay, drive, c, h0) -> None:
    if decay.ndim != 4 or drive.shape != decay.shape:
        raise ValueError(f"ssm_scan takes decay and drive [B,S,d,N] of one shape, got "
                         f"{tuple(decay.shape)}, {tuple(drive.shape)}")
    B, S, d, N = decay.shape
    if tuple(c.shape) != (B, S, N):
        raise ValueError(f"c must be [B,S,N] = {(B, S, N)}, got {tuple(c.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, d, N):
        raise ValueError(f"h0 must be [B,d,N] = {(B, d, N)}, got {tuple(h0.shape)}")
    if S == 0:
        raise ValueError("ssm_scan needs at least one step")
    tensors = [decay, drive, c] + ([] if h0 is None else [h0])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan tensors on several devices: {devices}")


def _launch(decay, drive, c, h0):
    if decay.dtype not in _DTYPES or drive.dtype != decay.dtype:
        raise TypeError(f"the ssm_scan kernel takes bf16 or f32 decay and drive of one "
                        f"dtype, got {decay.dtype}, {drive.dtype}")
    B, S, d, N = decay.shape
    if N > MAX_STATE:
        raise ValueError(f"the ssm_scan kernel takes a state dim N <= {MAX_STATE}, got {N}")
    if B >= 65536:
        raise ValueError(f"the ssm_scan kernel takes B < 65536, got {B}")
    decay, drive = decay.contiguous(), drive.contiguous()
    c = c.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    y = torch.empty(B, S, d, dtype=decay.dtype, device=decay.device)
    h_last = torch.empty(B, d, N, dtype=torch.float32, device=decay.device)
    _SCAN(decay.data_ptr(), drive.data_ptr(), c.data_ptr(),
          None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
          _DTYPES[decay.dtype], B, S, d, N, common.current_stream(decay.get_device()))
    global launches
    launches += 1
    _report(decay, c, h0, y, h_last)
    return y, h_last


def _report(decay, c, h0, y, h_last) -> None:
    """The kernel's bound's counts to a running cost counter: decay and
    drive, c, y, h0 and h_last; the FMA of h, the product with c and the
    sum over N."""
    B, S, d, N = decay.shape
    cost.report_kernel("ssm_scan", 4 * B * S * d * N,
                       2 * B * S * d * N * decay.element_size() + B * S * N * 4
                       + y.nbytes + (0 if h0 is None else B * d * N * 4) + h_last.nbytes,
                       product=False)


def _forward(decay, drive, c, h0):
    if decay.device.type == "cpu":
        return ssm_scan_ref(decay, drive, c, h0)
    if decay.device.type == "meta" and cost.active() is not None:
        return _meta(decay, c, h0)
    if decay.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {decay.device}")
    return _launch(decay, drive, c, h0)


def _meta(decay, c, h0):
    """What a launch would give on meta tensors under a running cost
    counter (`launch.dryrun`): the outputs' shapes, and the kernel's counts
    to the counter.  Nothing runs and nothing is counted as a launch."""
    B, S, d, N = decay.shape
    y = torch.empty(B, S, d, dtype=decay.dtype, device="meta")
    h_last = torch.empty(B, d, N, dtype=torch.float32, device="meta")
    _report(decay, c, h0, y, h_last)
    return y, h_last


class _Scan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    recompute through the plain version and differentiate it."""

    @staticmethod
    def forward(ctx, decay, drive, c, h0):
        ctx.save_for_backward(decay, drive, c, h0)
        return _forward(decay, drive, c, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in ctx.saved_tensors]
        live = [t for t in ins if t is not None]
        with torch.enable_grad():
            y, h_last = ssm_scan_ref(*ins)
        grads = iter(torch.autograd.grad((y, h_last), live, (g_y, g_h)))
        return tuple(None if t is None else next(grads) for t in ins)


def selective_scan(decay: torch.Tensor, drive: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """decay/drive [B,S,d,N], c [B,S,N], h0 [B,d,N] or None (zeros) ->
    (y [B,S,d] in decay's dtype, h_last [B,d,N] f32), with
    ``h_t = decay_t * h_{t-1} + drive_t`` from ``h_{-1} = h0`` and
    ``y_t = sum_N h_t * c_t``."""
    _check(decay, drive, c, h0)
    tensors = (decay, drive, c) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Scan.apply(decay, drive, c, h0)
    return _forward(decay, drive, c, h0)


def ssm_scan(decay: torch.Tensor, drive: torch.Tensor, c: torch.Tensor,
             block_d: int = 256, block_t: int = 128) -> torch.Tensor:
    """The reference's call: y [B,S,d] from a zero state.  `block_d` and
    `block_t` are the Pallas grid's blocks; the result does not depend on
    them and the CUDA kernel has no such blocks."""
    del block_d, block_t
    return selective_scan(decay, drive, c)[0]
