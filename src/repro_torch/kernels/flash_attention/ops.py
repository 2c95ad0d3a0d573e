"""Flash attention with the reference's autograd contract (the counterpart of
`repro.kernels.flash_attention.ops`).

`flash_attention(q, k, v, causal)` computes, on CPU tensors, the plain
PyTorch version (`ref.attention_ref`); on CUDA tensors it launches the
hand-written kernel (``csrc/flash_attention.cu``) or raises — there is no
fallback.  The forward is a `torch.autograd.Function` whose backward
recomputes through the plain version, as the reference's custom VJP
recomputes through its oracle: no backward kernel exists.  `launches`
counts the kernel's launches and nothing else, so a run can show that its
path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import common
from .ref import attention_ref

_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)               # the kernel's template instances
MAX_HEAD_DIM = HEAD_DIMS[-1]                # a smaller hd is zero-padded to its instance
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                                # kernel launches by `flash_attention`


def effective_blocks(seq_q: int, seq_k: int, block_q: int = 512,
                     block_k: int = 512) -> tuple[int, int]:
    """Clamp requested block sizes to the sequence lengths (the reference's
    dispatch rule; the CUDA kernel's tiles are fixed at 64 x 64)."""
    return min(block_q, seq_q), min(block_k, seq_k)


def _fn():
    fn = common.load(_NAME).flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,Hq,Sq,hd] and k, v [B,Hkv,Sk,hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(batch, head dim, Hq a multiple of Hkv)")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention tensors on several devices: {devices}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash_attention kernel takes bf16 or f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head dims 1-{MAX_HEAD_DIM} "
                         f"(padded to one of {HEAD_DIMS}), got {hd}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a contiguous head dim in q, k and v")
    out = torch.empty(B, Hq, Sq, hd, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               _DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, hd,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               float(hd ** 0.5), int(causal), stream)
    common.check(rc, _NAME)
    global launches
    launches += 1
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, causal)


class _Flash(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    recompute through the plain version and differentiate it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """[B,Hq,Sq,hd] x [B,Hkv,Sk,hd] -> [B,Hq,Sq,hd] in q's dtype; key t is
    visible to query s iff t <= s + (Sk - Sq) when causal."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal)
    return _forward(q, k, v, causal)
