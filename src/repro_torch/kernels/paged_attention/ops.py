"""Paged attention: the wrapper the serving path calls.

On CPU tensors it computes the plain PyTorch version (`ref`); on CUDA
tensors it launches the hand-written kernel (``csrc/paged_attention.cu``)
or raises — there is no fallback.  The module's `launches` counts kernel
launches (and nothing else), so a run can show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import common
from . import ref

_NAME = "paged_attention"
_MAX_SMEM = 48 * 1024   # static launch limit without an opt-in attribute

launches = 0            # kernel launches by `paged_attention`


def _library() -> ctypes.CDLL:
    lib = common.load(_NAME)
    fn = lib.paged_attention_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(q: torch.Tensor, kv_pages: torch.Tensor,
                     ids: torch.Tensor) -> None:
    if q.dtype != torch.float32 or kv_pages.dtype != torch.float32:
        raise TypeError(f"paged_attention kernel takes float32 q and pages, "
                        f"got {q.dtype} and {kv_pages.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"page ids must be int32, got {ids.dtype}")
    m, _, hd = q.shape
    if kv_pages.ndim != 4 or kv_pages.shape[2] != 2 or kv_pages.shape[3] != hd:
        raise ValueError(f"kv_pages must be [n_pages, pt, 2, {hd}], "
                         f"got {tuple(kv_pages.shape)}")
    if ids.ndim != 2 or ids.shape[0] != m:
        raise ValueError(f"ids must be [{m}, k], got {tuple(ids.shape)}")
    if hd % 32 or not 0 < hd <= 1024:
        raise ValueError(f"head dim must be a multiple of 32 in (0, 1024], got {hd}")
    if kv_pages.shape[1] * 4 > _MAX_SMEM:
        raise ValueError(f"page_tokens {kv_pages.shape[1]} too large")
    if not (kv_pages.is_contiguous() and ids.is_contiguous()):
        raise ValueError("kv_pages and ids must be contiguous")


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor, ids: torch.Tensor,
                    scale: float | None = None, causal: bool = False) -> torch.Tensor:
    """q [m, Sq, hd], kv_pages [n_pages, pt, 2, hd], ids [m, k] int32
    -> [m, Sq, hd].  Row i attends over the tokens of pool pages ids[i];
    negative ids are masked out of the softmax."""
    if q.ndim != 3:
        raise ValueError(f"q must be [m, Sq, hd], got {tuple(q.shape)}")
    devices = {q.device, kv_pages.device, ids.device}
    if len(devices) != 1:
        raise ValueError(f"paged_attention tensors on several devices: {devices}")
    m, Sq, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, kv_pages, ids, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, kv_pages, ids)
    qs = (q * scale).to(q.dtype).contiguous()   # scale in q's dtype, as the TPU kernel
    out = torch.empty_like(qs)
    fn = _library().paged_attention_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(qs.data_ptr(), kv_pages.data_ptr(), ids.data_ptr(), out.data_ptr(),
            m, Sq, hd, kv_pages.shape[0], kv_pages.shape[1], ids.shape[1],
            int(causal), stream)
    common.check(rc, _NAME)
    global launches
    launches += 1
    return out
