"""Paged attention: the pool-local wrapper the serving path calls, and the
cross-rank `paged_attention_shift`.

On CPU tensors each computes its plain PyTorch version (`ref`); on CUDA
tensors it launches its hand-written kernel (``csrc/paged_attention.cu``)
or raises — there is no fallback.  `launches` and `shift_launches` count
the two kernels' launches (and nothing else), so a run can show that its
path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from ...mesh import Mesh
from .. import common
from . import ref

_NAME = "paged_attention"
_MAX_SMEM = 48 * 1024   # static launch limit without an opt-in attribute

launches = 0            # kernel launches by `paged_attention`
shift_launches = 0      # kernel launches by `paged_attention_shift`

_SIGNATURES = {
    "paged_attention_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "paged_attention_shift_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
}


def _fn(name: str):
    fn = getattr(common.load(_NAME), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _fn("paged_attention_f32")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(qs.data_ptr(), kv_pages.data_ptr(), ids.data_ptr(), out.data_ptr(),
            m, Sq, hd, kv_pages.shape[0], kv_pages.shape[1], ids.shape[1],
            int(causal), stream)
    common.check(rc, _NAME)
    global launches
    launches += 1
    return out


def paged_attention_shift(q: torch.Tensor, kv_pages: torch.Tensor,
                          ids: torch.Tensor, shift: int, mesh: Mesh,
                          scale: float | None = None,
                          causal: bool = False) -> torch.Tensor:
    """Cross-rank paged attention: q [p, Sq, hd], kv_pages [p, n_pages, pt,
    2, hd], ids [p, k] int32 -> [p, Sq, hd].  Rank r attends over pages
    ``ids[r]`` of rank (r + shift)'s pool, read in place (never gathered
    into a block); negative ids are masked out of the softmax."""
    mesh._check(q)
    mesh._check(kv_pages)
    mesh._check(ids)
    if q.ndim != 3:
        raise ValueError(f"q must be [p, Sq, hd], got {tuple(q.shape)}")
    devices = {q.device, kv_pages.device, ids.device}
    if len(devices) != 1:
        raise ValueError(f"paged_attention_shift tensors on several devices: {devices}")
    p, Sq, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_shift_ref(q, kv_pages, ids, shift, mesh,
                                             scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_shift runs on cpu or cuda, not {q.device}")
    if kv_pages.ndim != 5:
        raise ValueError(f"kv_pages must be [p, n_pages, pt, 2, hd], "
                         f"got {tuple(kv_pages.shape)}")
    _check_cuda_args(q, kv_pages[0], ids)
    if not kv_pages.is_contiguous():
        raise ValueError("kv_pages and ids must be contiguous")
    qs = (q * scale).to(q.dtype).contiguous()   # scale in q's dtype, as the TPU kernel
    out = torch.empty_like(qs)
    n_pages, pt = kv_pages.shape[1], kv_pages.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("paged_attention_shift_f32")(
        qs.data_ptr(), kv_pages.data_ptr(), ids.data_ptr(), out.data_ptr(),
        p, int(shift) % p, Sq, hd, n_pages, pt, ids.shape[1], int(causal), stream)
    common.check(rc, _NAME)
    global shift_launches
    shift_launches += 1
    return out
