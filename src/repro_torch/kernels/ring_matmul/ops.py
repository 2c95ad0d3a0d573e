"""The fused all-gather matmul (the counterpart of
`repro.kernels.ring_matmul.ops`), on the stacked rank axis.

`ring_matmul(x_t [K, m], w [n, K/n, N], mesh)` returns ``Y = x_t.T @
concat(w[0], ..., w[n-1])`` as ``[m, N]`` f32: rank 0's copy, which is
what `Mesh.replicated` reads of a replicated result.  `ring_matmul_ranks`
gives every rank's copy ``[n, m, N]``: each rank computes its own Y, in its
own shard order, as the reference does on n devices.  The reference shards
``w [K, N]`` on dim 0; here the sharded dim is the leading rank dim.

On CPU tensors both compute the plain ring schedule (`ref.ring_schedule_ref`);
on CUDA tensors they launch the hand-written kernel (``csrc/ring_matmul.cu``)
once a ring step, n times a call, or raise — there is no fallback.
`launches` counts those kernel launches and nothing else, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...mesh import Mesh
from .. import common
from .ref import ring_schedule_ref

_NAME = "ring_matmul"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                    # kernel launches (one a ring step)


def _fn():
    fn = common.load(_NAME).ring_matmul_step
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [ctypes.c_int] + [_L] * 5 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> None:
    if x_t.ndim != 2 or w.ndim != 3:
        raise ValueError(f"ring_matmul takes x_t [K, m] and w [n, K/n, N], got "
                         f"{tuple(x_t.shape)}, {tuple(w.shape)}")
    mesh._check(w)
    if w.shape[0] * w.shape[1] != x_t.shape[0]:
        raise ValueError(f"w {tuple(w.shape)} does not shard x_t's K = {x_t.shape[0]} "
                         f"over {mesh.p} ranks")
    if x_t.device != w.device:
        raise ValueError(f"ring_matmul tensors on several devices: {x_t.device}, {w.device}")


def _launch(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if x_t.dtype not in _DTYPES or w.dtype != x_t.dtype:
        raise TypeError(f"the ring_matmul kernel takes bf16 or f32 x_t and w of one "
                        f"dtype, got {x_t.dtype}, {w.dtype}")
    n, ks, N = w.shape
    m = x_t.shape[1]
    x_t, w = x_t.contiguous(), w.contiguous()
    out = torch.empty(n, m, N, dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    if ks == 0:
        return out.zero_()
    # the double-buffered slots; one rank forwards nothing
    buf = torch.empty(n, 2, ks, N, dtype=w.dtype, device=w.device) if n > 1 else None
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fn = _fn()
    global launches
    for step in range(n):
        rc = fn(x_t.data_ptr(), w.data_ptr(), None if buf is None else buf.data_ptr(),
                out.data_ptr(), _DTYPES[w.dtype], n, ks, m, N, step, stream)
        common.check(rc, _NAME)
        launches += 1
    return out


def ring_matmul_ranks(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x_t [K, m], w [n, K/n, N] -> [n, m, N] f32: every rank's copy of Y."""
    _check(x_t, w, mesh)
    if w.device.type == "cpu":
        return ring_schedule_ref(x_t, w, mesh)
    if w.device.type != "cuda":
        raise ValueError(f"ring_matmul runs on cpu or cuda, not {w.device}")
    return _launch(x_t, w, mesh)


def ring_matmul(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x_t [K, m] (replicated), w [n, K/n, N] (rank r's shard at w[r]) ->
    Y [m, N] f32, the one copy every rank holds."""
    return Mesh.replicated(ring_matmul_ranks(x_t, w, mesh))
