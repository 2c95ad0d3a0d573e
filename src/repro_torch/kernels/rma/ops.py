"""One-sided RMA ops over a `Mesh`: the `repro.kernels.rma.ops` surface.

Each takes the stacked global view ``x [p, ...]`` (rank r's block is
``x[r]``).  On CPU tensors it computes the plain PyTorch version (`ref`);
on CUDA tensors it launches the hand-written kernel (``csrc/rma.cu``) or
raises — there is no fallback.  The kernels read each rank's block in place
at the tensor's rank stride, so a halo slice ``x.narrow(1, ...)`` of a
bigger array is not copied; only a view whose per-rank block is not
contiguous (a slice of an inner dim) is made contiguous first, and that
copy belongs to the op, not the kernel.  The output is always a fresh
contiguous tensor.  `launches` counts kernel launches per op (and
nothing else), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...mesh import Mesh
from .. import common
from . import ref

_NAME = "rma"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_PUT = common.Entry(_NAME, "rma_put_shift", [_P, _P, _I, _I, _I, _I])
_GET = common.Entry(_NAME, "rma_get_shift", [_P, _P, _I, _I, _I, _I])
_ACC = common.Entry(_NAME, "rma_accumulate_shift_f32", [_P, _P, _P, _I, _I, _I, _I, _I])
_GATHER = common.Entry(_NAME, "rma_ring_all_gather", [_P, _P, _I, _I, _I])

# kernel launches by op
launches = {"put_shift": 0, "get_shift": 0, "accumulate_shift": 0,
            "ring_all_gather": 0}


def _on_card(op: str, mesh: Mesh, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain version)."""
    for t in tensors:
        mesh._check(t)
    x = tensors[0]
    if len(tensors) > 1:
        dev = x.device
        for t in tensors[1:]:
            if t.device != dev:
                raise ValueError(f"{op}: tensors on several devices: "
                                 f"{[str(t.device) for t in tensors]}")
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"{op} runs on cpu or cuda, not {x.device}")


def block_contiguous(shape, strides) -> bool:
    """Whether a rank's block ``x[0]`` is contiguous, read from x's shape and
    strides (``x[0].is_contiguous()`` without making the view): every dim
    past the rank dim that is longer than 1 at the stride of a dense block."""
    if 0 in shape[1:]:
        return True
    want = 1
    for n, st in zip(reversed(shape[1:]), reversed(strides[1:])):
        if n != 1 and st != want:
            return False
        want *= n
    return True


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """x as p rank blocks of contiguous words at a fixed rank stride, the
    kernels' contract: (tensor, words a block, words between blocks).  Only
    a view whose block is not contiguous is copied."""
    if x.is_contiguous():
        row = x.numel() // x.shape[0]
        return x, row, row
    shape, strides = x.shape, x.stride()
    if not block_contiguous(shape, strides):
        x = x.contiguous()
        strides = x.stride()
    row = math.prod(shape[1:])
    return x, row, strides[0] if shape[0] > 1 else row


def _words(op: str, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    if x.dtype.itemsize != 4 or x.dtype.is_complex:
        raise TypeError(f"{op} moves 32-bit words; got {x.dtype}")
    return _rows(x)


def _launch(op: str, entry: common.Entry, device: int, *args) -> None:
    entry(*args, common.current_stream(device))
    launches[op] += 1


def _fresh(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def put_shift(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """Put rank r's block to rank (r + shift) mod p; returns what landed."""
    if not _on_card("put_shift", mesh, x):
        return ref.put_shift_ref(x, shift, mesh)
    xs, row, stride = _words("put_shift", x)
    out = _fresh(x)
    if out.numel():
        _launch("put_shift", _PUT, x.get_device(), xs.data_ptr(), out.data_ptr(),
                mesh.p, row, stride, int(shift))
    return out


def get_shift(x: torch.Tensor, src_shift: int, mesh: Mesh) -> torch.Tensor:
    """Get rank (r + src_shift) mod p's block into rank r."""
    if not _on_card("get_shift", mesh, x):
        return ref.get_shift_ref(x, src_shift, mesh)
    xs, row, stride = _words("get_shift", x)
    out = _fresh(x)
    if out.numel():
        _launch("get_shift", _GET, x.get_device(), xs.data_ptr(), out.data_ptr(),
                mesh.p, row, stride, int(src_shift))
    return out


def accumulate_shift(x: torch.Tensor, acc: torch.Tensor, shift: int,
                     mesh: Mesh) -> torch.Tensor:
    """Slotted accumulate to rank r + shift: ``acc[r] + x[(r - shift) % p]``.
    The kernel takes float32 only."""
    if x.shape != acc.shape:
        raise ValueError(f"accumulate_shift: x {tuple(x.shape)} and acc "
                         f"{tuple(acc.shape)} differ")
    if not _on_card("accumulate_shift", mesh, x, acc):
        return ref.accumulate_shift_ref(x, acc, shift, mesh)
    if x.dtype != torch.float32 or acc.dtype != torch.float32:
        raise TypeError(f"accumulate_shift kernel takes float32, got "
                        f"{x.dtype} and {acc.dtype}")
    (xs, row, x_stride), (acs, _, acc_stride) = _rows(x), _rows(acc)
    out = _fresh(acc)
    if out.numel():
        _launch("accumulate_shift", _ACC, x.get_device(), xs.data_ptr(),
                acs.data_ptr(), out.data_ptr(), mesh.p, row, x_stride,
                acc_stride, int(shift))
    return out


def ring_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [p, ...] -> [p(receiver), p(source), ...]: each receiver's copy of
    every rank's block, in rank order (what every TPU rank holds)."""
    if not _on_card("ring_all_gather", mesh, x):
        return ref.ring_all_gather_ref(x, mesh)
    xs, row, stride = _words("ring_all_gather", x)
    out = torch.empty((mesh.p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("ring_all_gather", _GATHER, x.get_device(), xs.data_ptr(),
                out.data_ptr(), mesh.p, row, stride)
    return out
