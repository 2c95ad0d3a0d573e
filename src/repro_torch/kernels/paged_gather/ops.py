"""Cross-rank paged gather: the `repro.kernels.paged_gather.ops` surface.

On CPU tensors it computes the plain PyTorch version (`ref`); on CUDA
tensors it launches the hand-written kernel (``csrc/paged_gather.cu``) or
raises — there is no fallback.  `launches` counts kernel launches (and
nothing else), so a run can show that its path went through the kernel.

``holes=True`` is the kernel's hole mode, which `rmem.pages.gather_shift`
takes: a row whose id is < 0 comes back as zero words and is never read
(`ref.paged_gather_holes_ref`), in the same one launch.

On a `ProcMesh` (one rank a process) `pages` is this rank's ``[1, n_pages,
*ps]`` pool, which must be a symmetric tensor (`ProcMesh.symmetric`, a
window of `core.window.win_allocate`): the peer form reads rank (rank +
shift)'s pool in place through the peer mapping, one one-sided read where
the reference sends an id list and gets a packed reply.  A fence opens the
epoch (the owner's writes visible) and one closes it (every read done
before an owner writes again).  On the card that is the kernel
``paged_gather_peer`` (one launch, counted in `launches`); on the CPU its
plain version (`ref.paged_gather_peer_ref`).  A pool outside every segment
is refused; nothing is copied into one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...obs import cost
from ...mesh import Mesh
from ...procmesh import ProcMesh
from .. import common
from . import ref

_NAME = "paged_gather"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_GATHER = common.Entry(_NAME, "paged_gather_shift",
                       [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_int])
_PEER = common.Entry(_NAME, "paged_gather_peer",
                     [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_int])

launches = 0            # kernel launches by `paged_gather`


def _check_cuda_args(pages: torch.Tensor, ids: torch.Tensor) -> None:
    if pages.dtype.itemsize != 4 or pages.dtype.is_complex:
        raise TypeError(f"paged_gather moves 32-bit words; got {pages.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"page ids must be int32, got {ids.dtype}")
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")


def paged_gather(pages: torch.Tensor, ids: torch.Tensor, shift: int, mesh: Mesh,
                 holes: bool = False) -> torch.Tensor:
    """pages [p, n_pages, *ps] of 32-bit words, ids [p, k] int32 ->
    [p, k, *ps]: rank r gathers rows ``ids[r]`` of rank (r + shift)'s pool
    as one block.  Ids are clamped to ``[0, n_pages - 1]``; with `holes`, a
    row whose id is < 0 is zeros instead."""
    mesh._check(pages)
    mesh._check(ids)
    if ids.ndim != 2:
        raise ValueError(f"ids must be [p, k], got {tuple(ids.shape)}")
    if pages.ndim < 2:
        raise ValueError(f"pages must be [p, n_pages, ...], got {tuple(pages.shape)}")
    if pages.device != ids.device:
        raise ValueError(f"paged_gather tensors on several devices: "
                         f"{pages.device}, {ids.device}")
    if isinstance(mesh, ProcMesh):
        return _peer_gather(pages, ids, shift, mesh, holes)
    if pages.device.type == "cpu":
        plain = ref.paged_gather_holes_ref if holes else ref.paged_gather_ref
        return plain(pages, ids, shift, mesh)
    if pages.device.type != "cuda":
        raise ValueError(f"paged_gather runs on cpu or cuda, not {pages.device}")
    _check_cuda_args(pages, ids)
    p, n_pages = pages.shape[0], pages.shape[1]
    k = ids.shape[1]
    if n_pages == 0 and k:
        raise ValueError("cannot gather from an empty pool")
    ids = ids.contiguous()
    out = pages.new_empty((p, k) + tuple(pages.shape[2:]))
    if out.numel():
        _GATHER(pages.data_ptr(), ids.data_ptr(), out.data_ptr(), p, n_pages,
                math.prod(pages.shape[2:]), k, int(shift), int(holes),
                common.current_stream(pages.get_device()))
        global launches
        launches += 1
        # the rows read and written, the ids read
        cost.report_kernel("paged_gather", 0, 2 * out.nbytes + ids.nbytes, product=False)
    return out


def _peer_gather(pages: torch.Tensor, ids: torch.Tensor, shift: int, mesh: ProcMesh,
                 holes: bool) -> torch.Tensor:
    """The peer form: rows ``ids[0]`` of rank (rank + shift)'s symmetric pool,
    read in place between the epoch's two fences."""
    if pages.device.type == "cpu":
        return ref.paged_gather_peer_ref(pages, ids, shift, mesh, holes)
    if pages.device.type != "cuda":
        raise ValueError(f"paged_gather runs on cpu or cuda, not {pages.device}")
    _check_cuda_args(pages, ids)
    seg, off = mesh.locate(pages)
    n_pages, k = pages.shape[1], ids.shape[1]
    if n_pages == 0 and k:
        raise ValueError("cannot gather from an empty pool")
    ids = ids.contiguous()
    out = pages.new_empty((1, k) + tuple(pages.shape[2:]))
    mesh.fence()                    # the owner's writes are visible
    if out.numel():
        _PEER(seg.table_ptr, off, ids.data_ptr(), out.data_ptr(), mesh.p, mesh.rank,
              int(shift), n_pages, math.prod(pages.shape[2:]), k, int(holes),
              common.current_stream(pages.get_device()))
        global launches
        launches += 1
        cost.report_kernel("paged_gather", 0, 2 * out.nbytes + ids.nbytes, product=False)
    mesh.fence()                    # every read done before an owner writes again
    return out
