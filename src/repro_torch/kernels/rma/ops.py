"""One-sided RMA ops over a `Mesh`: the `repro.kernels.rma.ops` surface.

Each takes the stacked global view ``x [p, ...]`` (rank r's block is
``x[r]``).  On CPU tensors it computes the plain PyTorch version (`ref`);
on CUDA tensors it launches the hand-written kernel (``csrc/rma.cu``) or
raises — there is no fallback.  On a `ProcMesh` (one rank a process) x is
this rank's block ``[1, ...]`` and each op runs its peer form: the kernels
of ``csrc/rma_peer.cu`` store into (or load from) the peers' blocks of the
mesh's exchange segment through its pointer table, the round's fence makes
the stores visible, and the result is this rank's row of the stacked op's
(the plain versions do the same with ``Tensor.copy_`` on the mapped
blocks).  A peer all-to-all (`all_to_all`) is p launches of the peer put
kernel, one a destination block, each block seen as 32-bit words whatever
its dtype.  The kernels read each rank's block in place
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

from ...obs import cost
from ...mesh import Mesh
from ...procmesh import ProcMesh
from .. import common
from . import ref

_NAME = "rma"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_PUT = common.Entry(_NAME, "rma_put_shift", [_P, _P, _I, _I, _I, _I])
_GET = common.Entry(_NAME, "rma_get_shift", [_P, _P, _I, _I, _I, _I])
_ACC = common.Entry(_NAME, "rma_accumulate_shift_f32", [_P, _P, _P, _I, _I, _I, _I, _I])
_GATHER = common.Entry(_NAME, "rma_ring_all_gather", [_P, _P, _I, _I, _I])
# the peer forms (csrc/rma_peer.cu): x or out, the pointer table, then
# p, rank, shift / hop, the byte offset in the segment, the words
_PEER_PUT = common.Entry("rma_peer", "rma_peer_put", [_P, _P, _I, _I, _I, _I, _I])
_PEER_GET = common.Entry("rma_peer", "rma_peer_get", [_P, _P, _I, _I, _I, _I, _I])
_PEER_ACC = common.Entry("rma_peer", "rma_peer_accumulate_f32", [_P, _P, _P, _I, _I, _I])
_PEER_HOP = common.Entry("rma_peer", "rma_peer_ring_hop", [_P, _P, _I, _I, _I, _I, _I])

# kernel launches by kernel row, each counted where it is launched: a peer
# get's exposing store and a peer accumulate's slot store launch the peer
# put kernel and count under put_shift; a peer gather counts its p - 1 hops
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


def _launch(op: str, entry: common.Entry, device: int, out: torch.Tensor,
            passes: float, *args) -> None:
    """Launch, count, and report to a running cost counter: the output
    written and `passes - 1` blocks of its size read (its bound's bytes);
    an accumulate's adds as FLOPs."""
    entry(*args, common.current_stream(device))
    launches[op] += 1
    cost.report_kernel(op, out.numel() if op == "accumulate_shift" else 0,
                       passes * out.nbytes, product=False)


def _fresh(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def put_shift(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """Put rank r's block to rank (r + shift) mod p; returns what landed."""
    if not _on_card("put_shift", mesh, x):
        return ref.put_shift_ref(x, shift, mesh)
    if isinstance(mesh, ProcMesh):
        return _peer_put(x, shift, mesh)
    xs, row, stride = _words("put_shift", x)
    out = _fresh(x)
    if out.numel():
        _launch("put_shift", _PUT, x.get_device(), out, 2, xs.data_ptr(), out.data_ptr(),
                mesh.p, row, stride, int(shift))
    return out


def get_shift(x: torch.Tensor, src_shift: int, mesh: Mesh) -> torch.Tensor:
    """Get rank (r + src_shift) mod p's block into rank r."""
    if not _on_card("get_shift", mesh, x):
        return ref.get_shift_ref(x, src_shift, mesh)
    if isinstance(mesh, ProcMesh):
        return _peer_get(x, src_shift, mesh)
    xs, row, stride = _words("get_shift", x)
    out = _fresh(x)
    if out.numel():
        _launch("get_shift", _GET, x.get_device(), out, 2, xs.data_ptr(), out.data_ptr(),
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
    if isinstance(mesh, ProcMesh):
        return _peer_accumulate(x, acc, shift, mesh)
    (xs, row, x_stride), (acs, _, acc_stride) = _rows(x), _rows(acc)
    out = _fresh(acc)
    if out.numel():
        _launch("accumulate_shift", _ACC, x.get_device(), out, 3, xs.data_ptr(),
                acs.data_ptr(), out.data_ptr(), mesh.p, row, x_stride,
                acc_stride, int(shift))
    return out


def ring_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [p, ...] -> [p(receiver), p(source), ...]: each receiver's copy of
    every rank's block, in rank order (what every TPU rank holds); on a
    `ProcMesh` x [1, ...] -> [1, p, ...]."""
    if not _on_card("ring_all_gather", mesh, x):
        return ref.ring_all_gather_ref(x, mesh)
    if isinstance(mesh, ProcMesh):
        return _peer_ring_all_gather(x, mesh)
    xs, row, stride = _words("ring_all_gather", x)
    out = torch.empty((mesh.p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if out.numel():
        # every rank's block read once, every receiver's copy written
        _launch("ring_all_gather", _GATHER, x.get_device(), out, 1 + 1 / mesh.p,
                xs.data_ptr(), out.data_ptr(), mesh.p, row, stride)
    return out


# ------------------------------------------------------------- peer forms
def block_words(x: torch.Tensor) -> bool:
    """Whether each destination block of an all-to-all payload x [R, p, ...]
    is a whole number of 4-byte words: what the put kernel can carry as a
    word view, whatever x's dtype (a bool block of 4k elements, bf16 of 2k,
    any int64 or complex64 block)."""
    return math.prod(x.shape[2:]) * x.dtype.itemsize % 4 == 0


def word_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as flat int32 words (a view, no copy)."""
    return t.reshape(-1).view(torch.uint8).view(torch.int32)


def _block(op: str, x: torch.Tensor) -> torch.Tensor:
    """This rank's block as contiguous 32-bit words (a copy only where it
    is not contiguous)."""
    if x.dtype.itemsize != 4 or x.dtype.is_complex:
        raise TypeError(f"{op} moves 32-bit words; got {x.dtype}")
    return x if x.is_contiguous() else x.contiguous()


def put_store(x: torch.Tensor, shift: int, mesh: ProcMesh, seg, off: int) -> None:
    """The store half of a peer put, with no fence: this rank's block into
    rank (rank + shift) mod p's block of `seg` at byte `off`.  The epoch
    that closes the round makes it visible (`core.plan`'s deferred
    groups).  CPU tensors take the plain copy (`ProcMesh.store`)."""
    if not _on_card("put_shift", mesh, x):
        mesh.store(x, shift, seg, off)
        return
    xs = _block("put_shift", x)
    if xs.numel():
        _launch("put_shift", _PEER_PUT, x.get_device(), xs, 2, xs.data_ptr(),
                seg.table_ptr, mesh.p, mesh.rank, int(shift), off, xs.numel())


def all_to_all(x: torch.Tensor, mesh: ProcMesh) -> torch.Tensor:
    """x [1, p_dst, ...] -> [1, p_src, ...] on a `ProcMesh` (the result of
    `ProcMesh.all_to_all`): block d of this rank's x is stored into rank
    d's slot `rank` of one exchange round by the peer put kernel at shift
    (d - rank) mod p; this rank's own block is a launch at shift 0 too, so
    every block goes through the kernel, p launches a call.  Then the
    round's fence, and this rank's p slots copied out.  A block goes as a
    view of 32-bit words whatever its dtype (a copy only where the block
    is not contiguous); a block that is not whole words is refused.  CPU
    tensors take the plain stores (`ProcMesh.store`)."""
    p, r = mesh.p, mesh.rank
    if x.ndim < 2 or x.shape[1] != p:
        raise ValueError(f"all_to_all needs [1, p, ...], got {tuple(x.shape)}")
    nb = math.prod(x.shape[2:]) * x.dtype.itemsize
    on_card = _on_card("put_shift", mesh, x)
    if on_card and not block_words(x):
        raise TypeError(f"all_to_all moves 32-bit words; a block of {tuple(x.shape[2:])} "
                        f"{x.dtype} is {nb} bytes")
    seg, off = mesh.round(x.nbytes)
    for d in range(p):
        if not on_card:
            mesh.store(x[:, d], d - r, seg, off + r * nb)
            continue
        blk = x[0, d]
        w = word_view(blk if blk.is_contiguous() else blk.contiguous())
        if w.numel():
            _launch("put_shift", _PEER_PUT, x.get_device(), w, 2, w.data_ptr(), seg.table_ptr,
                    p, r, (d - r) % p, off + r * nb, w.numel())
    mesh.fence()
    return mesh.take(seg, off, tuple(x.shape), x.dtype)


def _peer_put(x: torch.Tensor, shift: int, mesh: ProcMesh) -> torch.Tensor:
    """This rank's block stored into rank (rank + shift) mod p's slot; after
    the fence, what landed here."""
    seg, off = mesh.round(x.nbytes)
    put_store(x, shift, mesh, seg, off)
    mesh.fence()
    return mesh.take(seg, off, tuple(x.shape), x.dtype)


def _peer_get(x: torch.Tensor, src_shift: int, mesh: ProcMesh) -> torch.Tensor:
    """Every rank exposes its block in its own slot (the put kernel at shift
    0); after the fence, this rank loads rank (rank + src_shift) mod p's."""
    xs = _block("get_shift", x)
    seg, off = mesh.round(xs.nbytes)
    put_store(xs, 0, mesh, seg, off)
    mesh.fence()
    out = _fresh(xs)
    if xs.numel():
        _launch("get_shift", _PEER_GET, x.get_device(), out, 2, out.data_ptr(),
                seg.table_ptr, mesh.p, mesh.rank, int(src_shift), off, xs.numel())
    return out


def _peer_accumulate(x: torch.Tensor, acc: torch.Tensor, shift: int,
                     mesh: ProcMesh) -> torch.Tensor:
    """The slotted accumulate: this rank's block into rank (rank + shift)
    mod p's slot; after the fence, the owner's add of its slot to acc."""
    xs, acs = _block("accumulate_shift", x), _block("accumulate_shift", acc)
    seg, off = mesh.round(xs.nbytes)
    put_store(xs, shift, mesh, seg, off)
    mesh.fence()
    out = _fresh(acs)
    if xs.numel():
        _launch("accumulate_shift", _PEER_ACC, x.get_device(), out, 3, acs.data_ptr(),
                seg.table_ptr, out.data_ptr(), mesh.rank, off, xs.numel())
    return out


def _peer_ring_all_gather(x: torch.Tensor, mesh: ProcMesh) -> torch.Tensor:
    """p - 1 hops to the right neighbour, a fence after each: hop h forwards
    slot (rank - h) mod p of the gather buffer (this rank's x at hop 0)."""
    xs = _block("ring_all_gather", x)
    p, nb = mesh.p, xs.nbytes
    seg, off = mesh.round(p * nb)
    dev = x.get_device()
    for hop in range(p - 1):
        if nb:
            _launch("ring_all_gather", _PEER_HOP, dev, xs, 2, xs.data_ptr(),
                    seg.table_ptr, p, mesh.rank, hop, off, xs.numel())
        mesh.fence()
    out = mesh.take(seg, off, (p,) + tuple(x.shape[1:]), x.dtype)
    out[mesh.rank] = xs[0]
    return out[None]
