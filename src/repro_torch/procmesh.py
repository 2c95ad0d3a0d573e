"""The rank axis over processes: one rank a process, windows in peer-mapped
memory (the `Mesh` surface for ranks that are separate devices).

The reference runs every rank as its own `shard_map` shard on its own chip,
and its RMA kernels store into a neighbour chip's memory.  `Mesh` stacks
all p ranks on one device; `ProcMesh` gives each rank a process of its own,
its device ``cuda:r % n`` over n cards (all on ``cuda:0`` with one card)
or the CPU.  A tensor's leading dim then holds the rank blocks this process
owns, one, so ``x[0]`` is this rank's block and the collectives return the
stacked result restricted to that row:

  * ``axis_index()``      -> ``[rank]``;
  * ``shift(x, s)``       -> the block of rank ``(rank - s) mod p``;
  * ``ppermute(x, perm)`` -> the block a pair sends here, or zeros;
  * ``all_gather(x)``     -> ``[1, p, ...]``, every rank's block;
  * ``all_to_all(x[1, p_dst, ...])`` -> ``[1, p_src, ...]``;
  * ``psum_scatter(x[1, p*m, ...])`` -> ``[1, m, ...]``, chunk ``rank`` of
    the sum over ranks (summed here in rank order), and ``psum``.

``p`` stays the world's rank count and ``local_ranks`` is 1, so code that
sizes the leading dim by ``mesh.local_ranks`` runs on either mesh.

**Grids.**  ``run(fn, 4, axes={"pod": 2, "data": 2})`` gives each rank a
grid `ProcMesh`: world rank = row-major over the axes (pod the major one,
as the stacked ``[pod, data, ...]``), a tensor's leading dims ``[1, 1,
...]``, `front` / `back` / `dim` / `psum` over any axis, and `along(axis)`
the one-axis mesh of the ranks sharing this rank's other coordinates (a
put along ``data`` reaches world rank ``pod * D + (d + s) mod D``, along
``pod`` rank ``((q + s) mod P) * D + d``).  Such a sub-mesh is a view of
the same process group: its rounds use the group's segments, every rank
issuing the same rounds (SPMD) so that the group's barrier fences them,
and the peer kernels reach its ranks through a pointer table in the
axis's order (`SegmentView`), with no change to the kernels.

**Launch and bootstrap.**  `run(fn, nprocs)` starts one process a rank
with the ``spawn`` start method (CUDA cannot be forked), joins them into a
``gloo`` group over a `FileStore` in a temporary directory (no network),
binds each rank to its device and calls ``fn(mesh, *args)``.  The bootstrap
carries the handshake (handles, barriers, the PSCW tokens) and never a
payload.  NCCL is not used: it refuses two ranks on one card.  A rank that
raises makes `run` raise with that rank's traceback; a rank that hangs past
``timeout`` is killed and `run` raises.  No process outlives `run`.

**Symmetric segments.**  `Segment` is one allocation of the same size on
every rank: each rank allocates its block and shares a handle, every peer
maps it, and every rank holds the table of the p blocks (its own entry its
local memory: a process cannot open its own handle).  On the card the
block is ``cudaMalloc``'d by ``csrc/rma_peer.cu`` and shared by CUDA IPC,
and the table is also a device array of base pointers for the kernels; on
the CPU it is a file that the peers map with ``torch.from_file(...,
shared=True)``.  A segment is freed collectively: a fence, every peer
closes its mapping (``cudaIpcCloseMemHandle``), a barrier, the owner frees.
A *symmetric tensor* lies in this rank's block of a segment (`symmetric`,
or a window of `core.window.win_allocate`): `locate` gives its segment and
offset and `peer(t, r)` rank r's counterpart as mapped here, so a peer
kernel reads or stores into a peer's pool or ring in place.

**Host gathers.**  Where every process runs the same host scheduler
(`serve.disagg.DisaggEngine` on a `ProcMesh`), the scheduler reads each
step's device results of every rank through `host_gather`: one small
exchange round of int32 words.  That is the controller's read, not a
protocol message, so it enters no op ledger and is counted apart
(`host_gathers`).

**Exchange rounds.**  An eager collective or peer op is a round over the
mesh's exchange segment: the stores into the peers' blocks are issued,
`fence` (the stream synchronised, then a barrier of the bootstrap) makes
them visible, and the round's slot of this rank's block is copied out into
a fresh tensor.  Rounds alternate between the segment's two halves, so a
half is written again only after a later fence, by which time every rank
has copied it out.  Every rank issues the same rounds with the same sizes
(SPMD), so the segment grows on all ranks at once when a round needs more.
The stores of the plain collectives here are ``Tensor.copy_`` into the
mapped blocks; `kernels.rma.ops` issues its own with the peer kernels.

**Epoch rounds.**  A plan flushed inside a fence or PSCW epoch
(`core.plan.RmaPlan.flush(sync=...)`) issues its puts into a second
segment, ``round(..., epoch=True)``, and does not fence: the epoch's own
closing synchronisation makes them visible (a fence's barrier, or PSCW's
complete tokens from the k neighbours the puts reach) and the epoch then
copies them out.  That a target's slot is free again is the epoch's
opening synchronisation: the fence, or the target's post.  `barriers` and
`tokens` count this rank's host barriers and sent tokens, so a run can
show which synchronisation an epoch took.
"""

from __future__ import annotations

import ctypes
import datetime
import gc
import math
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from .kernels import common
from .mesh import MeshError, NamedAxes, resolve_device
from .obs import cost

ALIGN = 256                     # bytes: a slot's offset in a segment
MIN_EXCHANGE = 1 << 20          # bytes: the exchange segment's first half
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_ALLOC = common.Entry("rma_peer", "rma_peer_alloc", [_I, _P])
_OPEN = common.Entry("rma_peer", "rma_peer_open", [_P, _P])
_CLOSE = common.Entry("rma_peer", "rma_peer_close", [_P])
_FREE = common.Entry("rma_peer", "rma_peer_free", [_P])


class ProcMeshError(RuntimeError):
    pass


def aligned(n: int) -> int:
    """`n` bytes rounded up to a slot's alignment."""
    return -(-n // ALIGN) * ALIGN


class _DeviceBytes:
    """Device memory that PyTorch did not allocate, seen as uint8 through
    the CUDA array interface (the tensor keeps this object alive)."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """x's elements as a flat uint8 tensor (a copy only where x's memory is
    not dense).  A one-element slice may keep its parent's stride, which
    a dtype view refuses: it is read at stride 1."""
    flat = x.contiguous().reshape(-1)
    if flat.numel() == 1:
        flat = flat.as_strided((1,), (1,))
    return flat.view(torch.uint8)


class Segment:
    """One symmetric allocation: `nbytes` on every rank, mapped by every
    peer.  ``blocks[r]`` is rank r's block as this process sees it (uint8),
    ``table`` (card only) the device array of the p base pointers."""

    def __init__(self, mesh: "ProcMesh", nbytes: int) -> None:
        self.mesh, self.nbytes = mesh, int(nbytes)
        self.id = mesh._next_segment
        mesh._next_segment += 1
        self._ptrs: list[int] = []
        self.table: Optional[torch.Tensor] = None
        if mesh.device.type == "cuda":
            self.blocks = self._map_cuda()
        else:
            self.blocks = self._map_files()
        mesh._segments.append(self)

    # ------------------------------------------------------------ mapping
    def _map_cuda(self) -> list:
        mesh, stream = self.mesh, common.current_stream(self.mesh.device.index)
        buf = ctypes.create_string_buffer(72)
        _ALLOC(self.nbytes, ctypes.addressof(buf), stream)
        own = int.from_bytes(buf.raw[:8], "little")
        handles = mesh.gather_objects(buf.raw[8:72])
        ptrs = []
        for r, handle in enumerate(handles):
            if r == mesh.rank:
                ptrs.append(own)
                continue
            hbuf, out = ctypes.create_string_buffer(handle, 64), ctypes.c_uint64()
            _OPEN(ctypes.addressof(hbuf), ctypes.addressof(out), stream)
            ptrs.append(out.value)
        self._ptrs = ptrs
        self.table = torch.tensor(ptrs, dtype=torch.int64, device=mesh.device)
        return [torch.as_tensor(_DeviceBytes(ptr, self.nbytes), device=mesh.device)
                for ptr in ptrs]

    def _map_files(self) -> list:
        mesh = self.mesh
        if mesh.workdir is None:
            if not mesh._own_workdir:
                raise ProcMeshError("a CPU segment over several ranks needs the ranks' "
                                    "shared workdir (procmesh.run gives it)")
            mesh.workdir = tempfile.mkdtemp(prefix="procmesh-")
        path = os.path.join(mesh.workdir, f"segment-{self.id}-rank{mesh.rank}")
        own = torch.from_file(path, shared=True, size=max(self.nbytes, 1), dtype=torch.uint8)
        paths = mesh.gather_objects(path)
        return [own if r == mesh.rank else
                torch.from_file(q, shared=True, size=max(self.nbytes, 1), dtype=torch.uint8)
                for r, q in enumerate(paths)]

    # ------------------------------------------------------------- access
    def view(self, rank: int, off: int, nbytes: int) -> torch.Tensor:
        """Bytes [off, off + nbytes) of rank `rank`'s block, as mapped here."""
        if off < 0 or off + nbytes > self.nbytes:
            raise ProcMeshError(f"segment {self.id}: bytes [{off}, {off + nbytes}) outside "
                                f"its {self.nbytes}")
        return self.blocks[rank % self.mesh.p][off:off + nbytes]

    def tensor(self, rank: int, shape, dtype: torch.dtype, off: int = 0) -> torch.Tensor:
        """Rank `rank`'s block from byte `off`, seen as `shape` of `dtype`:
        this process's own memory for its own rank, a peer's as mapped
        here (loads and stores reach it)."""
        nbytes = math.prod(shape) * dtype.itemsize
        return self.view(rank, off, nbytes).view(dtype).reshape(tuple(shape))

    @property
    def table_ptr(self) -> int:
        return self.table.data_ptr()

    def free(self) -> None:
        """Collective: every rank's uses end (a fence), every peer closes its
        mappings, a barrier, every owner frees its block."""
        mesh = self.mesh
        mesh.fence()
        self.blocks = self.table = None
        gc.collect()
        if mesh.device.type == "cuda":
            stream = common.current_stream(mesh.device.index)
            for r, ptr in enumerate(self._ptrs):
                if r != mesh.rank:
                    _CLOSE(ptr, stream)
            mesh.barrier()
            _FREE(self._ptrs[mesh.rank], stream)
        else:
            mesh.barrier()
            os.unlink(os.path.join(mesh.workdir, f"segment-{self.id}-rank{mesh.rank}"))
        self._ptrs = []
        mesh._segments.remove(self)
        mesh._views = {k: v for k, v in mesh._views.items() if k[0] != self.id}


class SegmentView(Segment):
    """A group's segment as a view of the group sees it (`ProcMesh.along`):
    its rank r is the group's rank ``mesh.members[r]``, and on the card
    ``table`` holds those ranks' base pointers in the view's order, so a
    peer kernel given the view's rank and size stores into the right
    block.  Freed with its segment, never alone."""

    def __init__(self, seg: Segment, mesh: "ProcMesh") -> None:
        self.mesh, self.nbytes, self.id = mesh, seg.nbytes, seg.id
        self.blocks = [seg.blocks[m] for m in mesh.members]
        self.table = None if seg.table is None else seg.table[list(mesh.members)]
        self._ptrs = []

    def free(self) -> None:
        raise ProcMeshError("a view's segment is freed with the group's")


def neighbour_offsets(k: int) -> list[int]:
    """The ring offsets of a group of k neighbours: +1, -1, +2, -2, ..."""
    return [(i // 2 + 1) * (1 if i % 2 == 0 else -1) for i in range(k)]


class ProcMesh(NamedAxes):
    """One rank of a p-rank axis, or of a grid of named axes, this
    process's, with `Mesh`'s surface.

    Made by `run` in each rank's process (or, for one rank, directly:
    ``ProcMesh(1, 0, device=...)`` needs no process group).  ``devices``
    names every rank's device, so a model can tell a crossing of a link
    from one within a card.

    Given a dict of named axes, ``ProcMesh({"pod": 2, "data": 2}, rank)``
    is a grid: the world rank is row-major over the axes in order (the
    first the major one, as the stacked ``[pod, data, ...]``), ``coords``
    this rank's coordinate on each, and a tensor's leading dims are one
    unit dim an axis.  `along(axis)` is the one-axis mesh of the ranks
    that share this rank's other coordinates (its ``p`` the axis's size,
    its ``rank`` this rank's coordinate on it) and `regrid` the same ranks
    as another grid: both are views of the process group that `run`
    made.  A view's rounds use the group's exchange and epoch segments,
    with every rank of the group issuing the same rounds in the same order
    (SPMD), so the group's barrier fences them; a view sees a segment
    through its own ranks (`SegmentView`), and on the card through a
    pointer table of its ranks' blocks in its own order, which the peer
    kernels index as they index the group's."""

    local_ranks = 1
    _lead_note = " (this process's rank block)"

    def __init__(self, p, rank: int, axis: str = "serve", device=None, *,
                 workdir: Optional[str] = None, devices: Optional[Sequence[str]] = None):
        self._name_axes(p, axis)
        if not 0 <= rank < self.p:
            raise MeshError(f"rank {rank} outside a mesh of {self.p}")
        self.rank = int(rank)
        self.ranks = self.p
        self.world, self.members = self, tuple(range(self.p))
        self.coords = self._coords(self.rank)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.devices = tuple(devices) if devices is not None else (str(self.device),) * self.p
        self._own_workdir = workdir is None and self.p == 1
        self.workdir = workdir
        self._next_segment = 0
        self._segments: list[Segment] = []
        self._rounds: dict = {}          # eager / epoch -> [segment, next half]
        self._sends: list = []
        self._reads: Optional[torch.cuda.Event] = None
        self._counts = {"barriers": 0, "tokens": 0, "host_gathers": 0}
        self._views: dict = {}           # (segment id, members) -> SegmentView
        self._along: dict = {}

    def _view(self, shape: dict, members: tuple) -> "ProcMesh":
        """The mesh of `shape` over the world ranks `members` (row-major),
        which hold this process's rank: a view of this process group."""
        v = object.__new__(ProcMesh)
        v._name_axes(shape, None)
        world = self.world
        v.world, v.members = world, tuple(members)
        v.rank, v.ranks = v.members.index(world.rank), world.p
        v.coords = v._coords(v.rank)
        v.device = world.device
        v.devices = tuple(world.devices[m] for m in v.members)
        v._along = {}
        return v

    def _coords(self, rank: int) -> tuple:
        out = []
        for n in reversed(tuple(self.shape.values())):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    @property
    def rank_dims(self) -> tuple:
        """This process's one rank block: a unit dim an axis."""
        return (1,) * len(self.shape)

    # ------------------------------------------------------------ bootstrap
    @property
    def barriers(self) -> int:
        """Host barriers this process entered, over every view of its group."""
        return self.world._counts["barriers"]

    @property
    def tokens(self) -> int:
        """PSCW tokens this process sent, over every view of its group."""
        return self.world._counts["tokens"]

    @property
    def host_gathers(self) -> int:
        return self.world._counts["host_gathers"]

    @property
    def crosses_link(self) -> bool:
        """Whether ranks of this mesh sit on different devices."""
        return len(set(self.devices)) > 1

    def barrier(self) -> None:
        """A barrier of the bootstrap (host only), over the whole group."""
        if self.world.p > 1:
            self.world._counts["barriers"] += 1
            torch.distributed.barrier()

    def fence(self) -> None:
        """Every rank's stores issued so far have landed: this rank's stream
        drains, then the ranks meet."""
        self.flush()
        self.barrier()

    def flush(self) -> None:
        """This rank's issued stores are complete (remote completion)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def mark_reads(self) -> None:
        """Mark this point of the stream: the copies out of this rank's
        window issued so far (an epoch's results)."""
        if self.device.type == "cuda":
            self.world._reads = torch.cuda.Event()
            self.world._reads.record(torch.cuda.current_stream(self.device))

    def reads_done(self) -> None:
        """Wait until the stream has passed the mark, so that peers may
        store into the window again (PSCW's post)."""
        if self.world._reads is not None:
            self.world._reads.synchronize()
            self.world._reads = None

    def gather_objects(self, obj: Any) -> list:
        """Every rank's `obj` (small metadata only: handles, paths), in this
        mesh's rank order; collective over the whole group."""
        if self.world.p == 1:
            return [obj]
        out = [None] * self.world.p
        torch.distributed.all_gather_object(out, obj)
        return [out[m] for m in self.members]

    def notify(self, offsets: Sequence[int], tag: int) -> None:
        """A token to rank + o for each offset o (rank itself skipped)."""
        w = self.world
        for j, o in enumerate(offsets):
            dst = (self.rank + o) % self.p
            if dst != self.rank:
                w._counts["tokens"] += 1
                tok = torch.zeros(1, dtype=torch.int32)
                w._sends.append((torch.distributed.isend(tok, self.members[dst], tag=tag + j),
                                 tok))

    def await_tokens(self, offsets: Sequence[int], tag: int) -> None:
        """The token of rank - o for each offset o, then every send of this
        rank done."""
        for j, o in enumerate(offsets):
            src = (self.rank - o) % self.p
            if src != self.rank:
                torch.distributed.recv(torch.zeros(1, dtype=torch.int32), self.members[src],
                                       tag=tag + j)
        for work, _ in self.world._sends:
            work.wait()
        self.world._sends = []

    # ------------------------------------------------------------ segments
    def allocate(self, nbytes: int) -> Segment:
        """A symmetric segment of `nbytes` a rank, zero-filled (collective
        over the whole group), as this mesh sees it."""
        return self._seg(Segment(self.world, nbytes))

    def _seg(self, seg: Segment) -> Segment:
        """`seg` as this mesh sees it: the group's own where this mesh holds
        every rank of the group in its order, else a cached `SegmentView`."""
        if self.members == self.world.members:
            return seg
        key = (seg.id, self.members)
        views = self.world._views
        if key not in views:
            views[key] = SegmentView(seg, self)
        return views[key]

    def round(self, nbytes: int, epoch: bool = False) -> tuple[Segment, int]:
        """The exchange segment (or, with `epoch`, the epoch segment) and
        this round's offset for `nbytes` a rank (collective: every rank
        asks for the same bytes)."""
        w = self.world
        need = aligned(max(int(nbytes), 1))
        seg, half = w._rounds.get(epoch, (None, 0))
        if seg is None or need > seg.nbytes // 2:
            size = max(need, MIN_EXCHANGE, 0 if seg is None else seg.nbytes)
            if seg is not None:
                seg.free()
            seg, half = Segment(w, 2 * size), 0
        w._rounds[epoch] = [seg, half ^ 1]
        return self._seg(seg), half * (seg.nbytes // 2)

    def symmetric(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A zero-filled tensor ``[1, *shape]`` in a new symmetric segment:
        this rank's block, whose peers' blocks `peer` reaches (collective)."""
        shape = (1,) + tuple(shape)
        return self.allocate(math.prod(shape) * dtype.itemsize).tensor(self.rank, shape, dtype)

    def locate(self, t: torch.Tensor) -> tuple[Segment, int]:
        """The segment whose block on this rank holds `t`, and t's byte
        offset in it.  A peer form reads or writes the same offset of a
        peer's block, so `t` must lie whole in a segment and be dense; any
        other tensor is refused (it is never copied into one)."""
        if not t.is_contiguous():
            raise ProcMeshError(f"a symmetric tensor must be contiguous, got strides "
                                f"{t.stride()} for {tuple(t.shape)}")
        ptr, n = t.data_ptr(), t.nbytes
        w = self.world
        for seg in w._segments:
            base = seg.blocks[w.rank].data_ptr()
            if base <= ptr and ptr + n <= base + seg.nbytes:
                return self._seg(seg), ptr - base
        raise ProcMeshError(f"a tensor {tuple(t.shape)} {t.dtype} outside every symmetric "
                            "segment of this mesh (allocate it with ProcMesh.symmetric or "
                            "core.window.win_allocate)")

    def peer(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s counterpart of the symmetric tensor `t`: the same
        shape at the same offset of its block, as mapped here."""
        seg, off = self.locate(t)
        return seg.tensor(rank, t.shape, t.dtype, off)

    def host_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of x [1, ...] on the host, [p, ...] in rank
        order (collective).  It is the controller reading device results
        when every process runs the same host scheduler: this rank's block
        into its own slot of an exchange round, a fence, the p slots read
        back.  It is no protocol message: no op ledger records it, and it
        is counted apart, in `host_gathers`."""
        self._check(x)
        self.world._counts["host_gathers"] += 1
        seg, off = self.round(x.nbytes)
        seg.view(self.rank, off, x.nbytes).copy_(as_bytes(x))
        self.fence()
        rows = torch.stack([seg.view(r, off, x.nbytes) for r in range(self.p)]).cpu()
        return rows.view(x.dtype).reshape((self.p,) + tuple(x.shape[1:]))

    def take(self, seg: Segment, off: int, shape, dtype) -> torch.Tensor:
        """A fresh copy of this rank's bytes at `off`, as `shape` of `dtype`."""
        n = math.prod(shape) * dtype.itemsize
        return seg.view(self.rank, off, n).clone().view(dtype).reshape(shape)

    def close(self) -> None:
        """Frees every segment (collective), and a one-rank mesh's own
        directory of CPU segments.  A view owns nothing: its group closes."""
        if self.world is not self:
            raise ProcMeshError("a view of a process group is closed with the group")
        for seg in list(reversed(self._segments)):
            seg.free()
        self._rounds = {}
        if self._own_workdir and self.workdir is not None:
            os.rmdir(self.workdir)
            self.workdir = None

    # ----------------------------------------------------- the Mesh surface
    def along(self, axis: str) -> "ProcMesh":
        """The one-axis mesh of `axis`: the ranks that share this rank's
        other coordinates, in the axis's order (this mesh, on one axis)."""
        d = self.dim(axis)
        if len(self.shape) == 1:
            return self
        if axis not in self._along:
            sizes = tuple(self.shape.values())
            stride = math.prod(sizes[d + 1:])
            base = self.rank - self.coords[d] * stride
            members = tuple(self.members[base + c * stride] for c in range(sizes[d]))
            self._along[axis] = self._view({axis: sizes[d]}, members)
        return self._along[axis]

    def regrid(self, axes) -> "ProcMesh":
        """These ranks, in their order, as the grid `axes` (a dict of named
        axes, or one axis name for a single axis): the 2 x 2 grid's four
        ranks as one axis of 4, say, or as the grid of other names."""
        shape = dict(axes) if isinstance(axes, dict) else {str(axes): self.p}
        if math.prod(shape.values()) != self.p:
            raise MeshError(f"a grid {shape} of {math.prod(shape.values())} ranks over "
                            f"{self.p}")
        return self._view(shape, self.members)

    def axis_index(self) -> torch.Tensor:
        """[1] int64: this rank's index."""
        return torch.tensor([self.rank], device=self.device)

    def _exchange_blocks(self, block_shape, dtype, slots: int, sends,
                         zero: bool = False) -> torch.Tensor:
        """One round: `sends` is [(tensor, dst rank, slot)]; returns this
        rank's `slots` received blocks [slots, *block_shape] (zeros where
        nothing landed, if `zero`: the same on every rank, since it adds a
        fence)."""
        nb = math.prod(block_shape) * dtype.itemsize
        seg, off = self.round(slots * nb)
        if zero:
            seg.view(self.rank, off, slots * nb).zero_()
            self.fence()            # zeroed before any peer stores
        for t, dst, slot in sends:
            seg.view(dst, off + slot * nb, nb).copy_(as_bytes(t))
        self.fence()
        return self.take(seg, off, (slots,) + tuple(block_shape), dtype)

    def store(self, x: torch.Tensor, shift: int, seg: Segment, off: int) -> None:
        """A plain peer put's store, with no fence: this rank's block into
        rank (rank + shift) mod p's block of `seg` at byte `off`."""
        self._check(x)
        cost.record_collective("collective-permute", x.nbytes, self.p)
        seg.view(self.rank + int(shift), off, x.nbytes).copy_(as_bytes(x))

    def shift(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """``out[0]`` = the block of rank (rank - shift) mod p: this rank's
        block stored into rank (rank + shift) mod p's (a plain peer put)."""
        self._check(x)
        seg, off = self.round(x.nbytes)
        self.store(x, shift, seg, off)
        self.fence()
        return self.take(seg, off, tuple(x.shape), x.dtype)

    def pull(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """``out[0]`` = the block of rank (rank + shift) mod p, read from its
        window: every rank exposes its block in its own, then reads the
        peer's (a plain peer get)."""
        self._check(x)
        seg, off = self.round(x.nbytes)
        seg.view(self.rank, off, x.nbytes).copy_(as_bytes(x))
        self.fence()
        got = seg.view(self.rank + int(shift), off, x.nbytes).clone()
        return got.view(x.dtype).reshape(x.shape)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``out[0]`` = the block of the pair ``(src, rank)``, zeros where no
        pair names this rank."""
        self._check(x)
        cost.record_collective("collective-permute", x.nbytes, self.p)
        sends = [(x[0], d, 0) for s, d in perm if s == self.rank]
        got = self._exchange_blocks(tuple(x.shape[1:]), x.dtype, 1, sends,
                                    zero=len({d for _, d in perm}) < self.p)
        return got.reshape(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x [1, ...] -> [1, p(source), ...]."""
        self._check(x)
        cost.record_collective("all-gather", x.nbytes, self.p)
        sends = [(x[0], d, self.rank) for d in range(self.p)]
        return self._exchange_blocks(tuple(x.shape[1:]), x.dtype, self.p, sends)[None]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [1, p_dst, ...] -> [1, p_src, ...]: block d goes to rank d."""
        self._check(x)
        if x.ndim < 2 or x.shape[1] != self.p:
            raise MeshError(f"all_to_all needs [1, p, ...], got {tuple(x.shape)}")
        cost.record_collective("all-to-all", x.nbytes, self.p)
        sends = [(x[0, d], d, self.rank) for d in range(self.p)]
        return self._exchange_blocks(tuple(x.shape[2:]), x.dtype, self.p, sends)[None]

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x [1, p*m, ...] -> [1, m, ...]: chunk `rank` of the sum over ranks."""
        self._check(x)
        if x.ndim < 2 or x.shape[1] % self.p:
            raise MeshError(f"psum_scatter needs [1, p*m, ...], got {tuple(x.shape)}")
        cost.record_collective("reduce-scatter", x.nbytes, self.p)
        chunks = x.reshape((1, self.p, x.shape[1] // self.p) + tuple(x.shape[2:]))
        sends = [(chunks[0, d], d, self.rank) for d in range(self.p)]
        got = self._exchange_blocks(tuple(chunks.shape[2:]), x.dtype, self.p, sends)
        return got.sum(0, dtype=x.dtype)[None]

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` over `axis`: every rank the sum over that axis's
        ranks, in their order (on a grid, through `along`)."""
        self.dim(axis)
        if len(self.shape) > 1:
            self._check_rank_dims(x)
            return self.back(self.along(axis).psum(self.front(x, axis), axis), axis)
        self._check(x)
        cost.record_collective("all-reduce", x.nbytes, self.p, 1)
        sends = [(x[0], d, self.rank) for d in range(self.p)]
        got = self._exchange_blocks(tuple(x.shape[1:]), x.dtype, self.p, sends)
        return got.sum(0, keepdim=True, dtype=x.dtype)

    @staticmethod
    def replicated(gathered: torch.Tensor) -> torch.Tensor:
        """The one copy of an `all_gather` result: [p, ...]."""
        return gathered[0]


# ----------------------------------------------------------------- launch
def _rank_main(fn, rank: int, p: int, device: str, n_dev: int, workdir: str,
               axis, args: tuple, results, timeout: float) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ok = False
    try:
        store = torch.distributed.FileStore(os.path.join(workdir, "store"), p)
        # the bootstrap's own deadline; `run` cuts a rank at `timeout`
        torch.distributed.init_process_group(
            "gloo", store=store, rank=rank, world_size=p,
            timeout=datetime.timedelta(seconds=max(timeout, 300.0)))
        if device == "cuda":
            dev = torch.device("cuda", rank % n_dev)
            torch.cuda.set_device(dev)
            devices = [f"cuda:{r % n_dev}" for r in range(p)]
        else:
            dev, devices = torch.device("cpu"), ["cpu"] * p
        shape = axis if isinstance(axis, dict) else p
        mesh = ProcMesh(shape, rank, axis, dev, workdir=workdir, devices=devices)
        out = pickle.dumps(fn(mesh, *args))    # by value: this process exits
        mesh.close()
        results.put((rank, "ok", out))
        ok = True
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if ok:
            torch.distributed.destroy_process_group()


def run(fn: Callable, nprocs: int, device=None, *, args: tuple = (), axis="serve",
        axes: Optional[dict] = None, timeout: float = 600.0) -> list:
    """``fn(mesh, *args)`` in `nprocs` processes, one rank each; returns
    their results in rank order.  The mesh has the one axis `axis`, or
    the grid `axes` (a dict of named axes, also taken as `axis`), whose
    ranks must number `nprocs`.  `fn` must be importable by name (spawn)
    and its results picklable.  Raises `ProcMeshError` with a rank's
    traceback if it raises, or when `timeout` seconds pass before every
    rank is done; no rank process is left running either way."""
    if axes is not None:
        axis = dict(axes)
    if isinstance(axis, dict) and math.prod(axis.values()) != nprocs:
        raise MeshError(f"a grid {axis} of {math.prod(axis.values())} ranks over "
                        f"{nprocs} processes")
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise MeshError(f"a ProcMesh runs on cuda or cpu, not {dev}")
    n_dev = 1
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        common.build("rma_peer")        # once, before the ranks start
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="procmesh-") as workdir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nprocs, dev.type, n_dev, workdir, axis, args,
                                   results, timeout))
                 for r in range(nprocs)]
        for pr in procs:
            pr.start()
        try:
            return _collect(procs, results, timeout)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                pr.join(30)
            results.close()


def _collect(procs, results, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    got: dict = {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(got))
            raise ProcMeshError(f"ranks {missing} not done after {timeout} s: killed")
        try:
            rank, status, out = results.get(timeout=min(left, 0.5))
        except queue_mod.Empty:
            dead = [r for r, pr in enumerate(procs)
                    if r not in got and pr.exitcode not in (None, 0)]
            if dead and results.empty():
                raise ProcMeshError(f"rank {dead[0]} died with exit code "
                                    f"{procs[dead[0]].exitcode} before reporting")
            continue
        if status == "error":
            raise ProcMeshError(f"rank {rank} raised:\n{out}")
        got[rank] = pickle.loads(out)
    for pr in procs:
        pr.join(max(1.0, deadline - time.monotonic()))
    return [got[r] for r in range(len(procs))]
