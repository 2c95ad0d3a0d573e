"""RMA windows (paper §2.2) over the stacked rank axis.

MPI-3.0 defines four collective window-creation modes with very different
scalability properties; the paper's point is that *allocated* windows (the
symmetric heap) need only O(1) metadata per process while *traditional*
windows need Ω(p).  The four modes over a `Mesh`:

  * ``win_allocate``       — symmetric heap: every rank holds an identical
    local shape at an identical logical offset, so one (shape, dtype, axis)
    tuple — O(1) — describes all remote regions.  On one device the global
    buffer is a ``[p, *local_shape]`` tensor and rank r's window is row r.
  * ``win_create``         — exposes memory at arbitrary per-rank base
    offsets: the O(p) offset table is stored and counted (the paper's Ω(p)
    lower bound, and its advice: avoid).
  * ``win_create_dynamic`` — attach/detach regions after creation: a region
    registry with an id counter, and `DescriptorCache` invalidation.
  * ``win_allocate_shared``— the intra-node window: same layout as an
    allocated window (on one card every rank is load/store reachable).

On a `ProcMesh` (one rank a process) ``win_allocate`` and ``win_create``
give this rank's block ``[1, *local_shape]`` of a symmetric segment that
every peer maps (`Window.peer` is rank r's block as mapped here, for
direct loads and stores), and ``win_free`` releases it: a fence, every
peer closes its mapping, a barrier, every owner frees.

Windows are metadata; ``Window.metadata_nbytes()`` counts the same bytes as
the reference (`repro.core.window`), so the complexity claims hold for
both packages.  The reference's ``Window.global_spec()`` (a JAX
``NamedSharding``) has no counterpart: the rank axis is the leading
dimension of one tensor, not a device placement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..mesh import Mesh
from ..procmesh import ProcMesh


class WindowError(RuntimeError):
    pass


@dataclasses.dataclass
class Window:
    """Descriptor of an RMA window over one mesh axis.  ``mesh`` may be
    None for a window used only as a descriptor (a dynamic window's region
    registry)."""

    kind: str                       # create | allocate | dynamic | shared
    mesh: Optional[Mesh]
    local_shape: tuple[int, ...]    # shape owned by each rank
    dtype: Any
    disp_unit: int = 1
    # traditional windows only: per-rank base offsets (the Ω(p) table)
    base_offsets: Optional[np.ndarray] = None
    # dynamic windows only
    attach_id: int = 0
    regions: dict = dataclasses.field(default_factory=dict)
    _next_region: int = 0
    # on a ProcMesh: the symmetric segment that holds every rank's block
    segment: Any = None

    @property
    def axis(self) -> Optional[str]:
        return None if self.mesh is None else self.mesh.axis

    @property
    def n_ranks(self) -> int:
        return self.mesh.p

    def global_shape(self) -> tuple[int, ...]:
        return (self.n_ranks,) + tuple(self.local_shape)

    def block_shape(self) -> tuple[int, ...]:
        """The tensor this process holds: every rank's block on a stacked
        `Mesh`, its own on a `ProcMesh`."""
        return (self.mesh.local_ranks,) + tuple(self.local_shape)

    def peer(self, rank: int) -> torch.Tensor:
        """Rank `rank`'s block [1, *local_shape] as mapped in this process
        (a `ProcMesh` window): loads and stores reach its memory."""
        if self.segment is None:
            raise WindowError("peer() needs a window allocated on a ProcMesh")
        return self.segment.tensor(rank, self.block_shape(), self.dtype)

    def metadata_nbytes(self) -> int:
        """Bytes of per-process metadata — the paper's scalability metric."""
        base = 64  # kind/axis/shape/dtype/disp_unit — O(1)
        if self.base_offsets is not None:
            base += self.base_offsets.nbytes  # Ω(p) for traditional windows
        return base + 48 * len(self.regions)  # O(1) a region (a list node)

    # ---------------------------------------------------- dynamic windows
    def attach(self, name: str, local_shape: tuple[int, ...], dtype: Any) -> int:
        """MPI_Win_attach: register a region; O(1) memory a region (§2.2).
        Bumps ``attach_id``, which invalidates remote descriptor caches."""
        if self.kind != "dynamic":
            raise WindowError("attach requires a dynamic window")
        rid = self._next_region
        self._next_region += 1
        self.regions[rid] = (name, tuple(local_shape), dtype)
        self.attach_id += 1
        return rid

    def detach(self, rid: int) -> None:
        if self.kind != "dynamic":
            raise WindowError("detach requires a dynamic window")
        if rid not in self.regions:
            raise WindowError(f"region {rid} not attached")
        del self.regions[rid]
        self.attach_id += 1


class DescriptorCache:
    """Origin-side cache of a target's dynamic-window regions (paper §2.2).

    A lookup first gets the target's ``attach_id`` (one remote op); on a
    mismatch the cached list is discarded and re-fetched with one read a
    region.  ``remote_ops`` counts them, so tests can check the
    O(1)-amortized claim; with a host `fabric` the same reads are charged
    to its op ledger as gets."""

    def __init__(self, fabric=None) -> None:
        self.cached_id: int = -1
        self.descriptors: dict = {}
        self.remote_ops: int = 0
        self.fabric = fabric

    def _charge(self, n: int) -> None:
        self.remote_ops += n
        if self.fabric is not None:
            self.fabric._count("gets", n)

    def lookup(self, target: Window, rid: int):
        self._charge(1)  # get(attach_id)
        if self.cached_id != target.attach_id:
            self._charge(max(1, len(target.regions)))
            self.descriptors = dict(target.regions)
            self.cached_id = target.attach_id
        if rid not in self.descriptors:
            raise WindowError(f"region {rid} not attached at target")
        return self.descriptors[rid]


# ------------------------------------------------------------------ creation
def _buffer(win: Window) -> torch.Tensor:
    """A window's zero-filled memory on the mesh device: the stacked
    ``[p, ...]`` tensor, or on a `ProcMesh` this rank's block of a new
    symmetric segment (collective)."""
    mesh = win.mesh
    if not isinstance(mesh, ProcMesh):
        return torch.zeros(win.global_shape(), dtype=win.dtype, device=mesh.device)
    win.segment = mesh.allocate(math.prod(win.local_shape) * win.dtype.itemsize)
    return win.peer(mesh.rank)


def win_allocate(mesh: Mesh, local_shape: tuple[int, ...],
                 dtype: Any = torch.float32) -> tuple[Window, torch.Tensor]:
    """MPI_Win_allocate: the symmetric heap, zero-filled on the mesh device."""
    win = Window("allocate", mesh, tuple(local_shape), dtype)
    return win, _buffer(win)


def win_free(win: Window) -> None:
    """MPI_Win_free: on a `ProcMesh`, collective; the window's tensors must
    not be used after it.  A stacked window's tensor is freed by PyTorch."""
    if win.segment is not None:
        win.segment.free()
        win.segment = None


def win_create(base_offsets, mesh: Mesh, local_shape: tuple[int, ...],
               dtype: Any = torch.float32) -> tuple[Window, torch.Tensor]:
    """MPI_Win_create: expose memory at arbitrary per-rank offsets.  Needs
    the Ω(p) base-offset table (one int64 a rank), which is stored so
    ``metadata_nbytes`` shows the cost."""
    offsets = np.asarray(base_offsets, dtype=np.int64)
    if offsets.shape != (mesh.p,):
        raise WindowError(
            f"need one base offset per rank on axis {mesh.axis!r} ({mesh.p})")
    win = Window("create", mesh, tuple(local_shape), dtype, base_offsets=offsets)
    return win, _buffer(win)


def win_create_dynamic(mesh: Optional[Mesh]) -> Window:
    """MPI_Win_create_dynamic: a window with attach/detach; O(1) a region."""
    return Window("dynamic", mesh, (), torch.float32)


def win_allocate_shared(mesh: Mesh, local_shape: tuple[int, ...],
                        dtype: Any = torch.float32) -> tuple[Window, torch.Tensor]:
    """MPI_Win_allocate_shared: the layout of an allocated window."""
    win, buf = win_allocate(mesh, local_shape, dtype)
    win.kind = "shared"
    return win, buf
