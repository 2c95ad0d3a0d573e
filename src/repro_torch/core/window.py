"""RMA windows (paper §2.2) over the stacked rank axis.

``win_allocate`` is the symmetric heap: every rank holds an identical local
shape at an identical logical offset, so one (shape, dtype, axis) tuple —
O(1) metadata — describes all remote regions.  On one device the global
buffer is a ``[p, *local_shape]`` tensor and rank r's window is row r.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..mesh import Mesh


class WindowError(RuntimeError):
    pass


@dataclasses.dataclass
class Window:
    """Descriptor of a symmetric RMA window over one mesh axis."""

    kind: str                       # allocate (the only mode the path uses)
    mesh: Mesh
    local_shape: tuple[int, ...]    # shape owned by each rank
    dtype: Any

    @property
    def axis(self) -> str:
        return self.mesh.axis

    @property
    def n_ranks(self) -> int:
        return self.mesh.p

    def global_shape(self) -> tuple[int, ...]:
        return (self.n_ranks,) + tuple(self.local_shape)


def win_allocate(mesh: Mesh, local_shape: tuple[int, ...],
                 dtype: Any = torch.float32) -> tuple[Window, torch.Tensor]:
    """MPI_Win_allocate: the symmetric heap, zero-filled on the mesh device."""
    win = Window("allocate", mesh, tuple(local_shape), dtype)
    return win, torch.zeros(win.global_shape(), dtype=dtype, device=mesh.device)
