"""Distributed 3-D FFT with a one-sided transpose (paper §4.3): the port's
counterpart of `examples/fft3d.py` and `benchmarks/bench_fft.py`.

The N³ grid is distributed over the ranks along x: rank r holds the slab
``[N/p, N, N]`` (x, y, z) of complex64, so the stacked grid is
``[p, N/p, N, N]``.  The pencil transform:

  1. each rank's local 2-D FFT over (y, z);
  2. the transpose: every rank puts its x-slab's p y-blocks to their owners
     through `core.collectives.all_to_all` (p one-sided puts in one epoch),
     so each rank holds every x for its N/p values of y;
  3. the 1-D FFT over x;
  4. the transpose back, so each rank again holds its x-slab, transformed.

`fft3d_slabs` computes the same result in the schedule the paper overlaps:
each x-plane's 2-D FFT, then that plane's own exchange, so one plane's
exchange can run while the next plane transforms.

The complex64 payload goes through the plan unpacked (a single-op plan is
never packed, so its dtype never meets the plan's 32-bit word codec).  With
every rank on one device an all-to-all is a view of the stacked grid, and
`torch.fft` keeps its input's layout, so neither transpose copies: the
x-axis FFT reads the strided view.
"""

from __future__ import annotations

import math

import torch

from ..core import collectives
from ..mesh import Mesh, MeshError


def fft_flops(n: int) -> float:
    """The standard operation count of an N³ complex FFT, 5 N³ log2 N³."""
    return 5.0 * n ** 3 * math.log2(n ** 3)


def _grid(x: torch.Tensor, mesh: Mesh) -> tuple[int, int]:
    """(N, N/p) of a stacked grid; raises unless x is [p, N/p, N, N]."""
    p = mesh.p
    if x.ndim != 4 or x.shape[0] != p or x.shape[2] != x.shape[3]:
        raise MeshError(f"grid must be [{p}, N/{p}, N, N], got {tuple(x.shape)}")
    n = x.shape[2]
    if n % p or x.shape[1] != n // p:
        raise MeshError(f"N = {n} must split into p = {p} slabs of N/p x-planes, "
                        f"got {tuple(x.shape)}")
    return n, n // p


def _x_fft_and_back(blocks: torch.Tensor, mesh: Mesh, s: int) -> torch.Tensor:
    """blocks [p(y-owner), p(x-block), s, N/p, N], every x of the owner's
    y-rows: the x-axis FFT, then the transpose back to x-slabs."""
    p = mesh.p
    n = p * s
    xs = torch.fft.fft(blocks.reshape(p, n, n // p, n), dim=1)
    back = collectives.all_to_all(xs.reshape(p, p, s, n // p, n), mesh)
    return back.transpose(1, 2).reshape(p, s, n, n)     # [x-owner, s, y, z]


def fft3d(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The pencil FFT of the stacked grid x [p, N/p, N, N] (complex):
    returns the 3-D spectrum in the same layout."""
    n, s = _grid(x, mesh)
    p = mesh.p
    v = torch.fft.fftn(x, dim=(2, 3))                  # local (y, z)
    blocks = v.reshape(p, s, p, n // p, n).transpose(1, 2)   # [src, y-owner, s, N/p, N]
    return _x_fft_and_back(collectives.all_to_all(blocks, mesh), mesh, s)


def fft3d_slabs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`fft3d`'s result, scheduled plane by plane: each x-plane's 2-D FFT,
    then that plane's own exchange of its y-blocks."""
    n, s = _grid(x, mesh)
    p = mesh.p
    planes = []
    for i in range(s):
        plane = torch.fft.fftn(x[:, i], dim=(1, 2))    # [p, N, N]
        planes.append(collectives.all_to_all(plane.reshape(p, p, n // p, n), mesh))
    blocks = torch.stack(planes, dim=2)                # [y-owner, src, s, N/p, N]
    return _x_fft_and_back(blocks, mesh, s)


def fft3d_reference(x: torch.Tensor) -> torch.Tensor:
    """`torch.fft.fftn` of the global [N, N, N] view (the example's
    single-device `want`), returned in the stacked layout."""
    n = x.shape[2]
    return torch.fft.fftn(x.reshape(n, n, n)).reshape(x.shape)
