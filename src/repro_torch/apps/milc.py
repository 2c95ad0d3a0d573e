"""MILC-style 4-D lattice stencil with a one-sided halo exchange (the
port's counterpart of `examples/milc_stencil.py` and `benchmarks/bench_milc.py`).

The lattice is distributed over the ranks along T: rank r holds
``[T_local, X, Y, Z, 6]`` sites (a 3-component complex vector as 6 reals),
so the stacked lattice is ``[p, T_local, X, Y, Z, 6]`` (on a `ProcMesh`,
one rank a process, each process holds its own ``[1, T_local, ...]``).
One step exchanges
one T-slice with each T neighbour inside a PSCW epoch (k = 2 neighbours:
the configuration where the paper's model prefers PSCW at scale; over
processes the epoch's tokens are the step's only synchronisation) and
rolls periodically along X/Y/Z locally:

    out = sum over the 8 neighbours of v  -  8 v
"""

from __future__ import annotations

import torch

from ..core import collectives
from ..core.epoch import PSCWEpoch
from ..mesh import Mesh, MeshError

SITE_REALS = 6      # one 3-component complex vector


def stencil_step(lattice: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One stencil application: lattice [p, T_local, X, Y, Z, 6] -> same
    (the rank blocks this process holds: all p on a `Mesh`)."""
    if lattice.ndim != 6 or lattice.shape[0] != mesh.local_ranks:
        raise MeshError(f"lattice must be [{mesh.local_ranks}, T_local, X, Y, Z, "
                        f"{SITE_REALS}], got {tuple(lattice.shape)}")
    ep = PSCWEpoch(mesh, group=[0, 1])          # 2 neighbours on the T ring
    v = ep.post(lattice)
    h_left, h_right = collectives.halo_puts(v, 1, mesh, dim=0, sync=ep)
    v = ep.complete(v)                          # on a ProcMesh: the puts visible
    padded = torch.cat([h_left.result(), v, h_right.result()], dim=1)
    acc = padded[:, 2:] + padded[:, :-2]        # T+1 and T-1
    for d in (2, 3, 4):                         # X, Y, Z
        acc = acc + torch.roll(v, 1, dims=d) + torch.roll(v, -1, dims=d)
    return acc - 8.0 * v


def stencil_reference(lattice: torch.Tensor) -> torch.Tensor:
    """The whole-lattice stencil on the global [T, X, Y, Z, 6] view (the
    example's single-device `want`), returned in the stacked layout."""
    g = lattice.reshape((-1,) + tuple(lattice.shape[2:]))
    want = torch.roll(g, 1, dims=0) + torch.roll(g, -1, dims=0)
    for d in (1, 2, 3):
        want = want + torch.roll(g, 1, dims=d) + torch.roll(g, -1, dims=d)
    return (want - 8.0 * g).reshape(lattice.shape)
