"""Plain PyTorch versions of the RMA kernels (the `repro.kernels.rma.ref`
oracles) on the stacked ``[p, ...]`` view: the mesh's ppermute on dim 0,
an owner-side add, and a broadcast copy.  On a `ProcMesh` (one rank a
process, x this rank's ``[1, ...]`` block) the same functions are the peer
forms' plain versions: ``Tensor.copy_`` into the peer's mapped block (the
put, `ProcMesh.shift`), a read of the peer's (the get, `ProcMesh.pull`),
``acc + slot`` for the accumulate, and the ring gather's p - 1 hops."""

from __future__ import annotations

import torch

from ...mesh import Mesh
from ...procmesh import ProcMesh, as_bytes


def put_shift_ref(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """``out[(r + shift) % p] = x[r]``."""
    return mesh.shift(x, shift)


def get_shift_ref(x: torch.Tensor, src_shift: int, mesh: Mesh) -> torch.Tensor:
    """``out[r] = x[(r + src_shift) % p]``: a put with the shift negated (on
    a `ProcMesh`, a read of the peer's exposed block)."""
    if isinstance(mesh, ProcMesh):
        return mesh.pull(x, src_shift)
    return put_shift_ref(x, -src_shift, mesh)


def accumulate_shift_ref(x: torch.Tensor, acc: torch.Tensor, shift: int,
                         mesh: Mesh) -> torch.Tensor:
    """``out[r] = acc[r] + x[(r - shift) % p]``."""
    return acc + put_shift_ref(x, shift, mesh)


def ring_all_gather_ref(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [p, ...] -> [p(receiver), p(source), ...]: every receiver's copy
    (on a `ProcMesh`, [1, ...] -> [1, p, ...] by p - 1 hops to the right
    neighbour, slot (rank - h) mod p forwarded at hop h)."""
    mesh._check(x)
    if not isinstance(mesh, ProcMesh):
        return x.unsqueeze(0).expand((mesh.p,) + tuple(x.shape)).clone()
    p, rank, nb = mesh.p, mesh.rank, x.nbytes
    seg, off = mesh.round(p * nb)
    src = as_bytes(x)
    for hop in range(p - 1):
        b = (rank - hop) % p
        if hop:
            src = seg.view(rank, off + b * nb, nb)
        seg.view(rank + 1, off + b * nb, nb).copy_(src)
        mesh.fence()
    out = mesh.take(seg, off, (p,) + tuple(x.shape[1:]), x.dtype)
    out[rank] = x[0]
    return out[None]
