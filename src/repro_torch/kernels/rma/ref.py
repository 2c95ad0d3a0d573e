"""Plain PyTorch versions of the RMA kernels (the `repro.kernels.rma.ref`
oracles) on the stacked ``[p, ...]`` view: the mesh's ppermute on dim 0,
an owner-side add, and a broadcast copy."""

from __future__ import annotations

import torch

from ...mesh import Mesh


def put_shift_ref(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """``out[(r + shift) % p] = x[r]``."""
    return mesh.shift(x, shift)


def get_shift_ref(x: torch.Tensor, src_shift: int, mesh: Mesh) -> torch.Tensor:
    """``out[r] = x[(r + src_shift) % p]``: a put with the shift negated."""
    return put_shift_ref(x, -src_shift, mesh)


def accumulate_shift_ref(x: torch.Tensor, acc: torch.Tensor, shift: int,
                         mesh: Mesh) -> torch.Tensor:
    """``out[r] = acc[r] + x[(r - shift) % p]``."""
    return acc + put_shift_ref(x, shift, mesh)


def ring_all_gather_ref(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [p, ...] -> [p(receiver), p(source), ...]: every receiver's copy."""
    mesh._check(x)
    return x.unsqueeze(0).expand((mesh.p,) + tuple(x.shape)).clone()
