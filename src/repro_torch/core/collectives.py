"""Collective schedules composed from one-sided ops (the
`repro.core.collectives` counterpart on the stacked rank axis).

Every collective below is built only from `repro_torch.core.rma` one-sided
ops and (where one step issues several ops — the halo exchange, the
bidirectional ring step) single-epoch `RmaPlan`s, so each put goes through
the plan's backend dispatch.  The reference's `fori_loop`/`cond` become
Python loops over steps; a rank's own index ``me`` becomes
`Mesh.axis_index()` with advanced indexing, so each step is batched over
all ranks.  Every tensor is the global view ``[p, ...]``; on a `ProcMesh`
(one rank a process) it is this rank's row ``[1, ...]`` and the same code
runs the rank's own program, its puts the peer forms.

On a mesh of several named axes (``Mesh({"pod": 2, "data": 2})``) the
global view is ``[pod, data, ...]`` and ``axis=`` names the axis a
collective runs over: it is the one-axis schedule on the tensor with that
axis moved to the front (`Mesh.front`) and the axis's own mesh
(`Mesh.along`), the other rank dims riding along in every put.  A
collective moves the axis once on the way in and once on the way out, so
the ring's payloads stay contiguous from step to step.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..mesh import Mesh, MeshError
from . import plan as plan_mod, rma


def _axis(mesh: Mesh, axis) -> tuple[str, Mesh, int]:
    """(the axis a collective runs over, its one-axis mesh, the count of
    rank dims); None names a one-axis mesh's own axis."""
    if axis is None:
        if len(mesh.axis_names) > 1:
            raise MeshError(f"a mesh of axes {mesh.axis_names} needs axis=")
        axis = mesh.axis
    return axis, mesh.along(axis), len(mesh.axis_names)


# ------------------------------------------------------------ ring schedules
def ring_all_gather(x: torch.Tensor, mesh: Mesh, bidirectional: bool = True,
                    axis: str | None = None) -> torch.Tensor:
    """All-gather via p - 1 one-sided ring puts; bidirectional sends half the
    shards each way.  x [p, ...] -> [p, p, ...]: rank r holds every rank's
    block in rank order.  Over a named axis of a grid: x [ranks..., ...] ->
    [ranks..., p_axis, ...]."""
    axis, sub, k = _axis(mesh, axis)
    out = _ring_all_gather(mesh.front(x, axis), sub, bidirectional)
    return mesh.back(out.movedim(1, k), axis)


def _ring_all_gather(x: torch.Tensor, mesh: Mesh, bidirectional: bool) -> torch.Tensor:
    p = mesh.p
    me = mesh.axis_index()
    if p == 1:
        return x[:, None].clone()

    row = torch.arange(x.shape[0], device=x.device)     # the rank blocks held here
    out = torch.zeros((x.shape[0], p) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[row, me] = x

    if not bidirectional:
        buf = x
        for i in range(p - 1):
            buf = rma.put_shift(buf, +1, mesh)           # receive from the left
            out[row, (me - i - 1) % p] = buf
        return out

    fwd = bwd = x
    steps_f = (p - 1) - (p - 1) // 2
    steps_b = (p - 1) // 2
    for i in range(max(steps_f, steps_b)):
        # both directions of one ring step form one plan: the permutations
        # differ, so they stay two transfers under one dispatch
        step_plan = plan_mod.RmaPlan(mesh)
        h_f = step_plan.put_shift(fwd, +1)
        h_b = step_plan.put_shift(bwd, -1)
        step_plan.flush()
        fwd, bwd = h_f.result(), h_b.result()
        if i < steps_f:
            out[row, (me - i - 1) % p] = fwd
        if i < steps_b:
            out[row, (me + i + 1) % p] = bwd
    return out


def ring_reduce_scatter(x: torch.Tensor, mesh: Mesh, op: Callable = torch.add,
                        axis: str | None = None) -> torch.Tensor:
    """Reduce-scatter via ring accumulate: x [p, p, ...] (rank r's p chunks)
    -> [p, ...] (rank r's reduced chunk r).  Step i forwards the growing
    partial of chunk (r - 1 - i) mod p to the right neighbour.  Over a named
    axis of a grid: x [ranks..., p_axis, ...] -> [ranks..., ...]."""
    axis, sub, k = _axis(mesh, axis)
    out = _ring_reduce_scatter(mesh.front(x, axis).movedim(k, 1), sub, op)
    return mesh.back(out, axis)


def _ring_reduce_scatter(x: torch.Tensor, mesh: Mesh, op: Callable) -> torch.Tensor:
    p = mesh.p
    me = mesh.axis_index()
    if p == 1:
        return x[:, 0].clone()

    row = torch.arange(x.shape[0], device=x.device)     # the rank blocks held here
    acc = torch.zeros_like(x[:, 0])
    for i in range(p - 1):
        chunk = x[row, (me - 1 - i) % p]
        outgoing = chunk if i == 0 else op(chunk, acc)
        acc = rma.put_shift(outgoing, +1, mesh)
    return op(x[row, me], acc)


def _parts(x: torch.Tensor, k: int, p: int) -> tuple[torch.Tensor, int]:
    """Each rank's block flattened and zero-padded into p equal chunks:
    x [ranks(k dims)..., ...] -> ([ranks..., p, m], the unpadded length)."""
    flat = x.reshape(tuple(x.shape[:k]) + (-1,))
    n = flat.shape[-1]
    return torch.nn.functional.pad(flat, (0, (-n) % p)).unflatten(-1, (p, -1)), n


def _unparts(full: torch.Tensor, k: int, n: int, shape) -> torch.Tensor:
    """Inverse of `_parts`: the gathered chunks cut back to each block."""
    return full.flatten(k)[..., :n].reshape(shape)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: Callable = torch.add,
               axis: str | None = None) -> torch.Tensor:
    """Reduce-scatter + all-gather ring all-reduce over the axis, built only
    on one-sided puts.  x [p, ...] -> [p, ...], every rank the reduction
    (over a named axis of a grid, every rank of that axis)."""
    axis, sub, k = _axis(mesh, axis)
    if sub.p == 1:
        return x.clone()
    parts, n = _parts(x, k, sub.p)
    shard = ring_reduce_scatter(parts, mesh, op, axis=axis)
    full = ring_all_gather(shard, mesh, axis=axis)
    return _unparts(full, k, n, x.shape)


def hierarchical_all_reduce(x: torch.Tensor, mesh: Mesh, inner_axis: str,
                            outer_axis: str) -> torch.Tensor:
    """Two-level all-reduce over a grid: reduce-scatter within the pod (the
    ring over `inner_axis`), `psum` across pods (`outer_axis`: each rank
    carries 1/inner of its payload there), all-gather within the pod.
    x [ranks..., ...] -> the same shape, every rank the sum over both axes."""
    k = len(mesh.axis_names)
    parts, n = _parts(x, k, mesh.shape[inner_axis])
    shard = ring_reduce_scatter(parts, mesh, axis=inner_axis)   # in-pod
    shard = mesh.psum(shard, outer_axis)                        # cross-pod (1/p bytes)
    full = ring_all_gather(shard, mesh, axis=inner_axis)        # in-pod
    return _unparts(full, k, n, x.shape)


# ------------------------------------------------------------- halo exchange
def halo_exchange_1d(x: torch.Tensor, halo: int, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Bidirectional halo exchange via one-sided puts (the MILC pattern).

    `dim` counts a rank's own dims (0 is the first dim after the rank dim).
    Returns x padded with `halo` remote rows on each side of `dim`
    (periodic): two puts in one plan, O(k=2) messages."""
    h_left, h_right = halo_puts(x, halo, mesh, dim)
    return torch.cat([h_left.result(), x, h_right.result()], dim=dim + 1)


def halo_puts(x: torch.Tensor, halo: int, mesh: Mesh, dim: int = 0,
              sync=None) -> tuple:
    """The two puts of `halo_exchange_1d` in one flushed plan: handles of
    the left neighbour's high rows and the right neighbour's low rows.
    With `sync` (an open fence or PSCW epoch) they resolve when it closes
    on a `ProcMesh` (`RmaPlan.flush`), so the epoch's own synchronisation
    orders them."""
    d = dim + 1
    lo = x.narrow(d, 0, halo)
    hi = x.narrow(d, x.shape[d] - halo, halo)
    ep = plan_mod.RmaPlan(mesh)
    h_left = ep.put_shift(hi, +1)    # the left neighbour's high rows
    h_right = ep.put_shift(lo, -1)   # the right neighbour's low rows
    ep.flush(sync=sync)
    return h_left, h_right


def halo_exchange_nd(x: torch.Tensor, halos: dict[str, int],
                     axis_dims: dict[str, int], mesh: Mesh) -> torch.Tensor:
    """Multi-axis halo exchange (the 4-D MILC lattice): one 1-D exchange per
    named axis of the mesh, `axis_dims[ax]` counting a rank's own dims."""
    k = len(mesh.axis_names)
    for ax, h in halos.items():
        if h > 0:
            x = mesh.back(halo_exchange_1d(mesh.front(x, ax), h, mesh.along(ax),
                                           dim=axis_dims[ax] + k - 1), ax)
    return x


# ------------------------------------------------------------------ alltoall
def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Personalised exchange: x [p_src, p_dst, ...] -> [p_dst, p_src, ...]."""
    return rma.put_all_to_all(x, mesh)


def broadcast(x: torch.Tensor, root: int, mesh: Mesh) -> torch.Tensor:
    return rma.put_bcast(x, root, mesh)
