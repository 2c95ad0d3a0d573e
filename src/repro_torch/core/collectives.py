"""Collective schedules composed from one-sided ops (the
`repro.core.collectives` counterpart on the stacked rank axis).

Every collective below is built only from `repro_torch.core.rma` one-sided
ops and (where one step issues several ops — the halo exchange, the
bidirectional ring step) single-epoch `RmaPlan`s, so each put goes through
the plan's backend dispatch.  The reference's `fori_loop`/`cond` become
Python loops over steps; a rank's own index ``me`` becomes
`Mesh.axis_index()` with advanced indexing, so each step is batched over
all ranks.  Every tensor is the global view ``[p, ...]``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..mesh import Mesh, MeshError
from . import plan as plan_mod, rma


# ------------------------------------------------------------ ring schedules
def ring_all_gather(x: torch.Tensor, mesh: Mesh,
                    bidirectional: bool = True) -> torch.Tensor:
    """All-gather via p - 1 one-sided ring puts; bidirectional sends half the
    shards each way.  x [p, ...] -> [p, p, ...]: rank r holds every rank's
    block in rank order."""
    p = mesh.p
    me = mesh.axis_index()
    if p == 1:
        return x[:, None].clone()

    out = torch.zeros((p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[me, me] = x

    if not bidirectional:
        buf = x
        for i in range(p - 1):
            buf = rma.put_shift(buf, +1, mesh)           # receive from the left
            out[me, (me - i - 1) % p] = buf
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
            out[me, (me - i - 1) % p] = fwd
        if i < steps_b:
            out[me, (me + i + 1) % p] = bwd
    return out


def ring_reduce_scatter(x: torch.Tensor, mesh: Mesh,
                        op: Callable = torch.add) -> torch.Tensor:
    """Reduce-scatter via ring accumulate: x [p, p, ...] (rank r's p chunks)
    -> [p, ...] (rank r's reduced chunk r).  Step i forwards the growing
    partial of chunk (r - 1 - i) mod p to the right neighbour."""
    p = mesh.p
    me = mesh.axis_index()
    if p == 1:
        return x[:, 0].clone()

    acc = torch.zeros_like(x[:, 0])
    for i in range(p - 1):
        chunk = x[me, (me - 1 - i) % p]
        outgoing = chunk if i == 0 else op(chunk, acc)
        acc = rma.put_shift(outgoing, +1, mesh)
    return op(x[me, me], acc)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: Callable = torch.add) -> torch.Tensor:
    """Reduce-scatter + all-gather ring all-reduce over the axis, built only
    on one-sided puts.  x [p, ...] -> [p, ...], every rank the reduction."""
    p = mesh.p
    if p == 1:
        return x.clone()
    flat = x.reshape(p, -1)
    n = flat.shape[1]
    parts = torch.nn.functional.pad(flat, (0, (-n) % p)).reshape(p, p, -1)
    shard = ring_reduce_scatter(parts, mesh, op)
    full = ring_all_gather(shard, mesh)
    return full.reshape(p, -1)[:, :n].reshape(x.shape)


# ------------------------------------------------------------- halo exchange
def halo_exchange_1d(x: torch.Tensor, halo: int, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Bidirectional halo exchange via one-sided puts (the MILC pattern).

    `dim` counts a rank's own dims (0 is the first dim after the rank dim).
    Returns x padded with `halo` remote rows on each side of `dim`
    (periodic): two puts in one plan, O(k=2) messages."""
    d = dim + 1
    lo = x.narrow(d, 0, halo)
    hi = x.narrow(d, x.shape[d] - halo, halo)
    ep = plan_mod.RmaPlan(mesh)
    h_left = ep.put_shift(hi, +1)    # the left neighbour's high rows
    h_right = ep.put_shift(lo, -1)   # the right neighbour's low rows
    ep.flush()
    return torch.cat([h_left.result(), x, h_right.result()], dim=d)


def halo_exchange_nd(x: torch.Tensor, halos: dict[str, int],
                     axis_dims: dict[str, int], mesh: Mesh) -> torch.Tensor:
    """Multi-axis halo exchange: one 1-D exchange per named axis.  The
    port's mesh has one axis, so `halos` may name only `mesh.axis`."""
    for ax, h in halos.items():
        if ax != mesh.axis:
            raise MeshError(f"halo_exchange_nd: axis {ax!r} is not the mesh's "
                            f"axis {mesh.axis!r}")
        if h > 0:
            x = halo_exchange_1d(x, h, mesh, dim=axis_dims[ax])
    return x


# ------------------------------------------------------------------ alltoall
def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Personalised exchange: x [p_src, p_dst, ...] -> [p_dst, p_src, ...]."""
    return rma.put_all_to_all(x, mesh)


def broadcast(x: torch.Tensor, root: int, mesh: Mesh) -> torch.Tensor:
    return rma.put_bcast(x, root, mesh)
