"""Plain PyTorch versions of the fused ring matmul on the stacked rank axis
(the counterpart of `repro.kernels.ring_matmul.ref`).

W is row-sharded over the ring: ``w [n, K/n, N]`` holds rank r's shard at
``w[r]``, and every rank holds the whole ``x_t [K, m]``.

`ring_matmul_ref` is the reference's oracle: all-gather the shards, then
one f32 matmul, ``[m, N]`` (every rank's result is the same).
`ring_schedule_ref` runs the ring schedule the kernel runs, step by step,
and gives each rank's own copy ``[n, m, N]``: at step i every rank forwards
the shard it holds to its right neighbour's other buffer slot and adds
``x_t[j*ks:(j+1)*ks].T @ shard`` for the shard it holds, ``j = (r - i) mod
n``, to its output, in f32.  The `ops` wrapper computes it on CPU tensors.
On a `ProcMesh` (one rank a process) w is this rank's shard ``[1, K/n,
N]``, the shard travels by the mesh's plain peer copy, and the result is
this rank's copy ``[1, m, N]``.
"""

from __future__ import annotations

import torch

from ...mesh import Mesh


def ring_matmul_ref(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x_t [K, m], w [n, K/n, N] -> [m, N] f32."""
    w_full = Mesh.replicated(mesh.all_gather(w)).reshape(-1, w.shape[-1])   # [K, N]
    return x_t.float().T @ w_full.float()


def ring_schedule_ref(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x_t [K, m], w [n, K/n, N] -> [n, m, N] f32, rank r's output at [r].
    Step 0 multiplies each rank's own shard in place; the buffer's slots
    alternate from step 1 on, as the kernel's do."""
    n, ks = mesh.p, w.shape[1]
    xs = x_t.float().reshape(n, ks, x_t.shape[1])             # [n, K/n, m]
    me = mesh.axis_index()
    buf = torch.empty((w.shape[0], 2) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    out = None
    for i in range(n):
        held = w if i == 0 else buf[:, i % 2]
        if i < n - 1:
            buf[:, (i + 1) % 2] = mesh.shift(held, 1)         # to the right neighbour
        part = torch.bmm(xs[(me - i) % n].transpose(1, 2), held.float())
        out = part if out is None else out + part
    return out
