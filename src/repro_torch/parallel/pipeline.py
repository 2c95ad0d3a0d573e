"""Pipeline parallelism (GPipe) over the `pod` axis, built on one-sided puts
(the `repro.parallel.pipeline` counterpart).

Stages map to the ranks of one mesh axis; activations flow stage to stage
as one-sided puts (`core.rma.put_shift(+1)`), and microbatches fill the
pipeline.  The schedule is the classic (n_micro + n_stages - 1)-tick loop
with bubble fraction (S - 1) / (M + S - 1).

Every tensor is the stacked global view: at tick t rank s applies stage s
to microbatch t - s.  The reference computes zeros at an inactive tick and
never records them, so an inactive rank here skips its compute and puts
zeros.  `stage_fn(stage_params_s, x)` gets rank s's slice of
`stage_params` with its leading stage dim kept at 1, as a `shard_map`
shard of ``P("pod", ...)`` is.  On a `ProcMesh` over the axis (one stage a
process) rank s holds only its stage's parameters and its row of every
tensor, and on the card the put to stage s + 1 is the put kernel's peer
form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import rma
from ..mesh import Mesh, MeshError
from ..procmesh import ProcMesh
from ..train.optimizer import tree_map


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_micro: int
    axis: str = "pod"

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / (self.n_micro + self.n_stages - 1)


def _words(y: torch.Tensor) -> torch.Tensor:
    """y's rank blocks as 32-bit words (a view) where each is whole words,
    so the put kernel carries activations of any dtype; else y."""
    if y.dtype.itemsize == 4 or y[0].numel() * y.element_size() % 4:
        return y
    return y.reshape(y.shape[0], -1).view(torch.int32)


def pipeline_forward(stage_fn: Callable, stage_params: Any, x_micro: torch.Tensor,
                     cfg: PipelineConfig, mesh: Mesh) -> torch.Tensor:
    """The GPipe forward schedule over `cfg.axis` of `mesh`.

    stage_params: a tree whose leaves carry the leading stage dim
    [n_stages, ...] (on a `ProcMesh`, [1, ...]: this rank's stage only);
    x_micro [n_micro, mb, ...]: stage 0's inputs, the same at every rank.
    At tick t rank s computes microbatch t - s (when in range) and puts its
    activation to rank s + 1 (as 32-bit words where a block is whole
    words); the last stage records finished microbatches.  Returns the
    global view [n_stages, n_micro, mb, ...] (on a `ProcMesh` this rank's
    row [1, ...]): every rank holds the last stage's outputs, put there by
    one broadcast from it."""
    sub = mesh.along(cfg.axis)
    if len(mesh.axis_names) > 1 or sub.p != cfg.n_stages:
        raise MeshError(f"pipeline_forward runs {cfg.n_stages} stages over a mesh of the "
                        f"one axis {cfg.axis!r}, got axes {mesh.shape}")
    S, M = cfg.n_stages, cfg.n_micro
    mb_shape = tuple(x_micro.shape[1:])
    if isinstance(mesh, ProcMesh):          # one stage a process: its own parameters
        held, stages = [mesh.rank], [stage_params]
    else:
        held = list(range(S))
        stages = [tree_map(lambda a, s=s: a[s:s + 1], stage_params) for s in range(S)]
    R = len(held)
    inflight = torch.zeros((R,) + mb_shape, dtype=x_micro.dtype, device=x_micro.device)
    outputs = torch.zeros((R, M) + mb_shape, dtype=x_micro.dtype, device=x_micro.device)
    for t in range(M + S - 1):
        y = torch.zeros_like(inflight)
        for i, s in enumerate(held):
            if max(0, t - M + 1) <= s <= min(t, S - 1):
                # stage 0 reads fresh input; the others what arrived last tick
                my_in = x_micro[t] if s == 0 else inflight[i]
                y[i] = stage_fn(stages[i], my_in)
        # one-sided put to the next stage
        inflight = rma.put_shift(_words(y), +1, sub).view(y.dtype).reshape(y.shape)
        if t >= S - 1 and held[-1] == S - 1:      # the last stage finished t - (S - 1)
            outputs[R - 1, t - (S - 1)] = y[R - 1]
    # the results live on the last stage: one-sided broadcast to every stage
    return rma.put_bcast(outputs, S - 1, sub)
