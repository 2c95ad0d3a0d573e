"""Train / prefill / serve steps with microbatch accumulation and remat (the
counterpart of `repro.train.train_step`).

PyTorch runs eagerly, so a step is a plain function, not a jitted one.
A `parallel.sharding.ShardingPolicy` (``policy=``) is active around the
loss and the AdamW update, where the reference activates it: its
placements change no value on one card, its MoE dispatch groups do.
Under a policy that splits the model over processes (`ShardingPolicy.
splits_model`) every step runs the split forward on this rank's blocks.
The train step there computes the reference's step on the global batch
(dense and moe families): the rank takes its rows of each microbatch by
the reference's batch spec (``P(("pod", "data"), None)``), an MoE
model's aux and z losses are this rank's terms of the batch's
(`models.moe.global_aux`), its backward runs through the split forward's
collectives (their autograd rules, `parallel.sharding`), each gradient
block is summed over the data axes (a leaf split over ``data`` by its
FSDP gather's backward, every other leaf and the loss in one ring
all-reduce of their concatenation) and divided by their ranks, and AdamW
updates the blocks with the clip's global norm counting each block once.
Microbatches run in a Python loop where the reference scans; their
f32-accumulated gradients are averaged (`step_grads`), and a split step
runs its collectives once a microbatch, its data sums once.  Remat
(`models.transformer.set_remat`) is switched on around the loss only, as
the reference does, so the flash kernel runs once a layer in the forward
and once more in the backward's recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..ckpt.checkpoint import _unflatten_like, flatten
from ..models import transformer as T
from ..models.registry import Model
from ..parallel.sharding import ShardingPolicy, use_policy
from .optimizer import AdamWConfig, OptState, adamw_update, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    remat: bool = True


def loss_and_grads(model: Model, params: dict, batch: dict, remat: bool = True,
                   policy: Optional[ShardingPolicy] = None, rows: Optional[int] = None
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of `model.loss` at `params`, under `policy`
    (`rows`: the global batch's row count under a model split); the grads
    have each param's dtype, zeros where a param does not reach the loss."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    T.set_remat(remat)
    try:
        with use_policy(policy):
            loss, met = model.loss(leaves, batch, rows)
    finally:
        T.set_remat(False)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(flat, got)}
    grads = tree_map(lambda p: by_id[id(p)], leaves)
    return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in met.items()}, grads


def step_grads(model: Model, params: dict, batch: dict, step_cfg: StepConfig = StepConfig(),
               policy: Optional[ShardingPolicy] = None) -> tuple[torch.Tensor, dict, dict]:
    """A train step's (loss, metrics, grads): one `loss_and_grads`, or with
    n microbatches (B must divide by n) their f32-accumulated grads and
    losses, averaged.  Under a policy that splits the model over processes
    `batch` is the global batch and `params` this rank's blocks: microbatch
    i is global rows [i B / n, (i + 1) B / n), as the reference splits the
    batch, of which the rank takes its rows (`ShardingPolicy.local_batch`;
    an MoE layer's dispatch groups and capacity drops depend on which rows
    form a microbatch); the loss and metrics are the global batch's, the
    grads this rank's blocks of its gradient."""
    loss, met, grads = _step_grads(model, params, batch, step_cfg, policy)
    if policy is None or not policy.splits_model:
        return loss, met, grads
    return _sum_over_data(model, policy, loss, met, grads)


def _step_grads(model, params, batch, step_cfg, policy):
    """`step_grads` on this process's rows, before the data sum."""
    split = policy is not None and policy.splits_model

    def part(mb):                       # (this rank's rows, the global row count)
        if not split:
            return mb, None
        return policy.local_batch(mb), mb["tokens"].shape[0]

    n = step_cfg.n_microbatches
    if n == 1:
        mb, rows = part(batch)
        return loss_and_grads(model, params, mb, step_cfg.remat, policy, rows)

    def micro(x, i):
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]

    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss = torch.zeros((), device=tree_leaves(params)[0].device)
    for i in range(n):
        mb, rows = part({k: micro(v, i) for k, v in batch.items()})
        l, _, g = loss_and_grads(model, params, mb, step_cfg.remat, policy, rows)
        grads = tree_map(torch.add, grads, g)
        loss = loss + l
    grads = tree_map(lambda g: g / n, grads)
    loss = loss / n
    return loss, {"nll": loss, "aux": torch.zeros_like(loss), "z": torch.zeros_like(loss)}, grads


_METRICS = ("nll", "aux", "z")


def _sum_over_data(model: Model, policy: ShardingPolicy, loss: torch.Tensor, met: dict,
                   grads: dict) -> tuple[torch.Tensor, dict, dict]:
    """This data rank's (loss, metrics, grads) -> the global batch's: on
    each data axis, one ring all-reduce of the loss, the metrics and every
    gradient block that the axis does not split (a block split over
    ``data`` is already summed there by its gather's backward); then
    everything divided by the data ranks (each took equal rows)."""
    specs = policy.flat_specs(model.init_shapes())
    g = dict(flatten(grads))
    vals = torch.stack([loss] + [torch.as_tensor(met[k], device=loss.device).float()
                                 for k in _METRICS])
    dp = 1
    for axis in policy.data_axes:
        dp *= policy.mesh.shape[axis]
        todo = [p for p in g if not policy.names(specs[p], axis)]
        *summed, vals = policy.sum_over(axis, [g[p] for p in todo] + [vals])
        g.update(zip(todo, summed))
    g = {p: (v.float() / dp).to(v.dtype) for p, v in g.items()}
    vals = vals / dp
    return vals[0], dict(zip(_METRICS, vals[1:])), _unflatten_like(grads, g)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(),
                    policy: Optional[ShardingPolicy] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).
    Under a policy that splits the model over processes `params` and the
    moments are this rank's blocks and `batch` the global batch; the dense
    and moe families train so (what `ShardingPolicy.check_model_split`
    refuses is refused here)."""
    specs = None
    if policy is not None and policy.splits_model:
        policy.check_model_split(model.cfg, train=True)
        specs = policy.tree_specs(model.init_shapes())

    def train_step(params: dict, opt_state: OptState, batch: dict):
        loss, met, grads = step_grads(model, params, batch, step_cfg, policy)
        with use_policy(policy):
            params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state, specs)
        return params, opt_state, {"loss": loss, **met, **om}

    return train_step


def make_prefill_step(model: Model, policy: Optional[ShardingPolicy] = None) -> Callable:
    """prefill_step(params, batch, rows=None) -> logits; under a model split
    `batch` holds this rank's rows and `rows` is the global batch's count
    (an MoE model's dispatch groups need it where data axes split it)."""

    def prefill_step(params: dict, batch: dict, rows: Optional[int] = None) -> torch.Tensor:
        with torch.no_grad(), use_policy(policy):
            return model.forward_logits(params, batch, rows).logits

    return prefill_step


def make_serve_step(model: Model, policy: Optional[ShardingPolicy] = None) -> Callable:
    """One decode step: a new token against a full KV / SSM cache."""

    def serve_step(params: dict, token: torch.Tensor, cache: dict):
        with torch.no_grad(), use_policy(policy):
            return model.decode_step(params, token, cache)

    return serve_step
