"""Train / prefill / serve steps with microbatch accumulation and remat (the
counterpart of `repro.train.train_step`).

PyTorch runs eagerly, so a step is a plain function, not a jitted one.
A `parallel.sharding.ShardingPolicy` (``policy=``) is active around the
loss and the AdamW update, where the reference activates it: its
placements change no value on one card, its MoE dispatch groups do.
Under a policy that splits the model over processes the prefill and serve
steps run the split forward on this rank's blocks, and the train step
raises: its collectives have no backward yet (ROADMAP item 12c.1).
Microbatches run in a Python loop where the reference scans; their
f32-accumulated gradients are averaged (`step_grads`).  Remat
(`models.transformer.set_remat`) is switched on around the loss only, as
the reference does, so the flash kernel runs once a layer in the forward
and once more in the backward's recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models import transformer as T
from ..models.registry import Model
from ..parallel.sharding import ShardingPolicy, use_policy
from .optimizer import AdamWConfig, OptState, adamw_update, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    remat: bool = True


def loss_and_grads(model: Model, params: dict, batch: dict, remat: bool = True,
                   policy: Optional[ShardingPolicy] = None
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of `model.loss` at `params`, under `policy`;
    the grads have each param's dtype, zeros where a param does not reach
    the loss."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    T.set_remat(remat)
    try:
        with use_policy(policy):
            loss, met = model.loss(leaves, batch)
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
    losses, averaged."""
    n = step_cfg.n_microbatches
    if n == 1:
        return loss_and_grads(model, params, batch, step_cfg.remat, policy)

    def split(x, i):
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]

    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss = torch.zeros((), device=tree_leaves(params)[0].device)
    for i in range(n):
        mb = {k: split(v, i) for k, v in batch.items()}
        l, _, g = loss_and_grads(model, params, mb, step_cfg.remat, policy)
        grads = tree_map(torch.add, grads, g)
        loss = loss + l
    grads = tree_map(lambda g: g / n, grads)
    loss = loss / n
    return loss, {"nll": loss, "aux": torch.zeros_like(loss), "z": torch.zeros_like(loss)}, grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(),
                    policy: Optional[ShardingPolicy] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).
    Refused under a policy that splits the model over processes."""
    if policy is not None and policy.splits_model:
        raise NotImplementedError("the train step split over `model` is ROADMAP item 12c.1: "
                                  "the split forward's collectives have no backward")

    def train_step(params: dict, opt_state: OptState, batch: dict):
        loss, met, grads = step_grads(model, params, batch, step_cfg, policy)
        with use_policy(policy):
            params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **met, **om}

    return train_step


def make_prefill_step(model: Model, policy: Optional[ShardingPolicy] = None) -> Callable:
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad(), use_policy(policy):
            return model.forward_logits(params, batch).logits

    return prefill_step


def make_serve_step(model: Model, policy: Optional[ShardingPolicy] = None) -> Callable:
    """One decode step: a new token against a full KV / SSM cache."""

    def serve_step(params: dict, token: torch.Tensor, cache: dict):
        with torch.no_grad(), use_policy(policy):
            return model.decode_step(params, token, cache)

    return serve_step
