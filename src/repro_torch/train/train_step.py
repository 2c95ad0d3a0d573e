"""Train / prefill / serve steps with microbatch accumulation and remat (the
counterpart of `repro.train.train_step`).

PyTorch runs eagerly, so a step is a plain function, not a jitted one.
The reference's `ShardingPolicy` is an identity on one card and is dropped,
as the model drops `shard()`.  Microbatches run in a Python loop where the
reference scans; their f32-accumulated gradients are averaged.  Remat
(`models.transformer.set_remat`) is switched on around the loss only, as
the reference does, so the flash kernel runs once a layer in the forward
and once more in the backward's recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import transformer as T
from ..models.registry import Model
from .optimizer import AdamWConfig, OptState, adamw_update, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    remat: bool = True


def loss_and_grads(model: Model, params: dict, batch: dict,
                   remat: bool = True) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of `model.loss` at `params`; the grads have
    each param's dtype, zeros where a param does not reach the loss."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    T.set_remat(remat)
    try:
        loss, met = model.loss(leaves, batch)
    finally:
        T.set_remat(False)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    by_id = {id(p): g if g is not None else torch.zeros_like(p)
             for p, g in zip(flat, got)}
    grads = tree_map(lambda p: by_id[id(p)], leaves)
    return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in met.items()}, grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig()) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params: dict, opt_state: OptState, batch: dict):
        n = step_cfg.n_microbatches
        if n == 1:
            loss, met, grads = loss_and_grads(model, params, batch, step_cfg.remat)
        else:
            # gradient accumulation over microbatches (B must divide by n)
            def split(x, i):
                return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), device=tree_leaves(params)[0].device)
            for i in range(n):
                mb = {k: split(v, i) for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, mb, step_cfg.remat)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            met = {"nll": loss, "aux": torch.zeros_like(loss), "z": torch.zeros_like(loss)}
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **met, **om}

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.forward_logits(params, batch).logits

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step: a new token against a full KV / SSM cache."""

    def serve_step(params: dict, token: torch.Tensor, cache: dict):
        with torch.no_grad():
            return model.decode_step(params, token, cache)

    return serve_step
