"""AdamW with a cosine schedule and global-norm clipping (the counterpart of
`repro.train.optimizer`).

The moments are f32 and have the params' tree; the params keep their own
dtype (bf16 on the card) and are updated through f32, with no f32 master
copy, as in the reference.  Decoupled weight decay applies to leaves of
two or more dims only.  The step counter is a 0-dim int32 tensor on the
params' device and the schedule is computed from it in f32 on that device,
as the reference computes it under `jit`, so a step needs no host sync.
The update is functional: new params and a new state, the inputs untouched.

Trees are nested dicts of tensors; their leaves are visited in sorted key
order, the order `jax.tree.leaves` gives the reference's dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


class OptState(NamedTuple):
    step: torch.Tensor      # [] int32
    mu: Any                 # first moment (f32, the params' tree)
    nu: Any                 # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_opt_state(params: Any) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def opt_state_from_jax(step, mu: dict, nu: dict, device=None) -> OptState:
    """The reference's `OptState` (its step and moment trees as numpy) as
    the port's, on `device` (CUDA unless it says otherwise)."""
    from ..models.registry import params_from_jax

    mu_t = params_from_jax(mu, device, dtype=torch.float32)
    dev = tree_leaves(mu_t)[0].device
    return OptState(torch.tensor(np.asarray(step), dtype=torch.int32, device=dev),
                    mu_t, params_from_jax(nu, device, dtype=torch.float32))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `lr`, then cosine to `min_lr_frac * lr`; f32."""
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: OptState) -> tuple[Any, OptState, dict]:
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.ndim >= 2:                 # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.mu, state.nu)     # leaves (p, m, v)
    new_params, new_mu, new_nu = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
    return new_params, OptState(step, new_mu, new_nu), {"grad_norm": gnorm, "lr": lr}
