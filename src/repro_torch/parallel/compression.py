"""Error-feedback gradient compression for the cross-pod hop (the
`repro.parallel.compression` counterpart).

The in-pod reduce runs at full precision; the cross-pod hop may carry int8
blocks (symmetric per-tensor, an f32 scale) with an error-feedback residual,
so the compression noise averages out over steps (Karimireddy et al.).  It
composes with `core.collectives.hierarchical_all_reduce`: compress exactly
the tensor that crosses pods.  Rounding is half to even in both packages
(`torch.round`, `jnp.round`).

Trees are nested dicts of tensors, walked by `train.optimizer.tree_map`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..train.optimizer import tree_leaves, tree_map


class CompressionState(NamedTuple):
    residual: Any   # error-feedback carry, the grads' tree in f32


def init_compression_state(grads_like: Any) -> CompressionState:
    return CompressionState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with an f32 scale."""
    scale = x.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads: Any, state: CompressionState
                        ) -> tuple[Any, CompressionState, dict]:
    """One error-feedback int8 round trip (what the cross-pod hop carries).

    Returns (the grads as the receivers decode them, the new residual
    state, metrics): the int8 payload is a quarter of the f32 one, plus a
    4-byte scale a tensor."""

    def one(g, r):
        x = g.to(torch.float32) + r
        q, scale = _quantize_int8(x)
        deq = _dequantize_int8(q, scale)
        return deq.to(g.dtype), x - deq

    pairs = tree_map(one, grads, state.residual)
    comp = tree_map(lambda t: t[0], pairs)
    resid = tree_map(lambda t: t[1], pairs)
    leaves = tree_leaves(grads)
    return comp, CompressionState(resid), {
        "dcn_bytes_uncompressed": sum(g.numel() * 4 for g in leaves),
        "dcn_bytes_compressed": sum(g.numel() * 1 + 4 for g in leaves),
    }


def topk_sparsify(g: torch.Tensor, frac: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude top-k sparsification: (values, flat indices), largest
    magnitude first.  Ties may break otherwise than `lax.top_k`'s."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx
