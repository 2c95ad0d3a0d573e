"""The decoder LM for the dense and vlm families (the counterpart of
`repro.models.transformer`).

Params keep the reference's pytree: ``tok``, ``final_norm`` and ``blocks``,
whose leaves carry a leading [L, ...] layer axis; `forward` walks the layers
in a plain Python loop where the reference scans.  ``forward(...,
cache=None)`` is the cache-free forward (training, and the path of the
flash-attention kernel); with a cache the same code does prefill (S tokens
into the cache) and decode (S = 1), writing the cache in place.  The cache's
``len`` is a scalar or one position a row ([B]).

The moe, hybrid (mamba), ssm (xlstm) and audio families are later slices of
the port (ROADMAP queue 1 item 8): `check_family` raises for them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from . import layers as L

FAMILIES = ("dense", "vlm")
_LATER = {
    "moe": "models/moe with dsde.moe_dispatch / moe_combine",
    "hybrid": "models/mamba",
    "ssm": "models/xlstm",
    "audio": "the whisper encoder-decoder",
}


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    cache: Any
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        what = _LATER.get(cfg.family)
        if what is None:
            raise ValueError(f"unknown family {cfg.family}")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({what}; ROADMAP "
            "queue 1 item 8); repro_torch serves the dense and vlm families")


# ============================================================ init
def _stack(layers: list[dict]) -> dict:
    return {k: (_stack([lay[k] for lay in layers]) if isinstance(layers[0][k], dict)
                else torch.stack([lay[k] for lay in layers]))
            for k in layers[0]}


def init_lm(cfg: ArchConfig, gen: Optional[torch.Generator], device=None) -> dict:
    """Random weights with the reference's shapes and scales (not its
    numbers: the generators differ).  ``device="meta"`` allocates nothing."""
    check_family(cfg)
    dtype = torch.bfloat16
    params: dict = {"tok": L.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.tie_embeddings, dtype, device)}
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": L.init_rmsnorm(cfg.d_model, dtype, device),
            "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, cfg.qkv_bias, dtype, device),
            "ln2": L.init_rmsnorm(cfg.d_model, dtype, device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device),
        })
    params["blocks"] = _stack(layers)
    return params


# ============================================================ caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> dict:
    """Decode cache: K/V [L, B, max_seq, Hkv, hd] in bf16 and a scalar len."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "kv": {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
               "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)},
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# ============================================================ forward
def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _attn_block(cfg, blk, h, positions, cache_kv, cache_len):
    """One attention residual branch; the cache rows are written in place."""
    cache = None
    if cache_kv is not None:
        cache = {"k": cache_kv["k"], "v": cache_kv["v"], "len": cache_len}
    y, _ = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"]["scale"], cfg.norm_eps),
                       positions, cfg.rope_style, causal=True, cache=cache)
    return h + y


def _ffn_block(cfg, blk, h):
    xn = L.rmsnorm(h, blk["ln2"]["scale"], cfg.norm_eps)
    return h + L.mlp(blk["mlp"], xn, cfg.mlp_type)


def forward(
    params: dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,                       # [B, S]
    cache: Optional[dict] = None,
    prefix_embeds: Optional[torch.Tensor] = None,   # vlm patches [B, P, D]
) -> ForwardOut:
    check_family(cfg)
    B, S = tokens.shape
    dev = tokens.device
    h = L.embed(params["tok"], tokens)
    if prefix_embeds is not None and cfg.family == "vlm":
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        S = h.shape[1]
    start = cache["len"] if cache is not None else torch.zeros((), dtype=torch.int32,
                                                               device=dev)
    positions = (torch.as_tensor(start, device=dev).to(torch.int64).reshape(-1, 1)
                 + torch.arange(S, device=dev)[None, :]).expand(B, S)

    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        kv = None if cache is None else {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
        h = _attn_block(cfg, blk, h, positions, kv, start)
        h = _ffn_block(cfg, blk, h)
    new_cache = None if cache is None else {"kv": cache["kv"], "len": start + S}

    h = L.rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.unembed(params["tok"], h)
    zero = torch.zeros((), device=dev)
    return ForwardOut(logits, new_cache, zero, zero)
