"""The decoder LM for the dense, vlm, moe and hybrid families (the
counterpart of `repro.models.transformer`).

Params keep the reference's pytree, and `forward` walks the layers in a
plain Python loop where the reference scans:

  dense / vlm / moe : ``blocks``, leaves [L, ...]: attention + MLP (dense,
                      vlm) or attention + MoE FFN (moe) a layer;
  hybrid (jamba)    : ``periods``, leaves [n_p, ...]: a period of
                      `attn_period` layers, attention at ``period // 2`` and
                      Mamba elsewhere ([n_p, n_mamba, ...]); the channel
                      mixer is an MoE FFN where ``j % moe_every ==
                      moe_every - 1`` ([n_p, n_moe, ...]), a dense MLP
                      elsewhere ([n_p, n_mlp, ...]).

``forward(..., cache=None)`` is the cache-free forward (training, and the
path of the flash-attention kernel); with a cache the same code does
prefill (S tokens into the cache; the Mamba layers through the
selective-scan kernel) and decode (S = 1; Mamba's O(1) step), writing the
cache in place: K/V rows and the Mamba state leaves [n_p, n_mamba, B, ...].
The cache's ``len`` is a scalar or one position a row ([B]).  The MoE
layers' aux and z losses are summed into `ForwardOut`.

`set_remat(True)` makes the cache-free forward rematerialise each layer
body (dense, vlm, moe) and each period body (hybrid) in the backward, the
reference's ``jax.checkpoint`` of its scan bodies: a body returns (h, aux,
z), as the reference's scan carry does, so a recomputed body adds nothing
to the losses twice.  The stacked leaves are cut into per-layer views by
one `unbind` each, so a leaf's gradient is stacked once, not scattered
into a zero tensor a layer.

The ssm (xlstm) and audio families are later slices of the port (ROADMAP
queue 1 item 8): `check_family` raises for them.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from . import mamba as M
from . import moe as X

FAMILIES = ("dense", "vlm", "moe", "hybrid")
_LATER = {
    "ssm": "models/xlstm",
    "audio": "the whisper encoder-decoder",
}


# when True, the cache-free forward rematerialises each layer / period body
_REMAT: list[bool] = [False]


def set_remat(flag: bool) -> None:
    _REMAT[0] = bool(flag)


def _maybe_remat(body, cache):
    """`body` checkpointed (non-reentrant) when remat is on and there is no
    cache to write: only the cache-free forward is differentiated."""
    if _REMAT[0] and cache is None:
        return functools.partial(torch.utils.checkpoint.checkpoint, body,
                                 use_reentrant=False)
    return body


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
            f"queue 1 item 8); repro_torch serves the {', '.join(FAMILIES)} families")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole periods of "
                         f"{cfg.attn_period}")


def _hybrid_counts(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """(periods, Mamba layers, MoE FFNs, dense MLPs) of a hybrid period."""
    period = cfg.attn_period
    n_moe = sum(1 for j in range(period) if j % cfg.moe_every == cfg.moe_every - 1)
    return cfg.n_layers // period, period - 1, n_moe, period - n_moe


# ============================================================ init
def _attn_layer(cfg, gen, dtype, device, lead) -> dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.qkv_bias, dtype, device, lead),
    }


def _ffn_layer(cfg, gen, is_moe: bool, dtype, device, lead) -> dict:
    if is_moe:
        return {"ln2": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
                "moe": X.init_moe(gen, cfg.d_model, cfg.moe_experts, cfg.moe_d_ff,
                                  cfg.mlp_type, cfg.moe_shared_ff, dtype, device, lead)}
    return {"ln2": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device, lead)}


def init_lm(cfg: ArchConfig, gen: Optional[torch.Generator], device=None) -> dict:
    """Random weights with the reference's shapes, scales and leaf dtypes
    (bf16; the router, ``A_log`` and ``D_skip`` f32), not its numbers: the
    generators differ.  Stacked leaves are drawn in place, a chunk at a
    time, so the peak is the weights themselves.  ``device="meta"``
    allocates nothing."""
    check_family(cfg)
    dtype = torch.bfloat16
    params: dict = {"tok": L.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.tie_embeddings, dtype, device)}
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    if cfg.family == "hybrid":
        n_p, n_m, n_moe, n_mlp = _hybrid_counts(cfg)
        params["periods"] = {
            "attn": _attn_layer(cfg, gen, dtype, device, (n_p,)),
            "mamba": {
                "ln1": L.init_rmsnorm(cfg.d_model, dtype, device, (n_p, n_m)),
                "mix": M.init_mamba(gen, cfg.d_model, cfg.ssm_expand, cfg.ssm_state_dim,
                                    cfg.ssm_conv_width, dtype, device, (n_p, n_m)),
            },
            "moe": _ffn_layer(cfg, gen, True, dtype, device, (n_p, n_moe)),
            "mlp": _ffn_layer(cfg, gen, False, dtype, device, (n_p, n_mlp)),
        }
    else:
        lead = (cfg.n_layers,)
        params["blocks"] = {**_attn_layer(cfg, gen, dtype, device, lead),
                            **_ffn_layer(cfg, gen, cfg.family == "moe", dtype, device, lead)}
    return params


# ============================================================ caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> dict:
    """Decode cache: K/V [L or n_p, B, max_seq, Hkv, hd] in bf16, a scalar
    len, and for the hybrid family the Mamba state, ``h`` [n_p, n_mamba, B,
    di, N] f32 and ``conv`` [n_p, n_mamba, B, W-1, di] bf16."""
    check_family(cfg)
    n_kv = cfg.n_layers
    if cfg.family == "hybrid":
        n_kv, n_m, _, _ = _hybrid_counts(cfg)
    shape = (n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cache = {
        "kv": {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
               "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)},
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.family == "hybrid":
        cache["mamba"] = M.init_mamba_state(batch, cfg.d_model, cfg.ssm_expand,
                                            cfg.ssm_state_dim, cfg.ssm_conv_width,
                                            device=device, lead=(n_kv, n_m))
    return cache


# ============================================================ forward
def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The stacked leaves [n, ...] of `tree` as n trees of per-layer views."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _attn_block(cfg, blk, h, positions, cache_kv, cache_len):
    """One attention residual branch; the cache rows are written in place."""
    cache = None
    if cache_kv is not None:
        cache = {"k": cache_kv["k"], "v": cache_kv["v"], "len": cache_len}
    y, _ = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"]["scale"], cfg.norm_eps),
                       positions, cfg.rope_style, causal=True, cache=cache)
    return h + y


def _ffn_block(cfg, blk, h):
    """Channel mixer -> (h, aux, z); aux and z are None for a dense MLP."""
    xn = L.rmsnorm(h, blk["ln2"]["scale"], cfg.norm_eps)
    if "moe" in blk:
        y, met = X.moe_ffn(blk["moe"], xn, cfg.moe_top_k, mlp_type=cfg.mlp_type)
        return h + y, met.aux_loss, met.router_z_loss
    return h + L.mlp(blk["mlp"], xn, cfg.mlp_type), None, None


def _block(cfg, blk, h, positions, kv, start):
    """One dense / vlm / moe layer -> (h, aux, z), as `_ffn_block`."""
    h = _attn_block(cfg, blk, h, positions, kv, start)
    return _ffn_block(cfg, blk, h)


def _mamba_block(cfg, mp, h, state: Optional[dict], decode: bool):
    """One Mamba residual branch.  With a cache state (views of its leaves)
    the new state is written into them in place."""
    xn = L.rmsnorm(h, mp["ln1"]["scale"], cfg.norm_eps)
    if state is None:
        return h + M.mamba_forward(mp["mix"], xn)
    step = M.mamba_decode if decode else M.mamba_prefill
    y, new = step(mp["mix"], xn, state)
    state["h"].copy_(new["h"])
    state["conv"].copy_(new["conv"])
    return h + y


def _period(cfg, per, h, aux, zl, positions, cache, pi, start, decode):
    """One hybrid period -> (h, aux, z): attention at ``period // 2``, Mamba
    elsewhere, each followed by its channel mixer; the losses are carried
    through it, in the reference's order of sums."""
    period, attn_pos = cfg.attn_period, cfg.attn_period // 2
    kv = None if cache is None else {"k": cache["kv"]["k"][pi], "v": cache["kv"]["v"][pi]}
    m_i, ffn_i = 0, {"moe": 0, "mlp": 0}
    for j in range(period):
        if j == attn_pos:
            h = _attn_block(cfg, per["attn"], h, positions, kv, start)
        else:
            st = None if cache is None else {k: v[pi, m_i] for k, v in cache["mamba"].items()}
            h = _mamba_block(cfg, _layer(per["mamba"], m_i), h, st, decode)
            m_i += 1
        key = "moe" if j % cfg.moe_every == cfg.moe_every - 1 else "mlp"
        h, a, z = _ffn_block(cfg, _layer(per[key], ffn_i[key]), h)
        if a is not None:
            aux, zl = aux + a, zl + z
        ffn_i[key] += 1
    return h, aux, zl


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

    aux = zl = torch.zeros((), device=dev)      # summed over the MoE layers
    if cfg.family == "hybrid":
        decode = cache is not None and S == 1
        body = _maybe_remat(_period, cache)
        for pi, per in enumerate(_unstack(params["periods"], cfg.n_layers // cfg.attn_period)):
            h, aux, zl = body(cfg, per, h, aux, zl, positions, cache, pi, start, decode)
    else:
        body = _maybe_remat(_block, cache)
        for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            kv = None if cache is None else {"k": cache["kv"]["k"][i],
                                             "v": cache["kv"]["v"][i]}
            h, a, z = body(cfg, blk, h, positions, kv, start)
            if a is not None:
                aux, zl = aux + a, zl + z
    new_cache = None if cache is None else {**cache, "len": start + S}

    h = L.rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = L.unembed(params["tok"], h)
    return ForwardOut(logits, new_cache, aux, zl)
