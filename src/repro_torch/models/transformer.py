"""The unified LM for every family of the model zoo (the counterpart of
`repro.models.transformer`).

Params keep the reference's pytree, and `forward` walks the layers in a
plain Python loop where the reference scans:

  dense / vlm / moe : ``blocks``, leaves [L, ...]: attention + MLP (dense,
                      vlm) or attention + MoE FFN (moe) a layer;
  hybrid (jamba)    : ``periods``, leaves [n_p, ...]: a period of
                      `attn_period` layers, attention at ``period // 2`` and
                      Mamba elsewhere ([n_p, n_mamba, ...]); the channel
                      mixer is an MoE FFN where ``j % moe_every ==
                      moe_every - 1`` ([n_p, n_moe, ...]), a dense MLP
                      elsewhere ([n_p, n_mlp, ...]);
  ssm (xlstm)       : ``periods``, leaves [n_p, ...]: `slstm_period` - 1
                      mLSTM blocks ([n_p, period - 1, ...]) and one sLSTM
                      block, each a pre-norm residual branch;
  audio (whisper)   : ``enc_blocks`` [encoder_layers, ...] (non-causal
                      attention + MLP over the frames, `encode`), and the
                      decoder ``blocks`` [L, ...]: causal self-attention,
                      cross-attention to the encoder output (``ln_x``,
                      ``xattn``) and the MLP.

``forward(..., cache=None)`` is the cache-free forward (training, and the
path of the flash-attention kernel); with a cache the same code does
prefill (S tokens into the cache; the Mamba layers through the
selective-scan kernel) and decode (S = 1; the O(1) recurrent steps),
writing the cache in place: K/V rows and the recurrent state leaves
(Mamba [n_p, n_mamba, B, ...], mLSTM [n_p, period - 1, B, ...], sLSTM
[n_p, B, ...]).  The cache's ``len`` is a scalar or one position a row
([B]).  The MoE layers' aux and z losses are summed into `ForwardOut`.
The audio decoder always runs with a cache: it carries ``enc_out``, from
which each layer recomputes its cross K/V at every step, as the reference
does; its sinusoidal positions follow each row's ``len``.  `encode` runs
the encoder; its attention is cache-free, so on backend "cuda" it goes
through the flash kernel, non-causal.

`set_remat(True)` makes the cache-free forward rematerialise each layer
body (dense, vlm, moe, the audio encoder) and each period body (hybrid)
in the backward, the reference's ``jax.checkpoint`` of its scan bodies: a
body returns (h, aux, z), as the reference's scan carry does, so a
recomputed body adds nothing to the losses twice.  The mLSTM checkpoints
each chunk instead (`xlstm.mlstm_prefill`), as the reference does; a body
that writes a cache is never rematerialised.  The stacked leaves are cut
into per-layer views by one `unbind` each, so a leaf's gradient is
stacked once, not scattered into a zero tensor a layer.

`init_cache` gives every leaf its initial value: 0, and -1e30 for the
sLSTM stabiliser ``m`` (`xlstm.SLSTM_INIT`); the serving engine's lane
reset copies a batch-1 `init_cache` into the lane.

Under a policy that splits the model over processes
(`parallel.sharding.tensor_parallel`; the dense, moe, hybrid and ssm
families when serving, the rest refused by `ShardingPolicy.
check_model_split`) `forward` takes this rank's blocks of the params and
hands the layers the config's whole sizes (the Mamba layers d_inner and
the state size, the xLSTM blocks the head count; an MoE layer also the
global batch's row count, ``rows``, for its dispatch groups:
`models.moe.dispatch_groups`; an moe or hybrid cache keeps it), and
`init_cache` gives the K/V cache this rank's block by the reference's
cache spec (`ShardingPolicy.kv_cache_sharding`): its rows over the data
axes, and over ``model`` its KV heads (``n_kv_heads / tp`` where ``wk`` is
split, all of them where it is whole) or, where the spec splits the
sequence, every KV head over its block of the positions; the recurrent
states are this rank's block too (`ShardingPolicy.state_sharding`).
Under a policy
whose spec puts the sequence on ``model`` the cache carries
``kv_seq_blocks`` (tp, or 1 where ``model`` does not divide max_seq and
the cache stays whole), which `forward` hands each layer's attention with
the layer's K/V views, and with them whether every row is empty (decided
once a call).  Where the
policy also splits leaves over ``data`` (FSDP, `ShardingPolicy.
gathers_data`) each layer's blocks are gathered over ``data`` inside its
remat body (`_block`; a hybrid or xLSTM period's in `_period` /
`_xlstm_period`), so the backward's recomputation gathers them again and
no gathered layer is kept for it, and ``tok``'s leaves are gathered at
each use (the embedding, the LM head); the layers then see the blocks of a
split over ``model`` alone.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..ckpt.checkpoint import flatten
from ..configs.base import ArchConfig
from ..parallel.sharding import current_policy, tensor_parallel, use_policy
from . import layers as L
from . import mamba as M
from . import moe as X
from . import xlstm as XL

FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")


# when True, the cache-free forward rematerialises each layer / period body
_REMAT: list[bool] = [False]


def set_remat(flag: bool) -> None:
    _REMAT[0] = bool(flag)


def _maybe_remat(body, cache):
    """`body` checkpointed (non-reentrant) when remat is on and there is no
    cache to write: only the cache-free forward is differentiated.  The
    recomputation runs in the backward, after the forward's `use_policy`
    has closed, so the body carries the forward's policy into it (MoE
    dispatch groups, the split step's collectives), as a traced body does
    in the reference."""
    if _REMAT[0] and cache is None:
        pol = current_policy()

        def under_policy(*args):
            with use_policy(pol):
                return body(*args)

        return functools.partial(torch.utils.checkpoint.checkpoint, under_policy,
                                 use_reentrant=False)
    return body


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    cache: Any
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    period = {"hybrid": cfg.attn_period, "ssm": cfg.slstm_period}.get(cfg.family)
    if period is not None and cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole periods of "
                         f"{period}")


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
    elif cfg.family == "ssm":
        n_p, n_m = cfg.n_layers // cfg.slstm_period, cfg.slstm_period - 1
        params["periods"] = {
            "mlstm": {
                "ln1": L.init_rmsnorm(cfg.d_model, dtype, device, (n_p, n_m)),
                "mix": XL.init_mlstm(gen, cfg.d_model, cfg.n_heads, dtype, device, (n_p, n_m)),
            },
            "slstm": {
                "ln1": L.init_rmsnorm(cfg.d_model, dtype, device, (n_p,)),
                "mix": XL.init_slstm(gen, cfg.d_model, cfg.n_heads, dtype, device, (n_p,)),
            },
        }
    elif cfg.family == "audio":
        lead = (cfg.encoder_layers,)
        params["enc_blocks"] = {**_attn_layer(cfg, gen, dtype, device, lead),
                                **_ffn_layer(cfg, gen, False, dtype, device, lead)}
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        params["enc_pos"] = L._normal(gen, (cfg.encoder_seq, cfg.d_model), 0.01, dtype,
                                      device)
        lead = (cfg.n_layers,)
        params["blocks"] = {
            **_attn_layer(cfg, gen, dtype, device, lead),
            "ln_x": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "xattn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      False, dtype, device, lead),
            **_ffn_layer(cfg, gen, False, dtype, device, lead),
        }
    else:
        lead = (cfg.n_layers,)
        params["blocks"] = {**_attn_layer(cfg, gen, dtype, device, lead),
                            **_ffn_layer(cfg, gen, cfg.family == "moe", dtype, device, lead)}
    return params


# ============================================================ caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None) -> dict:
    """Decode cache with a scalar len: K/V [L or n_p, B, max_seq, Hkv, hd]
    in bf16 (not for ssm); for the hybrid family the Mamba state, ``h``
    [n_p, n_mamba, B, di, N] f32 and ``conv`` [n_p, n_mamba, B, W-1, di]
    bf16; for ssm the mLSTM state ``C, n, m`` [n_p, period-1, B, nh, ...]
    f32 and the sLSTM state ``c, n, h, m`` [n_p, B, D] (h bf16, m -1e30);
    for audio ``enc_out`` [B, encoder_seq, D] bf16 (a prefill replaces
    it).  Under a policy that splits the model over processes `batch` and
    `max_seq` are the whole cache's and every leaf this rank's block (the
    reference's `_cache_specs`): the K/V leaves' by
    `ShardingPolicy.kv_cache_sharding`, the recurrent states' by
    `ShardingPolicy.state_sharding` (the Mamba channels, the mLSTM heads,
    the sLSTM heads' channels; the rows over the data axes); where the
    policy's spec puts the sequence on ``model`` the cache says in how many
    blocks (``kv_seq_blocks``: tp, or 1 for a whole one), and an moe or
    hybrid cache keeps `batch` (``rows``) for the dispatch groups."""
    check_family(cfg)
    tp = tensor_parallel()
    if tp is not None:
        tp.check_model_split(cfg)
    cache: dict = {}
    if cfg.family == "ssm":
        n_p = cfg.n_layers // cfg.slstm_period
        cache["mlstm"] = _state_blocks(tp, "mlstm", XL.init_mlstm_state(
            batch, cfg.d_model, cfg.n_heads, "meta", (n_p, cfg.slstm_period - 1)), device)
        cache["slstm"] = _state_blocks(tp, "slstm", XL.init_slstm_state(
            batch, cfg.d_model, device="meta", lead=(n_p,)), device)
    else:
        n_kv = cfg.n_layers
        if cfg.family == "hybrid":
            n_kv, n_m, _, _ = _hybrid_counts(cfg)
        shape = (n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        if tp is not None:
            # this rank's block (`_cache_specs`): rows over the data axes,
            # the KV heads or the sequence over ``model``
            ns = tp.kv_cache_sharding(cfg.n_kv_heads, shape)
            if tp.kv_seq_split(cfg.n_kv_heads):
                cache["kv_seq_blocks"] = tp.kv_seq_blocks(cfg.n_kv_heads, shape)
            shape = _block_shape(tp, ns, shape)
        cache["kv"] = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                       "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
        if tp is not None and cfg.family in ("moe", "hybrid"):
            cache["rows"] = batch           # the MoE dispatch groups' global batch
    if cfg.family == "hybrid":
        cache["mamba"] = _state_blocks(tp, "mamba", M.init_mamba_state(
            batch, cfg.d_model, cfg.ssm_expand, cfg.ssm_state_dim, cfg.ssm_conv_width,
            device="meta", lead=(n_kv, n_m)), device)
    if cfg.family == "audio":
        cache["enc_out"] = torch.zeros(batch, cfg.encoder_seq, cfg.d_model,
                                       dtype=torch.bfloat16, device=device)
    cache["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _block_shape(tp, ns, shape: tuple) -> tuple:
    """The shape of this rank's block of a leaf of whole `shape` placed by
    the `NamedSharding` `ns`."""
    return tuple(len(range(*s.indices(n))) for s, n in zip(ns.index(tp.mesh.coords, shape),
                                                             shape))


def _state_blocks(tp, kind: str, whole: dict, device) -> dict:
    """A recurrent state from its whole leaves' shapes and dtypes (meta
    tensors): each leaf at its initial value (0; the sLSTM's by
    `xlstm.SLSTM_INIT`), whole, or this rank's block under a split
    (`ShardingPolicy.state_sharding`)."""
    out = {}
    for k, v in whole.items():
        shape = tuple(v.shape)
        if tp is not None:
            shape = _block_shape(tp, tp.state_sharding(kind, k, shape), shape)
        fill = XL.SLSTM_INIT[k] if kind == "slstm" else 0.0
        out[k] = torch.full(shape, fill, dtype=v.dtype, device=device)
    return out


# ============================================================ forward
def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The stacked leaves [n, ...] of `tree` as n trees of per-layer views."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _attn_block(cfg, blk, h, positions, cache_kv, cache_len, cross_kv=None):
    """One attention residual branch, and the cross-attention one when
    `cross_kv` is given; the cache rows are written in place."""
    cache = None if cache_kv is None else {**cache_kv, "len": cache_len}
    heads = (cfg.n_heads, cfg.n_kv_heads)
    y, _ = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"]["scale"], cfg.norm_eps),
                       positions, cfg.rope_style, causal=True, cache=cache, heads=heads)
    h = h + y
    if cross_kv is not None:
        y, _ = L.attention(blk["xattn"], L.rmsnorm(h, blk["ln_x"]["scale"], cfg.norm_eps),
                           positions, "none", causal=False, cross_kv=cross_kv, heads=heads)
        h = h + y
    return h


def _ffn_block(cfg, blk, h, rows=None):
    """Channel mixer -> (h, aux, z); aux and z are None for a dense MLP.  For
    an MoE layer whose rank routes a share of the batch (`rows`, the global
    batch, gives its dispatch groups under a split) aux is the layer's
    `MoEMetrics.load`, of which `forward` makes the batch's aux loss."""
    xn = L.rmsnorm(h, blk["ln2"]["scale"], cfg.norm_eps)
    if "moe" in blk:
        y, met = X.moe_ffn(blk["moe"], xn, cfg.moe_top_k, mlp_type=cfg.mlp_type,
                           d_ff=cfg.moe_d_ff, shared_ff=cfg.moe_shared_ff or None, rows=rows)
        return h + y, (met.aux_loss if met.load is None else met.load), met.router_z_loss
    return h + L.mlp(blk["mlp"], xn, cfg.mlp_type, cfg.d_ff), None, None


def _block(cfg, blk, h, positions, kv, start, gather=None, rows=None):
    """One dense / vlm / moe layer -> (h, aux, z), as `_ffn_block`; `gather`
    (FSDP) joins the layer's blocks over ``data`` first."""
    if gather is not None:
        blk = gather(blk)
    h = _attn_block(cfg, blk, h, positions, kv, start)
    return _ffn_block(cfg, blk, h, rows)


def _dec_block(cfg, blk, h, positions, kv, start, enc_out):
    """One audio decoder layer -> (h, aux, z): its cross K/V recomputed from
    the encoder output, as the reference does at every step."""
    xk = L.einsum_promoted("bsd,dhk->bshk", enc_out, blk["xattn"]["wk"])
    xv = L.einsum_promoted("bsd,dhk->bshk", enc_out, blk["xattn"]["wv"])
    h = _attn_block(cfg, blk, h, positions, kv, start, cross_kv=(xk, xv))
    return _ffn_block(cfg, blk, h)


def _enc_block(cfg, blk, h, positions):
    """One encoder layer: cache-free non-causal attention, then the MLP."""
    y, _ = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"]["scale"], cfg.norm_eps),
                       positions, "none", causal=False)
    return _ffn_block(cfg, blk, h + y)[0]


def _write(state: dict, new: dict) -> None:
    for k, v in state.items():
        v.copy_(new[k])


def _xlstm_period(cfg, per, h, cache, pi, decode, gather=None):
    """One xLSTM period: period - 1 mLSTM blocks, then one sLSTM block.  With
    a cache, each block's state (views of its leaves) is written in place.
    `gather` (FSDP) joins the period's blocks over ``data`` first; the
    blocks take the model's head count (their leaves may hold a share)."""
    if gather is not None:
        per = gather(per)
    nh = cfg.n_heads
    for j, mp in enumerate(_unstack(per["mlstm"], cfg.slstm_period - 1)):
        xn = L.rmsnorm(h, mp["ln1"]["scale"], cfg.norm_eps)
        if cache is None:
            y = XL.mlstm_forward(mp["mix"], xn, n_heads=nh)
        else:
            st = {k: v[pi, j] for k, v in cache["mlstm"].items()}
            y, new = (XL.mlstm_decode if decode else XL.mlstm_prefill)(mp["mix"], xn, st,
                                                                      n_heads=nh)
            _write(st, new)
        h = h + y
    sp = per["slstm"]
    xn = L.rmsnorm(h, sp["ln1"]["scale"], cfg.norm_eps)
    if cache is None:
        y = XL.slstm_forward(sp["mix"], xn, nh)
    else:
        st = {k: v[pi] for k, v in cache["slstm"].items()}
        y, new = (XL.slstm_decode if decode else XL.slstm_prefill)(sp["mix"], xn, st, nh)
        _write(st, new)
    return h + y


def _mamba_block(cfg, mp, h, state: Optional[dict], decode: bool):
    """One Mamba residual branch.  With a cache state (views of its leaves)
    the new state is written into them in place.  The layer takes the
    model's d_inner and state size (its leaves may hold a share)."""
    xn = L.rmsnorm(h, mp["ln1"]["scale"], cfg.norm_eps)
    dims = (cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim)
    if state is None:
        return h + M.mamba_forward(mp["mix"], xn, *dims)
    step = M.mamba_decode if decode else M.mamba_prefill
    y, new = step(mp["mix"], xn, state, *dims)
    _write(state, new)
    return h + y


def _period(cfg, per, h, aux, zl, positions, cache, pi, start, decode, gather=None,
            rows=None, seq=None):
    """One hybrid period -> (h, aux, z, loads): attention at ``period // 2``,
    Mamba elsewhere, each followed by its channel mixer; the losses are
    carried through it, in the reference's order of sums, and the MoE
    layers that route a data share give their `MoEMetrics.load` (as
    `_ffn_block`).  `gather` (FSDP) joins the period's blocks over
    ``data`` first; `rows` is the global batch for the dispatch groups
    and `seq` the K/V views' sequence split (``seq_blocks``,
    ``rows_empty``), as `forward` hands a dense layer."""
    if gather is not None:
        per = gather(per)
    period, attn_pos = cfg.attn_period, cfg.attn_period // 2
    kv = None if cache is None else {"k": cache["kv"]["k"][pi], "v": cache["kv"]["v"][pi],
                                     **(seq or {})}
    m_i, ffn_i = 0, {"moe": 0, "mlp": 0}
    loads = []
    for j in range(period):
        if j == attn_pos:
            h = _attn_block(cfg, per["attn"], h, positions, kv, start)
        else:
            st = None if cache is None else {k: v[pi, m_i] for k, v in cache["mamba"].items()}
            h = _mamba_block(cfg, _layer(per["mamba"], m_i), h, st, decode)
            m_i += 1
        key = "moe" if j % cfg.moe_every == cfg.moe_every - 1 else "mlp"
        h, a, z = _ffn_block(cfg, _layer(per[key], ffn_i[key]), h, rows)
        if isinstance(a, tuple):
            loads.append(a)
            zl = zl + z
        elif a is not None:
            aux, zl = aux + a, zl + z
        ffn_i[key] += 1
    return h, aux, zl, loads


def forward(
    params: dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,                       # [B, S]
    cache: Optional[dict] = None,
    prefix_embeds: Optional[torch.Tensor] = None,   # vlm patches [B, P, D]
    rows: Optional[int] = None,                 # the global batch under a split
    losses: bool = False,
) -> ForwardOut:
    """Under a model split over processes `tokens` are this rank's rows and
    `rows` the global batch's count (a cache made under the policy keeps
    it), which the MoE layers' dispatch groups need where the batch is
    split over data axes.  Where a rank's rows are a share of the batch
    the aux and z losses are None unless `losses` asks for them; then
    they are this rank's terms of the batch's (`models.moe.global_aux`:
    one sum of the layers' expert counts over the data axes), whose mean
    over the data ranks is the batch's loss and its gradient."""
    check_family(cfg)
    tp = tensor_parallel()
    if tp is not None:
        tp.check_model_split(cfg)
    B, S = tokens.shape
    dev = tokens.device
    gather = _fsdp_gather(tp, cfg) if tp is not None and tp.gathers_data else None
    tok = params["tok"] if gather is None else gather({"embed": params["tok"]["embed"]}, "tok")
    h = L.embed(tok, tokens, cfg.vocab_size)
    del tok
    if prefix_embeds is not None and cfg.family == "vlm":
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        S = h.shape[1]
    start = cache["len"] if cache is not None else torch.zeros((), dtype=torch.int32,
                                                               device=dev)
    positions = (torch.as_tensor(start, device=dev).to(torch.int64).reshape(-1, 1)
                 + torch.arange(S, device=dev)[None, :]).expand(B, S)

    aux = zl = torch.zeros((), device=dev)      # summed over the MoE layers
    decode = cache is not None and S == 1
    seq_blocks = None if cache is None else cache.get("kv_seq_blocks")
    # a chunk into empty rows of a sequence-split cache attends locally
    # (a decode step never looks: the merged path is right for any rows)
    rows_empty = bool((seq_blocks or 1) > 1 and S > 1 and not torch.as_tensor(start).any())
    seq = {"seq_blocks": seq_blocks, "rows_empty": rows_empty}
    if rows is None and cache is not None:
        rows = cache.get("rows")
    loads = []                          # MoE layers routing a data share
    # a period's blocks joined over ``data`` (FSDP), its stacked dim cut away
    per_gather = None if gather is None else functools.partial(gather, prefix="periods", lead=1)
    if cfg.family == "hybrid":
        body = _maybe_remat(_period, cache)
        for pi, per in enumerate(_unstack(params["periods"], cfg.n_layers // cfg.attn_period)):
            h, aux, zl, got = body(cfg, per, h, aux, zl, positions, cache, pi, start, decode,
                                   per_gather, rows, seq)
            loads += got
    elif cfg.family == "ssm":
        for pi, per in enumerate(_unstack(params["periods"],
                                          cfg.n_layers // cfg.slstm_period)):
            h = _xlstm_period(cfg, per, h, cache, pi, decode, per_gather)
    elif cfg.family == "audio":
        if cache is None:
            raise ValueError("whisper forward requires a cache carrying enc_out; use "
                             "encode() + forward")
        # sinusoidal decoder positions, one row of them a lane
        h = h + L.sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
        for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i]}
            h, _, _ = _dec_block(cfg, blk, h, positions, kv, start, cache["enc_out"])
    else:
        body = _maybe_remat(_block, cache)
        layer = None if gather is None else functools.partial(gather, prefix="blocks", lead=1)
        for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            kv = None if cache is None else {"k": cache["kv"]["k"][i],
                                             "v": cache["kv"]["v"][i], **seq}
            h, a, z = body(cfg, blk, h, positions, kv, start, layer, rows)
            if isinstance(a, tuple):
                loads.append(a)
                zl = zl + z
            elif a is not None:
                aux, zl = aux + a, zl + z
    if loads:
        aux, zl = (X.global_aux(tp, loads), zl) if losses else (None, None)
    new_cache = None if cache is None else {**cache, "len": start + S}

    h = L.rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    tok = params["tok"]
    if gather is not None:
        head = "lm_head" if "lm_head" in tok else "embed"
        tok = gather({head: tok[head]}, "tok")
    logits = L.unembed(tok, h, cfg.vocab_size)
    return ForwardOut(logits, new_cache, aux, zl)


_DATA_DIMS: dict = {}


def _fsdp_gather(tp, cfg: ArchConfig):
    """`gather(tree, prefix, lead=0)`: the leaves of `tree` (at `prefix` in
    the params, with `lead` stacked dims cut away) joined over ``data``
    where their fitted spec splits them there (`ShardingPolicy.data_dim`,
    from the whole leaves' shapes), the rest as they are."""
    key = (cfg, tuple(tp.mesh.shape.items()))
    if key not in _DATA_DIMS:
        _DATA_DIMS[key] = {path: tp.data_dim(path, tuple(leaf.shape))
                           for path, leaf in flatten(init_lm(cfg, None, "meta"))}
    dims = _DATA_DIMS[key]

    def gather(tree: dict, prefix: str, lead: int = 0) -> dict:
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = gather(v, path, lead)
            else:
                d = dims[path]
                out[k] = v if d is None else tp.gather_data(v, d - lead)
        return out

    return gather


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings [B, F, D] (the
    conv frontend is a stub): the frames rounded to bf16, plus ``enc_pos``
    (an f32 model promotes the sum back to f32, as JAX does)."""
    B, n = frames.shape[:2]
    h = frames.to(torch.bfloat16) + params["enc_pos"][None, :n]
    positions = torch.arange(n, device=frames.device)[None].expand(B, n)
    body = _maybe_remat(_enc_block, None)
    for blk in _unstack(params["enc_blocks"], cfg.encoder_layers):
        h = body(cfg, blk, h, positions)
    return L.rmsnorm(h, params["enc_norm"]["scale"], cfg.norm_eps)
