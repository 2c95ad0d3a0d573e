"""Shared neural building blocks (the counterpart of `repro.models.layers`).

Conventions, kept from the reference so the tests compare like with like:
  * activations [B, S, D]; attention heads [B, S, H, hd];
  * params are nested dicts of tensors; stacked-layer weights carry a
    leading [L, ...] axis;
  * compute dtype bf16, params bf16, reductions fp32.

Attention without a cache goes to the backend `set_attention_backend`
names: ``"torch"`` (blockwise online softmax, the reference's ``"xla"``)
or ``"cuda"`` (the flash-attention kernel, the reference's ``"pallas"``).
With a cache it is always blockwise.  The cache's ``len`` may be a scalar
(every row at one position, as in the reference) or a [B] tensor (one
position a row): RoPE positions, the cache write offset, ``q_offset`` and
``kv_valid_len`` then follow each row.  Cache writes are in place.

``shard(...)`` sits at the reference's sites (`parallel.sharding`): under a
policy it checks the logical name and returns its input, since a placement
changes no value on one card.  Under a policy that splits the model over
processes (`parallel.sharding.tensor_parallel`) the params are this rank's
blocks, and the model's whole sizes (``heads``, ``d_ff``, ``vocab``) say
which of them are split: `attention` runs over its own q heads (each meets
its own GQA group's K/V heads, a selection of them where K/V are whole and
q split), `mlp` over its own slice of F, and both all-reduce the partial
sum of a projection whose contraction dim is split; `embed` looks up the
ids of its own block of the vocabulary, zeros for the rest, and
all-reduces; `unembed` all-gathers its block of the logits into the whole
vocabulary.  For the backward, a replicated activation entering split
heads, a split F or a split vocabulary passes through the policy's
column-parallel entry (`ShardingPolicy.enter`), and so does a K/V leaf
that is whole on every rank while the q heads are split (each rank's use
of it, and so its gradient, is partial); the norm scales' use is
replicated, and their gradient whole on every rank.  Where the cache holds
every KV head over this rank's block of the positions (``seq_blocks``,
`transformer.init_cache` under a policy that splits the cache's
sequence), the new rows' K/V (gathered over ``model`` where ``wk`` is
split) go to the ranks that own their positions, and every chunk but a
prefill of empty rows (``rows_empty``, decided by the caller) attends by
`_attend_seq_split`: each rank's partial
online softmax of every q head over its block (`blockwise_partial`),
exchanged by one all-to-all and merged by log-sum-exp (`merge_partials`).
`grad_cast_bf16` rounds the cotangent entering `unembed` to bf16, as the
reference's custom VJP does; remat is `transformer.set_remat`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..obs import cost
from ..parallel.sharding import ShardingPolicy, shard, tensor_parallel

DEFAULT_BLOCK = 512

_ATTN_BACKEND: list[str] = ["torch"]


def set_attention_backend(name: str) -> None:
    assert name in ("torch", "cuda"), name
    _ATTN_BACKEND[0] = name


_CHUNK = 1 << 26                # f32 normals drawn at a time (256 MiB)


def _normal(gen: Optional[torch.Generator], shape, std: float, dtype,
            device) -> torch.Tensor:
    """N(0, std²) in `dtype`, drawn in f32 chunks so that a stacked leaf of
    many layers needs no f32 copy of itself (``device="meta"`` allocates
    nothing)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        n = min(_CHUNK, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=device,
                                    dtype=torch.float32) * std
    return out


# ---------------------------------------------------------- gradient dtype
class _GradCastBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the incoming cotangent is rounded to bf16.

    For a bf16 x nothing changes.  For an f32 x the reference's VJP hands
    back a bf16 cotangent, which `jax.grad` then cannot multiply into the
    next f32 op (ROADMAP §3); here autograd casts the rounded cotangent back
    to x's dtype, so an f32 model trains with the same rounded values."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradCastBf16.apply(x)
    return x


# ------------------------------------------------------------------- norms
def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or as it is where it is f64 (`.float()` would round an f64
    run to f32).  `torch.promote_types` would add a dispatched call a use
    on the host-bound decode path."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 variance (f64 in an f64 run), elementwise math in x's dtype (the
    reference's order)."""
    var = at_least_f32(x).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None, lead=()) -> dict:
    return {"scale": torch.ones(*lead, d, dtype=dtype, device=device)}


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, style: str = "full",
               theta: float = 10_000.0) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] or [S].  'full' rotates every pair,
    '2d' (ChatGLM) the first half of the head dim only, 'none' nothing."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot_dim = hd // 2 if style == "2d" else hd
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    freqs = rope_freqs(rot_dim, theta, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # [B, S, rd/2]
    cos = ang.cos()[:, :, None, :]
    sin = ang.sin()[:, :, None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------- attention
def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   bias: bool = False, dtype=torch.bfloat16, device=None,
                   lead=()) -> dict:
    """`lead` prepends stacked-layer axes to every leaf."""
    s = 1.0 / math.sqrt(d_model)
    lead = tuple(lead)
    p = {
        "wq": _normal(gen, lead + (d_model, n_heads, head_dim), s, dtype, device),
        "wk": _normal(gen, lead + (d_model, n_kv, head_dim), s, dtype, device),
        "wv": _normal(gen, lead + (d_model, n_kv, head_dim), s, dtype, device),
        "wo": _normal(gen, lead + (n_heads, head_dim, d_model), s, dtype, device),
    }
    if bias:
        p["bq"] = torch.zeros(*lead, n_heads, head_dim, dtype=dtype, device=device)
        p["bk"] = torch.zeros(*lead, n_kv, head_dim, dtype=dtype, device=device)
        p["bv"] = torch.zeros(*lead, n_kv, head_dim, dtype=dtype, device=device)
    return p


def _per_row(x, B: int, device) -> torch.Tensor:
    """A scalar or [B] position as a [B, 1] int64 tensor."""
    t = torch.as_tensor(x, device=device).to(torch.int64)
    return t.reshape(-1, 1).expand(B, 1) if t.numel() == 1 else t.reshape(B, 1)


def blockwise_attention(
    q: torch.Tensor,            # [B, Sq, H, hd]
    k: torch.Tensor,            # [B, Sk, Hkv, hd]
    v: torch.Tensor,            # [B, Sk, Hkv, hd]
    causal: bool = True,
    q_offset=0,                 # absolute position of q[:, 0]: scalar or [B]
    block_size: int = DEFAULT_BLOCK,
    kv_valid_len=None,          # mask cache slots >= this: scalar or [B]
    block_q: Optional[int] = None,
) -> torch.Tensor:
    """Flash-structured attention in plain PyTorch: Q chunks, each folded
    over KV blocks with an online softmax.  Scores are f32; probabilities
    go to the p@v product in v's dtype (standard flash practice, as the
    reference); accumulation stays f32.  GQA: H a multiple of Hkv."""
    def normalised(acc, m, l):
        return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)

    return _blockwise(q, k, v, causal, q_offset, block_size, kv_valid_len, block_q, 0,
                      normalised)


def blockwise_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset=0,
                      kv_offset: int = 0, block_size: int = DEFAULT_BLOCK,
                      kv_valid_len=None) -> torch.Tensor:
    """`blockwise_attention`'s causal online softmax over keys at absolute
    positions ``kv_offset + [0, Sk)``, stopped before the divide: [B, Sq,
    H, hd + 2] f32, each head's unnormalised sum of p v, then its running
    max m and its sum l.  A row with no valid key here has (0, -inf, 0)."""
    def packed(acc, m, l):
        return torch.cat([acc, m[..., None], l[..., None]], dim=-1)

    return _blockwise(q, k, v, True, q_offset, block_size, kv_valid_len, None, kv_offset,
                      packed)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """[n, ..., hd + 2] partial results (`blockwise_partial`) of the same
    queries over n disjoint key sets -> [..., hd] f32, their softmax over
    the union: each set's sum rescaled to the largest max (log-sum-exp).
    A set with no valid key (m = -inf) adds nothing; where no set has one
    the result is 0, as `blockwise_attention`'s."""
    acc, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    top = m.amax(0)
    top = torch.where(torch.isneginf(top), 0.0, top)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - top))
    num = (w[..., None] * acc).sum(0)
    den = (w * l).sum(0)
    return num / den.clamp_min(1e-30)[..., None]


def _blockwise(q, k, v, causal, q_offset, block_size, kv_valid_len, block_q, kv_offset,
               finish) -> torch.Tensor:
    """The online softmax of `blockwise_attention`; `finish(acc, m, l)`
    turns a Q block's state ([B, Hkv, g, bq, hd] and [B, Hkv, g, bq]) into
    its [B, Hkv, g, bq, X] output, laid out as [B, Sq, H, X]."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    bq = min(block_q or block_size, Sq)
    bk = min(block_size, Sk)
    nq = max(1, (Sq + bq - 1) // bq)
    nk = max(1, (Sk + bk - 1) // bk)
    dev = q.device

    qp = F.pad(q, (0, 0, 0, 0, 0, nq * bq - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * bk - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * bk - Sk))
    # [nq, B, Hkv, g, bq, hd] / [nk, B, Hkv, bk, hd]
    qb = qp.reshape(B, nq, bq, Hkv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)
    q_off = _per_row(q_offset, B, dev)                       # [B, 1]
    kv_len = None if kv_valid_len is None else _per_row(kv_valid_len, B, dev)

    def kv_block(qblk, q_pos, ik, m, l, acc):
        kv_idx = ik * bk + torch.arange(bk, device=dev)      # [bk], in k
        kv_pos = kv_idx + kv_offset                          # absolute
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kb[ik].float()) * scale
        mask = (kv_idx < Sk)[None, None, :].expand(B, bq, bk)
        if causal:
            mask = mask & (q_pos[:, :, None] >= kv_pos[None, None, :])
        if kv_len is not None:
            mask = mask & (kv_pos[None, None, :] < kv_len[:, :, None])
        mask = mask[:, None, None]                           # [B, 1, 1, bq, bk]
        sc = torch.where(mask, sc, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        pr = torch.exp(sc - m_safe[..., None])
        pr = torch.where(mask, pr, 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + pr.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", pr.to(v.dtype).float(), vb[ik].float())
        return m_new, l, acc

    # on meta tensors (the dry-run) every block pair has the same shapes:
    # one runs and is counted nq x nk times (`obs.cost.repeat`); a block's
    # temporaries die with its call, before its repeat counts what lives
    fold = dev.type == "meta"

    def q_block(iq):
        qblk = qb[iq].float()                                # [B, Hkv, g, bq, hd]
        q_pos = q_off + iq * bq + torch.arange(bq, device=dev)   # [B, bq]
        m = torch.full((B, Hkv, g, bq), float("-inf"), device=dev)
        l = torch.zeros(B, Hkv, g, bq, device=dev)
        acc = torch.zeros(B, Hkv, g, bq, hd, device=dev)
        with cost.repeat(nk if fold else 1) as rep:
            for ik in range(1 if fold else nk):
                m, l, acc = kv_block(qblk, q_pos, ik, m, l, acc)
            if fold and not torch.is_grad_enabled():
                rep.carried(m, l, acc)           # the next trip replaces them
        return finish(acc, m, l)

    with cost.repeat(nq if fold else 1):
        outs = [q_block(iq) for iq in range(1 if fold else nq)]
    if fold:
        outs *= nq
    # [nq, B, Hkv, g, bq, X] -> [B, Sq, H, X]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, nq * bq, H, -1)
    return out[:, :Sq]


def attention(
    params: dict,
    x: torch.Tensor,                # [B, S, D]
    positions: torch.Tensor,        # [B, S] or [S]
    rope_style: str = "full",
    causal: bool = True,
    cache: Optional[dict] = None,   # {"k": [B,Smax,Hkv,hd], "v": ..., "len": [] or [B]}
    cross_kv: Optional[tuple] = None,   # precomputed (k, v) [B, Sk, Hkv, hd]
    block_size: int = DEFAULT_BLOCK,
    heads: Optional[tuple] = None,      # the model's (n_heads, n_kv_heads)
) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention, optionally with a decode cache or cross-attention K/V.
    Cross-attention projects q only, applies no RoPE, always runs blockwise
    and non-causal (the reference never sends it to the kernel) and returns
    the cache untouched.  Under a model split over processes `heads` is
    required, params, cache and `cross_kv` hold this rank's heads, or, for
    a cache whose ``seq_blocks`` is tp, every KV head over this rank's
    block of the positions (`_attend_seq_split`; ``rows_empty``, where the
    caller knows every row starts at 0, attends locally instead), and the
    cache holds as many rows as x."""
    B, S, D = x.shape
    tp = tensor_parallel()
    hs = _local_heads(tp, params, heads, D)
    reduce = hs is not None and hs.reduce
    if reduce:
        x = tp.enter(x)
        if hs.kv_whole:
            params = {k: tp.enter(v) if k in _KV_LEAVES else v for k, v in params.items()}
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = shard(q, "act_bthd")
    if cross_kv is not None:
        k, v = (_take_heads(t, _group(hs, t.shape[2], t.device)) for t in cross_kv)
        with cost.scope("attention"):
            out = blockwise_attention(q, k, v, causal=False, block_size=block_size)
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
        return shard(tp.all_reduce(y) if reduce else y, "act_btd"), cache
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, rope_style)
    k = apply_rope(k, positions, rope_style)
    if cache is None:
        group = _group(hs, k.shape[2], k.device)
        k, v = _take_heads(k, group), _take_heads(v, group)
        with cost.scope("attention"):
            if _ATTN_BACKEND[0] == "cuda":
                from ..kernels.flash_attention.ops import flash_attention

                out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal).transpose(1, 2)
            else:
                out = blockwise_attention(q, k, v, causal=causal, block_size=block_size)
        new_cache = None
    else:
        # decode / chunked prefill: write the rows into the cache in place,
        # then attend over it
        ck, cv = cache["k"], cache["v"]
        start = cache["len"]
        blocks = _seq_blocks(tp, hs, cache)
        if hs is not None and ck.shape[0] != B:
            raise ValueError(f"a cache of {ck.shape[0]} rows for a batch of {B}: under a "
                             "policy init_cache takes the global batch, a step the rank's rows")
        if hs is not None and ck.shape[2] != k.shape[2]:
            # the cache holds every KV head, this rank computed its own
            k, v = tp.all_gather(torch.stack([k, v]), dim=3).unbind(0)
        n = ck.shape[1]
        lo = tp.model_rank * n if blocks > 1 else 0
        rows = _per_row(start, B, x.device)
        # the reference's dynamic_update_slice clamps the start so the
        # update fits; a row's write does the same, on global positions
        at = rows.clamp(0, blocks * n - S) + torch.arange(S, device=x.device)
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S)
        if blocks > 1:                       # only the positions this rank owns
            mine = (at >= lo) & (at < lo + n)
            b_idx, at, kw, vw = b_idx[mine], at[mine] - lo, k[mine], v[mine]
        else:
            kw, vw = k, v
        ck[b_idx, at] = kw.to(ck.dtype)
        cv[b_idx, at] = vw.to(cv.dtype)
        new_cache = {**cache, "len": start + S}
        with cost.scope("attention"):
            if blocks == 1:
                group = _group(hs, ck.shape[2], ck.device)
                out = blockwise_attention(
                    q, _take_heads(ck, group), _take_heads(cv, group), causal=True,
                    q_offset=start, block_size=block_size, kv_valid_len=start + S,
                )
            elif cache.get("rows_empty", False):
                # every row empty (the caller's word): the prompt's K/V are all here
                group = _group(hs, k.shape[2], k.device)
                out = blockwise_attention(
                    q, _take_heads(k.to(ck.dtype), group), _take_heads(v.to(cv.dtype), group),
                    causal=True, q_offset=start, block_size=block_size,
                    kv_valid_len=start + S)
            else:
                out = _attend_seq_split(tp, hs, q, ck, cv, start, S, lo, block_size)

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return shard(tp.all_reduce(y) if reduce else y, "act_btd"), new_cache


def _seq_blocks(tp: Optional[ShardingPolicy], hs, cache: dict) -> int:
    """The blocks a cache's sequence is cut into over ``model`` (1: whole).
    A block and a whole cache of the same length look alike, so under a
    policy whose cache spec puts the sequence on ``model`` the cache must
    say which it is (``seq_blocks``, `transformer.init_cache`'s
    ``kv_seq_blocks``): one that does not is refused."""
    blocks = cache.get("seq_blocks")
    seq = tp is not None and tp.kv_seq_split(hs.n_kv)
    if blocks is None:
        if seq:
            raise ValueError("a K/V cache under a policy that splits its sequence carries "
                             "kv_seq_blocks: make it with init_cache under the policy")
        return 1
    if blocks != 1 and not (seq and blocks == tp.tp):
        raise ValueError(f"a cache in {blocks} sequence blocks under this policy")
    return blocks


def _attend_seq_split(tp: ShardingPolicy, hs, q, ck, cv, start, S: int, lo: int,
                      block_size: int) -> torch.Tensor:
    """Attention of this rank's q heads over a cache split on its sequence:
    every head's q gathered over ``model``; each rank's partial online
    softmax of every head over its own block of positions (causal and
    ``len`` masks on global positions); the all-to-all sends each rank the
    tp partials of its own heads (all of them to every rank where the q
    heads are whole), which it merges."""
    split_q = hs.hq < hs.H
    q_all = tp.all_gather(q, dim=2) if split_q else q
    part = blockwise_partial(q_all, ck, cv, q_offset=start, kv_offset=lo,
                             block_size=block_size, kv_valid_len=start + S)
    if split_q:                          # [tp(dst), B, Sq, hq, hd + 2] -> by source
        parts = tp.all_to_all(part.unflatten(2, (tp.tp, hs.hq)).movedim(2, 0))
    else:
        parts = tp.all_gather(part[None], dim=0)
    return merge_partials(parts).to(q.dtype)


def _is_split(tp: ShardingPolicy, path: str, local: torch.Tensor, shape: tuple,
              dim: int) -> bool:
    """Whether this rank's leaf `local` at `path` holds dim `dim` of the
    whole `shape` split over ``model`` (else whole); a leaf of neither size
    (the whole weights where blocks were due) is refused."""
    split = tp.splits(path, shape, dim)
    want = shape[dim] // tp.tp if split else shape[dim]
    if local.shape[dim] != want:
        raise ValueError(f"{path}: this rank holds {local.shape[dim]} of dim {dim} of "
                         f"{tuple(shape)}, its block has {want}: give each rank its blocks "
                         "(ShardingPolicy.local_params or params_from_jax(..., policy=))")
    return split


_KV_LEAVES = ("wk", "wv", "bk", "bv")


class _Heads(NamedTuple):
    """A rank's heads under a model split: its first q head and count, the
    model's q and KV heads, its first KV head (0 where ``wk`` is whole),
    whether ``wo``'s heads are split (its sum then reduced), and whether
    the K/V leaves are whole on this rank."""
    q0: int
    hq: int
    H: int
    n_kv: int
    kv0: int
    reduce: bool
    kv_whole: bool


def _local_heads(tp: Optional[ShardingPolicy], params: dict, heads: Optional[tuple],
                 D: int) -> Optional[_Heads]:
    """This rank's heads under a model split (None without one)."""
    if tp is None:
        return None
    if heads is None:
        raise ValueError("attention under a model split over processes needs heads="
                         "(n_heads, n_kv_heads)")
    H, Hkv = heads
    hd = params["wq"].shape[-1]
    hq, hkv = params["wq"].shape[-2], params["wk"].shape[-2]
    q0 = tp.model_rank * hq if _is_split(tp, "wq", params["wq"], (D, H, hd), 1) else 0
    kv_split = _is_split(tp, "wk", params["wk"], (D, Hkv, hd), 1)
    return _Heads(q0, hq, H, Hkv, tp.model_rank * hkv if kv_split else 0,
                  _is_split(tp, "wo", params["wo"], (H, hd, D), 0), not kv_split)


def _group(hs: Optional[_Heads], n: int, device) -> Optional[torch.Tensor]:
    """The K/V head, among `n` held (every KV head, or this rank's own
    from ``kv0``), that each local q head attends with; None where the
    local q heads already form GQA groups of them in order."""
    if hs is None:
        return None
    kv0 = 0 if n == hs.n_kv else hs.kv0
    g = hs.H // hs.n_kv
    kv_of = [(hs.q0 + i) // g - kv0 for i in range(hs.hq)]
    if hs.hq % n == 0 and kv_of == [i // (hs.hq // n) for i in range(hs.hq)]:
        return None
    return torch.tensor(kv_of, device=device)


def _take_heads(t: torch.Tensor, group: Optional[torch.Tensor]) -> torch.Tensor:
    """t [B, S, Hkv, hd] with one K/V head a local q head where `group`
    says so (`_group`), else t itself."""
    return t if group is None else t.index_select(2, group)


def make_cache(batch: int, max_seq: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> dict:
    return {
        "k": torch.zeros(batch, max_seq, n_kv, head_dim, dtype=dtype, device=device),
        "v": torch.zeros(batch, max_seq, n_kv, head_dim, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------- MLP
def init_mlp(gen, d_model: int, d_ff: int, mlp_type: str = "swiglu",
             dtype=torch.bfloat16, device=None, lead=()) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    lead = tuple(lead)
    p = {
        "w_in": _normal(gen, lead + (d_model, d_ff), s_in, dtype, device),
        "w_out": _normal(gen, lead + (d_ff, d_model), s_out, dtype, device),
    }
    if mlp_type == "swiglu":
        p["w_gate"] = _normal(gen, lead + (d_model, d_ff), s_in, dtype, device)
    return p


def mlp(params: dict, x: torch.Tensor, mlp_type: str = "swiglu",
        d_ff: Optional[int] = None, reduce: bool = True) -> torch.Tensor:
    """Under a model split over processes `d_ff` (the model's F) is required
    and the params are this rank's slice of F; with ``reduce=False`` the
    rank's partial sum is returned unreduced (the MoE layer reduces it
    with its experts')."""
    tp = tensor_parallel()
    split = False
    if tp is not None:
        if d_ff is None:
            raise ValueError("mlp under a model split over processes needs d_ff=")
        split = _is_split(tp, "w_out", params["w_out"], (d_ff, x.shape[-1]), 0)
        if split:
            x = tp.enter(x)
    h = x @ params["w_in"]
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default form
    h = shard(h, "act_btf")
    y = h @ params["w_out"]
    if split and reduce:
        y = tp.all_reduce(y)
    return shard(y, "act_btd")


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic sin/cos positional embedding for arbitrary positions of any
    shape ([S], or [B, S] for one row a lane) -> [..., d_model]."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([ang.sin(), ang.cos()], dim=-1)


def einsum_promoted(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of two operands in their promoted dtype, as JAX promotes (a
    bf16 cache leaf against f32 weights computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# --------------------------------------------------------------- embedding
def init_embed(gen, vocab: int, d_model: int, tie: bool, dtype=torch.bfloat16,
               device=None) -> dict:
    p = {"embed": _normal(gen, (vocab, d_model), 0.02, dtype, device)}
    if not tie:
        p["lm_head"] = _normal(gen, (d_model, vocab), 0.02, dtype, device)
    return p


class _Lookup(torch.autograd.Function):
    """``w[ids]`` whose backward sums each row's cotangents in f32 (or f64),
    then rounds once: the index backward of a bf16 table adds every
    repeat of an id in bf16, and a frequent token repeats hundreds of
    times in a batch."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = w.shape, w.dtype
        return w[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = at_least_f32(g)
        acc = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return acc.index_put_((ids,), g, accumulate=True).to(ctx.dtype), None


def lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows `ids` of the table `w`, their gradient summed in f32."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _Lookup.apply(w, ids)
    return w[ids]


def embed(params: dict, tokens: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """Under a model split over processes `vocab` (the model's) is required;
    a rank whose block of the table is split looks up the ids in its block,
    zeros for the rest, and the all-reduce sums the one row each id has."""
    w, ids = params["embed"], tokens.long()
    tp = tensor_parallel()
    if tp is None or not _split_vocab(tp, "embed", w, vocab, 0):
        return shard(lookup(w, ids), "act_btd")
    n = w.shape[0]
    ids = ids - tp.model_rank * n
    mine = (ids >= 0) & (ids < n)
    h = torch.where(mine[..., None], lookup(w, ids.clamp(0, n - 1)), 0)
    return shard(tp.all_reduce(h), "act_btd")


def unembed(params: dict, x: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """Under a model split over processes `vocab` is required; a rank whose
    block of ``lm_head`` (or, tied, of ``embed``) is split computes its
    block of the logits and all-gathers the whole vocabulary."""
    w = params.get("lm_head")
    tied = w is None
    if tied:
        w = params["embed"].T
    x = grad_cast_bf16(x)       # keep the backward residual stream in bf16
    tp = tensor_parallel()
    split = tp is not None and (_split_vocab(tp, "embed", params["embed"], vocab, 0) if tied
                                else _split_vocab(tp, "lm_head", w, vocab, 1))
    if split:
        x = tp.enter(x)         # its cotangent summed in f32, then rounded
    logits = torch.einsum("bsd,dv->bsv", x, w)
    if split:
        logits = tp.all_gather(logits, dim=-1)
    return shard(logits, "logits")


def _split_vocab(tp: ShardingPolicy, path: str, w: torch.Tensor, vocab: Optional[int],
                 dim: int) -> bool:
    """Whether this rank's ``embed`` ([V, D], dim 0) or ``lm_head`` ([D, V],
    dim 1) is its block of a vocabulary split over ``model``."""
    if vocab is None:
        raise ValueError(f"{path} under a model split over processes needs vocab=")
    shape = list(w.shape)
    shape[dim] = vocab
    return _is_split(tp, path, w, tuple(shape), dim)
