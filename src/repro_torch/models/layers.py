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

The reference's ``shard(...)`` annotations are identities on one card and
are dropped.  `grad_cast_bf16` rounds the cotangent entering `unembed` to
bf16, as the reference's custom VJP does; remat is `transformer.set_remat`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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

    outs = []
    for iq in range(nq):
        qblk = qb[iq].float()                                # [B, Hkv, g, bq, hd]
        q_pos = q_off + iq * bq + torch.arange(bq, device=dev)   # [B, bq]
        m = torch.full((B, Hkv, g, bq), float("-inf"), device=dev)
        l = torch.zeros(B, Hkv, g, bq, device=dev)
        acc = torch.zeros(B, Hkv, g, bq, hd, device=dev)
        for ik in range(nk):
            kv_pos = ik * bk + torch.arange(bk, device=dev)      # [bk]
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kb[ik].float()) * scale
            mask = (kv_pos < Sk)[None, None, :].expand(B, bq, bk)
            if causal:
                mask = mask & (q_pos[:, :, None] >= kv_pos[None, None, :])
            if kv_len is not None:
                mask = mask & (kv_pos[None, None, :] < kv_len[:, :, None])
            mask = mask[:, None, None]                       # [B, 1, 1, bq, bk]
            sc = torch.where(mask, sc, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            pr = torch.exp(sc - m_safe[..., None])
            pr = torch.where(mask, pr, 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", pr.to(v.dtype).float(), vb[ik].float())
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    # [nq, B, Hkv, g, bq, hd] -> [B, Sq, H, hd]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, nq * bq, H, hd)
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
) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention, optionally with a decode cache or cross-attention K/V.
    Cross-attention projects q only, applies no RoPE, always runs blockwise
    and non-causal (the reference never sends it to the kernel) and returns
    the cache untouched."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cross_kv is not None:
        k, v = cross_kv
        out = blockwise_attention(q, k, v, causal=False, block_size=block_size)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, rope_style)
    k = apply_rope(k, positions, rope_style)
    if cache is None:
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
        rows = _per_row(start, B, x.device)
        # the reference's dynamic_update_slice clamps the start so the
        # update fits; a row's write does the same
        at = rows.clamp(0, ck.shape[1] - S) + torch.arange(S, device=x.device)
        b_idx = torch.arange(B, device=x.device)[:, None]
        ck[b_idx, at] = k.to(ck.dtype)
        cv[b_idx, at] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "len": start + S}
        out = blockwise_attention(
            q, ck, cv, causal=True, q_offset=start,
            block_size=block_size, kv_valid_len=start + S,
        )

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


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


def mlp(params: dict, x: torch.Tensor, mlp_type: str = "swiglu") -> torch.Tensor:
    h = x @ params["w_in"]
    if mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default form
    return h @ params["w_out"]


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


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    x = grad_cast_bf16(x)       # keep the backward residual stream in bf16
    return torch.einsum("bsd,dv->bsv", x, w)
