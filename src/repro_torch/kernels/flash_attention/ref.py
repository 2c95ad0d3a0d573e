"""Plain PyTorch oracle: exact softmax attention with GQA and the offset
causal mask (the counterpart of `repro.kernels.flash_attention.ref`).

fp32 math; query head h reads KV head h // (Hq / Hkv) (`repeat_interleave`);
causal keeps key t for query s iff t <= s + (Sk - Sq) (``tril(k=Sk-Sq)``).
One difference from the reference oracle, where it has no answer: a row
that sees no key at all (causal with Sq > Sk) is 0 here, as in the kernel
(its ``max(l, 1e-30)`` guard); the reference's softmax gives NaN there.
"""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q [B,Hq,Sq,hd], k/v [B,Hkv,Sk,hd] -> [B,Hq,Sq,hd] in q's dtype."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float() / (hd ** 0.5)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    # softmax as jax.nn.softmax computes it: exp(s - max) / sum, the max
    # held constant; an all-masked row has sum 0 and gives 0, not NaN
    m = s.amax(-1, keepdim=True).detach()
    e = torch.exp(s - torch.where(torch.isneginf(m), torch.zeros_like(m), m))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
