"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan with stabiliser); the counterpart
of `repro.models.xlstm`, function by function, with its param pytree.

mLSTM recurrence per head (state C [dh, dh], normaliser n [dh], stabiliser m):
    f_t' = exp(log sigmoid(f_t)),  i_t' = exp(i_t)       (log-space stabilised)
    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))

The prefill and training use the chunkwise form: a recurrent step a chunk of
`CHUNK` tokens over the chunk states, plus the intra-chunk attention.  Each
chunk is checkpointed when it is differentiated (the backward recomputes
the chunk's matrices instead of keeping every chunk state).  Decode is the O(1)
recurrent update.  No kernel of the table runs here: the reference names
`kernels/ssm_scan` as the fused version, but no line of it calls one.

The reference reassembles the chunks' outputs [nc, B, nh, c, dh] with a
reshape that interleaves chunks and heads; its prefill is therefore wrong
at every position once a sequence spans more than one chunk and there is
more than one head.  Here the outputs are put back in order (B, nh, nc, c),
so that the chunkwise prefill equals the recurrent decode at every length.

The sLSTM is a Python loop over the sequence: its four gates' recurrent
products are one einsum a step over the stacked ``r_i, r_f, r_o, r_z``.
The recurrent product takes the promoted dtype of h and the weights (an
f32 model with a bf16 cache promotes, as JAX does), and h is cast back to
its own dtype.  The sLSTM state starts with the stabiliser ``m`` at -1e30
(`SLSTM_INIT`), not 0.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from . import layers as L

CHUNK = 64
GATES = ("i", "f", "o", "z")
# every sLSTM state leaf's initial value (`init_slstm_state`)
SLSTM_INIT = {"c": 0.0, "n": 0.0, "h": 0.0, "m": -1e30}


# ---------------------------------------------------------------- mLSTM
def init_mlstm(gen, d_model: int, n_heads: int, dtype=torch.bfloat16, device=None,
               lead=()) -> dict:
    """The reference's leaves and scales; `lead` prepends stacked-layer axes."""
    lead = tuple(lead)
    di = 2 * d_model
    dh = di // n_heads
    s, sh = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(dh)
    n = L._normal
    return {
        "up_proj": n(gen, lead + (d_model, 2 * di), s, dtype, device),
        "wq_blk": n(gen, lead + (n_heads, dh, dh), sh, dtype, device),
        "wk_blk": n(gen, lead + (n_heads, dh, dh), sh, dtype, device),
        "wv_blk": n(gen, lead + (n_heads, dh, dh), sh, dtype, device),
        "w_i": n(gen, lead + (di, n_heads), s * 0.1, dtype, device),
        "w_f": n(gen, lead + (di, n_heads), s * 0.1, dtype, device),
        "b_i": torch.zeros(*lead, n_heads, dtype=dtype, device=device),
        "b_f": torch.full((*lead, n_heads), 3.0, dtype=dtype, device=device),
        "down_proj": n(gen, lead + (di, d_model), sh, dtype, device),
        "ln": torch.ones(*lead, di, dtype=dtype, device=device),
    }


def _mlstm_qkvif(params: dict, xin: torch.Tensor):
    """q, k / sqrt(dh), v in the input's dtype; the gate logits in f32 (f64
    in an f64 run)."""
    B, S, _ = xin.shape
    nh, dh, _ = params["wq_blk"].shape
    up = torch.einsum("bsd,de->bse", xin, params["up_proj"])
    di = up.shape[-1] // 2
    x, z = up[..., :di], up[..., di:]
    xh = x.reshape(B, S, nh, dh)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq_blk"])
    k = torch.einsum("bshd,hde->bshe", xh, params["wk_blk"]) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", xh, params["wv_blk"])
    logi = L.at_least_f32(torch.einsum("bse,eh->bsh", x, params["w_i"]) + params["b_i"])
    logf = F.logsigmoid(
        L.at_least_f32(torch.einsum("bse,eh->bsh", x, params["w_f"]) + params["b_f"]))
    return q, k, v, logi, logf, x, z


def _mlstm_chunk(C, n, m, qb, kb, vb, ib, a, fs):
    """One chunk: carry (C [B,nh,dh,dh], n [B,nh,dh], m [B,nh]) and the
    chunk's q, k, v [B,nh,c,dh], log input gates ib and in-chunk cumulative
    log forget gates a [B,nh,c], total decay fs [B,nh] -> (C, n, m, h)."""
    c = a.shape[-1]
    tri = torch.ones(c, c, dtype=torch.bool, device=a.device).tril()
    # source weight for k_s, v_s carried to the chunk's end: fs - a_s + i_s
    b = fs[..., None] - a + ib
    # intra-chunk logits D_ts = a_t - a_s + i_s (t >= s)
    dmat = torch.where(tri, a[..., :, None] - a[..., None, :] + ib[..., None, :],
                       float("-inf"))
    m_intra = dmat.amax(-1)                                   # [B,nh,c]
    m_inter = m[..., None] + a                                # the carried state's scale
    m_t = torch.maximum(m_inter, m_intra)
    qf, kf, vf = L.at_least_f32(qb), L.at_least_f32(kb), L.at_least_f32(vb)
    qs = qf * torch.exp(m_inter - m_t)[..., None]
    h_inter = torch.einsum("bhtd,bhde->bhte", qs, C)
    n_inter = torch.einsum("bhtd,bhd->bht", qs, n)
    w = torch.where(tri, torch.exp(dmat - m_t[..., None]), 0.0)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    h_intra = torch.einsum("bhts,bhse->bhte", w * s, vf)
    n_intra = torch.einsum("bhts,bhts->bht", w, s)
    denom = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_t))
    h = (h_inter + h_intra) / denom[..., None]
    # the chunk state, stabilised by the new running max m2
    m2 = torch.maximum(m + fs, b.amax(-1))
    cw = torch.exp(b - m2[..., None])                         # [B,nh,c]
    decay = torch.exp(m + fs - m2)
    C = C * decay[..., None, None] + torch.einsum("bhs,bhsd,bhse->bhde", cw, kf, vf)
    n = n * decay[..., None] + torch.einsum("bhs,bhsd->bhd", cw, kf)
    return C, n, m2, h


def mlstm_prefill(params: dict, xin: torch.Tensor, state: Optional[dict],
                  chunk: int = CHUNK):
    """Chunkwise-parallel mLSTM: [B,S,D] -> ([B,S,D], final state or None).
    Padding past S has log input gate -1e30 and log forget gate 0, so it
    neither writes the state nor decays it."""
    B, S, D = xin.shape
    nh, dh, _ = params["wq_blk"].shape
    q, k, v, logi, logf, x, z = _mlstm_qkvif(params, xin)

    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = (S + pad) // c

    def resh(t):  # [B, nc*c, nh, ...] -> [nc, B, nh, c, ...]
        t = t.reshape((B, nc, c) + tuple(t.shape[2:]))
        return t.movedim(3, 2).movedim(1, 0)

    qc, kc, vc = resh(q), resh(k), resh(v)                    # [nc,B,nh,c,dh]
    ic, fc = resh(logi[..., None])[..., 0], resh(logf[..., None])[..., 0]   # [nc,B,nh,c]
    csum_f = torch.cumsum(fc, dim=-1)                         # in-chunk cumulative log f
    fsum = csum_f[..., -1]                                    # a chunk's total decay

    if state is not None:
        C, n, m = state["C"], state["n"], state["m"]
    else:
        C = torch.zeros(B, nh, dh, dh, dtype=logi.dtype, device=xin.device)
        n = torch.zeros(B, nh, dh, dtype=logi.dtype, device=xin.device)
        m = torch.zeros(B, nh, dtype=logi.dtype, device=xin.device)
    step = _mlstm_chunk
    if torch.is_grad_enabled() and q.requires_grad:
        step = functools.partial(torch.utils.checkpoint.checkpoint, _mlstm_chunk,
                                 use_reentrant=False)
    hs = []
    for i in range(nc):
        C, n, m, h = step(C, n, m, qc[i], kc[i], vc[i], ic[i], csum_f[i], fsum[i])
        hs.append(h)

    # [nc, B, nh, c, dh] -> [B, nh, nc*c, dh], chunks in order
    h = torch.stack(hs).permute(1, 2, 0, 3, 4).reshape(B, nh, nc * c, dh)[:, :, :S]
    h = h.transpose(1, 2).reshape(B, S, nh * dh).to(xin.dtype)
    h = h * params["ln"] * F.silu(z)
    out = torch.einsum("bse,ed->bsd", h, params["down_proj"])
    return out, ({"C": C, "n": n, "m": m} if state is not None else None)


def mlstm_forward(params: dict, xin: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Training: stateless chunkwise mLSTM."""
    return mlstm_prefill(params, xin, None, chunk)[0]


def init_mlstm_state(batch: int, d_model: int, n_heads: int, device=None,
                     lead=()) -> dict:
    di = 2 * d_model
    dh = di // n_heads
    f32 = torch.float32
    return {
        "C": torch.zeros(*lead, batch, n_heads, dh, dh, dtype=f32, device=device),
        "n": torch.zeros(*lead, batch, n_heads, dh, dtype=f32, device=device),
        "m": torch.zeros(*lead, batch, n_heads, dtype=f32, device=device),
    }


def mlstm_decode(params: dict, xin: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step: xin [B,1,D]."""
    B = xin.shape[0]
    nh, dh, _ = params["wq_blk"].shape
    q, k, v, logi, logf, x, z = _mlstm_qkvif(params, xin)
    q, k, v = (L.at_least_f32(t[:, 0]) for t in (q, k, v))   # [B,nh,dh]
    logi, logf = logi[:, 0], logf[:, 0]                       # [B,nh]

    m2 = torch.maximum(state["m"] + logf, logi)
    fw = torch.exp(state["m"] + logf - m2)[..., None]
    iw = torch.exp(logi - m2)[..., None]
    C = torch.addcmul(state["C"] * fw[..., None], (iw * k)[..., :, None], v[..., None, :])
    n = state["n"] * fw + iw * k
    hq = torch.einsum("bhde,bhd->bhe", C, q)
    nq = torch.einsum("bhd,bhd->bh", n, q)
    denom = torch.maximum(nq.abs(), torch.exp(-m2))
    h = (hq / denom[..., None]).reshape(B, 1, nh * dh).to(xin.dtype)
    h = h * params["ln"] * F.silu(z)
    out = torch.einsum("bse,ed->bsd", h, params["down_proj"])
    return out, {"C": C, "n": n, "m": m2}


# ---------------------------------------------------------------- sLSTM
def init_slstm(gen, d_model: int, n_heads: int, dtype=torch.bfloat16, device=None,
               lead=()) -> dict:
    lead = tuple(lead)
    d = d_model
    dh = d // n_heads
    s = 1.0 / math.sqrt(d)
    n = L._normal
    p = {}
    for g in GATES:
        p[f"w_{g}"] = n(gen, lead + (d, d), s, dtype, device)
        p[f"r_{g}"] = n(gen, lead + (n_heads, dh, dh), s, dtype, device)
        p[f"b_{g}"] = torch.full((*lead, d), 3.0 if g == "f" else 0.0, dtype=dtype,
                                 device=device)
    dff = int(d * 4.0 / 3.0)
    p["w_in"] = n(gen, lead + (d, 2 * dff), s, dtype, device)
    p["w_out"] = n(gen, lead + (dff, d), 1.0 / math.sqrt(dff), dtype, device)
    return p


def _gate_inputs(params: dict, x: torch.Tensor, eq: str) -> torch.Tensor:
    """The four gates' input projections plus biases, stacked on a leading
    axis of 4 (i, f, o, z)."""
    w = torch.stack([params[f"w_{g}"] for g in GATES])
    b = torch.stack([params[f"b_{g}"] for g in GATES])
    out = torch.einsum(eq, x, w)
    return out + b.reshape((4,) + (1,) * (out.ndim - 2) + (b.shape[-1],))


def _slstm_step(r: torch.Tensor, nh: int, carry: tuple, xt: torch.Tensor):
    """xt [4,B,D]: the pre-projected gate inputs; r [4,nh,dh,dh] the stacked
    recurrent weights; carry (c, n, h, m), each [B,D]."""
    c, n, h, m = carry
    B, D = h.shape
    rec = L.einsum_promoted("bhd,ghde->gbhe", h.reshape(B, nh, D // nh), r).reshape(4, B, D)
    g = xt + rec
    it, ft = L.at_least_f32(g[0]), L.at_least_f32(g[1])
    ot = torch.sigmoid(L.at_least_f32(g[2]))
    zt = torch.tanh(L.at_least_f32(g[3]))
    logf = F.logsigmoid(ft)
    m2 = torch.maximum(logf + m, it)
    iw = torch.exp(it - m2)
    fw = torch.exp(logf + m - m2)
    c2 = fw * c + iw * zt
    n2 = fw * n + iw
    h2 = (ot * (c2 / n2.clamp_min(1e-6))).to(h.dtype)
    return c2, n2, h2, m2


def _slstm_ffn(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The post-projection gated FFN (pf = 4/3) over [..., D]."""
    u = L.einsum_promoted("...d,de->...e", h, params["w_in"])
    dff = u.shape[-1] // 2
    u = F.silu(u[..., :dff]) * u[..., dff:]
    return torch.einsum("...e,ed->...d", u, params["w_out"])


def slstm_prefill(params: dict, xin: torch.Tensor, state: Optional[dict], n_heads: int):
    """Sequential sLSTM over [B,S,D] + gated FFN; threads the state if given."""
    B, S, D = xin.shape
    zs = _gate_inputs(params, xin, "bsd,gde->gbse")            # [4,B,S,D]
    r = torch.stack([params[f"r_{g}"] for g in GATES])
    if state is not None:
        carry = (state["c"], state["n"], state["h"], state["m"])
    else:
        init = init_slstm_state(B, D, xin.dtype, xin.device)
        carry = (init["c"], init["n"], init["h"], init["m"])
    hs = []
    for t in range(S):
        carry = _slstm_step(r, n_heads, carry, zs[:, :, t])
        hs.append(carry[2])
    out = _slstm_ffn(params, torch.stack(hs, dim=1))
    new_state = dict(zip(("c", "n", "h", "m"), carry)) if state is not None else None
    return out, new_state


def slstm_forward(params: dict, xin: torch.Tensor, n_heads: int) -> torch.Tensor:
    return slstm_prefill(params, xin, None, n_heads)[0]


def init_slstm_state(batch: int, d_model: int, dtype=torch.bfloat16, device=None,
                     lead=()) -> dict:
    """c, n, m f32 and h in `dtype`, [*lead, B, D], at `SLSTM_INIT`."""
    shape = (*lead, batch, d_model)
    return {k: torch.full(shape, v, dtype=dtype if k == "h" else torch.float32,
                          device=device) for k, v in SLSTM_INIT.items()}


def slstm_decode(params: dict, xin: torch.Tensor, state: dict,
                 n_heads: int) -> tuple[torch.Tensor, dict]:
    zs = _gate_inputs(params, xin[:, 0], "bd,gde->gbe")        # [4,B,D]
    r = torch.stack([params[f"r_{g}"] for g in GATES])
    carry = _slstm_step(r, n_heads, (state["c"], state["n"], state["h"], state["m"]), zs)
    out = _slstm_ffn(params, carry[2])[:, None]
    return out, dict(zip(("c", "n", "h", "m"), carry))
