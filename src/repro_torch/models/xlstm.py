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

**Split over a `ProcMesh`'s ``model`` axis** (serving; `parallel.sharding.
tensor_parallel`; ``model`` must divide the heads).  An mLSTM rank runs
its block of the heads (``wq_blk`` / ``wk_blk`` / ``wv_blk`` and ``C`` /
``n`` / ``m``); ``up_proj`` [D, 2di] is split on its columns, which hold
x ‖ z, and the gates ``w_i`` / ``w_f`` [di, nh] give the rank its heads'
columns but contract over every channel of x: the up-projection's
product is all-gathered over ``model`` (every rank then holds x whole and
its heads' z), ``ln`` (whole) is sliced to the rank's channels, and
``down_proj``'s rows are its heads' channels: one all-reduce.  An sLSTM
rank runs the recurrence of its heads (``w_i..w_z``' columns and
``r_i..r_z``' heads; ``c`` / ``n`` / ``h`` / ``m`` its channels): a head
needs only its own h, so no collective runs in the time loop.  Its gated
FFN contracts over every head: h is all-gathered once after the loop;
``w_in`` [D, 2 dff] is split on its columns across gate ‖ up, so its
product is all-gathered too; ``w_out`` [dff, D] takes its rows' part and
one all-reduce (where ``model`` divides dff; xlstm-1.3b's dff = 2730 at
tp = 2), or stays whole and every rank computes it all (at tp = 4).
Training the split is ROADMAP item 12c.5b.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..obs import cost
from ..parallel.sharding import ShardingPolicy, shard, tensor_parallel
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


class _Block(NamedTuple):
    """A rank's heads under a model split over processes: the policy, its
    first head and count, the model's heads and their width, and its
    channels [lo, hi) of the heads' concatenation."""
    tp: ShardingPolicy
    h0: int
    hn: int
    nh: int
    dh: int

    @property
    def lo(self) -> int:
        return self.h0 * self.dh

    @property
    def hi(self) -> int:
        return (self.h0 + self.hn) * self.dh


def _split_heads(path: str, leaf: torch.Tensor, n_heads: Optional[int]) -> Optional[_Block]:
    """This rank's heads under a model split (None without one), from the
    leaf at `path` [nh, dh, dh] split on its heads."""
    tp = tensor_parallel()
    if tp is None:
        return None
    if n_heads is None:
        raise ValueError("an xLSTM block under a model split over processes needs n_heads=")
    hn, dh, _ = leaf.shape
    if not L._is_split(tp, path, leaf, (n_heads, dh, dh), 0):
        raise NotImplementedError(f"{n_heads} xLSTM heads over {tp.tp} model ranks do not "
                                  "split evenly")
    return _Block(tp, tp.model_rank * hn, hn, n_heads, dh)


def _mlstm_qkvif(params: dict, xin: torch.Tensor, blk: Optional[_Block] = None):
    """q, k / sqrt(dh), v in the input's dtype; the gate logits in f32 (f64
    in an f64 run); z.  Under a split (`blk`) all of this rank's heads'.
    ``up_proj``'s block is a block of the concatenated x ‖ z columns, and
    the gates ``w_i`` / ``w_f`` [di, nh] give the rank its heads' columns
    but contract over every channel of x: the product is all-gathered
    over ``model``, so that every rank holds x whole and its heads' z."""
    B, S, D = xin.shape
    nh, dh, _ = params["wq_blk"].shape
    up = shard(torch.einsum("bsd,de->bse", xin, params["up_proj"]), "act_btf")
    b_i, b_f, w_i, w_f = params["b_i"], params["b_f"], params["w_i"], params["w_f"]
    if blk is None:
        di = up.shape[-1] // 2
        x, z = up[..., :di], up[..., di:]
        xh = x
    else:
        tp, di = blk.tp, blk.nh * dh
        if L._is_split(tp, "up_proj", params["up_proj"], (D, 2 * di), 1):
            up = tp.all_gather(up, dim=-1)
        x, z, xh = up[..., :di], up[..., di + blk.lo:di + blk.hi], up[..., blk.lo:blk.hi]
        heads = slice(blk.h0, blk.h0 + blk.hn)
        b_i, b_f = b_i[heads], b_f[heads]
        if not L._is_split(tp, "w_i", w_i, (di, blk.nh), 1):
            w_i, w_f = w_i[:, heads], w_f[:, heads]
    xh = xh.reshape(B, S, nh, dh)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq_blk"])
    k = torch.einsum("bshd,hde->bshe", xh, params["wk_blk"]) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", xh, params["wv_blk"])
    logi = L.at_least_f32(torch.einsum("bse,eh->bsh", x, w_i) + b_i)
    logf = F.logsigmoid(L.at_least_f32(torch.einsum("bse,eh->bsh", x, w_f) + b_f))
    return q, k, v, logi, logf, z


def _mlstm_out(params: dict, h: torch.Tensor, z: torch.Tensor,
               blk: Optional[_Block]) -> torch.Tensor:
    """The gated output of the heads h [B, S, heads' channels] through
    ``down_proj``, whose rows are this rank's heads' channels under a
    split: a partial sum that one all-reduce over ``model`` completes."""
    ln = params["ln"] if blk is None else params["ln"][blk.lo:blk.hi]
    h = h * ln * F.silu(z)
    out = torch.einsum("bse,ed->bsd", h, params["down_proj"])
    return out if blk is None else blk.tp.all_reduce(out)


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
                  chunk: int = CHUNK, n_heads: Optional[int] = None):
    """Chunkwise-parallel mLSTM: [B,S,D] -> ([B,S,D], final state or None).
    Padding past S has log input gate -1e30 and log forget gate 0, so it
    neither writes the state nor decays it.  Under a model split over
    processes `n_heads` is the model's and the state this rank's heads'."""
    B, S, D = xin.shape
    nh, dh, _ = params["wq_blk"].shape
    blk = _split_heads("wq_blk", params["wq_blk"], n_heads)
    q, k, v, logi, logf, z = _mlstm_qkvif(params, xin, blk)

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
    # on meta tensors (the dry-run) every chunk has the same shapes: one
    # runs and is counted nc times (`obs.cost.repeat`)
    fold = xin.device.type == "meta"
    hs = []
    with cost.repeat(nc if fold else 1) as rep:
        for i in range(1 if fold else nc):
            C, n, m, h = step(C, n, m, qc[i], kc[i], vc[i], ic[i], csum_f[i], fsum[i])
            hs.append(h)
        if fold and not torch.is_grad_enabled():
            rep.carried(C, n, m)            # the next trip replaces them
    if fold:
        hs *= nc

    # [nc, B, nh, c, dh] -> [B, nh, nc*c, dh], chunks in order
    h = torch.stack(hs).permute(1, 2, 0, 3, 4).reshape(B, nh, nc * c, dh)[:, :, :S]
    h = h.transpose(1, 2).reshape(B, S, nh * dh).to(xin.dtype)
    out = shard(_mlstm_out(params, h, z, blk), "act_btd")
    return out, ({"C": C, "n": n, "m": m} if state is not None else None)


def mlstm_forward(params: dict, xin: torch.Tensor, chunk: int = CHUNK,
                  n_heads: Optional[int] = None) -> torch.Tensor:
    """Training: stateless chunkwise mLSTM."""
    return mlstm_prefill(params, xin, None, chunk, n_heads)[0]


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


def mlstm_decode(params: dict, xin: torch.Tensor, state: dict,
                 n_heads: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step: xin [B,1,D]; under a split as
    `mlstm_prefill`."""
    B = xin.shape[0]
    nh, dh, _ = params["wq_blk"].shape
    blk = _split_heads("wq_blk", params["wq_blk"], n_heads)
    q, k, v, logi, logf, z = _mlstm_qkvif(params, xin, blk)
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
    return _mlstm_out(params, h, z, blk), {"C": C, "n": n, "m": m2}


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
    dff = slstm_ff(d)
    p["w_in"] = n(gen, lead + (d, 2 * dff), s, dtype, device)
    p["w_out"] = n(gen, lead + (dff, d), 1.0 / math.sqrt(dff), dtype, device)
    return p


def slstm_ff(d_model: int) -> int:
    """The sLSTM's gated FFN width (pf = 4/3)."""
    return int(d_model * 4.0 / 3.0)


def _gate_inputs(params: dict, x: torch.Tensor, eq: str,
                 blk: Optional[_Block] = None) -> torch.Tensor:
    """The four gates' input projections plus biases, stacked on a leading
    axis of 4 (i, f, o, z); under a split this rank's heads' channels
    (``w_i..w_z``' column blocks, the biases' slice of them)."""
    w = torch.stack([params[f"w_{g}"] for g in GATES])
    b = torch.stack([params[f"b_{g}"] for g in GATES])
    if blk is not None:
        b = b[:, blk.lo:blk.hi]
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


def _slstm_split(params: dict, n_heads: int, D: int) -> Optional[_Block]:
    """This rank's heads of an sLSTM under a model split (None without
    one): ``r_i..r_z`` split on their heads, ``w_i..w_z`` on their
    columns, the same channels."""
    blk = _split_heads("r_i", params["r_i"], n_heads)
    if blk is not None and not L._is_split(blk.tp, "w_i", params["w_i"], (D, D), 1):
        raise NotImplementedError(f"an sLSTM of {D} channels over {blk.tp.tp} model ranks")
    return blk


def _slstm_ffn(params: dict, h: torch.Tensor, blk: Optional[_Block] = None) -> torch.Tensor:
    """The post-projection gated FFN (pf = 4/3) over [..., D].  Under a
    split h is this rank's heads' channels; ``w_in`` [D, 2 dff] contracts
    over every head, so h is all-gathered over ``model`` first; its column
    block is a block of the concatenated gate ‖ up, not this rank's part
    of each, so its product is all-gathered too; ``w_out`` [dff, D] then
    takes its rows' part (one all-reduce completes the sum), or, whole
    where ``model`` does not divide dff, every rank computes it all."""
    tp = None if blk is None else blk.tp
    if tp is not None:
        h = tp.all_gather(h, dim=-1)
    D = h.shape[-1]
    dff = slstm_ff(D)
    u = L.einsum_promoted("...d,de->...e", h, params["w_in"])
    if tp is not None and L._is_split(tp, "w_in", params["w_in"], (D, 2 * dff), 1):
        u = tp.all_gather(u, dim=-1)
    gate, up = u[..., :dff], u[..., dff:]
    split = tp is not None and L._is_split(tp, "w_out", params["w_out"], (dff, D), 0)
    if split:
        n = dff // tp.tp
        gate, up = (t[..., tp.model_rank * n:(tp.model_rank + 1) * n] for t in (gate, up))
    y = torch.einsum("...e,ed->...d", F.silu(gate) * up, params["w_out"])
    return shard(tp.all_reduce(y) if split else y, "act_btd")


def slstm_prefill(params: dict, xin: torch.Tensor, state: Optional[dict], n_heads: int):
    """Sequential sLSTM over [B,S,D] + gated FFN; threads the state if
    given.  Under a model split over processes the recurrence runs over
    this rank's heads (the state its channels): a head's recurrence needs
    only its own h, so no collective runs inside the time loop."""
    B, S, D = xin.shape
    blk = _slstm_split(params, n_heads, D)
    nh = n_heads if blk is None else blk.hn
    zs = _gate_inputs(params, xin, "bsd,gde->gbse", blk)       # [4,B,S,D]
    r = torch.stack([params[f"r_{g}"] for g in GATES])
    if state is not None:
        carry = (state["c"], state["n"], state["h"], state["m"])
    else:
        init = init_slstm_state(B, zs.shape[-1], xin.dtype, xin.device)
        carry = (init["c"], init["n"], init["h"], init["m"])
    # on meta tensors (the dry-run) every step has the same shapes: one runs
    # and is counted S times; each step's h stays in `hs`, and without
    # autograd nothing keeps the replaced c, n, m
    fold = xin.device.type == "meta"
    hs = []
    with cost.repeat(S if fold else 1) as rep:
        for t in range(1 if fold else S):
            carry = _slstm_step(r, nh, carry, zs[:, :, t])
            hs.append(carry[2])
        if fold and not torch.is_grad_enabled():
            rep.carried(carry[0], carry[1], carry[3])
    if fold:
        hs *= S
    out = _slstm_ffn(params, torch.stack(hs, dim=1), blk)
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
    blk = _slstm_split(params, n_heads, xin.shape[-1])
    zs = _gate_inputs(params, xin[:, 0], "bd,gde->gbe", blk)   # [4,B,D]
    r = torch.stack([params[f"r_{g}"] for g in GATES])
    carry = _slstm_step(r, n_heads if blk is None else blk.hn,
                        (state["c"], state["n"], state["h"], state["m"]), zs)
    out = _slstm_ffn(params, carry[2], blk)[:, None]
    return out, dict(zip(("c", "n", "h", "m"), carry))
