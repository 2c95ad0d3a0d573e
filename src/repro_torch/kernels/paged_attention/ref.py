"""Plain PyTorch paged attention (the `repro.kernels.paged_attention.ref`
oracle, exact-math semantics).

Queries attend over the tokens of the pages named by an int32 page-id list:

  * a negative id masks the page: its tokens leave the softmax entirely;
  * a fully masked query row yields zeros (the ``l == 0`` guard);
  * causal masking uses the offset convention — key ``t`` is visible to
    query ``s`` iff ``t <= s + (Sk - Sq)`` with ``Sk = k * pt``, counting
    masked pages too.

Pages carry K and V interleaved, ``[n_pages, page_tokens, 2, hd]``: the
layout of the serving engine's page pools.  `paged_attention_shift_ref`
is the cross-rank form: each rank attends over pages of another rank's
pool; `paged_attention_peer_ref` the same on a `ProcMesh`, the owner's
pages cloned through its mapped block.
"""

from __future__ import annotations

import torch

from ...mesh import Mesh
from ...procmesh import ProcMesh
from ..paged_gather.ref import paged_gather_peer_ref, paged_gather_ref

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, kv_pages: torch.Tensor,
                        ids: torch.Tensor, scale: float | None = None,
                        causal: bool = False) -> torch.Tensor:
    """q [m, Sq, hd], kv_pages [n_pages, pt, 2, hd], ids [m, k] int
    -> [m, Sq, hd]: row i attends over the pt*k tokens of pages ids[i]."""
    m, Sq, hd = q.shape
    n_pages, pt = kv_pages.shape[0], kv_pages.shape[1]
    k = ids.shape[1]
    Sk = k * pt
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    rows = kv_pages[torch.clamp(ids.to(torch.int64), 0, n_pages - 1)]  # [m, k, pt, 2, hd]
    k_in = rows[:, :, :, 0].reshape(m, Sk, hd).to(torch.float32)
    v_in = rows[:, :, :, 1].reshape(m, Sk, hd).to(torch.float32)

    s = torch.einsum("msd,mtd->mst", q.to(torch.float32) * scale, k_in)
    valid = torch.repeat_interleave(ids >= 0, pt, dim=1)          # [m, Sk]
    mask = valid[:, None, :]
    if causal:
        tri = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq)
        mask = mask & tri[None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s_max = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - s_max), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("mst,mtd->msd", p, v_in) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def paged_attention_shift_ref(q: torch.Tensor, kv_pages: torch.Tensor,
                              ids: torch.Tensor, shift: int, mesh: Mesh,
                              scale: float | None = None,
                              causal: bool = False) -> torch.Tensor:
    """Cross-rank oracle: rank r attends over pages ``ids[r]`` of rank
    (r + shift)'s pool.  q [p, Sq, hd], kv_pages [p, n_pages, pt, 2, hd],
    ids [p, k] -> [p, Sq, hd].  The pages are fetched by the plain paged
    gather; the mask stays the requester's: the fetched rows become a dense
    local pool and the sign of the original ids carries the mask."""
    p, k = ids.shape
    rows = paged_gather_ref(kv_pages, ids, shift, mesh)     # [p, k, pt, 2, hd]
    local = torch.arange(p * k, device=ids.device).reshape(p, k)
    local_ids = torch.where(ids >= 0, local, torch.full_like(local, -1))
    return paged_attention_ref(q, rows.reshape((p * k,) + tuple(rows.shape[2:])),
                               local_ids, scale=scale, causal=causal)


def paged_attention_peer_ref(q: torch.Tensor, kv_pages: torch.Tensor, ids: torch.Tensor,
                             shift: int, mesh: ProcMesh, scale: float | None = None,
                             causal: bool = False) -> torch.Tensor:
    """The peer form on a `ProcMesh`: q [1, Sq, hd], kv_pages [1, n_pages,
    pt, 2, hd] a symmetric tensor, ids [1, k] -> [1, Sq, hd], this rank
    attending over pages ``ids`` of rank (rank + shift)'s pool: the pages
    read through the peer mapping (`paged_gather_peer_ref`, between the
    epoch's fences), then the requester's mask over them."""
    k = ids.shape[1]
    rows = paged_gather_peer_ref(kv_pages, ids, shift, mesh)[0]    # [k, pt, 2, hd]
    local = torch.arange(k, device=ids.device)[None]
    local_ids = torch.where(ids >= 0, local, torch.full_like(local, -1))
    return paged_attention_ref(q, rows, local_ids, scale=scale, causal=causal)
