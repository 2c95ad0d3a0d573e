"""Plain PyTorch paged gather (the `repro.kernels.paged_gather.ref`
oracle, on the stacked rank axis).

The same two messages as the reference: the id list goes to the owner
(a shift by +shift), the owner packs its pool rows, and the packed block
comes back (a shift by -shift).  Ids are clamped to ``[0, n_pages - 1]``;
callers mask.
"""

from __future__ import annotations

import torch

from ...mesh import Mesh


def paged_gather_ref(pages: torch.Tensor, ids: torch.Tensor, shift: int,
                     mesh: Mesh) -> torch.Tensor:
    """pages [p, n_pages, *ps], ids [p, k] int -> [p, k, *ps]: rank r gets
    rows ``ids[r]`` of rank (r + shift)'s pool."""
    n_pages = pages.shape[1]
    req_ids = mesh.shift(ids, shift)          # rank r + shift holds r's ids
    safe = torch.clamp(req_ids.to(torch.int64), 0, n_pages - 1)
    owner = torch.arange(mesh.p, device=pages.device)[:, None]
    rows = pages[owner, safe]                 # each owner packs its rows
    return mesh.shift(rows, -shift)           # the reply to the requester
