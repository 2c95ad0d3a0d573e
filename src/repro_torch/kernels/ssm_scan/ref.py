"""Plain PyTorch version of the selective scan: the associative-scan
formulation of `repro.models.mamba` (the counterpart of
`repro.kernels.ssm_scan.ref`), seeded by an optional h0.

The pairs (decay_t, drive_t) are combined with ``(a, u) . (b, v) = (a b,
u b + v)`` by a doubling (Hillis-Steele) scan over time, which gives the
cumulative decay ``d_cum`` and the zero-started state ``h``; a seed enters
as ``h + d_cum * h0``, as `repro.models.mamba.mamba_prefill` adds it.
"""

from __future__ import annotations

from typing import Optional

import torch


def ssm_scan_ref(decay: torch.Tensor, drive: torch.Tensor, c: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """decay/drive [B,S,d,N], c [B,S,N], h0 [B,d,N] or None ->
    (y [B,S,d] in decay's dtype, h_last [B,d,N] f32).  f32 math and state."""
    a, h = decay.float(), drive.float()
    S = a.shape[1]
    off = 1
    while off < S:
        h = torch.cat([h[:, :off], h[:, off:] + a[:, off:] * h[:, :-off]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    if h0 is not None:
        h = h + a * h0.float()[:, None]
    y = torch.einsum("bsdn,bsn->bsd", h, c.float())
    return y.to(decay.dtype), h[:, -1]
