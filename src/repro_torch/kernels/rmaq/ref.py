"""Plain PyTorch versions of the rmaq kernels (the `repro.kernels.rmaq.ref`
oracles) on the stacked ``[p, ...]`` view.

The reference's counters are int32 words that stand for uint32 values; the
arithmetic here is done in int64 and wrapped to 32 bits wherever the
reference's int32 arithmetic wraps, so the results agree bit for bit at
any counter value.
"""

from __future__ import annotations

import torch

from ...core.plan import U32_MASK, u32_to_wire
from ...mesh import Mesh


def notified_put_ref(x: torch.Tensor, cnt: torch.Tensor, shift: int, mesh: Mesh
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(payload delivered, count delivered): ``out[(r + shift) % p] = x[r]``
    and the same for `cnt`."""
    return mesh.shift(x, shift), mesh.shift(cnt, shift)


def notify_accumulate_ref(cnt: torch.Tensor, local: torch.Tensor, shift: int,
                          mesh: Mesh) -> torch.Tensor:
    """``local[r] + cnt[(r - shift) % p]``, wrapping as int32 does."""
    return u32_to_wire(local.long() + mesh.shift(cnt, shift).long())


def queue_push_ref(buf: torch.Tensor, ctr: torch.Tensor, msgs: torch.Tensor,
                   shift: int, mesh: Mesh, capacity: int):
    """Ring-slot enqueue of rank r's k messages into rank (r + shift) % p's
    ring, with the reference's admission, slots and tail publish:

      * the producer fetches the target's (head, tail) and admits
        ``accept = min(k, capacity - (tail - head))`` (int32 wrapping);
      * message j < accept goes to slot ``(tail + j) & (capacity - 1)``;
        the rest are rejected at the origin and land nowhere;
      * the owner publishes ``tail + accept``.

    buf [p, capacity, w] and ctr [p, 2] int32 (head, tail) are updated IN
    PLACE, as the port's queue updates its ring; msgs [p, k, w].  Returns
    (buf, ctr, n_sent [p] int32 = each producer's accept, n_notif [p] int32
    = what arrived at each owner)."""
    p = mesh.p
    k = msgs.shape[1]
    mask = capacity - 1
    dev = buf.device
    tgt_ctr = mesh.shift(ctr, -shift).long()           # ctr of rank r + shift
    used = (tgt_ctr[:, 1] - tgt_ctr[:, 0]) & U32_MASK
    free = (capacity - used) & U32_MASK
    free = torch.where(free >= 1 << 31, free - (1 << 32), free)   # as int32
    accept = torch.clamp(free, max=k)                  # [p] per producer
    in_accept = mesh.shift(accept, shift)              # [p] per owner
    in_msgs = mesh.shift(msgs, shift)
    offs = torch.arange(k, device=dev)
    ok = offs[None, :] < in_accept[:, None]            # [p(owner), k]
    tail = ctr[:, 1].long()
    slot = (tail[:, None] + offs[None, :]) & mask
    owner = torch.arange(p, device=dev)[:, None].expand(p, k)
    buf[owner[ok], slot[ok]] = in_msgs[ok].to(buf.dtype)
    ctr[:, 1] = u32_to_wire(tail + in_accept)
    return buf, ctr, u32_to_wire(accept), u32_to_wire(in_accept)
