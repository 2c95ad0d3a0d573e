"""Plain PyTorch versions of the rmaq kernels (the `repro.kernels.rmaq.ref`
oracles) on the stacked ``[p, ...]`` view.

The reference's counters are int32 words that stand for uint32 values; the
arithmetic here is done in int64 and wrapped to 32 bits wherever the
reference's int32 arithmetic wraps, so the results agree bit for bit at
any counter value.

The ``*_peer_ref`` functions are the peer forms' plain versions on a
`ProcMesh` (one rank a process, tensors this rank's ``[1, ...]`` block):
the protocol of ``csrc/rmaq_peer.cu`` with ``Tensor.copy_`` and ``clone``
through the peers' mapped blocks and one add, the epoch's fences between.
"""

from __future__ import annotations

import torch

from ...core.plan import U32_MASK, u32_to_wire
from ...mesh import Mesh
from ...procmesh import ProcMesh, aligned, as_bytes


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


# ------------------------------------------------------------- peer forms
def notified_put_peer_ref(x: torch.Tensor, cnt: torch.Tensor, shift: int, mesh: ProcMesh
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [1, ...] and cnt [1] copied into rank (rank + shift)'s slots of an
    exchange round, payload first; after the fence, what landed here."""
    dst, xb = mesh.rank + int(shift), aligned(x.nbytes)
    seg, off = mesh.round(xb + cnt.nbytes)
    seg.view(dst, off, x.nbytes).copy_(as_bytes(x))
    seg.view(dst, off + xb, cnt.nbytes).copy_(as_bytes(cnt))
    mesh.fence()
    return (mesh.take(seg, off, tuple(x.shape), x.dtype),
            mesh.take(seg, off + xb, tuple(cnt.shape), cnt.dtype))


def notify_accumulate_peer_ref(cnt: torch.Tensor, local: torch.Tensor, shift: int,
                               mesh: ProcMesh) -> torch.Tensor:
    """cnt [1] copied into rank (rank + shift)'s slot; after the fence the
    owner adds its slot to local [1], wrapping as int32 does."""
    seg, off = mesh.round(cnt.nbytes)
    seg.view(mesh.rank + int(shift), off, cnt.nbytes).copy_(as_bytes(cnt))
    mesh.fence()
    slot = mesh.take(seg, off, tuple(cnt.shape), cnt.dtype)
    return u32_to_wire(local.long() + slot.long())


def queue_push_peer_ref(buf: torch.Tensor, ctr: torch.Tensor, msgs: torch.Tensor,
                        shift: int, mesh: ProcMesh, capacity: int):
    """`queue_push_ref`'s admission, slots and tail publish between
    processes: buf [1, capacity, w] and ctr [1, 2] (symmetric tensors) and
    msgs [1, k, w].  After the opening fence, the target's (head, tail) are
    read through the peer mapping, the admitted rows copied into its ring
    and the accept count into its slot; after the closing fence the owner
    publishes tail + what arrived.  Returns (buf, ctr, n_sent [1], n_notif
    [1]), the ring and counters updated IN PLACE."""
    t, k = mesh.rank + int(shift), msgs.shape[1]
    ring_t, ctr_t = mesh.peer(buf, t), mesh.peer(ctr, t)
    seg, off = mesh.round(4)                           # the target's incoming count
    mesh.fence()
    head, tail = (ctr_t[0].long() & U32_MASK).tolist()
    free = (capacity - ((tail - head) & U32_MASK)) & U32_MASK
    accept = min(free - (1 << 32) if free >= 1 << 31 else free, k)   # as int32
    slot = (tail + torch.arange(max(accept, 0), device=buf.device)) & (capacity - 1)
    ring_t[0, slot] = msgs[0, :max(accept, 0)].to(buf.dtype)
    sent = torch.tensor([accept], dtype=torch.int32, device=buf.device)
    seg.view(t, off, 4).copy_(as_bytes(sent))
    mesh.fence()
    notif = mesh.take(seg, off, (1,), torch.int32)
    ctr[:, 1] = u32_to_wire(ctr[:, 1].long() + notif.long())
    return buf, ctr, sent, notif
