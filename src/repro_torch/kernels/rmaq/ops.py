"""Notified-access kernels over a `Mesh`: the `repro.kernels.rmaq.ops`
surface on global ``[p, ...]`` tensors.

On CPU tensors each op computes the plain PyTorch version (`ref`); on CUDA
tensors it launches the hand-written kernel (``csrc/rmaq.cu``) or raises —
there is no fallback.  `launches` counts kernel launches per op (and
nothing else), so a run can show that its path went through the kernels.

`queue_push` updates the ring and the counters IN PLACE on both paths (a
functional copy of the ring would dominate the kernel) and returns them;
a rejected message is never written, so there is no trash row (the
reference's exists for its interpret mode's static DMA schedule).

On a `ProcMesh` (one rank a process) each op runs its peer form on this
rank's ``[1, ...]`` block: the kernels of ``csrc/rmaq_peer.cu`` store into
the peers' blocks through a segment's pointer table, and the epoch's fence
(stream drained, then a barrier) makes the stores visible.
`notified_put` stores the payload and then its count into the target's
slots of an exchange round; `notify_accumulate` stores the count into the
owner's slot and, after the fence, the owner adds it (two launches);
`queue_push` needs the ring and the counters in symmetric segments
(`core.window.win_allocate`, `ProcMesh.symmetric`): after a fence that
opens the epoch, the producer reads its target's (head, tail) in place,
admits, stores the admitted rows into the target's ring and the accept
count into its slot, and after the closing fence the owner publishes its
tail (two launches).  Under the uniform shift every target has exactly one
producer, so no store races another.  Every peer launch counts under its
op in `launches`; on the CPU the plain versions (`ref.*_peer_ref`) do the
same with ``Tensor.copy_`` through the mapped blocks.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs import cost
from ...mesh import Mesh
from ...procmesh import ProcMesh, aligned
from .. import common
from ..rma import ops as rma_ops
from . import ref

_NAME = "rmaq"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_PUT = common.Entry(_NAME, "rmaq_notified_put", [_P, _P, _P, _P, _I, _I, _I, _I])
_ACC = common.Entry(_NAME, "rmaq_notify_accumulate", [_P, _P, _P, _I, _I])
_PUSH = common.Entry(_NAME, "rmaq_queue_push", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
# the peer forms (csrc/rmaq_peer.cu)
_PEER = "rmaq_peer"
_PEER_PUT = common.Entry(_PEER, "rmaq_peer_notified_put", [_P, _P, _P] + [_I] * 7)
_PEER_STORE = common.Entry(_PEER, "rmaq_peer_count_store", [_P, _P] + [_I] * 5)
_PEER_ADD = common.Entry(_PEER, "rmaq_peer_count_add", [_P, _P, _P, _I, _I, _I])
_PEER_PUSH = common.Entry(_PEER, "rmaq_peer_queue_push",
                          [_P, _P, _I, _P, _I, _P, _I, _P] + [_I] * 6)
_PEER_PUBLISH = common.Entry(_PEER, "rmaq_peer_queue_publish", [_P, _P, _I, _I, _P])

# kernel launches by op
launches = {"notified_put": 0, "notify_accumulate": 0, "queue_push": 0}


def _launch(op: str, entry: common.Entry, device: int, nbytes: int, *args) -> None:
    """Launch, count, and report `nbytes` (its bound's bytes) to a running
    cost counter."""
    entry(*args, common.current_stream(device))
    launches[op] += 1
    cost.report_kernel(op, 0, nbytes, product=False)


def _words(op: str, name: str, t: torch.Tensor) -> None:
    if t.dtype.itemsize != 4 or t.dtype.is_complex:
        raise TypeError(f"{op}: {name} must be 32-bit words, got {t.dtype}")


def notified_put(x: torch.Tensor, cnt: torch.Tensor, shift: int,
                 mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """x [p, ...] of 32-bit words, cnt [p] 32-bit: each rank's block and its
    count word put to rank (r + shift) % p in one epoch.  Returns (payload
    delivered, counts delivered), both fresh."""
    R = mesh.local_ranks
    if cnt.shape != (R,):
        raise ValueError(f"notified_put: cnt must be [{R}], got {tuple(cnt.shape)}")
    if not rma_ops._on_card("notified_put", mesh, x, cnt):
        if isinstance(mesh, ProcMesh):
            return ref.notified_put_peer_ref(x, cnt, shift, mesh)
        return ref.notified_put_ref(x, cnt, shift, mesh)
    if isinstance(mesh, ProcMesh):
        return _peer_notified_put(x, cnt, shift, mesh)
    xs, row, stride = rma_ops._words("notified_put", x)
    _words("notified_put", "cnt", cnt)
    cnt = cnt.contiguous()
    out, cnt_out = rma_ops._fresh(x), torch.empty_like(cnt)
    _launch("notified_put", _PUT, x.get_device(), 2 * (out.nbytes + cnt.nbytes),
            xs.data_ptr(), out.data_ptr(), cnt.data_ptr(), cnt_out.data_ptr(), mesh.p, row,
            stride, int(shift))
    return out, cnt_out


def notify_accumulate(cnt: torch.Tensor, local: torch.Tensor, shift: int,
                      mesh: Mesh) -> torch.Tensor:
    """Counter-only notification, int32: ``local[r] + cnt[(r - shift) % p]``
    (the doorbell without a payload).  Returns a fresh [p] tensor."""
    want = (mesh.local_ranks,)
    if cnt.shape != want or local.shape != want:
        name, t = ("cnt", cnt) if cnt.shape != want else ("local", local)
        raise ValueError(f"notify_accumulate: {name} must be [{want[0]}], "
                         f"got {tuple(t.shape)}")
    if not rma_ops._on_card("notify_accumulate", mesh, cnt, local):
        if isinstance(mesh, ProcMesh):
            return ref.notify_accumulate_peer_ref(cnt, local, shift, mesh)
        return ref.notify_accumulate_ref(cnt, local, shift, mesh)
    if cnt.dtype != torch.int32 or local.dtype != torch.int32:
        raise TypeError(f"notify_accumulate adds int32 counters, got "
                        f"{cnt.dtype} and {local.dtype}")
    cnt, local = cnt.contiguous(), local.contiguous()
    if isinstance(mesh, ProcMesh):
        return _peer_notify_accumulate(cnt, local, shift, mesh)
    out = torch.empty_like(local)
    _launch("notify_accumulate", _ACC, local.get_device(), 3 * out.nbytes, cnt.data_ptr(),
            local.data_ptr(), out.data_ptr(), mesh.p, int(shift))
    return out


def queue_push(buf: torch.Tensor, ctr: torch.Tensor, msgs: torch.Tensor,
               shift: int, mesh: Mesh, capacity: int | None = None):
    """Ring-slot enqueue toward rank (r + shift) % p.

    buf [p, capacity, w] and ctr [p, 2] int32 (head, tail; uint32 values in
    int32 words) are updated in place; msgs [p, k, w] (k messages a rank),
    32-bit words like the ring.  Returns (buf, ctr, n_sent [p] int32 per
    producer, n_notif [p] int32 per owner); on the card n_sent and n_notif
    are the two rows of one [2, p] tensor, the call's one allocation."""
    bs, ms, p = buf.shape, msgs.shape, mesh.p     # each read once: the host path is the cost
    cap = bs[1] if capacity is None else int(capacity)
    if len(bs) != 3 or len(ms) != 3 or ctr.shape != (mesh.local_ranks, 2):
        raise ValueError(f"queue_push needs buf [p, cap, w], ctr [p, 2], msgs "
                         f"[p, k, w]; got {tuple(bs)}, {tuple(ctr.shape)}, {tuple(ms)}")
    if cap != bs[1] or cap < 2 or cap & (cap - 1):
        raise ValueError(f"queue_push: capacity {cap} must be the ring's "
                         f"{bs[1]} and a power of two >= 2")
    if ms[2] != bs[2] or msgs.dtype != buf.dtype:
        raise ValueError(f"queue_push: messages {tuple(ms)} {msgs.dtype} do "
                         f"not fit ring rows {tuple(bs)} {buf.dtype}")
    if ctr.dtype != torch.int32:
        raise TypeError(f"queue_push counters must be int32, got {ctr.dtype}")
    if not rma_ops._on_card("queue_push", mesh, buf, ctr, msgs):
        if isinstance(mesh, ProcMesh):
            return ref.queue_push_peer_ref(buf, ctr, msgs, shift, mesh, cap)
        return ref.queue_push_ref(buf, ctr, msgs, shift, mesh, cap)
    _words("queue_push", "the ring", buf)
    if not (buf.is_contiguous() and ctr.is_contiguous()):
        raise ValueError("queue_push updates the ring and counters in place: "
                         "both must be contiguous")
    msgs = msgs.contiguous()
    if isinstance(mesh, ProcMesh):
        return _peer_queue_push(buf, ctr, msgs, shift, mesh, cap)
    counts = ctr.new_empty((2, p))                      # int32, on ctr's card
    ptr = counts.data_ptr()
    # the counters read and written, the messages read and placed, the counts
    _launch("queue_push", _PUSH, buf.get_device(), 2 * (ctr.nbytes + msgs.nbytes) + 4 * p,
            buf.data_ptr(), ctr.data_ptr(), msgs.data_ptr(), ptr, ptr + 4 * p, p, cap,
            ms[1], bs[2], int(shift))
    n_sent, n_notif = counts.unbind()
    return buf, ctr, n_sent, n_notif


# ------------------------------------------------------------- peer forms
def _peer_notified_put(x: torch.Tensor, cnt: torch.Tensor, shift: int,
                       mesh: ProcMesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The payload and then its count word into rank (rank + shift)'s slots
    of an exchange round; after the fence, what landed here."""
    xs = rma_ops._block("notified_put", x)
    _words("notified_put", "cnt", cnt)
    cnt = cnt.contiguous()
    xb = aligned(xs.nbytes)
    seg, off = mesh.round(xb + cnt.nbytes)
    _launch("notified_put", _PEER_PUT, x.get_device(), 2 * (xs.nbytes + cnt.nbytes),
            xs.data_ptr(), cnt.data_ptr(), seg.table_ptr, mesh.p, mesh.rank, int(shift), off,
            off + xb, xs.numel(), cnt.numel())
    mesh.fence()
    return (mesh.take(seg, off, tuple(x.shape), x.dtype),
            mesh.take(seg, off + xb, tuple(cnt.shape), cnt.dtype))


def _peer_notify_accumulate(cnt: torch.Tensor, local: torch.Tensor, shift: int,
                            mesh: ProcMesh) -> torch.Tensor:
    """The count into rank (rank + shift)'s slot; after the fence, the
    owner's add of its slot to `local`."""
    seg, off = mesh.round(cnt.nbytes)
    dev = local.get_device()
    _launch("notify_accumulate", _PEER_STORE, dev, 2 * cnt.nbytes, cnt.data_ptr(),
            seg.table_ptr, mesh.p, mesh.rank, int(shift), off, cnt.numel())
    mesh.fence()
    out = torch.empty_like(local)
    _launch("notify_accumulate", _PEER_ADD, dev, 3 * out.nbytes, local.data_ptr(),
            seg.table_ptr, out.data_ptr(), mesh.rank, off, out.numel())
    return out


def _peer_queue_push(buf: torch.Tensor, ctr: torch.Tensor, msgs: torch.Tensor, shift: int,
                     mesh: ProcMesh, cap: int):
    """After the opening fence the producer's launch (the target's counters
    read in place, the admitted rows and the accept count stored); after the
    closing fence the owner's publish of its tail."""
    (bseg, boff), (cseg, coff) = mesh.locate(buf), mesh.locate(ctr)
    seg, off = mesh.round(4)                   # the target's incoming count
    counts = ctr.new_empty((2, 1))             # n_sent, n_notif
    dev, k, w = buf.get_device(), msgs.shape[1], buf.shape[2]
    mesh.fence()                               # every target's ring and tail current
    _launch("queue_push", _PEER_PUSH, dev, 2 * (ctr.nbytes + msgs.nbytes) + 4,
            msgs.data_ptr(), bseg.table_ptr, boff, cseg.table_ptr, coff, seg.table_ptr, off,
            counts.data_ptr(), mesh.p, mesh.rank, int(shift), cap, k, w)
    mesh.fence()                               # the rows and the counts have landed
    _launch("queue_push", _PEER_PUBLISH, dev, 2 * ctr.nbytes + 8, ctr.data_ptr(),
            seg.table_ptr, mesh.rank, off, counts[1].data_ptr())
    n_sent, n_notif = counts.unbind()
    return buf, ctr, n_sent, n_notif
