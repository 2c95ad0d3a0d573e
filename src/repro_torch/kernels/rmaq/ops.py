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
"""

from __future__ import annotations

import ctypes

import torch

from ...mesh import Mesh
from .. import common
from ..rma import ops as rma_ops
from . import ref

_NAME = "rmaq"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_PUT = common.Entry(_NAME, "rmaq_notified_put", [_P, _P, _P, _P, _I, _I, _I, _I])
_ACC = common.Entry(_NAME, "rmaq_notify_accumulate", [_P, _P, _P, _I, _I])
_PUSH = common.Entry(_NAME, "rmaq_queue_push", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])

# kernel launches by op
launches = {"notified_put": 0, "notify_accumulate": 0, "queue_push": 0}


def _launch(op: str, entry: common.Entry, device: int, *args) -> None:
    entry(*args, common.current_stream(device))
    launches[op] += 1


def _words(op: str, name: str, t: torch.Tensor) -> None:
    if t.dtype.itemsize != 4 or t.dtype.is_complex:
        raise TypeError(f"{op}: {name} must be 32-bit words, got {t.dtype}")


def notified_put(x: torch.Tensor, cnt: torch.Tensor, shift: int,
                 mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """x [p, ...] of 32-bit words, cnt [p] 32-bit: each rank's block and its
    count word put to rank (r + shift) % p in one epoch.  Returns (payload
    delivered, counts delivered), both fresh."""
    if cnt.shape != (mesh.p,):
        raise ValueError(f"notified_put: cnt must be [{mesh.p}], got {tuple(cnt.shape)}")
    if not rma_ops._on_card("notified_put", mesh, x, cnt):
        return ref.notified_put_ref(x, cnt, shift, mesh)
    xs, row, stride = rma_ops._words("notified_put", x)
    _words("notified_put", "cnt", cnt)
    cnt = cnt.contiguous()
    out, cnt_out = rma_ops._fresh(x), torch.empty_like(cnt)
    _launch("notified_put", _PUT, x.get_device(), xs.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), cnt_out.data_ptr(), mesh.p, row, stride, int(shift))
    return out, cnt_out


def notify_accumulate(cnt: torch.Tensor, local: torch.Tensor, shift: int,
                      mesh: Mesh) -> torch.Tensor:
    """Counter-only notification, int32: ``local[r] + cnt[(r - shift) % p]``
    (the doorbell without a payload).  Returns a fresh [p] tensor."""
    want = (mesh.p,)
    if cnt.shape != want or local.shape != want:
        name, t = ("cnt", cnt) if cnt.shape != want else ("local", local)
        raise ValueError(f"notify_accumulate: {name} must be [{mesh.p}], "
                         f"got {tuple(t.shape)}")
    if not rma_ops._on_card("notify_accumulate", mesh, cnt, local):
        return ref.notify_accumulate_ref(cnt, local, shift, mesh)
    if cnt.dtype != torch.int32 or local.dtype != torch.int32:
        raise TypeError(f"notify_accumulate adds int32 counters, got "
                        f"{cnt.dtype} and {local.dtype}")
    cnt, local = cnt.contiguous(), local.contiguous()
    out = torch.empty_like(local)
    _launch("notify_accumulate", _ACC, local.get_device(), cnt.data_ptr(),
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
    if len(bs) != 3 or len(ms) != 3 or ctr.shape != (p, 2):
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
        return ref.queue_push_ref(buf, ctr, msgs, shift, mesh, cap)
    _words("queue_push", "the ring", buf)
    if not (buf.is_contiguous() and ctr.is_contiguous()):
        raise ValueError("queue_push updates the ring and counters in place: "
                         "both must be contiguous")
    msgs = msgs.contiguous()
    counts = ctr.new_empty((2, p))                      # int32, on ctr's card
    ptr = counts.data_ptr()
    _launch("queue_push", _PUSH, buf.get_device(), buf.data_ptr(), ctr.data_ptr(),
            msgs.data_ptr(), ptr, ptr + 4 * p, p, cap, ms[1], bs[2], int(shift))
    n_sent, n_notif = counts.unbind()
    return buf, ctr, n_sent, n_notif
