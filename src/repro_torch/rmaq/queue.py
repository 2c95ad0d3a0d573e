"""MPSC ring-buffer message queues over RMA windows (the `repro.rmaq.queue`
counterpart over the stacked rank axis).

Every window rank owns one fixed-capacity multi-producer/single-consumer
ring in an allocated window.  One enqueue epoch is the reference protocol:

  1. **reserve** — every producer's per-target message counts and every
     target's counter block ride ONE fused gather (the rank-ordered
     fetch-and-add: producers in rank order, messages in program order);
  2. **admit** — slots are granted up to the ring's free space; the rest is
     rejected at the origin (the backpressure signal, never an overwrite);
  3. **put + notify** — payloads, sequence numbers and notification flags
     ride ONE fused all-to-all, and each owner scatters into disjoint slots
     (``seq & (capacity-1)``) and publishes its tail.

Global view: ``buf [p, capacity, item_w]``, ``ctrs [p, 5]``; on a
`ProcMesh` (one rank a process) the leading dim is this process's one rank
block (``mesh.local_ranks``), so ``buf [1, capacity, item_w]``: a rank's
row index into its own tensors is ``arange(local_ranks)``, its global rank
id ``mesh.axis_index()``, and only dims indexed by a peer rank keep p.
Admission runs on the gathered ``[p, p]`` counts, so every rank computes
the same grants.  The counters
are uint32 in the reference; here they are int64 holding uint32 values, and
every place the reference wraps masks with ``& 0xFFFFFFFF``, so behaviour
matches at wrap as well.  On the wire they travel as 32-bit words.

The ring and counters are updated **in place** (the caller threads the
returned state, as in the reference): a functional update would copy the
whole ring every epoch.  Ring cells hold bitcast headers and payloads, so
they only ever move by copy, index or `where`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import plan as plan_mod
from ..core import window as window_mod
from ..core.fabric import default_fabric
from ..core.plan import U32_MASK, u32_from_wire, u32_to_wire
from ..mesh import Mesh
from ..obs import causal as obs_causal
from ..obs import trace as obs_trace

# counter-block columns (one uint32 row of 5 per rank)
HEAD, TAIL, ENQ, DROP, NOTIF = range(5)
N_CTRS = 5


class QueueError(RuntimeError):
    pass


class QueueState(NamedTuple):
    """Device state of this process's ranks' queues: buf [R, capacity,
    item_w], ctrs [R, 5] int64 (uint32 values); R = ``mesh.local_ranks``."""

    buf: torch.Tensor
    ctrs: torch.Tensor


class EnqueueReceipt(NamedTuple):
    accepted: torch.Tensor       # [R, k] bool — per input message: granted?
    n_sent: torch.Tensor         # [R] int — messages accepted somewhere
    n_dropped: torch.Tensor      # [R] int — valid messages rejected
    incoming: torch.Tensor       # [R, p] — msgs admitted into MY ring, per producer
    notifications: torch.Tensor  # [R] — notifications delivered to me


@dataclasses.dataclass(frozen=True)
class QueueDescriptor:
    """O(1) metadata describing every rank's ring (the §2.2 property)."""

    mesh: Mesh
    capacity: int
    item_shape: tuple
    dtype: Any
    window: window_mod.Window

    @property
    def axis(self) -> str:
        return self.mesh.axis

    @property
    def item_width(self) -> int:
        return int(np.prod(self.item_shape)) if self.item_shape else 1

    @property
    def mask(self) -> int:
        return self.capacity - 1

    def metadata_nbytes(self) -> int:
        """Per-process queue metadata: descriptor constants + the window's
        own O(1) descriptor.  Independent of p and of capacity: the ring
        storage is window payload, not metadata."""
        return 48 + self.window.metadata_nbytes()


# ------------------------------------------------------------------ creation
def queue_allocate(mesh: Mesh, capacity: int, item_shape: tuple = (),
                   dtype: Any = torch.float32) -> tuple[QueueDescriptor, QueueState]:
    """Allocate one ring per rank inside an allocated window."""
    if capacity < 2 or capacity & (capacity - 1):
        raise QueueError(f"capacity must be a power of two >= 2, got {capacity}")
    item_w = int(np.prod(item_shape)) if item_shape else 1
    win, buf = window_mod.win_allocate(mesh, (capacity, item_w), dtype)
    desc = QueueDescriptor(mesh, capacity, tuple(item_shape), dtype, win)
    ctrs = torch.zeros((mesh.local_ranks, N_CTRS), dtype=torch.int64, device=mesh.device)
    return desc, QueueState(buf, ctrs)


# ------------------------------------------------------------ admission plan
def admission_plan(C: torch.Tensor, used: torch.Tensor, capacity: int):
    """Rank-ordered slot admission.

    C[r, t]: messages producer r wants to enqueue at target t; used[t]: tail
    - head at target t.  Returns (grant[r, t], offset[r, t]): how many of r's
    messages t admits, and r's slot offset past t's current tail — the value
    a rank-order-serialized fetch-and-add would have fetched."""
    cum = torch.cumsum(C, dim=0) - C                     # exclusive prefix
    free = (capacity - used).to(C.dtype)
    grant = torch.clamp(free[None, :] - cum, min=torch.zeros_like(C), max=C)
    offset = torch.minimum(cum, free[None, :].expand_as(cum))
    return grant, offset


def _fifo_pos(key: torch.Tensor, valid: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Program-order index of each message within its group (`key` in
    [0, n_keys)), batched over any leading dims: the per-message
    fetch-and-add result.  Invalid messages sort last."""
    k = key.shape[-1]
    key = torch.where(valid, key, torch.full_like(key, n_keys))
    s_key, order = torch.sort(key, dim=-1, stable=True)
    first = torch.searchsorted(s_key.contiguous(), s_key.contiguous(), side="left")
    pos_sorted = torch.arange(k, device=key.device) - first
    return torch.zeros_like(pos_sorted).scatter_(-1, order, pos_sorted)


# ------------------------------------------------------------------- enqueue
def enqueue_epoch(desc: QueueDescriptor, state: QueueState, msgs: torch.Tensor,
                  dest: torch.Tensor, reserve_riders: tuple = ()):
    """Collective enqueue epoch (all ranks).

    msgs [R, k, *item_shape]; dest [R, k] int target ranks, -1 = no message
    (R = ``mesh.local_ranks``).  Returns (state, receipt, rider_out):
    `reserve_riders` are extra [R, ...] tensors all-gathered on the
    reservation plan — they ride the SAME fused wire transfer as the
    counter fetch and come back as [R(me), p, ...] each.  Rejected messages
    (receipt.accepted False) stay with the caller.
    """
    mesh = desc.mesh
    p, cap, R = mesh.p, desc.capacity, mesh.local_ranks
    k = dest.shape[1]
    dev = dest.device
    me = mesh.axis_index()                     # global ids of my ranks
    mine = torch.arange(R, device=dev)[:, None]    # their rows in my tensors
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("queue.enqueue_epoch", axis=desc.axis, k=int(k), p=int(p),
                 riders=len(reserve_riders))
    flat = msgs.reshape(R, k, desc.item_width).to(desc.dtype)

    # out-of-range dests are "no message" (never accepted)
    dest = dest.to(torch.int64)
    valid = (dest >= 0) & (dest < p)
    dest_safe = torch.where(valid, dest, torch.zeros_like(dest))
    counts = (F.one_hot(dest_safe, p) * valid[..., None]).sum(dim=1).to(torch.int32)

    # ---- 1. reserve: the count fetch, the counter-window read and the
    # riders share ONE fused gather
    rplan = plan_mod.RmaPlan(mesh)
    h_C = rplan.all_gather(counts, kind="gets")
    h_ctrs = rplan.all_gather(u32_to_wire(state.ctrs), kind="accs")
    h_riders = [rplan.all_gather(r, kind=None) for r in reserve_riders]
    rplan.flush(aggregate=True)
    C = mesh.replicated(h_C.result()).to(torch.int64)             # [p, p]
    ctrs_all = u32_from_wire(mesh.replicated(h_ctrs.result()))    # [p, 5]
    rider_out = tuple(h.result() for h in h_riders)
    tails = ctrs_all[:, TAIL]
    used = (tails - ctrs_all[:, HEAD]) & U32_MASK

    # ---- 2. admit up to free space, producers served in rank order
    grant, offset = admission_plan(C, used, cap)                  # [p, p]
    base = (tails[None, :] + offset) & U32_MASK

    rows = me[:, None]
    pos = _fifo_pos(dest, valid, p)                               # [R, k]
    accepted = valid & (pos < grant[rows, dest_safe])
    seq = (base[rows, dest_safe] + pos) & U32_MASK

    # ---- 3. put + notify: pack granted payloads per target; row p*k of
    # the send buffers is the trash row for rejected messages
    slot_idx = dest_safe * k + pos
    put_idx = torch.where(accepted, slot_idx, torch.full_like(slot_idx, p * k))
    send_buf = torch.zeros((R, p * k + 1, desc.item_width), dtype=desc.dtype,
                           device=dev)
    send_buf[mine, put_idx] = flat
    send_seq = torch.zeros((R, p * k + 1), dtype=torch.int32, device=dev)
    send_seq[mine, put_idx] = u32_to_wire(seq)
    send_val = torch.zeros((R, p * k + 1), dtype=torch.bool, device=dev)
    send_val[mine, put_idx] = accepted

    # payload + sequence numbers + notification flags: ONE fused transfer
    pplan = plan_mod.RmaPlan(mesh)
    h_buf = pplan.put_all_to_all(
        send_buf[:, : p * k].reshape(R, p, k, desc.item_width), kind="puts")
    h_seq = pplan.put_all_to_all(send_seq[:, : p * k].reshape(R, p, k), kind=None)
    h_val = pplan.put_all_to_all(send_val[:, : p * k].reshape(R, p, k), kind="accs")
    pplan.flush(aggregate=True)
    recv_buf = h_buf.result().reshape(R, p * k, desc.item_width)
    recv_seq = u32_from_wire(h_seq.result()).reshape(R, p * k)
    in_val = h_val.result().reshape(R, p * k)

    # ---- owner side: scatter into disjoint ring slots, publish the tail
    r_idx, j_idx = in_val.nonzero(as_tuple=True)
    in_slot = recv_seq[r_idx, j_idx] & desc.mask
    state.buf[r_idx, in_slot] = recv_buf[r_idx, j_idx]
    n_in = in_val.sum(dim=1)
    ctrs = state.ctrs
    for col in (TAIL, ENQ, NOTIF):
        ctrs[:, col] = (ctrs[:, col] + n_in) & U32_MASK
    n_sent = accepted.sum(dim=1)
    n_dropped = (valid & ~accepted).sum(dim=1)
    ctrs[:, DROP] = (ctrs[:, DROP] + n_dropped) & U32_MASK

    receipt = EnqueueReceipt(
        accepted=accepted,
        n_sent=n_sent,
        n_dropped=n_dropped,
        incoming=grant.t()[me],
        notifications=n_in,
    )
    return state, receipt, rider_out


def enqueue(desc: QueueDescriptor, state: QueueState, msgs: torch.Tensor,
            dest: torch.Tensor) -> tuple[QueueState, EnqueueReceipt]:
    """`enqueue_epoch` without riders (the plain two-transfer append)."""
    state, receipt, _ = enqueue_epoch(desc, state, msgs, dest)
    return state, receipt


def enqueue_shift(desc: QueueDescriptor, state: QueueState, msgs: torch.Tensor,
                  shift: int) -> tuple[QueueState, EnqueueReceipt]:
    """All k messages of rank r to rank (r + shift) mod p — the ring special
    case the `queue_push` kernel implements (`kernels.rmaq`)."""
    mesh = desc.mesh
    k = msgs.shape[1]
    dest = ((mesh.axis_index() + shift) % mesh.p)[:, None].expand(mesh.local_ranks, k)
    return enqueue(desc, state, msgs, dest)


# ------------------------------------------------------------------- dequeue
def available(state: QueueState) -> torch.Tensor:
    return (state.ctrs[:, TAIL] - state.ctrs[:, HEAD]) & U32_MASK


def dequeue(desc: QueueDescriptor, state: QueueState, max_n: int):
    """Owner-local drain of up to `max_n` messages per rank in arrival order.

    Returns (state, items [R, max_n, *item_shape], valid [R, max_n]).
    Purely local: head is consumer-private."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("queue.dequeue", axis=desc.axis, max_n=int(max_n))
    R = state.ctrs.shape[0]
    n = torch.clamp(available(state), max=max_n)                  # [R]
    offs = torch.arange(max_n, device=state.ctrs.device)
    valid = offs[None, :] < n[:, None]
    idx = (state.ctrs[:, HEAD:HEAD + 1] + offs[None, :]) & desc.mask
    mine = torch.arange(R, device=state.ctrs.device)[:, None]
    items = state.buf[mine, idx]                                  # [R, max_n, w]
    items = torch.where(valid[..., None], items, torch.zeros_like(items))
    state.ctrs[:, HEAD] = (state.ctrs[:, HEAD] + n) & U32_MASK
    return state, items.reshape((R, max_n) + tuple(desc.item_shape)), valid


def drain(desc: QueueDescriptor, state: QueueState):
    """Dequeue everything currently in each ring (up to capacity)."""
    return dequeue(desc, state, desc.capacity)


def stats(state: QueueState) -> dict:
    """Message-count instrumentation (uint32 values, like the reference)."""
    c = state.ctrs
    return {
        "head": c[..., HEAD],
        "tail": c[..., TAIL],
        "enqueued": c[..., ENQ],
        "dropped_by_me": c[..., DROP],
        "notifications": c[..., NOTIF],
    }


# ----------------------------------------------------------- host simulation
class HostQueueGroup:
    """Host-side simulation of p ranks' rings, sharing `admission_plan`
    (run on CPU tensors, so the host and device paths admit by one function
    of ``(C, used, capacity)``).

    The control plane (ft.heartbeat) and unit tests run the identical
    protocol — reservation order, backpressure, wraparound — against numpy
    buffers, without needing a device mesh.

    Remote accesses route through a `core.fabric.Fabric`: the default
    `LocalFabric` applies them immediately (byte-identical to the direct
    mutation this class used to do — the diff test pins it), while
    `repro_torch.sim.fabric.SimFabric` delays/reorders/duplicates delivery so the
    conformance suite can run this exact protocol under chaos schedules.
    """

    def __init__(self, p: int, capacity: int, item_width: int, dtype=np.float32,
                 fabric=None, name: str = "q"):
        if capacity < 2 or capacity & (capacity - 1):
            raise QueueError(f"capacity must be a power of two >= 2, got {capacity}")
        self.p = p
        self.capacity = capacity
        self.item_width = item_width
        self.buf = np.zeros((p, capacity, item_width), dtype)
        self.ctrs = np.zeros((p, N_CTRS), np.uint64)
        self.fabric = default_fabric(fabric, p=p)
        self._name = name
        self.fabric.register(f"{name}.buf", self.buf)
        self.fabric.register(f"{name}.ctrs", self.ctrs)

    def step(self, sends: dict[int, list[tuple[int, np.ndarray]]]) -> dict[int, list[bool]]:
        """One enqueue epoch.  sends[r] = [(dest, payload), ...] in program
        order.  Returns per-producer accepted flags (the receipt).

        Fabric protocol per epoch: fence (close the previous epoch so the
        reservation sees delivered state), ONE fused counter gather, then
        per producer a batch of slot puts closed by a flush, and finally the
        owner-side tail/enq/notif publish as `fence_add`s — ordered after
        every payload of this epoch (payload visible ⇒ notification
        visible, the §6.1 write-with-notification guarantee).
        """
        tr = obs_trace.TRACER
        if not tr.enabled:
            return self._step_impl(sends)
        with tr.span("queue.step", rank=-1, queue=self._name,
                     producers=len(sends), epoch=self.fabric.epoch,
                     rids=obs_causal.current_epoch_rids()) as sp:
            accepted = self._step_impl(sends)
            flat = [ok for flags in accepted.values() for ok in flags]
            sp.set(accepted=sum(flat), rejected=len(flat) - sum(flat))
            return accepted

    def _step_impl(self, sends: dict[int, list[tuple[int, np.ndarray]]]) -> dict[int, list[bool]]:
        fab, name = self.fabric, self._name
        fab.fence()  # close the previous epoch before reserving against it
        C = np.zeros((self.p, self.p), np.int64)
        for r, items in sends.items():
            for dst, _ in items:
                C[r, dst] += 1
        ctrs_all = fab.gather(0, f"{name}.ctrs")           # reservation gather
        used = (ctrs_all[:, TAIL] - ctrs_all[:, HEAD]).astype(np.int64)
        grant, offset = (t.numpy() for t in admission_plan(
            torch.from_numpy(C), torch.from_numpy(used), self.capacity))
        accepted: dict[int, list[bool]] = {}
        taken = np.zeros((self.p, self.p), np.int64)  # msgs placed so far per pair
        for r, items in sends.items():
            flags = []
            for dst, payload in items:
                j = taken[r, dst]
                ok = j < grant[r, dst]
                if ok:
                    seq = ctrs_all[dst, TAIL] + np.uint64(offset[r, dst] + j)
                    slot = int(seq) & (self.capacity - 1)
                    fab.put(r, dst, f"{name}.buf", slot,
                            np.asarray(payload, self.buf.dtype).reshape(-1))
                else:
                    fab.add(r, r, f"{name}.ctrs", (DROP,), 1)
                taken[r, dst] = j + 1
                flags.append(bool(ok))
            accepted[r] = flags
            fab.flush(r)                                   # producer's epoch close
        admitted = grant.sum(axis=0).astype(np.uint64)
        for t in np.nonzero(admitted)[0]:
            n = admitted[t]
            fab.fence_add(int(t), f"{name}.ctrs", (TAIL,), n)
            fab.fence_add(int(t), f"{name}.ctrs", (ENQ,), n)
            fab.fence_add(int(t), f"{name}.ctrs", (NOTIF,), n)
        return accepted

    def drain(self, rank: int, max_n: int | None = None) -> list[np.ndarray]:
        avail = int(self.ctrs[rank, TAIL] - self.ctrs[rank, HEAD])
        n = avail if max_n is None else min(avail, max_n)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("queue.drain", rank=rank, queue=self._name, n=n,
                     epoch=self.fabric.epoch)
        out = []
        for i in range(n):
            slot = int(self.ctrs[rank, HEAD] + np.uint64(i)) & (self.capacity - 1)
            out.append(self.buf[rank, slot].copy())
        self.ctrs[rank, HEAD] += np.uint64(n)
        return out

    def stats(self, rank: int) -> dict:
        c = self.ctrs[rank]
        return {
            "head": int(c[HEAD]),
            "tail": int(c[TAIL]),
            "enqueued": int(c[ENQ]),
            "dropped_by_me": int(c[DROP]),
            "notifications": int(c[NOTIF]),
        }
