"""Typed multi-lane message channels multiplexed over one queue (the
`repro.rmaq.channel` counterpart over the stacked rank axis).

Each message is a typed payload on a named **lane** plus a 4-word header
(lane id, source rank, user tag, payload length).  All lanes share ONE ring
per rank; the receiver demultiplexes by lane id after `recv`.

Headers and payloads are stored bitcast into the queue's float32 cells, so
int32/uint32/float32 payloads round-trip exactly.  Small header integers
are float32 denormals: messages are assembled in the int32 domain and only
viewed as float32 (`Tensor.view`), and cells move only by copy, index or
`where` — no arithmetic ever touches them.

Tensors lead with the rank dim of `queue`'s rule: every rank's on a stacked
`Mesh`, this process's one rank on a `ProcMesh`; a header's source is the
sender's global rank id (``mesh.axis_index()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..mesh import Mesh
from . import queue as rq

HDR = 4  # header words: lane_id, src_rank, tag, payload_words

LANE_KINDS = ("payload", "descriptor")


class ChannelError(RuntimeError):
    pass


class Lane(NamedTuple):
    """A typed lane: fixed payload shape + 32-bit dtype.  ``kind`` tags what
    the lane carries (``"payload"`` data itself, ``"descriptor"`` references
    the consumer pulls); it changes no wire format."""

    name: str
    shape: tuple
    dtype: Any = torch.float32
    kind: str = "payload"


def _lane_width(lane: Lane) -> int:
    return int(np.prod(lane.shape)) if lane.shape else 1


def _lane_kind(lane) -> str:
    kind = getattr(lane, "kind", "payload")
    if kind not in LANE_KINDS:
        raise ChannelError(f"lane kind must be one of {LANE_KINDS}, got {kind!r}")
    return kind


def _check_dtype(dtype) -> None:
    if dtype.itemsize != 4:
        raise ChannelError(f"lane dtypes must be 32-bit (bitcast storage), got {dtype}")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """32-bit payload -> its int32 bit pattern (a view, no arithmetic)."""
    return x if x.dtype == torch.int32 else x.contiguous().view(torch.int32)


class RecvBatch(NamedTuple):
    """Demux view of drained messages, per local rank: fields [R, n]."""

    lane_id: torch.Tensor   # int32
    src: torch.Tensor       # int32
    tag: torch.Tensor       # int32
    words: torch.Tensor     # [R, n, payload_words] float32 raw payload cells
    valid: torch.Tensor     # bool


@dataclasses.dataclass(frozen=True)
class Channel:
    """O(1) channel metadata: the lane table + the queue descriptor."""

    lanes: tuple[Lane, ...]
    desc: rq.QueueDescriptor

    def lane_id(self, name: str) -> int:
        for i, lane in enumerate(self.lanes):
            if lane.name == name:
                return i
        raise ChannelError(f"unknown lane {name!r} (have {[l.name for l in self.lanes]})")

    def lane(self, name: str) -> Lane:
        return self.lanes[self.lane_id(name)]

    @property
    def payload_words(self) -> int:
        return self.desc.item_width - HDR

    def metadata_nbytes(self) -> int:
        """The lane table (32 bytes a lane) + the queue descriptor's."""
        return 32 * len(self.lanes) + self.desc.metadata_nbytes()

    # ------------------------------------------------------------- packing
    def _pack_bits(self, name: str, payload: torch.Tensor,
                   tag: torch.Tensor) -> torch.Tensor:
        """[*lead, *lane.shape] payload + [*lead] tag -> [*lead, item] int32."""
        lane = self.lane(name)
        lead = tuple(tag.shape)
        w = _lane_width(lane)
        pad = self.payload_words - w
        if pad < 0:
            raise ChannelError(f"lane {name!r} payload wider than channel item")
        flat = _bits(payload.reshape(lead + (w,)).to(lane.dtype))
        flat = F.pad(flat, (0, pad))
        hdr = torch.stack([
            torch.full(lead, self.lane_id(name), dtype=torch.int32, device=tag.device),
            torch.zeros(lead, dtype=torch.int32, device=tag.device),  # src: packed()
            tag.to(torch.int32),
            torch.full(lead, w, dtype=torch.int32, device=tag.device),
        ], dim=-1)
        return torch.cat([hdr, flat], dim=-1)

    def pack(self, name: str, payload: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
        """Typed payload + tag -> float32 ring items (bitcast, not converted)."""
        return self._pack_bits(name, payload, tag).view(torch.float32)

    def homogeneous(self) -> bool:
        """Whether every lane shares one payload shape + dtype + kind — the
        precondition for runtime (data-dependent) lane selection."""
        return len({(l.shape, l.dtype, _lane_kind(l)) for l in self.lanes}) == 1

    # ------------------------------------------------- send/recv (SPMD path)
    def packed(self, name: str, payload: torch.Tensor, tag: torch.Tensor,
               lane_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pack + stamp each rank as its messages' source.  payload
        [R, k, *lane.shape], tag [R, k].  `lane_id` ([R, k]) overrides the
        static lane id per message (homogeneous lane tables only)."""
        bits = self._pack_bits(name, payload, tag)
        me = self.desc.mesh.axis_index().to(torch.int32)
        bits[..., 1] = me[:, None]
        if lane_id is not None:
            if not self.homogeneous():
                raise ChannelError(
                    "runtime lane selection needs a homogeneous lane table")
            bits[..., 0] = lane_id.to(torch.int32)
        return bits.view(torch.float32)

    def send(self, state: rq.QueueState, name: str, payload: torch.Tensor,
             tag: torch.Tensor, dest: torch.Tensor
             ) -> tuple[rq.QueueState, rq.EnqueueReceipt]:
        """Collective: enqueue ``payload[:, i]`` on lane `name` at rank
        ``dest[:, i]`` (-1 = skip); a full ring rejects (receipt.accepted
        False, the caller retries).  payload [R, k, *lane.shape], tag/dest
        [R, k]."""
        return rq.enqueue(self.desc, state, self.packed(name, payload, tag), dest)

    def recv(self, state: rq.QueueState, max_n: int) -> tuple[rq.QueueState, RecvBatch]:
        """Owner-local drain + header decode; `payload` decodes the rows."""
        state, items, valid = rq.dequeue(self.desc, state, max_n)
        hdr = items[..., :HDR].contiguous().view(torch.int32)
        neg = torch.full_like(hdr[..., 0], -1)
        return state, RecvBatch(
            lane_id=torch.where(valid, hdr[..., 0], neg),
            src=torch.where(valid, hdr[..., 1], neg),
            tag=torch.where(valid, hdr[..., 2], neg),
            words=items[..., HDR:],
            valid=valid,
        )

    def _decode_rows(self, batch: RecvBatch, lane: Lane,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode `batch` rows as `lane`-typed payloads, zeroing ~mask."""
        w = _lane_width(lane)
        flat = batch.words[..., :w].contiguous()
        if lane.dtype != torch.float32:
            flat = flat.view(lane.dtype)
        flat = torch.where(mask[..., None], flat, torch.zeros_like(flat))
        return flat.reshape(tuple(mask.shape) + tuple(lane.shape)), mask

    def payload(self, batch: RecvBatch, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Lane `name`'s messages from a RecvBatch: (typed [R, n,
        *lane.shape] payloads, [R, n] bool mask of the rows on this lane).
        Other lanes' rows are zeroed."""
        mask = batch.valid & (batch.lane_id == self.lane_id(name))
        return self._decode_rows(batch, self.lane(name), mask)

    def payload_all(self, batch: RecvBatch):
        """Decode every valid row regardless of lane (lanes as credit
        domains, not types).  Requires a homogeneous lane table."""
        if not self.homogeneous():
            raise ChannelError("payload_all needs a homogeneous lane table")
        mask = (batch.valid & (batch.lane_id >= 0)
                & (batch.lane_id < len(self.lanes)))
        return self._decode_rows(batch, self.lanes[0], mask)


def channel_allocate(mesh: Mesh, capacity: int,
                     lanes: Sequence[Lane]) -> tuple[Channel, rq.QueueState]:
    """One ring per rank sized for the widest lane (+HDR header words)."""
    lanes = tuple(Lane(l.name, tuple(l.shape), l.dtype, _lane_kind(l)) for l in lanes)
    names = [l.name for l in lanes]
    if len(set(names)) != len(names):
        raise ChannelError(f"duplicate lane names: {names}")
    for lane in lanes:
        _check_dtype(lane.dtype)
    item_w = HDR + max(_lane_width(l) for l in lanes)
    desc, state = rq.queue_allocate(mesh, capacity, (item_w,), torch.float32)
    return Channel(lanes, desc), state


# --------------------------------------------------------------- host mirror
def _np_dtype(dtype) -> np.dtype:
    """A lane's dtype as numpy's: torch dtypes map through an empty tensor,
    anything else goes to `np.dtype` (names such as ``"float32"`` too)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class HostChannel:
    """Host-side channel over `HostQueueGroup` — same header layout, same
    admission protocol; used by control-plane components (ft.heartbeat).

    `fabric` (a `core.fabric.Fabric`) is threaded through to the queue
    group: the default in-process transport keeps today's semantics, the
    sim transport runs the same protocol under chaos schedules.  `name`
    namespaces this channel's fabric regions — give each channel sharing
    one fabric a distinct name (the default suits one channel per fabric).
    """

    def __init__(self, p: int, capacity: int, lanes: Sequence[Lane], fabric=None,
                 name: str = "q"):
        self.lanes = tuple(
            Lane(l.name, tuple(l.shape), _np_dtype(l.dtype), _lane_kind(l))
            for l in lanes
        )
        for lane in self.lanes:
            if np.dtype(lane.dtype).itemsize != 4:
                raise ChannelError(f"lane dtypes must be 32-bit, got {lane.dtype}")
        self.payload_words = max(
            (int(np.prod(l.shape)) if l.shape else 1) for l in self.lanes
        )
        self.group = rq.HostQueueGroup(p, capacity, HDR + self.payload_words,
                                       np.float32, fabric=fabric, name=name)
        self._pending: dict[int, list[tuple[int, np.ndarray]]] = {}

    def _lane_id(self, name: str) -> int:
        for i, lane in enumerate(self.lanes):
            if lane.name == name:
                return i
        raise ChannelError(f"unknown lane {name!r}")

    def send(self, src: int, name: str, payload, tag: int, dest: int) -> None:
        """Stage one message; delivered at the next `flush()` epoch."""
        lid = self._lane_id(name)
        lane = self.lanes[lid]
        w = int(np.prod(lane.shape)) if lane.shape else 1
        flat = np.asarray(payload, lane.dtype).reshape(w).view(np.float32)
        row = np.zeros(HDR + self.payload_words, np.float32)
        row[:HDR] = np.asarray([lid, src, tag, w], np.int32).view(np.float32)
        row[HDR : HDR + w] = flat
        self._pending.setdefault(src, []).append((dest, row))

    def flush(self) -> dict[int, list[bool]]:
        """Run one enqueue epoch over everything staged (the fence close)."""
        sends, self._pending = self._pending, {}
        return self.group.step(sends)

    def recv(self, rank: int, max_n: int | None = None) -> list[dict]:
        """Drain + demux rank's ring into decoded message dicts."""
        out = []
        for row in self.group.drain(rank, max_n):
            hdr = row[:HDR].view(np.int32)
            lane = self.lanes[int(hdr[0])]
            w = int(hdr[3])
            payload = row[HDR : HDR + w].view(lane.dtype).reshape(lane.shape or (1,))
            out.append(
                {
                    "lane": lane.name,
                    "kind": lane.kind,
                    "src": int(hdr[1]),
                    "tag": int(hdr[2]),
                    "payload": payload.copy(),
                }
            )
        return out

    def stats(self, rank: int) -> dict:
        return self.group.stats(rank)
