"""Deferred one-sided substrate: epoch-scoped plan recording (the
`repro.core.plan` counterpart over the stacked rank axis).

`RmaPlan` *records* collective one-sided ops instead of issuing them; each
record returns an `RmaHandle` and nothing moves until `flush()`.  At flush,
ops with an identical collective signature (same all-to-all or all-gather
over the axis) are fused into ONE wire transfer: payloads are re-expressed
as 32-bit words, concatenated, moved by a single collective, then split and
decoded losslessly.  The one backend is ``"torch"``: `repro_torch.mesh`'s
indexing collectives on the stacked ``[p, ...]`` view.

Payloads are global views (leading rank dim p).  Byte counts are per rank,
exactly as the reference counts them inside one rank's `shard_map` trace, so
`PlanStats.bytes_wire` and the `OpCounter` ledger match the reference's.

Word carrier: the reference packs into uint32 words; here the words are
int32 with the same bits (torch's uint32 arithmetic is thin, and a word is
only ever copied, never computed on).  A uint32 *value* the protocol keeps
in int64 goes on the wire through `u32_to_wire` / `u32_from_wire`, so it
still costs 4 bytes, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..mesh import Mesh
from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta
from .rma import OpCounter

U32_MASK = 0xFFFFFFFF
WORD = torch.int32


class PlanError(RuntimeError):
    pass


# ------------------------------------------------------- uint32 on the wire
def u32_to_wire(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    return (x & U32_MASK).to(torch.int32)


def u32_from_wire(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `u32_to_wire`: int32 bits -> int64 uint32 values."""
    return w.to(torch.int64) & U32_MASK


# --------------------------------------------------------- payload word codec
def _widen(dtype: torch.dtype) -> tuple[torch.dtype, bool]:
    """Map a payload dtype to a >=32-bit carrier dtype.

    Returns (wide dtype, needs_value_cast).  Sub-32-bit payloads are widened
    by a value-preserving cast before bitcasting to words; 32/64-bit payloads
    bitcast directly."""
    if dtype == torch.bool:
        return torch.int32, True
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32, True
    if not dtype.is_floating_point and not dtype.is_complex and dtype.itemsize < 4:
        return torch.int32, True
    if dtype.itemsize in (4, 8) and not dtype.is_complex:
        return dtype, False
    raise PlanError(f"cannot pack payload dtype {dtype}")


def _words_per_elt(dtype: torch.dtype) -> int:
    wide, _ = _widen(dtype)
    return wide.itemsize // 4


def _encode(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Re-express `x` as 32-bit words: shape [*x.shape[:lead], -1]."""
    wide, cast = _widen(x.dtype)
    if cast:
        x = x.to(wide)
    flat = x.contiguous().reshape(tuple(x.shape[:lead]) + (-1,))
    return flat.view(WORD)


def _decode(w: torch.Tensor, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_encode`: words back to the original payload."""
    wide, cast = _widen(dtype)
    w = w.contiguous()
    if wide.itemsize == 8:
        out = w.reshape(tuple(shape) + (2,)).view(wide).reshape(tuple(shape))
    else:
        out = w.reshape(tuple(shape)).view(wide)
    return out.to(dtype) if cast else out


# ------------------------------------------------------------------- handles
_UNRESOLVED = object()


class RmaHandle:
    """Deferred result of one recorded op; resolved by the plan's flush."""

    __slots__ = ("_result",)

    def __init__(self) -> None:
        self._result = _UNRESOLVED

    def result(self):
        if self._result is _UNRESOLVED:
            raise PlanError("handle not resolved — flush the plan first")
        return self._result


@dataclasses.dataclass
class _RecordedOp:
    kind: Optional[str]     # puts | gets | accs | colls | None (protocol rider)
    sig: tuple              # ("all_to_all",) | ("all_gather",)
    axis: str
    payload: Any            # global view [p, ...]
    handle: RmaHandle
    finalize: Callable      # delivered tensor -> handle result
    ranks: int = 1
    # target byte interval [lo, hi) on the destination window; None means
    # the op's own disjoint slot of the fused buffer
    at: Optional[tuple] = None

    @property
    def nbytes(self) -> int:
        """Per-rank payload bytes (one rank's block of the global view)."""
        return self.payload.numel() // self.ranks * self.payload.dtype.itemsize


@dataclasses.dataclass
class PlanStats:
    """Per-plan aggregation stats (the OpCounter ledger keeps the totals)."""

    raw: int = 0             # recorded (logical) messages
    coalesced: int = 0       # wire transfers actually issued
    groups: int = 0          # distinct collective signatures
    packed_groups: int = 0   # groups fused into one transfer
    bytes_logical: int = 0   # payload bytes as recorded (per rank)
    bytes_wire: int = 0      # origin-injected bytes on the wire (per rank)
    backends: dict = dataclasses.field(default_factory=dict)

    @property
    def aggregation_factor(self) -> float:
        return self.raw / self.coalesced if self.coalesced else 1.0

    def snapshot(self) -> dict:
        return {
            "raw_msgs": self.raw,
            "coalesced_msgs": self.coalesced,
            "groups": self.groups,
            "packed_groups": self.packed_groups,
            "bytes_logical": self.bytes_logical,
            "bytes_wire": self.bytes_wire,
            "backends": dict(sorted(self.backends.items())),
        }

    def delta(self, prev) -> dict:
        if hasattr(prev, "snapshot"):
            prev = prev.snapshot()
        return snapshot_delta(self.snapshot(), prev)


# ----------------------------------------------------------------- the plan
class RmaPlan:
    """Records one-sided ops for one window axis; coalesces at flush."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.axis = mesh.axis
        self.ops: list[_RecordedOp] = []
        self.flushed = False
        self.stats: Optional[PlanStats] = None

    def _record(self, kind, sig, payload, finalize=None, at=None) -> RmaHandle:
        if self.flushed:
            raise PlanError("plan already flushed")
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("plan.record", axis=self.axis, kind=kind or "rider",
                     sig=sig[0])
        h = RmaHandle()
        self.ops.append(
            _RecordedOp(kind, sig, self.axis, payload, h,
                        finalize or (lambda d: d), ranks=self.mesh.p,
                        at=None if at is None else (int(at[0]), int(at[1]))))
        return h

    def put_all_to_all(self, x: torch.Tensor,
                       kind: Optional[str] = "colls") -> RmaHandle:
        """Record: personalized all-to-all; x [p_src, p_dst, ...] resolves to
        [p_dst, p_src, ...] (block b of every rank lands at rank b)."""
        return self._record(kind, ("all_to_all",), x)

    def all_gather(self, x: torch.Tensor,
                   kind: Optional[str] = "gets") -> RmaHandle:
        """Record: window-wide gather; x [p, ...] resolves to [p, p, ...]."""
        return self._record(kind, ("all_gather",), x)

    # -------------------------------------------------------------- issuing
    def _move(self, sig: tuple, x: torch.Tensor) -> torch.Tensor:
        if sig[0] == "all_to_all":
            return self.mesh.all_to_all(x)
        return self.mesh.all_gather(x)

    def _issue_group(self, sig: tuple, ops: list[_RecordedOp],
                     pack: bool) -> tuple[int, int]:
        """Issue one signature group; returns (wire transfers, wire bytes
        per rank)."""
        p = self.mesh.p
        if not pack or len(ops) == 1:
            for op in ops:
                op.handle._result = op.finalize(self._move(sig, op.payload))
            return len(ops), sum(op.nbytes for op in ops)

        # fused: encode each payload to words, move once, decode.  The
        # per-rank lead dims (1 for all_to_all's destination dim) sit
        # behind the rank dim of the global view.
        lead = 2 if sig[0] == "all_to_all" else 1
        segs = [_encode(op.payload, lead) for op in ops]
        packed = torch.cat(segs, dim=lead)
        moved = self._move(sig, packed)             # [p, p, W] either way
        off = 0
        for op, seg in zip(ops, segs):
            w = seg.shape[-1]
            part = moved[..., off:off + w]
            shape = (tuple(op.payload.shape) if sig[0] == "all_to_all"
                     else (p,) + tuple(op.payload.shape))
            op.handle._result = op.finalize(
                _decode(part, shape, op.payload.dtype))
            off += w
        return 1, packed.numel() // p * 4

    def flush(self, aggregate: bool = True) -> PlanStats:
        """Issue every recorded op (MPI_Win_flush for the whole plan).
        aggregate=True packs every fusable group into one transfer, False
        issues one transfer per op."""
        tr = obs_trace.TRACER
        if not tr.enabled:
            return self._flush_impl(aggregate)
        with tr.span("plan.flush", axis=self.axis, pending=len(self.ops)) as sp:
            stats = self._flush_impl(aggregate)
            sp.set(raw=stats.raw, coalesced=stats.coalesced,
                   groups=stats.groups, packed_groups=stats.packed_groups,
                   bytes_wire=stats.bytes_wire)
            return stats

    def _flush_impl(self, aggregate: bool) -> PlanStats:
        if self.flushed:
            raise PlanError("plan already flushed")
        self.flushed = True
        stats = PlanStats()
        groups: dict[tuple, list[_RecordedOp]] = {}
        for op in self.ops:
            groups.setdefault((op.axis, op.sig), []).append(op)

        kinds: dict[tuple, int] = {}
        for (axis, sig), ops in groups.items():
            n = len(ops)
            stats.groups += 1
            stats.bytes_logical += sum(op.nbytes for op in ops)
            pack = bool(aggregate) and n > 1
            wire, wire_bytes = self._issue_group(sig, ops, pack)
            stats.raw += n
            stats.coalesced += wire
            stats.bytes_wire += wire_bytes
            if pack:
                stats.packed_groups += 1
            stats.backends["torch"] = stats.backends.get("torch", 0) + wire
            for op in ops:
                if op.kind is not None:
                    kinds[(op.kind, axis)] = kinds.get((op.kind, axis), 0) + 1

        OpCounter.record_plan(
            kinds, raw=stats.raw, coalesced=stats.coalesced,
            info={
                "axis": self.axis,
                "raw": stats.raw,
                "coalesced": stats.coalesced,
                "groups": stats.groups,
                "packed_groups": stats.packed_groups,
                "bytes_logical": stats.bytes_logical,
                "bytes_wire": stats.bytes_wire,
            },
        )
        self.stats = stats
        return stats
