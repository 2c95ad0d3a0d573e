"""Deferred one-sided substrate: epoch-scoped plan recording (the
`repro.core.plan` counterpart over the stacked rank axis).

`RmaPlan` *records* one-sided ops (put / get / accumulate / fetch_and_op /
all-to-all / all-gather) instead of issuing them; each record returns an
`RmaHandle` and nothing moves until `flush()`.  At flush, ops with an
identical collective signature (the same permutation, or the same
all-to-all or all-gather over the axis) may be fused into ONE wire
transfer: payloads are re-expressed as 32-bit words, concatenated, moved by
a single collective, then split and decoded losslessly.  Whether to pack is
`PerfModel.select_aggregation`'s call unless the caller forces it.

Each transfer runs on a backend: ``"torch"`` (`repro_torch.mesh`'s indexing
collectives on the stacked ``[p, ...]`` view) or ``"cuda"`` (the
hand-written put kernel of `repro_torch.kernels.rma`, which carries every
unpacked uniform-shift group of 32-bit payloads on the card — `_route`).

`AccessEpoch` ties a plan to one of the three synchronisation families
(fence / PSCW / shared lock): `open()` performs the family's opening sync,
record methods defer ops into the plan, and `close()` flushes the plan
before the family's closing sync.

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
import functools
from typing import Any, Callable, Literal, Optional, Sequence

import torch

from ..kernels.rma import ops as rma_ops
from ..mesh import Mesh
from ..obs import trace as obs_trace
from ..obs.metrics import snapshot_delta
from .perfmodel import DEFAULT_MODEL, PerfModel
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


class _Perm(tuple):
    """A permutation's ``(src, dst)`` pairs.  A plain tuple that computes its
    hash once: a shift over 10^5 ranks is hashed at every flush."""

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = self.__dict__["_hash"] = tuple.__hash__(self)
        return h


@functools.lru_cache(maxsize=64)
def _shift_perm(p: int, shift: int) -> _Perm:
    return _Perm((i, (i + shift) % p) for i in range(p))


@dataclasses.dataclass
class _RecordedOp:
    kind: Optional[str]     # puts | gets | accs | colls | None (protocol rider)
    sig: tuple              # ("ppermute", perm) | ("all_to_all",) | ("all_gather",) | ("local",)
    axis: str
    payload: Any            # global view [p, ...]
    handle: RmaHandle
    finalize: Callable      # delivered tensor -> handle result
    ranks: int = 1
    shift: Optional[int] = None   # set when sig is a uniform-shift ppermute
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


# --------------------------------------------------------- backend selection
Backend = Literal["torch", "cuda"]
BACKENDS = ("torch", "cuda")


def _cuda_eligible(x: torch.Tensor) -> bool:
    """Whether the put kernel can carry `x`: a CUDA payload whose per-rank
    block is whole 4-byte words, of any rank and layout (the wrapper reads a
    rank-strided block in place and copies any other view)."""
    return x.is_cuda and x.dtype.itemsize == 4 and not x.dtype.is_complex


def _route(sig: tuple, ops: list, pack: bool, backend: str) -> Backend:
    """The backend a group runs on.  Only a uniform-shift ppermute group can
    take the kernel: under "auto" when it is unpacked and every payload is
    the kernel's to carry (packed word buffers take "torch", as the
    reference sends them to XLA), under a forced "cuda" always (on CPU
    tensors the kernel's wrapper is its plain version).  Everything else
    goes through the mesh: "torch"."""
    shift_group = sig[0] == "ppermute" and all(op.shift is not None for op in ops)
    if not shift_group or backend == "torch":
        return "torch"
    if backend == "cuda":
        return "cuda"
    if not pack and all(_cuda_eligible(op.payload) for op in ops):
        return "cuda"
    return "torch"


def _issue_ppermute(mesh: Mesh, x: torch.Tensor, perm: tuple,
                    shift: Optional[int], backend: str) -> torch.Tensor:
    if backend == "cuda":
        return rma_ops.put_shift(x, shift, mesh)
    if shift is not None:
        return mesh.shift(x, shift)
    return mesh.ppermute(x, perm)


# ----------------------------------------------------------------- the plan
class RmaPlan:
    """Records one-sided ops for one window axis; coalesces at flush."""

    def __init__(self, mesh: Mesh, model: PerfModel = DEFAULT_MODEL) -> None:
        self.mesh = mesh
        self.axis = mesh.axis
        self.model = model
        self.ops: list[_RecordedOp] = []
        self.flushed = False
        self.stats: Optional[PlanStats] = None

    def _record(self, kind, sig, payload, finalize=None, shift=None,
                at=None) -> RmaHandle:
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
                        shift=shift,
                        at=None if at is None else (int(at[0]), int(at[1]))))
        return h

    def put_shift(self, x: torch.Tensor, shift: int, kind: str = "puts",
                  at: Optional[tuple] = None) -> RmaHandle:
        """Record: put rank r's block of `x` to rank (r+shift) mod p;
        resolves to what landed at each rank.  ``at=(lo, hi)`` declares the
        target byte interval (default: the op's own disjoint slot)."""
        return self._record(kind, ("ppermute", _shift_perm(self.mesh.p, int(shift))),
                            x, shift=int(shift), at=at)

    def put_perm(self, x: torch.Tensor, perm: Sequence[tuple[int, int]],
                 kind: str = "puts", at: Optional[tuple] = None) -> RmaHandle:
        """Record: put along an arbitrary (src, dst) permutation."""
        return self._record(kind, ("ppermute", tuple(tuple(p) for p in perm)),
                            x, at=at)

    def get_shift(self, x: torch.Tensor, shift: int) -> RmaHandle:
        """Record: get from rank (r+shift) mod p — the put by r+shift to r,
        so it is recorded as a put with the shift negated."""
        return self._record("gets", ("ppermute", _shift_perm(self.mesh.p, -int(shift))),
                            x, shift=-int(shift))

    def accumulate_shift(self, x: torch.Tensor, acc: torch.Tensor, shift: int,
                         op: Callable = torch.add) -> RmaHandle:
        """Record: slotted accumulate to rank r+shift.  The payload shares
        the wire with same-permutation puts; the owner applies
        ``op(acc, incoming)`` after delivery."""
        return self._record("accs", ("ppermute", _shift_perm(self.mesh.p, int(shift))),
                            x, finalize=lambda inc: op(acc, inc), shift=int(shift))

    def accumulate_perm(self, x: torch.Tensor, acc: torch.Tensor,
                        perm: Sequence[tuple[int, int]],
                        op: Callable = torch.add) -> RmaHandle:
        return self._record("accs", ("ppermute", tuple(tuple(p) for p in perm)),
                            x, finalize=lambda inc: op(acc, inc))

    def fetch_and_op(self, x: torch.Tensor, target: torch.Tensor,
                     op: Callable = torch.add) -> RmaHandle:
        """Record: fetch-and-op; resolves to (old, new).  Serialisation is the
        epoch's, so there is no wire transfer, but it is one AMO message for
        the accounting."""
        return self._record("accs", ("local",), x,
                            finalize=lambda _: (target, op(target, x)))

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
    def _move(self, sig: tuple, x: torch.Tensor, shift: Optional[int],
              backend: str) -> torch.Tensor:
        if sig[0] == "ppermute":
            return _issue_ppermute(self.mesh, x, sig[1], shift, backend)
        if sig[0] == "all_to_all":
            return self.mesh.all_to_all(x)
        return self.mesh.all_gather(x)

    def _issue_group(self, sig: tuple, ops: list[_RecordedOp], pack: bool,
                     backend: str) -> tuple[int, int]:
        """Issue one signature group; returns (wire transfers, wire bytes
        per rank)."""
        p = self.mesh.p
        if sig[0] == "local":
            for op in ops:
                op.handle._result = op.finalize(op.payload)
            return len(ops), 0

        if not pack or len(ops) == 1:
            for op in ops:
                op.handle._result = op.finalize(
                    self._move(sig, op.payload, op.shift, backend))
            return len(ops), sum(op.nbytes for op in ops)

        # fused: encode each payload to words, move once, decode.  The
        # per-rank lead dims (1 for all_to_all's destination dim) sit
        # behind the rank dim of the global view.  Every op of a ppermute
        # group has the same permutation, so the first op's shift holds.
        lead = 2 if sig[0] == "all_to_all" else 1
        segs = [_encode(op.payload, lead) for op in ops]
        packed = torch.cat(segs, dim=lead)
        moved = self._move(sig, packed, ops[0].shift, backend)
        off = 0
        for op, seg in zip(ops, segs):
            w = seg.shape[-1]
            part = moved[..., off:off + w]
            shape = ((p,) + tuple(op.payload.shape) if sig[0] == "all_gather"
                     else tuple(op.payload.shape))
            op.handle._result = op.finalize(
                _decode(part, shape, op.payload.dtype))
            off += w
        return 1, packed.numel() // p * 4

    def flush(self, aggregate: Optional[bool] = None,
              backend: str = "auto") -> PlanStats:
        """Issue every recorded op (MPI_Win_flush for the whole plan).

        aggregate: True forces packing of every fusable group, False forces
        per-op transfers, None consults `PerfModel.select_aggregation`.
        backend: "auto" sends every unpacked uniform-shift group of 32-bit
        CUDA payloads to the put kernel and the rest to the mesh; "torch" or
        "cuda" force one for every group the kernel can carry (`_route`).
        `PlanStats.backends` counts the backend each transfer ran on.
        """
        if backend != "auto" and backend not in BACKENDS:
            raise PlanError(f"unknown backend {backend!r}; "
                            f"expected 'auto' or one of {BACKENDS}")
        tr = obs_trace.TRACER
        if not tr.enabled:
            return self._flush_impl(aggregate, backend)
        with tr.span("plan.flush", axis=self.axis, pending=len(self.ops)) as sp:
            stats = self._flush_impl(aggregate, backend)
            sp.set(raw=stats.raw, coalesced=stats.coalesced,
                   groups=stats.groups, packed_groups=stats.packed_groups,
                   bytes_wire=stats.bytes_wire)
            return stats

    def _flush_impl(self, aggregate: Optional[bool], backend: str) -> PlanStats:
        if self.flushed:
            raise PlanError("plan already flushed")
        self.flushed = True
        stats = PlanStats()
        groups: dict[tuple, list[_RecordedOp]] = {}
        for op in self.ops:
            groups.setdefault((op.axis, op.sig), []).append(op)

        kinds: dict[tuple, int] = {}
        p = self.mesh.p
        for (axis, sig), ops in groups.items():
            n = len(ops)
            group_bytes = sum(op.nbytes for op in ops)
            stats.groups += 1
            stats.bytes_logical += group_bytes

            if aggregate is None:
                pack = (n > 1 and sig[0] != "local"
                        and self.model.select_aggregation(n, p * group_bytes / n) == "pack")
            else:
                pack = bool(aggregate) and n > 1 and sig[0] != "local"

            be = _route(sig, ops, pack, backend)
            wire, wire_bytes = self._issue_group(sig, ops, pack, be)
            stats.raw += n
            stats.coalesced += wire
            stats.bytes_wire += wire_bytes
            if pack:
                stats.packed_groups += 1
            stats.backends[be] = stats.backends.get(be, 0) + wire
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


# ------------------------------------------------------------- access epochs
class AccessEpoch:
    """An access epoch: one synchronisation family wrapped around one
    `RmaPlan`.

        ep = AccessEpoch(mesh, family="fence")
        x = ep.open(x)
        h1 = ep.put_shift(a, +1)          # recorded, not issued
        h2 = ep.put_shift(b, +1)          # same signature as h1
        x = ep.close(x)                   # flush + the family's closing sync
        a2, b2 = h1.result(), h2.result()

    `ep.sync.stats` counts raw and coalesced messages plus the family's own
    synchronisation messages; `ep.plan_stats` keeps the aggregation detail.
    """

    def __init__(self, mesh: Mesh,
                 family: Literal["fence", "pscw", "lock"] = "fence", *,
                 group: Sequence[int] = (),
                 model: PerfModel = DEFAULT_MODEL) -> None:
        from . import epoch as epoch_mod  # late: epoch imports plan

        self.mesh = mesh
        self.axis = mesh.axis
        self.family = family
        if family == "fence":
            self.sync = epoch_mod.FenceEpoch(mesh, model)
        elif family == "pscw":
            self.sync = epoch_mod.PSCWEpoch(mesh, list(group), model)
        elif family == "lock":
            self.sync = epoch_mod.SharedLockEpoch(mesh, model)
        else:
            raise PlanError(f"unknown epoch family {family!r}")
        self.plan = RmaPlan(mesh, model=model)
        self.plan_stats: Optional[PlanStats] = None

    def open(self, tree: Any) -> Any:
        if self.family == "fence":
            return self.sync.open(tree)
        if self.family == "pscw":
            return self.sync.start(self.sync.post(tree))
        return self.sync.lock(tree)

    def close(self, tree: Any, *, aggregate: Optional[bool] = None,
              backend: str = "auto") -> Any:
        if not self.plan.flushed:
            self.plan_stats = self.plan.flush(aggregate=aggregate, backend=backend)
            self.sync.stats.raw_msgs += self.plan_stats.raw
            self.sync.stats.coalesced_msgs += self.plan_stats.coalesced
        if self.family == "fence":
            return self.sync.close(tree)
        if self.family == "pscw":
            return self.sync.wait(self.sync.complete(tree))
        return self.sync.unlock(tree)

    def _rec(self) -> RmaPlan:
        # the closing flush already issued this epoch's plan, so a late
        # record would miss the epoch's sync
        if self.plan.flushed:
            raise PlanError(
                f"{self.family} epoch on axis {self.axis!r} already closed "
                "— op recorded after close() would never be synchronized "
                "by this epoch")
        return self.plan

    def put_shift(self, x, shift, kind="puts", at=None):
        return self._rec().put_shift(x, shift, kind=kind, at=at)

    def put_perm(self, x, perm, kind="puts", at=None):
        return self._rec().put_perm(x, perm, kind=kind, at=at)

    def get_shift(self, x, shift):
        return self._rec().get_shift(x, shift)

    def accumulate_shift(self, x, acc, shift, op=torch.add):
        return self._rec().accumulate_shift(x, acc, shift, op)

    def accumulate_perm(self, x, acc, perm, op=torch.add):
        return self._rec().accumulate_perm(x, acc, perm, op)

    def fetch_and_op(self, x, target, op=torch.add):
        return self._rec().fetch_and_op(x, target, op)

    def put_all_to_all(self, x, kind="colls"):
        return self._rec().put_all_to_all(x, kind=kind)

    def all_gather(self, x, kind="gets"):
        return self._rec().all_gather(x, kind=kind)

    def predicted_cost(self) -> float:
        return self.sync.predicted_cost()
