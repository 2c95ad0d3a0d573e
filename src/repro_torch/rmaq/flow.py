"""Credit-based flow control for rmaq channels (the `repro.rmaq.flow`
counterpart over the stacked rank axis).

Each rank publishes ``granted[p, L]``: the cumulative ring slots it has
granted producer r on lane l (a static partition of the capacity plus one
credit per drained message).  A producer keeps ``sent`` and ``limit`` (the
last-fetched grant) per (target, lane); its credit cache is ``limit -
sent``.  A send spends from the cache and *defers* what it cannot cover —
nothing is ever rejected at the ring, nothing is replayed.  The refresh of
``limit`` rides the enqueue epoch's reservation gather as a rider (zero
marginal wire transfers) and lands for the next epoch.  Conservation per
target: ``sum granted - head == capacity`` at all times.

Global view: every leaf ``[p, p, L]`` — row r is rank r's local ``[p, L]``;
on a `ProcMesh` (one rank a process) a leaf is this rank's ``[1, p, L]``.
The counters are uint32 in the reference; here they are int64 holding
uint32 values, masked with ``& 0xFFFFFFFF`` wherever the reference wraps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.plan import U32_MASK, u32_from_wire, u32_to_wire
from ..mesh import Mesh
from ..obs import causal as obs_causal
from ..obs import trace as obs_trace
from . import channel as rch
from . import notify
from . import queue as rq


class FlowError(RuntimeError):
    pass


class FlowState(NamedTuple):
    """Credit state of this process's ranks; each leaf [R, p, L] int64
    (uint32 values), R = ``mesh.local_ranks``.

    `sent` / `limit` are origin-private (row r, column t = r's traffic
    toward target t); `granted` is the published block (row t, column r =
    what t granted producer r)."""

    sent: torch.Tensor
    limit: torch.Tensor
    granted: torch.Tensor


class FlowReceipt(NamedTuple):
    accepted: torch.Tensor    # [p, k] bool — credit-admitted AND delivered
    deferred: torch.Tensor    # [p, k] bool — valid but uncredited: never wired
    n_sent: torch.Tensor      # [p]
    n_deferred: torch.Tensor  # [p]
    refreshed: torch.Tensor   # [p] bool — the cached credits ran dry
    rejected: torch.Tensor    # [p] ring-admission rejections (must stay 0)


# ------------------------------------------------------------------ creation
def initial_grants(p: int, n_lanes: int, capacity: int,
                   n_producers: Optional[int] = None) -> np.ndarray:
    """[p, L] uint32 static partition of one ring among producer-lanes (the
    first `n_producers` ranks; remainder to the lexicographically first
    pairs), so grants sum to capacity."""
    nprod = p if n_producers is None else n_producers
    if not 0 < nprod <= p:
        raise FlowError(f"need 0 < n_producers <= {p}, got {nprod}")
    if capacity < nprod * n_lanes:
        raise FlowError(
            f"capacity {capacity} < n_producers*n_lanes = {nprod * n_lanes}: "
            "every producer-lane needs at least one initial credit")
    base, rem = divmod(capacity, nprod * n_lanes)
    g = np.zeros((p, n_lanes), np.uint32)
    for i in range(nprod * n_lanes):
        r, lane = divmod(i, n_lanes)
        g[r, lane] = base + (1 if i < rem else 0)
    return g


def flow_attach(mesh: Mesh, channel: rch.Channel,
                n_producers: Optional[int] = None) -> FlowState:
    """Allocate the credit state for an existing channel."""
    p, L, R = mesh.p, len(channel.lanes), mesh.local_ranks
    g = torch.as_tensor(initial_grants(p, L, channel.desc.capacity, n_producers)
                        .astype(np.int64), device=mesh.device)
    granted = g[None].expand(R, p, L).clone()
    limit = g[mesh.axis_index()][:, None, :].expand(R, p, L).clone()
    sent = torch.zeros((R, p, L), dtype=torch.int64, device=mesh.device)
    return FlowState(sent, limit, granted)


def flow_allocate(mesh: Mesh, capacity: int, lanes: Sequence[rch.Lane],
                  n_producers: Optional[int] = None):
    """Channel + queue + credit state in one call."""
    channel, qstate = rch.channel_allocate(mesh, capacity, lanes)
    return channel, qstate, flow_attach(mesh, channel, n_producers)


def credits(fstate: FlowState) -> torch.Tensor:
    """[R, p, L] — each sender's local credit cache (limit - sent), as the
    reference's uint32 difference read as int32."""
    d = (fstate.limit - fstate.sent) & U32_MASK
    return torch.where(d >= 1 << 31, d - (1 << 32), d)


def _advance_limit(limit: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """Move the cached limit forward to `fresh` in wrap-safe modular order:
    `fresh` is ahead iff the modular difference is < 2**31."""
    delta = (fresh - limit) & U32_MASK
    ahead = delta < (1 << 31)
    return (limit + torch.where(ahead, delta, torch.zeros_like(delta))) & U32_MASK


# ---------------------------------------------------------------- send / recv
def send(channel: rch.Channel, qstate: rq.QueueState, fstate: FlowState,
         name: str, payload: torch.Tensor, tag: torch.Tensor,
         dest: torch.Tensor, lane: Optional[torch.Tensor] = None):
    """Credit-gated channel send (collective).  payload [R, k, *lane.shape],
    tag/dest [R, k]; `lane` ([R, k]) selects a runtime lane per message.
    Returns (qstate, fstate, FlowReceipt)."""
    desc = channel.desc
    mesh = desc.mesh
    p, L = mesh.p, len(channel.lanes)
    k = dest.shape[1]
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("flow.send_epoch", axis=desc.axis, k=int(k), lane=name)
    if lane is None:
        lane = torch.full_like(dest, channel.lane_id(name))
    lane = lane.to(torch.int64)
    dest = dest.to(torch.int64)

    valid = (dest >= 0) & (dest < p) & (lane >= 0) & (lane < L)
    zero = torch.zeros_like(dest)
    dest_safe = torch.where(valid, dest, zero)
    lane_safe = torch.where(valid, lane, zero)
    rows = torch.arange(dest.shape[0], device=dest.device)[:, None].expand_as(dest)

    # ---- spend from the local cache: per-(target, lane) FIFO admission
    avail = credits(fstate)                                    # [R, p, L]
    pos = rq._fifo_pos(dest_safe * L + lane_safe, valid, p * L)
    ok = valid & (pos < avail[rows, dest_safe, lane_safe])
    dry = valid & ~ok
    stage_dest = torch.where(ok, dest, torch.full_like(dest, -1))

    # ---- the wire epoch: 2 fused transfers; the credit refresh rides the
    # reservation gather as a kind-less rider
    msgs = channel.packed(name, payload, tag, lane_id=lane)
    qstate, receipt, (granted_all,) = rq.enqueue_epoch(
        desc, qstate, msgs, stage_dest,
        reserve_riders=(u32_to_wire(fstate.granted),))

    # ---- debit the cache, apply the refresh (visible next epoch)
    spent = torch.zeros_like(fstate.sent).index_put_(
        (rows, dest_safe, lane_safe), ok.to(torch.int64), accumulate=True)
    # what each owner t grants ME: granted_all[me][t, me, :]
    fresh = u32_from_wire(mesh.replicated(granted_all)).transpose(0, 1)[mesh.axis_index()]
    fstate = FlowState(
        sent=(fstate.sent + spent) & U32_MASK,
        limit=_advance_limit(fstate.limit, fresh),
        granted=fstate.granted,
    )
    flow_receipt = FlowReceipt(
        accepted=receipt.accepted,
        deferred=dry,
        n_sent=receipt.n_sent,
        n_deferred=dry.sum(dim=1),
        refreshed=dry.any(dim=1),
        rejected=(ok & ~receipt.accepted).sum(dim=1),
    )
    return qstate, fstate, flow_receipt


def recv(channel: rch.Channel, qstate: rq.QueueState, fstate: FlowState,
         max_n: int):
    """Owner-local drain that returns credits: every drained message grants
    one slot back to the (producer, lane) that sent it — head and grant move
    in lockstep (the conservation invariant).  `granted` is bumped in place."""
    L = len(channel.lanes)
    qstate, batch = channel.recv(qstate, max_n)
    ok = batch.valid & (batch.lane_id >= 0) & (batch.lane_id < L)
    zero = torch.zeros_like(batch.src, dtype=torch.int64)
    src_safe = torch.where(ok, batch.src.to(torch.int64), zero)
    lane_safe = torch.where(ok, batch.lane_id.to(torch.int64), zero)
    rows = torch.arange(src_safe.shape[0], device=src_safe.device)[:, None].expand_as(src_safe)
    granted = fstate.granted
    granted.index_put_((rows, src_safe, lane_safe), ok.to(torch.int64),
                       accumulate=True)
    granted &= U32_MASK
    return qstate, fstate._replace(granted=granted), batch


def refresh(channel: rch.Channel, fstate: FlowState) -> FlowState:
    """Standalone credit refresh for an idle sender (no enqueue to ride):
    one one-sided gather of the published grant blocks
    (`PerfModel.p_credit_refresh(fused=False)`)."""
    mesh = channel.desc.mesh
    granted_all = notify.fetch_credits(u32_to_wire(fstate.granted), mesh)
    # what each owner t grants ME: granted_all[me][t, me, :]
    fresh = u32_from_wire(mesh.replicated(granted_all)).transpose(0, 1)[mesh.axis_index()]
    return fstate._replace(limit=_advance_limit(fstate.limit, fresh))


# ------------------------------------------------------------------ invariants
def conservation(channel: rch.Channel, qstate: rq.QueueState,
                 fstate: FlowState) -> dict:
    """Global-view conservation check (host side).  For every target t:
    sum_{r,l} granted[t,r,l] - head[t] == capacity and outstanding credits
    + ring occupancy == capacity (exact until the counters wrap).  On a
    `ProcMesh` it is collective: every rank's blocks come to the host by
    `ProcMesh.host_gather`."""
    rows = channel.desc.mesh.host_gather
    granted = rows(fstate.granted).numpy().astype(np.int64)   # [t, r, L]
    sent = rows(fstate.sent).numpy().astype(np.int64)         # [r, t, L]
    ctrs = rows(qstate.ctrs).numpy().astype(np.int64)         # [t, 5]
    head, tail = ctrs[:, rq.HEAD], ctrs[:, rq.TAIL]
    outstanding = granted.sum(axis=(1, 2)) - sent.sum(axis=(0, 2))
    occupancy = tail - head
    return {
        "granted_minus_head": granted.sum(axis=(1, 2)) - head,
        "outstanding_plus_occupancy": outstanding + occupancy,
        "occupancy": occupancy,
        "capacity": channel.desc.capacity,
    }


# ----------------------------------------------------------- host simulation
class HostFlowChannel:
    """Host-side mirror of the credit protocol over `HostChannel`.

    Same cache / refresh / defer semantics as the SPMD path, with the
    refresh as an explicit one-sided read (counted in `refreshes`) issued
    only when the cache runs dry — the control-plane and unit tests exercise
    exhaustion → refresh → recovery without a device mesh.

    Credits cover **ring slots**, whatever the lane carries: on a
    descriptor-kind lane table (rendezvous pull, §16) the window is
    descriptor-width, so the credit protocol never has to account for
    payload bytes — `bytes_by_kind` / `sends_by_kind` ledger the split so
    engines and drift gates can assert a pull path puts zero payload
    bytes through the ring.

    Every window carries an **attach id** published beside the grant
    block.  `ft/elastic` leave/join can reuse a rank id; a refresh that
    monotonically maxed the *new* occupant's grants against the old
    occupant's would advance `limit` by credits nobody granted.  The
    refresh therefore rebases (limit := fresh, sent := 0) whenever the
    published attach id differs from the one it last saw — the same
    invalidation rule `rmem.DescriptorCache` applies to page tables.
    """

    def __init__(self, p: int, capacity: int, lanes: Sequence[rch.Lane],
                 n_producers: Optional[int] = None, fabric=None,
                 name: str = "q", causal_tags: bool = False):
        # causal_tags: declares that message tags ARE request ids (the serve
        # path's convention) — send/recv then stamp causal edge/cause links
        # so traces stitch into cross-rank request DAGs (obs.causal).  Off
        # by default: generic channels carry arbitrary tags.
        self.causal_tags = causal_tags
        self.ch = rch.HostChannel(p, capacity, lanes, fabric=fabric, name=name)
        self.fabric = self.ch.group.fabric
        self._granted_region = f"{name}.granted"
        self._attach_region = f"{name}.attach"
        self.p = p
        self.L = len(self.ch.lanes)
        self.capacity = capacity
        self.n_producers = p if n_producers is None else n_producers
        g = initial_grants(p, self.L, capacity, n_producers).astype(np.uint64)
        self.granted = np.tile(g[None], (p, 1, 1))          # [owner, prod, L]
        self.limit = np.tile(g[:, None, :], (1, p, 1))      # [prod, target, L]
        self.sent = np.zeros((p, p, self.L), np.uint64)     # [prod, target, L]
        # the published grant blocks live in the queue window (§9): remote
        # refreshes read them through the fabric; owner-side grant returns
        # stay direct (drain + grant move in lockstep, owner-locally)
        self.fabric.register(self._granted_region, self.granted)
        # window generation, bumped by rebind(); producers cache what they
        # last saw per target and rebase their limit on mismatch
        self.attach_id = np.zeros(p, np.int64)
        self.fabric.register(self._attach_region, self.attach_id)
        self._seen_attach = np.zeros((p, p), np.int64)      # [prod, target]
        self.refreshes = 0
        self.deferred = 0
        self.rejected = 0   # ring-admission rejections: must stay 0
        self.rebinds = 0    # refreshes that detected a window re-attach
        self.sends_by_kind = {k: 0 for k in rch.LANE_KINDS}
        self.bytes_by_kind = {k: 0 for k in rch.LANE_KINDS}

    def available(self, src: int, dest: int, lane: int) -> int:
        return int(self.limit[src, dest, lane] - self.sent[src, dest, lane])

    def ring_slot_nbytes(self) -> int:
        """Wire bytes one ring slot occupies (header + widest lane)."""
        return 4 * (rch.HDR + self.ch.payload_words)

    def ring_window_nbytes(self) -> int:
        """Per-rank ring footprint — the memory the credit window covers.
        On a descriptor lane table this is descriptor-sized no matter how
        large the KV blocks being transferred are."""
        return self.ring_slot_nbytes() * self.capacity

    def _refresh(self, src: int, dest: int) -> None:
        """One-sided get of dest's published grant row for this producer,
        guarded by the window attach id (class docstring): a re-attached
        window rebases the cache instead of maxing against stale grants."""
        self.refreshes += 1
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("flow.refresh", rank=src, dest=dest)
        aid = int(self.fabric.get(src, dest, self._attach_region))
        fresh = self.fabric.get(src, dest, self._granted_region, (src,))
        if aid != int(self._seen_attach[src, dest]):
            self._seen_attach[src, dest] = aid
            self.limit[src, dest] = fresh
            self.sent[src, dest] = 0
            self.rebinds += 1
            if tr.enabled:
                tr.event("flow.rebase", rank=src, dest=dest, attach=aid)
            return
        self.limit[src, dest] = np.maximum(self.limit[src, dest], fresh)

    def rebind(self, rank: int, n_producers: Optional[int] = None) -> None:
        """Re-attach `rank`'s window after an elastic leave/join reused its
        id: fresh ring, fresh initial grants, bumped attach id.  The caller
        (the membership layer) fences the fabric first so no epoch is in
        flight.  Producers discover the re-attach at their next refresh and
        rebase; the departed occupant's own outbound credit is frozen (its
        sender state dies with it — re-granting a *resurrected producer* is
        the membership layer's job, not the flow layer's)."""
        nprod = self.n_producers if n_producers is None else n_producers
        self.granted[rank] = initial_grants(
            self.p, self.L, self.capacity, nprod).astype(np.uint64)
        self.attach_id[rank] += 1
        grp = self.ch.group
        grp.ctrs[rank] = 0
        grp.buf[rank] = 0
        self.sent[rank] = self.limit[rank]
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("flow.rebind", rank=rank,
                     attach=int(self.attach_id[rank]))

    def send(self, src: int, name: str, payload, tag: int, dest: int) -> bool:
        """Stage one credited message; False = deferred (cache dry even
        after a refresh) and the message stays with the caller — it never
        reaches the wire, so there is nothing to retry."""
        lane = self.ch._lane_id(name)
        tr = obs_trace.TRACER
        if self.available(src, dest, lane) == 0:
            self._refresh(src, dest)                 # fall back: cache is dry
            if self.available(src, dest, lane) == 0:
                self.deferred += 1
                if tr.enabled:
                    if self.causal_tags:
                        tr.event("flow.send", rank=src, dest=dest, lane=lane,
                                 outcome="deferred", rid=int(tag),
                                 seg="credit_stall")
                    else:
                        tr.event("flow.send", rank=src, dest=dest, lane=lane,
                                 outcome="deferred")
                return False
        if tr.enabled:
            if self.causal_tags:
                # producer end of the message's causal edge; the matching
                # cause lands on the consumer's flow.deliver at recv
                tr.event("flow.send", rank=src, dest=dest, lane=lane,
                         outcome="credited", rid=int(tag),
                         edge=obs_causal.edge(int(tag), f"flow{src}-{dest}"))
            else:
                tr.event("flow.send", rank=src, dest=dest, lane=lane,
                         outcome="credited")
        self.ch.send(src, name, payload, tag, dest)
        self.sent[src, dest, lane] += 1
        kind = self.ch.lanes[lane].kind
        self.sends_by_kind[kind] += 1
        self.bytes_by_kind[kind] += self.ring_slot_nbytes()
        return True

    def flush(self) -> dict[int, list[bool]]:
        flags = self.ch.flush()
        self.rejected += sum(fl.count(False) for fl in flags.values())
        return flags

    def recv(self, rank: int, max_n: Optional[int] = None) -> list[dict]:
        msgs = self.ch.recv(rank, max_n)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("flow.recv", rank=rank, n=len(msgs))
            if self.causal_tags:
                for m in msgs:
                    tr.event("flow.deliver", rank=rank, rid=int(m["tag"]),
                             src=int(m["src"]),
                             cause=obs_causal.edge(
                                 int(m["tag"]), f"flow{int(m['src'])}-{rank}"))
        for m in msgs:
            self.granted[rank, m["src"], self.ch._lane_id(m["lane"])] += 1
        return msgs

    def conservation(self, rank: int) -> dict:
        ctrs = self.ch.group.ctrs[rank]
        head, tail = int(ctrs[rq.HEAD]), int(ctrs[rq.TAIL])
        g = int(self.granted[rank].sum())
        outstanding = g - int(self.sent[:, rank].sum())
        return {
            "granted_minus_head": g - head,
            "outstanding_plus_occupancy": outstanding + (tail - head),
            "occupancy": tail - head,
            "capacity": self.capacity,
        }

    def stats(self, rank: int) -> dict:
        s = self.ch.stats(rank)
        s.update(refreshes=self.refreshes, deferred=self.deferred,
                 rejected=self.rejected, rebinds=self.rebinds,
                 sends_by_kind=dict(self.sends_by_kind),
                 bytes_by_kind=dict(self.bytes_by_kind))
        return s
