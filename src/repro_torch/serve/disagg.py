"""Disaggregated prefill/decode serving over rmaq channels (the
`repro.serve.disagg` counterpart, on one device).

The mesh axis is split into prefill ranks [0, n_prefill) and decode ranks
[n_prefill, p).  Each prefill rank computes a request's KV and sends it over
a channel lane to a decode rank — a notified put into the decoder's MPSC
ring; decode ranks drain their rings each step and run the attention
readout to emit one token per request.  Modes:

  * **inline** — the message carries the KV block itself; backpressure is
    credit flow (`flow=True`: nothing is ever rejected or replayed) or the
    legacy reject/retry (`flow=False`: rejected sends are re-queued in
    staging order);
  * **paged** — the message carries a page TABLE of (owner, page id) pairs;
    prefill ranks write novel KV pages straight into the decoders' page
    pools (one fused scatter per step) and shared-prefix pages cost a
    refcount bump.  The decoder attends over its pool by page table: with
    ``attend="fused"`` through the hand-written CUDA paged-attention kernel
    (one launch per decode step over every rank's rows), with
    ``attend="gather"`` by materialising the block first (the A/B baseline);
  * **rendezvous** (``transport="rendezvous"``) — the consumer pulls.  A
    prefill rank writes a request's novel pages into its OWN pool (no wire
    traffic), pins every page it names, and publishes the page table as a
    descriptor on a descriptor-kind lane; the decoder, when it drains the
    descriptor, pulls the pages with two fused one-sided gets
    (`rmem.pages.gather_pages`) and attends over them in the same step.  No
    KV payload ever takes a ring slot; the pins drop when the token lands
    (or the request is cancelled).  ``transport="auto"`` asks the H100
    model (`parallel.overlap.CollectiveStrategist.transfer_plan`) to pick
    eager, rendezvous or paged for the configured block.

All p ranks run on one device as the leading dimension of stacked tensors
(`repro_torch.mesh`), with the same role masks the reference's SPMD step
uses.  Given a `repro_torch.procmesh.ProcMesh` (``mesh=``), the engine runs
one rank a process instead, as the reference runs a rank a chip: every
process runs the same host scheduler (the reference has one controller)
and builds the same global ``[p, ...]`` step inputs, its device step takes
its own row, and the step's results of every rank (sent, rejected, the
tokens out and the credits) come back to every process as one packed int32
`ProcMesh.host_gather`, so every process takes the same decisions.  That
gather is the controller's read, not a protocol message: it is counted in
`host_gathers`, never in `OpCounter` or `msg_stats`.  The pools then live
in symmetric segments, so a peer can read them in place
(`rmem.pages.gather_shift`).

The model is the reference's small single-head attention stack
(embedding KV producer + query readout decoder); `params_from_jax` loads the
reference engine's parameters so both packages compute the same thing.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.rma import OpCounter
from ..kernels.paged_attention import ops as pattn
from ..mesh import Mesh, resolve_device
from ..obs import causal as obs_causal
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry
from ..parallel.overlap import CollectiveStrategist
from ..procmesh import ProcMesh
from ..rmaq import channel as rch
from ..rmaq import flow as rfl
from ..rmaq import queue as rq
from ..rmem import pages as rpg
from .engine import DrainError

PARAM_KEYS = ("emb_k", "emb_v", "w_q", "readout")


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    n_prefill: int = 2            # first n_prefill ranks run prefill
    block_tokens: int = 16        # prompt tokens per request (one KV block)
    d_model: int = 32
    vocab: int = 97
    queue_capacity: int = 16      # KV blocks a decode rank can hold in flight
    max_recv_per_step: int = 4    # decode drain width per step
    n_lanes: int = 2              # kv lanes (credit domains) per decode rank
    flow: bool = True             # credit-based admission vs reject/retry
    # paged remote KV-cache; requires flow=True
    paged: bool = False           # page-table messages + page pools
    page_tokens: int = 4          # tokens per KV page (divides block_tokens)
    novel_slots: int = 2          # novel pages a prefill rank ships per step
    pool_pages: int = 32          # pages per decode-rank pool
    # decode attention path in paged mode: "fused" walks the page table in
    # the paged-attention kernel; "gather" materialises the block first
    attend: str = "fused"
    # KV transfer protocol: "eager" is the sender push (`paged` picks the
    # payload or page-table wire format); "rendezvous" publishes a
    # descriptor and the decoder pulls the pages with one-sided gets;
    # "auto" asks the perf model, for this block size and `expected_reuse`
    transport: str = "eager"
    expected_reuse: float = 0.0

    def __post_init__(self) -> None:
        # combinations with no meaning fail here, not at the first engine
        if self.transport not in ("eager", "rendezvous", "auto"):
            raise ValueError(f"transport must be 'eager', 'rendezvous' or "
                             f"'auto', got {self.transport!r}")
        if not 0.0 <= self.expected_reuse <= 1.0:
            raise ValueError(
                f"expected_reuse must be in [0, 1], got {self.expected_reuse}")
        if self.transport != "eager":
            if self.paged:
                raise ValueError(
                    "transport= and paged=True are exclusive: paged is the "
                    "legacy eager-mode switch (use transport='auto' with "
                    "expected_reuse to let the model pick paged shipping)")
            if not self.flow:
                raise ValueError(f"transport={self.transport!r} needs credit "
                                 "flow control (flow=True)")

    @property
    def pages_per_block(self) -> int:
        return self.block_tokens // self.page_tokens

    @property
    def staging_pages_resident(self) -> int:
        """Peak KV pages resident in decode staging per request, as the
        reference accounts it: the TPU kernel's double-buffer window vs the
        gather path's full block."""
        if self.attend == "fused":
            return min(2, self.pages_per_block)
        return self.pages_per_block

    @property
    def staging_nbytes(self) -> int:
        return self.staging_pages_resident * self.page_nbytes

    @property
    def page_nbytes(self) -> int:
        return self.page_tokens * 2 * self.d_model * 4

    @property
    def block_nbytes(self) -> int:
        return self.block_tokens * 2 * self.d_model * 4

    @property
    def table_nbytes(self) -> int:
        return self.pages_per_block * rpg.ENTRY_WORDS * 4


def resolve_transport(cfg: DisaggConfig, model=None) -> str:
    """`cfg.transport` as a concrete protocol: "eager", "rendezvous" or
    "paged".  "auto" asks the H100 model (`CollectiveStrategist
    .transfer_plan`) for the configured block size, pages per block and
    expected reuse.  A pure function of the config."""
    if cfg.transport != "auto":
        return cfg.transport
    strat = CollectiveStrategist() if model is None else CollectiveStrategist(model=model)
    plan = strat.transfer_plan(float(cfg.block_nbytes), cfg.pages_per_block,
                               cfg.expected_reuse)
    return str(plan["protocol"])


def params_from_jax(np_params: dict, device=None) -> dict:
    """The reference engine's `params` (as numpy arrays: emb_k, emb_v, w_q,
    readout) -> this package's float32 tensors on `device`."""
    dev = resolve_device(device)
    missing = set(PARAM_KEYS) - set(np_params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    return {k: torch.as_tensor(np.asarray(np_params[k], np.float32), device=dev)
            for k in PARAM_KEYS}


def _init_params(cfg: DisaggConfig, seed: int, device: torch.device) -> dict:
    """Random parameters from the engine's own seed (a torch.Generator; the
    numbers differ from the reference's jax.random stream)."""
    g = torch.Generator().manual_seed(seed)
    scale = 1.0 / np.sqrt(cfg.d_model)
    shapes = {"emb_k": (cfg.vocab, cfg.d_model), "emb_v": (cfg.vocab, cfg.d_model),
              "w_q": (cfg.d_model,), "readout": (cfg.d_model, cfg.vocab)}
    return {k: (torch.randn(s, generator=g) * scale).to(device)
            for k, s in shapes.items()}


def _requeue_rejected(pending: list, staged: dict, sent_ok) -> int:
    """Splice this step's rejected sends back onto the head of `pending` in
    *staging order* (ascending prefill rank), ahead of everything not yet
    staged.  Returns the number re-queued."""
    rejected = [staged[r] for r in sorted(staged) if not bool(sent_ok[r])]
    pending[:0] = rejected
    return len(rejected)


class DisaggEngine:
    """Host-orchestrated, device-stepped disaggregated serving engine.

    `p` ranks (the first `cfg.n_prefill` prefill, the rest decode) stacked
    on `device` (None = the card), or, given `mesh` (a `ProcMesh` of p
    ranks), one rank a process on the mesh's device.  `params` (e.g. from
    `params_from_jax`) replaces the engine's own random parameters."""

    def __init__(self, p: int, cfg: DisaggConfig, seed: int = 0, *,
                 params: dict | None = None, device=None, axis: str = "serve",
                 mesh: ProcMesh | None = None):
        if mesh is None:
            self.mesh = Mesh(p, axis, device)
            self._rows = slice(None)               # every rank's row
        else:
            if not isinstance(mesh, ProcMesh) or mesh.p != p:
                raise ValueError(f"mesh must be a ProcMesh of {p} ranks, got {mesh!r}")
            if device is not None and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
            self.mesh = mesh
            self._rows = slice(mesh.rank, mesh.rank + 1)   # this process's row
        self.device = self.mesh.device
        self.cfg = cfg
        self.p = p
        if not (0 < cfg.n_prefill < self.p):
            raise ValueError(f"need 0 < n_prefill < {self.p}, got {cfg.n_prefill}")
        if cfg.n_lanes < 1:
            raise ValueError(f"need n_lanes >= 1, got {cfg.n_lanes}")
        # the configured transport as an engine mode: "inline" (eager
        # payload push), "paged" (eager page-table shipping) or
        # "rendezvous" (descriptor publish + consumer pull)
        self.transport_selected = resolve_transport(cfg)
        if cfg.transport == "eager":
            self.mode = "paged" if cfg.paged else "inline"
        else:
            self.mode = {"eager": "inline", "paged": "paged",
                         "rendezvous": "rendezvous"}[self.transport_selected]
        if self.mode in ("paged", "rendezvous"):
            if not cfg.flow:
                raise ValueError("paged mode needs credit flow control (flow=True)")
            if cfg.block_tokens % cfg.page_tokens:
                raise ValueError(
                    f"page_tokens {cfg.page_tokens} must divide "
                    f"block_tokens {cfg.block_tokens}")
            if cfg.novel_slots < 1:
                raise ValueError(f"need novel_slots >= 1, got {cfg.novel_slots}")
            if cfg.pool_pages < cfg.pages_per_block:
                raise ValueError(
                    f"pool_pages {cfg.pool_pages} < pages_per_block "
                    f"{cfg.pages_per_block}: no request could ever map")
            if self.mode == "paged" and cfg.attend not in ("fused", "gather"):
                raise ValueError(
                    f"attend must be 'fused' or 'gather', got {cfg.attend!r}")
        self.n_decode = self.p - cfg.n_prefill

        if params is None:
            self.params = _init_params(cfg, seed, self.device)
        else:
            self.params = {k: params[k].to(self.device, torch.float32)
                           for k in PARAM_KEYS}
        want = {"emb_k": (cfg.vocab, cfg.d_model), "emb_v": (cfg.vocab, cfg.d_model),
                "w_q": (cfg.d_model,), "readout": (cfg.d_model, cfg.vocab)}
        for k, shape in want.items():
            if tuple(self.params[k].shape) != shape:
                raise ValueError(f"params[{k!r}] has shape "
                                 f"{tuple(self.params[k].shape)}, want {shape}")

        # n_lanes homogeneous kv lanes sharing one ring (separate credit
        # domains).  Inline mode ships the KV block [bt, 2, d]; paged mode
        # ships the page table [pages_per_block, 2] int32 instead, and
        # rendezvous mode the same table on a DESCRIPTOR-kind lane: it names
        # prefill-resident pages the decoder will pull.
        if self.mode in ("paged", "rendezvous"):
            lane_shape, lane_dtype = (cfg.pages_per_block, rpg.ENTRY_WORDS), torch.int32
        else:
            lane_shape, lane_dtype = (cfg.block_tokens, 2, cfg.d_model), torch.float32
        lane_kind = "descriptor" if self.mode == "rendezvous" else "payload"
        lanes = [rch.Lane(f"kv{i}", lane_shape, lane_dtype, lane_kind)
                 for i in range(cfg.n_lanes)]
        if self.mode in ("paged", "rendezvous"):
            # page pools: device payload storage + the host allocator mirror
            # (free lists, refcounts, prefix index).  Paged mode's pools are
            # DECODER-owned (prefill scatters novel pages into them);
            # rendezvous pools are PREFILL-owned: pages stay at the rank that
            # computed them until the decoder pulls.
            page = (cfg.pool_pages, cfg.page_tokens, 2, cfg.d_model)
            if isinstance(self.mesh, ProcMesh):    # a peer may read it in place
                self.pool = self.mesh.symmetric(page, torch.float32)
            else:
                self.pool = torch.zeros((self.p,) + page, dtype=torch.float32,
                                        device=self.device)
            owners = (range(cfg.n_prefill) if self.mode == "rendezvous"
                      else range(cfg.n_prefill, self.p))
            self.kv = rpg.PagedKVPool(
                owners=list(owners),
                n_pages=cfg.pool_pages,
                page_words=cfg.page_tokens * 2 * cfg.d_model,
            )
        else:
            self.pool = None
            self.kv = None
        if cfg.flow:
            self.channel, self.qstate, self.fstate = rfl.flow_allocate(
                self.mesh, cfg.queue_capacity, lanes, n_producers=cfg.n_prefill)
            # the credits the host schedules by, [p(producer), p(target), L]:
            # the initial grants here, then each step's read-back
            g = rfl.initial_grants(self.p, cfg.n_lanes, cfg.queue_capacity, cfg.n_prefill)
            self._credits = np.repeat(g[:, None, :].astype(np.int64), self.p, axis=1)
        else:
            self.channel, self.qstate = rch.channel_allocate(
                self.mesh, cfg.queue_capacity, lanes)
            self.fstate = None
        # message accounting: one step with no request staged, run on
        # cloned state under an OpCounter, tells how many raw ops coalesce
        # into how many wire transfers per engine step
        self.msg_stats = self._trace_message_stats()

        # host-side request tracking
        self._pending: list[tuple[int, np.ndarray]] = []   # (req_id, tokens)
        self._n_submitted = 0
        self._submitted_ids: set[int] = set()
        self.results: dict[int, int] = {}                  # req_id -> token
        self.retries = 0           # wire sends replayed (reject/retry only)
        self.credit_stalls = 0     # stage deferrals for want of credit (flow)
        self.lane_sends = np.zeros((self.p, cfg.n_lanes), np.int64)
        # paged-mode host scheduler state
        self._jobs: dict[int, dict] = {}         # rid -> shipping job
        self._rank_job: list = [None] * cfg.n_prefill   # prefill rank -> rid
        self._page_ready: set = set()            # (owner, page_id) scattered
        self.pool_stalls = 0       # requests deferred: pool had no free page
        self.novel_pages_shipped = 0
        self.appends = 0           # channel appends (admitted requests)
        self.ring_payload_appends = 0   # appends on payload-kind lanes
        self.descriptor_appends = 0     # appends on descriptor-kind lanes
        self.pulled_pages = 0      # pages pulled to completion (rendezvous)
        # rendezvous pull pins: rid -> [(owner, page_id, tag)], taken when
        # the descriptor is published, dropped when the token lands (or the
        # request is cancelled)
        self._pins: dict[int, list[tuple[int, int, int]]] = {}
        self.steps_run = 0
        self.host_gathers = 0      # device-result reads (one a step), no protocol message
        # request-lifecycle latency ledgers: TTFT = submit -> result landing;
        # TBT = engine-wide gap between consecutive result landings
        self.metrics = MetricsRegistry()
        self._t_submit: dict[int, float] = {}
        self._t_staged: dict[int, float] = {}
        # rid -> why it last stalled while queued ("credit" | "pool"); popped
        # on every terminal transition
        self._stalled: dict[int, str] = {}
        self._t_last_result: float | None = None

    # ----------------------------------------------------------- device step
    def _compute_kv(self, toks: torch.Tensor) -> torch.Tensor:
        """[..., n] tokens -> [..., n, 2, d] KV (clipped into the vocab)."""
        t = torch.clamp(toks.to(torch.int64), 0, self.cfg.vocab - 1)
        return torch.stack([self.params["emb_k"][t], self.params["emb_v"][t]],
                           dim=-2)

    def _readout(self, kv_in: torch.Tensor, mask: torch.Tensor,
                 tags: torch.Tensor):
        """kv_in [n, bt, 2, d], mask/tags [n] -> (out_req, out_tok) [n]."""
        k_in, v_in = kv_in[:, :, 0], kv_in[:, :, 1]
        attn = torch.softmax(k_in @ self.params["w_q"], dim=-1)   # [n, bt]
        ctx = torch.einsum("mt,mtd->md", attn, v_in)
        return self._emit(ctx, mask, tags)

    def _emit(self, ctx: torch.Tensor, mask: torch.Tensor, tags: torch.Tensor):
        logits = ctx @ self.params["readout"]                      # [n, vocab]
        neg = torch.full_like(tags, -1)
        out_tok = torch.where(mask, logits.argmax(-1).to(torch.int32), neg)
        out_req = torch.where(mask, tags, neg)
        return out_req, out_tok

    def _decode_batch(self, batch: rch.RecvBatch):
        kv_in, mask = self.channel.payload_all(batch)          # [R, m, bt, 2, d]
        p, m = mask.shape
        out_req, out_tok = self._readout(
            kv_in.reshape((p * m,) + tuple(kv_in.shape[2:])), mask.reshape(-1),
            batch.tag.reshape(-1))
        return out_req.reshape(p, m), out_tok.reshape(p, m)

    def _staged_dest(self, req_id: torch.Tensor, dest: torch.Tensor):
        """Role mask: only prefill ranks holding a request send."""
        me = self.mesh.axis_index()
        is_prefill = (me < self.cfg.n_prefill) & (req_id >= 0)
        return is_prefill, torch.where(is_prefill, dest, torch.full_like(dest, -1))

    def _step_flow(self, qstate, fstate, tokens, req_id, dest, lane):
        """Inline credit step.  tokens [R, bt], req_id/dest [R], lane [R, 1]:
        each local rank's staged request (req_id -1 = none)."""
        cfg = self.cfg
        is_prefill, dest_eff = self._staged_dest(req_id, dest)
        kv_block = self._compute_kv(tokens)                    # [p, bt, 2, d]
        qstate, fstate, receipt = rfl.send(
            self.channel, qstate, fstate, "kv0",
            kv_block[:, None], req_id[:, None], dest_eff[:, None], lane)
        qstate, fstate, batch = rfl.recv(self.channel, qstate, fstate,
                                         cfg.max_recv_per_step)
        out_req, out_tok = self._decode_batch(batch)
        sent_ok = receipt.accepted[:, 0] & is_prefill
        return qstate, fstate, out_req, out_tok, sent_ok, receipt.rejected

    def _step_legacy(self, qstate, tokens, req_id, dest, lane):
        """Inline reject/retry step (no credits)."""
        cfg = self.cfg
        is_prefill, dest_eff = self._staged_dest(req_id, dest)
        kv_block = self._compute_kv(tokens)
        msgs = self.channel.packed("kv0", kv_block[:, None], req_id[:, None],
                                   lane_id=lane)
        qstate, receipt = rq.enqueue(self.channel.desc, qstate, msgs,
                                     dest_eff[:, None])
        qstate, batch = self.channel.recv(qstate, cfg.max_recv_per_step)
        out_req, out_tok = self._decode_batch(batch)
        sent_ok = receipt.accepted[:, 0] & is_prefill
        return qstate, out_req, out_tok, sent_ok

    def _ship(self, qstate, fstate, pool, ptab, req_id, dest, lane,
              novel_toks, novel_slot, novel_dest):
        """Paged shipping step: scatter novel KV pages into the decoders'
        pools (one fused transfer), append page tables over the channel,
        drain the rings.  Attention runs in `_attend`."""
        cfg = self.cfg
        # 1. novel pages: compute their KV, write them into the owners' pools
        kv_pages = self._compute_kv(novel_toks)                # [R, S, pt, 2, d]
        pool = rpg.scatter_pages(self.mesh, pool, kv_pages, novel_slot, novel_dest)
        # 2. channel append: the page table is the message payload
        is_prefill, dest_eff = self._staged_dest(req_id, dest)
        qstate, fstate, receipt = rfl.send(
            self.channel, qstate, fstate, "kv0",
            ptab[:, None], req_id[:, None], dest_eff[:, None], lane)
        # 3. drain: the received page tables ARE the decode input
        qstate, fstate, batch = rfl.recv(self.channel, qstate, fstate,
                                         cfg.max_recv_per_step)
        entries, mask = self.channel.payload_all(batch)        # [R, m, ppb, 2]
        sent_ok = receipt.accepted[:, 0] & is_prefill
        return (qstate, fstate, pool, entries, mask, batch.tag, sent_ok,
                receipt.rejected)

    def _attend(self, pool, entries, mask, tags):
        """Paged decode attention, page table -> token, for every local rank
        in one go: the pool is flattened to [R*pool_pages, pt, 2, d] and each
        rank's own-page ids are offset by its row*pool_pages (-1 stays -1;
        on a `ProcMesh` the row, so the offset, is 0), so "fused" is ONE
        kernel launch per decode step over R*max_recv_per_step rows
        (prefill ranks' rows are fully masked and come out zero).  Scale
        1.0: the engine's unscaled readout."""
        cfg = self.cfg
        p, m = mask.shape
        me = self.mesh.axis_index()[:, None, None]
        mine = entries[..., rpg.ENTRY_OWNER] == me
        row = torch.arange(p, device=mask.device)[:, None, None]
        page = entries[..., rpg.ENTRY_PAGE].to(torch.int64) + row * cfg.pool_pages
        ids = torch.where(mask[..., None] & mine, page, torch.full_like(page, -1))
        ids = ids.reshape(p * m, cfg.pages_per_block).to(torch.int32)
        pool_flat = pool.view((p * cfg.pool_pages,) + tuple(pool.shape[2:]))
        msk, tg = mask.reshape(-1), tags.reshape(-1)
        if cfg.attend == "gather":
            kv_in = rpg.gather_local(pool_flat, ids)       # [p*m, ppb, pt, 2, d]
            out_req, out_tok = self._readout(
                kv_in.reshape(p * m, cfg.block_tokens, 2, cfg.d_model), msk, tg)
        else:
            q = self.params["w_q"].expand(p * m, 1, cfg.d_model).contiguous()
            ctx = pattn.paged_attention(q, pool_flat, ids, scale=1.0,
                                        causal=False)[:, 0]        # [p*m, d]
            out_req, out_tok = self._emit(ctx, msk, tg)
        return out_req.reshape(p, m), out_tok.reshape(p, m)

    def _ship_rdv(self, qstate, fstate, pool, ptab, req_id, dest, lane,
                  novel_toks, novel_slot):
        """Rendezvous step: prefill ranks write novel KV pages into their
        OWN pool slices (owner-local, zero wire), publish descriptors (page
        tables) on the descriptor lane, and the decode ranks — gated by
        their drain width — pull the pages with one fused gather and attend
        in the same step.  No KV payload takes a ring slot."""
        cfg, p = self.cfg, pool.shape[0]
        # 1. novel pages land in the staging rank's own pool, in place;
        # slots outside the pool are dropped
        n_pages = pool.shape[1]
        slot = novel_slot.to(torch.int64)
        r_idx, s_idx = ((slot >= 0) & (slot < n_pages)).nonzero(as_tuple=True)
        flat = pool.view(p, n_pages, -1)
        flat[r_idx, slot[r_idx, s_idx]] = self._compute_kv(
            novel_toks[r_idx, s_idx]).reshape(r_idx.numel(), flat.shape[2])
        # 2. descriptor append: the only thing that rides the ring
        is_prefill, dest_eff = self._staged_dest(req_id, dest)
        qstate, fstate, receipt = rfl.send(
            self.channel, qstate, fstate, "kv0",
            ptab[:, None], req_id[:, None], dest_eff[:, None], lane)
        # 3. drain descriptors: the decoder's readiness gate
        qstate, fstate, batch = rfl.recv(self.channel, qstate, fstate,
                                         cfg.max_recv_per_step)
        entries, mask = self.channel.payload_all(batch)        # [R, m, ppb, 2]
        # 4. pull the pages from their owners, then attend over the block
        kv_in = rpg.gather_pages(self.mesh, pool, entries, mask)
        m = mask.shape[1]
        out_req, out_tok = self._readout(
            kv_in.reshape(p * m, cfg.block_tokens, 2, cfg.d_model),
            mask.reshape(-1), batch.tag.reshape(-1))
        sent_ok = receipt.accepted[:, 0] & is_prefill
        return (qstate, fstate, pool, out_req.reshape(p, m),
                out_tok.reshape(p, m), sent_ok, receipt.rejected)

    def _step_inputs(self, **arrays) -> dict:
        """The global [p, ...] numpy step inputs as this process's device
        tensors: every row on a stacked `Mesh`, its own on a `ProcMesh`."""
        return {k: torch.as_tensor(v[self._rows], device=self.device)
                for k, v in arrays.items()}

    def _read_back(self, sent_ok, rejected, out_req, out_tok):
        """One step's results of every rank on the host, as numpy: sent_ok
        [p] bool, rejected [p], out_req / out_tok [p, m], and (credit flow)
        the credits the next step schedules by.  One packed int32 transfer:
        the stacked tensors' copy, or one `ProcMesh.host_gather`.  It is
        the controller reading device results, counted in `host_gathers`
        and in no op ledger."""
        R, m = out_req.shape
        cols = [sent_ok.to(torch.int32)[:, None], rejected.to(torch.int32)[:, None],
                out_req.to(torch.int32), out_tok.to(torch.int32)]
        if self.fstate is not None:
            cols.append((self.fstate.limit - self.fstate.sent).to(torch.int32).reshape(R, -1))
        rows = self.mesh.host_gather(torch.cat(cols, dim=1)).numpy()
        self.host_gathers += 1
        if self.fstate is not None:
            self._credits = rows[:, 2 + 2 * m:].astype(np.int64).reshape(self.p, self.p, -1)
        return (rows[:, 0].astype(bool), rows[:, 1], rows[:, 2:2 + m],
                rows[:, 2 + m:2 + 2 * m])

    def _trace_message_stats(self) -> dict:
        """Run one step with no request staged on cloned state under an
        `OpCounter` (outputs discarded) and report the raw vs coalesced
        (wire) message counts of the KV-shipping path."""
        cfg, p = self.cfg, self.p
        clone = lambda t: None if t is None else t.__class__(*(x.clone() for x in t))
        qstate, fstate = clone(self.qstate), clone(self.fstate)   # collective on a ProcMesh
        idle = self._step_inputs(req_id=np.full((p,), -1, np.int32),
                                 dest=np.full((p,), -1, np.int32),
                                 lane=np.zeros((p, 1), np.int32))
        with OpCounter() as c:
            if self.mode in ("paged", "rendezvous"):
                S = cfg.novel_slots
                ins = self._step_inputs(
                    ptab=np.full((p, cfg.pages_per_block, rpg.ENTRY_WORDS), -1, np.int32),
                    novel_toks=np.full((p, S, cfg.page_tokens), -1, np.int32),
                    novel_slot=np.full((p, S), -1, np.int32),
                    novel_dest=np.full((p, S), -1, np.int32))
                args = (qstate, fstate, self.pool.clone(), ins["ptab"],
                        idle["req_id"], idle["dest"], idle["lane"],
                        ins["novel_toks"], ins["novel_slot"])
                if self.mode == "paged":
                    self._ship(*args, ins["novel_dest"])
                else:
                    self._ship_rdv(*args)
            else:
                tokens = self._step_inputs(
                    tokens=np.full((p, cfg.block_tokens), -1, np.int32))["tokens"]
                args = (tokens, idle["req_id"], idle["dest"], idle["lane"])
                if fstate is None:
                    self._step_legacy(qstate, *args)
                else:
                    self._step_flow(qstate, fstate, *args)
        bytes_wire = sum(pl.get("bytes_wire", 0) for pl in c.plans)
        return {
            "raw_msgs_per_step": c.raw_msgs,
            "wire_msgs_per_step": c.coalesced_msgs,
            "aggregation_factor": c.aggregation_factor,
            "puts": c.puts,
            "gets": c.gets,
            "accs": c.accs,
            "bytes_wire_per_step": bytes_wire,
            "plans": [dict(pl) for pl in c.plans],
        }

    # ------------------------------------------------------------ host side
    def submit(self, req_id: int, tokens) -> None:
        toks = np.asarray(tokens, np.int32)
        if toks.shape != (self.cfg.block_tokens,):
            raise ValueError(f"prompt must be [{self.cfg.block_tokens}] tokens")
        self._pending.append((req_id, toks))
        self._n_submitted += 1
        self._submitted_ids.add(int(req_id))
        self._t_submit[int(req_id)] = time.perf_counter()
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("serve.request.submit", rid=int(req_id),
                     plen=int(toks.shape[0]))

    def _observe_result(self, rid: int, rank: int = 0) -> None:
        """Land one decoded result in the latency ledgers: per-request TTFT
        and the engine-wide inter-result gap (TBT)."""
        now = time.perf_counter()
        self._stalled.pop(rid, None)
        t0 = self._t_submit.pop(rid, None)
        if t0 is not None:
            ttft_us = (now - t0) * 1e6
            self.metrics.histogram("serve.ttft_us").observe(ttft_us, exemplar=rid)
            t_staged = self._t_staged.pop(rid, None)
            wire_seg = "kv_pull" if self.mode == "rendezvous" else "kv_wire"
            if t_staged is not None:
                self.metrics.histogram(f"seg.{wire_seg}_us").observe(
                    (now - t_staged) * 1e6)
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("serve.request.decode", rid=rid, rank=rank,
                         cause=obs_causal.edge(rid, "kv"), seg=wire_seg)
                tr.event("serve.request.first_token", rid=rid, rank=rank,
                         seg="attend", ttft_us=int(ttft_us))
        if self._t_last_result is not None:
            self.metrics.histogram("serve.tbt_us").observe(
                (now - self._t_last_result) * 1e6)
        self._t_last_result = now

    def serve_metrics(self) -> dict:
        """Request-latency summaries in microseconds: TTFT, TBT, and the
        per-decode-step attention latency (paged mode; empty otherwise)."""
        names = ("serve.ttft_us", "serve.tbt_us", "serve.attend_us",
                 "seg.queue_wait_us", "seg.kv_wire_us", "seg.kv_pull_us")
        return {n.removeprefix("serve."): self.metrics.histogram(n).summary()
                for n in names}

    def _host_credits(self) -> np.ndarray:
        """[p(producer), p(target), L] credits the device-side caches hold,
        as the last step's read-back brought them (the same one-epoch
        staleness); a copy the caller may spend from."""
        return self._credits.copy()

    def _select_lane(self, credits: np.ndarray, r: int,
                     targets=None) -> tuple[int, int] | None:
        """The (decode rank, lane) with the most credit for producer r, ties
        broken toward the least historically loaded lane; None when every
        lane is dry.  `targets` restricts the candidate decode ranks."""
        best, best_key = None, None
        if targets is None:
            targets = range(self.cfg.n_prefill, self.p)
        for t in targets:
            for ln in range(self.cfg.n_lanes):
                c = credits[r, t, ln]
                if c < 1:
                    continue
                key = (c, -self.lane_sends[t, ln])
                if best_key is None or key > best_key:
                    best, best_key = (t, ln), key
        return best

    # ------------------------------------------------------- paged host side
    def _map_request(self, rid: int, toks: np.ndarray, owner: int | None = None):
        """Acquire (or share) every page of the request in `owner`'s pool:
        the staging prefill rank's in rendezvous mode (the pages never move
        at publish time), the routed decoder's (prefix affinity) when None.
        None when the pool is dry (every acquisition rolled back; the
        request waits for releases)."""
        cfg = self.cfg
        pages_toks = rpg.split_pages(toks, cfg.page_tokens)
        dest = self.kv.route(rpg.page_key(pages_toks[0])) if owner is None else owner
        entries, novel = [], []
        hits0, miss0 = self.kv.hits, self.kv.misses
        for ptoks in pages_toks:
            res = self.kv.acquire(dest, rpg.page_key(ptoks))
            if res is None:
                for ref in entries:
                    self.kv.release_ref(ref)
                # rolled-back acquisitions are not real traffic
                self.kv.hits, self.kv.misses = hits0, miss0
                self.pool_stalls += 1
                return None
            ref, shared = res
            entries.append(ref)
            if not shared:
                novel.append((ref.page_id, ptoks))
        self.kv.table_set(rid, entries)
        return {"rid": rid, "dest": dest, "entries": entries,
                "novel": novel, "next": 0}

    def _take_job(self, r: int, owner: int | None) -> bool:
        """Map the next pending request for idle prefill rank r (pages in
        `owner`'s pool, see `_map_request`).  False when the pool is dry:
        the request goes back to the head of the queue and waits."""
        rid, toks = self._pending.pop(0)
        job = self._map_request(rid, toks, owner)
        if job is None:
            self._pending.insert(0, (rid, toks))
            self._stalled[int(rid)] = "pool"
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("serve.request.pool_stall", rank=r, rid=int(rid),
                         seg="queue_wait")
            return False
        self._jobs[rid] = job
        self._rank_job[r] = rid
        now = time.perf_counter()
        self._t_staged[int(rid)] = now
        self.metrics.histogram("seg.queue_wait_us").observe(
            (now - self._t_submit.get(int(rid), now)) * 1e6)
        tr = obs_trace.TRACER
        if tr.enabled:
            # time since submit was queue wait, unless the request sat out a
            # dry pool: then it waited on page releases
            tr.event("serve.request.page_alloc", rank=r, rid=int(rid),
                     pages=len(job["entries"]),
                     seg=("page_alloc" if self._stalled.get(int(rid)) == "pool"
                          else "queue_wait"))
        return True

    def _paged_step(self) -> int:
        """Ship novel pages, append page tables of requests whose pages are
        all resident, drain + decode, release finished requests' pages."""
        cfg, p = self.cfg, self.p
        S, ppb = cfg.novel_slots, cfg.pages_per_block
        ptab = np.full((p, ppb, rpg.ENTRY_WORDS), -1, np.int32)
        req_id = np.full((p,), -1, np.int32)
        dest = np.full((p,), -1, np.int32)
        lane = np.zeros((p, 1), np.int32)
        novel_toks = np.full((p, S, cfg.page_tokens), -1, np.int32)
        novel_slot = np.full((p, S), -1, np.int32)
        novel_dest = np.full((p, S), -1, np.int32)

        budget = self._host_credits()
        appended: dict[int, int] = {}
        pool_dry = False       # one dry probe per step, not one per idle rank
        for r in range(cfg.n_prefill):
            if self._rank_job[r] is None and self._pending and not pool_dry:
                pool_dry = not self._take_job(r, None)
            if self._rank_job[r] is None:
                continue
            job = self._jobs[self._rank_job[r]]
            # ship up to novel_slots of the job's unshipped novel pages; a
            # staged page is resident from this step on (the scatter
            # precedes every drain in program order)
            n_stage = min(S, len(job["novel"]) - job["next"])
            for s in range(n_stage):
                pid, ptoks = job["novel"][job["next"] + s]
                novel_toks[r, s] = ptoks
                novel_slot[r, s] = pid
                novel_dest[r, s] = job["dest"]
                self._page_ready.add((job["dest"], pid))
            job["next"] += n_stage
            self.novel_pages_shipped += n_stage
            if n_stage:
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("serve.request.kv_transfer", rank=r,
                             rid=int(job["rid"]), dst=int(job["dest"]),
                             pages=int(n_stage),
                             nbytes=int(n_stage) * cfg.page_nbytes)
            # append once every page (own novels AND shared pages shipped by
            # other jobs) is resident and a lane credit is available
            resident = all((ref.owner, ref.page_id) in self._page_ready
                           for ref in job["entries"])
            if job["next"] < len(job["novel"]) or not resident:
                continue
            t = job["dest"]
            sel = self._select_lane(budget, r, targets=(t,))
            if sel is None:
                self.credit_stalls += 1
                self._stalled[int(job["rid"])] = "credit"
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("serve.request.credit_stall", rank=r,
                             rid=int(job["rid"]), seg="host")
                continue
            _, ln = sel
            ptab[r] = self.kv.table_entries(job["rid"])
            req_id[r], dest[r], lane[r, 0] = job["rid"], t, ln
            budget[r, t, ln] -= 1
            self.lane_sends[t, ln] += 1
            self.appends += 1
            self.ring_payload_appends += 1
            appended[r] = job["rid"]
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("serve.request.append", rank=r, rid=int(job["rid"]),
                         dst=int(t), lane=int(ln),
                         seg=("credit_stall"
                              if self._stalled.get(int(job["rid"])) == "credit"
                              else "host"),
                         edge=obs_causal.edge(int(job["rid"]), "kv"))
            self._stalled.pop(int(job["rid"]), None)

        ins = self._step_inputs(ptab=ptab, req_id=req_id, dest=dest, lane=lane,
                                novel_toks=novel_toks, novel_slot=novel_slot,
                                novel_dest=novel_dest)
        (self.qstate, self.fstate, self.pool, entries, mask, tags, sent_ok,
         rejected) = self._ship(self.qstate, self.fstate, self.pool, **ins)
        self.steps_run += 1

        # decode attention, host-timed per step with the read-back (the
        # ship's work drained first): the fused-vs-gather A/B
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        out_req, out_tok = self._attend(self.pool, entries, mask, tags)
        sent_ok, rejected, out_req, out_tok = self._read_back(sent_ok, rejected, out_req,
                                                              out_tok)
        attend_us = (time.perf_counter() - t0) * 1e6
        if int(rejected.sum()):
            raise RuntimeError(
                "credit conservation violated: a credited paged append was "
                "rejected at the ring")
        for r, rid in appended.items():
            if not bool(sent_ok[r]):
                raise RuntimeError(f"credited paged append not delivered: {rid}")
            self._rank_job[r] = None        # the prefill rank frees up
            del self._jobs[rid]
        self.metrics.histogram("serve.attend_us").observe(attend_us)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("serve.decode.attend", us=int(attend_us), path=cfg.attend,
                     staging_pages=cfg.staging_pages_resident)
        emitted = 0
        for rr in range(cfg.n_prefill, p):
            for rid, tok in zip(out_req[rr], out_tok[rr]):
                if rid >= 0 and int(rid) in self._submitted_ids:
                    self.results[int(rid)] = int(tok)
                    self._observe_result(int(rid), rank=rr)
                    for ref in self.kv.table_release(int(rid)):
                        self._page_ready.discard((ref.owner, ref.page_id))
                    emitted += 1
        return emitted

    # -------------------------------------------------- rendezvous host side
    def _rendezvous_step(self) -> int:
        """Stage novel pages into the prefill ranks' own pools, publish
        descriptors for requests whose pages are all resident (pinning every
        named page so it stays live for the pull), run the device step —
        descriptor ring + fused pull + readout — and drop the pins when
        tokens land."""
        cfg, p = self.cfg, self.p
        S, ppb = cfg.novel_slots, cfg.pages_per_block
        ptab = np.full((p, ppb, rpg.ENTRY_WORDS), -1, np.int32)
        req_id = np.full((p,), -1, np.int32)
        dest = np.full((p,), -1, np.int32)
        lane = np.zeros((p, 1), np.int32)
        novel_toks = np.full((p, S, cfg.page_tokens), -1, np.int32)
        novel_slot = np.full((p, S), -1, np.int32)

        budget = self._host_credits()
        appended: dict[int, int] = {}
        pool_dry = False
        for r in range(cfg.n_prefill):
            if self._rank_job[r] is None and self._pending and not pool_dry:
                pool_dry = not self._take_job(r, r)
            if self._rank_job[r] is None:
                continue
            job = self._jobs[self._rank_job[r]]
            # stage up to novel_slots of the job's unwritten novel pages into
            # MY pool (owner-local device writes, zero wire traffic)
            n_stage = min(S, len(job["novel"]) - job["next"])
            for s in range(n_stage):
                pid, ptoks = job["novel"][job["next"] + s]
                novel_toks[r, s] = ptoks
                novel_slot[r, s] = pid
                self._page_ready.add((r, pid))
            job["next"] += n_stage
            self.novel_pages_shipped += n_stage
            # publish once every page (own novels AND shared pages written by
            # earlier jobs at this rank) is resident and a descriptor credit
            # toward some decode rank is available
            resident = all((ref.owner, ref.page_id) in self._page_ready
                           for ref in job["entries"])
            if job["next"] < len(job["novel"]) or not resident:
                continue
            sel = self._select_lane(budget, r)
            if sel is None:
                self.credit_stalls += 1
                self._stalled[int(job["rid"])] = "credit"
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("serve.request.credit_stall", rank=r,
                             rid=int(job["rid"]), seg="host")
                continue
            t, ln = sel
            # pin every named page before the descriptor goes out, so a
            # concurrent release can free nothing the pull will read
            rid_j = int(job["rid"])
            self._pins[rid_j] = [
                (ref.owner, ref.page_id,
                 self.kv.pools[ref.owner].pin(ref.page_id, origin=t))
                for ref in job["entries"]]
            ptab[r] = self.kv.table_entries(rid_j)
            req_id[r], dest[r], lane[r, 0] = rid_j, t, ln
            budget[r, t, ln] -= 1
            self.lane_sends[t, ln] += 1
            self.appends += 1
            self.descriptor_appends += 1
            appended[r] = rid_j
            tr = obs_trace.TRACER
            if tr.enabled:
                # the descriptor append carries the request's KV edge: it
                # licenses the decoder's pull
                tr.event("serve.request.publish", rank=r, rid=rid_j,
                         dst=int(t), lane=int(ln), nbytes=cfg.table_nbytes,
                         seg=("credit_stall"
                              if self._stalled.get(rid_j) == "credit"
                              else "host"),
                         edge=obs_causal.edge(rid_j, "kv"))
            self._stalled.pop(rid_j, None)

        ins = self._step_inputs(ptab=ptab, req_id=req_id, dest=dest, lane=lane,
                                novel_toks=novel_toks, novel_slot=novel_slot)
        (self.qstate, self.fstate, self.pool, out_req, out_tok, sent_ok,
         rejected) = self._ship_rdv(self.qstate, self.fstate, self.pool, **ins)
        self.steps_run += 1
        sent_ok, rejected, out_req, out_tok = self._read_back(sent_ok, rejected, out_req,
                                                              out_tok)
        if int(rejected.sum()):
            raise RuntimeError(
                "credit conservation violated: a credited descriptor append "
                "was rejected at the ring")
        for r, rid in appended.items():
            if not bool(sent_ok[r]):
                raise RuntimeError(f"credited descriptor append not delivered: {rid}")
            self._rank_job[r] = None        # the prefill rank frees up
            del self._jobs[rid]

        emitted = 0
        for rr in range(cfg.n_prefill, p):
            for rid, tok in zip(out_req[rr], out_tok[rr]):
                # a cancelled rid may still deliver a stale token: its pins
                # and table are already rolled back, and it must not count
                # toward the drain quota
                if rid >= 0 and int(rid) in self._submitted_ids:
                    self.results[int(rid)] = int(tok)
                    self._observe_result(int(rid), rank=rr)
                    # pull complete: drop the pull pins, then the table refs
                    for owner, pid, tag in self._pins.pop(int(rid), []):
                        self.kv.pools[owner].unpin(pid, tag, origin=rr)
                        self.pulled_pages += 1
                    if int(rid) in self.kv.page_tables:
                        for ref in self.kv.table_release(int(rid)):
                            self._page_ready.discard((ref.owner, ref.page_id))
                    emitted += 1
        return emitted

    def cancel(self, rid: int) -> bool:
        """Abort a request host-side — the puller that dies before its
        flush.  Rolls back everything the request holds: pull pins (if its
        descriptor was published), page-table refs, its place in the queue,
        its ledger entries; the pages a dead pull named are reclaimable at
        once (pool conservation holds).  True if the rid was known."""
        rid = int(rid)
        known = False
        if self._jobs.pop(rid, None) is not None:
            known = True
            for r, j in enumerate(self._rank_job):
                if j == rid:
                    self._rank_job[r] = None
        for owner, pid, tag in self._pins.pop(rid, []):
            self.kv.pools[owner].unpin(pid, tag, origin=owner)
            known = True
        if self.kv is not None and rid in self.kv.page_tables:
            for ref in self.kv.table_release(rid):
                self._page_ready.discard((ref.owner, ref.page_id))
            known = True
        before = len(self._pending)
        self._pending = [x for x in self._pending if int(x[0]) != rid]
        known = known or len(self._pending) != before
        if rid in self._submitted_ids and rid not in self.results:
            self._submitted_ids.discard(rid)
            self._n_submitted -= 1
        self._t_submit.pop(rid, None)
        self._t_staged.pop(rid, None)
        self._stalled.pop(rid, None)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("serve.request.cancel", rid=rid)
        return known

    def step(self) -> int:
        """One engine step: assign pending requests to prefill ranks, run the
        device step, collect decode outputs.  Returns #tokens emitted."""
        if self.mode == "rendezvous":
            return self._rendezvous_step()
        if self.mode == "paged":
            return self._paged_step()
        cfg, p = self.cfg, self.p
        tokens = np.full((p, cfg.block_tokens), -1, np.int32)
        req_id = np.full((p,), -1, np.int32)
        dest = np.full((p,), -1, np.int32)
        lane = np.zeros((p, 1), np.int32)
        staged: dict[int, tuple[int, np.ndarray]] = {}

        if cfg.flow:
            budget = self._host_credits()
            for r in range(cfg.n_prefill):
                if not self._pending:
                    break
                sel = self._select_lane(budget, r)
                if sel is None:
                    self.credit_stalls += 1
                    rid_wait = int(self._pending[0][0])
                    self._stalled[rid_wait] = "credit"
                    tr = obs_trace.TRACER
                    if tr.enabled:
                        tr.event("serve.request.credit_stall", rank=r,
                                 rid=rid_wait, seg="queue_wait")
                    continue               # r idles this step; request waits
                t, ln = sel
                rid, toks = self._pending.pop(0)
                tokens[r], req_id[r], dest[r], lane[r, 0] = toks, rid, t, ln
                staged[r] = (rid, toks)
                budget[r, t, ln] -= 1
                self.lane_sends[t, ln] += 1
                now = time.perf_counter()
                self._t_staged[int(rid)] = now
                self.metrics.histogram("seg.queue_wait_us").observe(
                    (now - self._t_submit.get(int(rid), now)) * 1e6)
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("serve.request.kv_transfer", rank=r, rid=int(rid),
                             dst=int(t), lane=int(ln), nbytes=cfg.block_nbytes,
                             seg=("credit_stall"
                                  if self._stalled.get(int(rid)) == "credit"
                                  else "queue_wait"),
                             edge=obs_causal.edge(int(rid), "kv"))
                self._stalled.pop(int(rid), None)
                self.ring_payload_appends += 1
        else:
            # legacy: round-robin by request id, single implicit lane
            for r in range(cfg.n_prefill):
                if self._pending:
                    rid, toks = self._pending.pop(0)
                    tokens[r], req_id[r] = toks, rid
                    dest[r] = cfg.n_prefill + max(rid, 0) % self.n_decode
                    staged[r] = (rid, toks)

        ins = self._step_inputs(tokens=tokens, req_id=req_id, dest=dest, lane=lane)
        if cfg.flow:
            (self.qstate, self.fstate, out_req, out_tok, sent_ok,
             rejected) = self._step_flow(self.qstate, self.fstate, **ins)
        else:
            self.qstate, out_req, out_tok, sent_ok = self._step_legacy(
                self.qstate, **ins)
            rejected = torch.zeros_like(sent_ok, dtype=torch.int32)
        sent_ok, rejected, out_req, out_tok = self._read_back(sent_ok, rejected, out_req,
                                                              out_tok)
        if cfg.flow:
            if int(rejected.sum()):
                raise RuntimeError(
                    "credit conservation violated: a credited send was "
                    "rejected at the ring (mixed credited/uncredited "
                    "producers on one channel?)")
            lost = [staged[r] for r in sorted(staged) if not bool(sent_ok[r])]
            if lost:
                raise RuntimeError(f"credited sends not delivered: {lost}")
        else:
            # backpressure: rejected sends go back to the head of the queue
            # in staging order
            self.retries += _requeue_rejected(self._pending, staged, sent_ok)

        self.steps_run += 1
        emitted = 0
        for r in range(cfg.n_prefill, p):
            for rid, tok in zip(out_req[r], out_tok[r]):
                if rid >= 0 and int(rid) in self._submitted_ids:
                    self.results[int(rid)] = int(tok)
                    self._observe_result(int(rid), rank=r)
                    emitted += 1
        return emitted

    def run_until_drained(self, max_steps: int = 1000) -> dict[int, int]:
        """Step until every submitted request has a result, including those
        in flight inside the decode rings.  Raises `DrainError` with the
        undrained request ids (and why each is stuck) if `max_steps` runs out."""
        steps = 0
        while len(self.results) < self._n_submitted:
            if steps >= max_steps:
                undrained = sorted(self._submitted_ids - set(self.results))
                # why each is stuck: a published descriptor whose pull never
                # completed, a recorded credit/pool stall, or queue residence
                reasons = {rid: "pull" if rid in self._pins
                           else self._stalled.get(rid, "queue")
                           for rid in undrained}
                self._stalled.clear()
                err = DrainError(f"not drained after {max_steps} steps",
                                 tuple(undrained), reasons=reasons)
                obs_flight.on_error(err, tag="disagg")
                raise err
            self.step()
            steps += 1
        return self.results

    # ----------------------------------------------------------- reference
    def reference(self, tokens) -> int:
        """Single-host oracle: what the disaggregated path must produce."""
        t = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        t = torch.clamp(t, 0, self.cfg.vocab - 1)
        k, v = self.params["emb_k"][t], self.params["emb_v"][t]
        attn = torch.softmax(k @ self.params["w_q"], dim=0)
        logits = (attn @ v) @ self.params["readout"]
        return int(logits.argmax())

    def queue_stats(self) -> dict:
        """Every rank's queue counters (uint32; collective on a `ProcMesh`)."""
        ctrs = self.mesh.host_gather(self.qstate.ctrs)
        return {k: v.numpy().astype(np.uint32)
                for k, v in rq.stats(rq.QueueState(None, ctrs)).items()}

    def paged_stats(self) -> dict:
        """Paged-mode instrumentation: prefix sharing, page traffic, and the
        payload bytes a request costs on the wire.  `effective_payload_bytes`
        counts one page-table message per append plus one page per NOVEL
        page; `wire_bytes_total` is the plan ledger's per-rank bytes over the
        steps run."""
        if self.mode != "paged":
            return {}
        ks = self.kv.stats()
        return {
            "attend_path": self.cfg.attend,
            "pages_per_block": self.cfg.pages_per_block,
            "staging_pages_resident": self.cfg.staging_pages_resident,
            "staging_bytes_per_decode": self.cfg.staging_nbytes,
            "appends": self.appends,
            "steps": self.steps_run,
            "novel_pages_shipped": self.novel_pages_shipped,
            "prefix_hits": ks["hits"],
            "prefix_hit_rate": ks["hit_rate"],
            "pool_stalls": self.pool_stalls,
            "effective_payload_bytes": (
                self.appends * self.cfg.table_nbytes
                + self.novel_pages_shipped * self.cfg.page_nbytes),
            "wire_bytes_total": self.steps_run * self.msg_stats["bytes_wire_per_step"],
            "pool_conservation_ok": self.kv.conservation()["ok"],
        }

    def rendezvous_stats(self) -> dict:
        """Rendezvous-mode instrumentation: descriptor-lane traffic against
        the pull path.  The headline invariant is ``ring_payload_appends ==
        0``: the ring moves descriptors only, and every KV byte travels as
        a one-sided get the decoder issues when it is ready to attend."""
        if self.mode != "rendezvous":
            return {}
        ks = self.kv.stats()
        return {
            "transport_selected": self.transport_selected,
            "descriptor_appends": self.descriptor_appends,
            "ring_payload_appends": self.ring_payload_appends,
            "descriptor_bytes": self.descriptor_appends * self.cfg.table_nbytes,
            "pulled_pages": self.pulled_pages,
            "pulled_bytes": self.pulled_pages * self.cfg.page_nbytes,
            "pool_stalls": self.pool_stalls,
            "prefix_hits": ks["hits"],
            "prefix_hit_rate": ks["hit_rate"],
            "pins_outstanding": sum(len(v) for v in self._pins.values()),
            "pool_conservation_ok": self.kv.conservation()["ok"],
            "wire_msgs_per_step": self.msg_stats["wire_msgs_per_step"],
            "wire_bytes_per_step": self.msg_stats["bytes_wire_per_step"],
        }

    def flow_stats(self) -> dict:
        """Credit-path instrumentation (flow mode only)."""
        if self.fstate is None:
            return {}
        cons = rfl.conservation(self.channel, self.qstate, self.fstate)
        return {
            "credit_stalls": self.credit_stalls,
            "retries": self.retries,
            "lane_sends": self.lane_sends.copy(),
            "conservation_ok": bool(
                (cons["granted_minus_head"] == cons["capacity"]).all()
                and (cons["outstanding_plus_occupancy"] == cons["capacity"]).all()),
        }
