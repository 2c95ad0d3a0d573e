"""Batched serving engine: continuous batching over a shared KV cache (the
counterpart of `repro.serve.engine`).

Host-side admission control is the paper's lock protocol (`core.locks_sim`):
request threads take shared locks on the cache window to append, the
scheduler takes the exclusive lock to mutate the slot table.

Lock discipline — every section is classified by what it touches:

  * **exclusive** — slot-table mutation: allocating a lane to a request and
    recycling a finished lane (`slot_free`/`slot_req` writes, `done.set()`).
    `_recycle()` refuses to run unless the window's writer bit is set, so a
    reader-locked recycle raises `LockDisciplineError`.
  * **shared** — per-lane cache appends (the prefill into a fresh lane, the
    decode appending one token a lane).  The cache tensors themselves are
    guarded by a plain mutex besides: a real window's regions are
    physically disjoint, one Python dict of tensors is not.

The device side runs two programs: a prefill of one request into its lane,
reset to `init_cache`'s values and then written in place (the reference
prefills into a fresh lane cache and copies it in; here one batch-1
`init_cache`, kept for the engine's life, is copied into the lane: one
lane's memory, 672 MiB for xLSTM-1.3B), and a decode step over all
`n_slots` lanes (free ones included: the shapes stay static, and a free
lane's state is reset before its next prefill).  Every lane decodes at its
own position: the cache's
``len`` is the [n_slots] vector of lane positions, so each row gets its own
RoPE position, cache write offset and visible length.  (The reference
decodes every lane at ``slot_pos.max()``, which is wrong for every lane
behind the furthest one; ROADMAP §3.)

`schedule()` is the unified tick — admit, decode, recycle — and
`run_until_drained` loops it, raising `DrainError` (with the undrained
request ids) when `max_steps` runs out.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.locks_sim import WRITER_BIT, LockOrigin, LockWindow
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry


class LockDisciplineError(RuntimeError):
    """A writer section ran without the exclusive lock (§2.3 violation)."""


class DrainError(RuntimeError):
    """`run_until_drained` exhausted `max_steps` with work still queued.

    `reasons` maps each undrained rid to why it is stuck — ``"credit"``
    (deferred on a dry credit window), ``"pool"`` (page pool dry),
    ``"pull"`` (rendezvous descriptor published, pull never completed) or
    ``"queue"`` (never left the pending queue)."""

    def __init__(self, message: str, undrained: tuple,
                 reasons: dict | None = None):
        detail = f"{message}; undrained request ids: {list(undrained)}"
        if reasons:
            detail += "; stall reasons: " + ", ".join(
                f"{rid}={reasons[rid]}" for rid in undrained if rid in reasons)
        super().__init__(detail)
        self.undrained = tuple(undrained)
        self.reasons = dict(reasons or {})


class ScheduleTick(NamedTuple):
    admitted: int
    emitted: int
    recycled: int


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    output: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0      # wall time of submit() (TTFT reference point)


def _lane_views(full, lane, slot: int):
    """`full`'s views of lane `slot`, found by matching `lane` (the same
    tree at batch 1): a leaf of n_slots rows on the axis
    where the lane leaf has 1 becomes that slot's view; a scalar (the
    cache's len) starts from zero."""
    if isinstance(full, dict):
        return {k: _lane_views(full[k], lane[k], slot) for k in full}
    if full.ndim and full.ndim == lane.ndim:
        for ax, (f, l) in enumerate(zip(full.shape, lane.shape)):
            if f != l:
                return full.narrow(ax, slot, 1) if l == 1 else _fresh(lane, full)
        return full                  # one slot: the lane is the whole leaf
    return _fresh(lane, full)


def _fresh(lane, full):
    return torch.zeros_like(lane, device=full.device)


def _copy(dst: dict, src: dict) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy(v, src[k])
        else:
            v.copy_(src[k])


class ServeEngine:
    def __init__(self, model, params, n_slots: int = 4, max_seq: int = 256,
                 device=None):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device("cuda" if device is None else device)
        self.cache = model.init_cache(n_slots, max_seq, device=self.device)
        # one lane as `init_cache` starts it: the lane reset copies it in
        self._lane_init = model.init_cache(1, max_seq, device=self.device)
        self.slot_free = [True] * n_slots
        # ready = prefill landed; decode skips allocated-but-unprefilled lanes
        self.slot_ready = [False] * n_slots
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.slot_last = np.zeros(n_slots, np.int64)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # admission control: the paper's RW lock over the cache window
        self.lock_win = LockWindow(p=1)
        self.lock = LockOrigin(self.lock_win, rank=0)
        self._cache_mu = threading.Lock()
        self.recycled_total = 0
        # TTFT = submit -> first token; TBT = gap between a lane's emissions
        self.metrics = MetricsRegistry()
        self._slot_t_last = [0.0] * n_slots

    # --------------------------------------------------------- plumbing
    def _prefill(self, prompt: list[int], slot: int) -> torch.Tensor:
        """Prefill one request into lane `slot` of the cache: every lane
        leaf first gets its initial value back, copied from a batch-1
        `init_cache` (0, and -1e30 for the sLSTM stabiliser) — a recurrent
        state (Mamba's h and conv window, the xLSTM states) left by the
        lane's last occupant, or drifted by decoding the free lane, would
        seed the new request's scan — then the model writes the lane's
        views in place."""
        views = _lane_views(self.cache, self._lane_init, slot)
        _copy(views, self._lane_init)
        tokens = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        logits, _ = self.model.prefill(self.params, tokens, views, None)
        return logits[0]

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.event("serve.request.submit", rid=req.rid,
                     plen=len(req.prompt), max_new=req.max_new)
        self.queue.put(req)

    # ------------------------------------------------- locked state sections
    def _alloc_slot(self) -> Optional[tuple[Request, int]]:
        """Exclusive section: claim (queue head, free slot), or None."""
        with self.lock.exclusive(0):
            if self.queue.empty() or not any(self.slot_free):
                return None
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return None
            slot = self.slot_free.index(True)
            self.slot_free[slot] = False
            self.slot_ready[slot] = False
            self.slot_req[slot] = req
            return req, slot

    def _recycle(self, slot: int) -> None:
        """Writer section: free a finished lane.  Raises unless the window's
        writer bit is set (an exclusive lock epoch is open)."""
        if not (self.lock_win.local[0].v & WRITER_BIT):
            raise LockDisciplineError(
                "lane recycle without the exclusive lock (writer bit clear)")
        req = self.slot_req[slot]
        self.slot_free[slot] = True
        self.slot_ready[slot] = False
        self.slot_req[slot] = None
        if req is not None:
            self.recycled_total += 1
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("serve.request.drain", rid=req.rid, slot=slot,
                         tokens=len(req.output))
            req.done.set()

    # ------------------------------------------------------------ steps
    def admit(self) -> int:
        """Admit queued requests into free slots: the allocation is an
        exclusive section, the prefill a shared one, and a request that the
        prefill already finished is recycled under the exclusive lock."""
        admitted = 0
        while True:
            claim = self._alloc_slot()
            if claim is None:
                return admitted
            req, slot = claim
            t_admit = time.perf_counter()
            self.metrics.histogram("seg.queue_wait_us").observe(
                (t_admit - req.t_submit) * 1e6)
            tr = obs_trace.TRACER
            if tr.enabled:
                tr.event("serve.request.admit", rid=req.rid, slot=slot,
                         seg="queue_wait")
            with self.lock.shared(0):
                plen = len(req.prompt)
                with self._cache_mu:
                    logits = self._prefill(req.prompt, slot)
                self.slot_pos[slot] = plen
                first = int(torch.argmax(logits))
                self.slot_last[slot] = first
                req.output.append(first)   # the prefill already produced token 1
                now = time.perf_counter()
                self.metrics.histogram("serve.ttft_us").observe(
                    (now - req.t_submit) * 1e6, exemplar=req.rid)
                self.metrics.histogram("seg.prefill_us").observe(
                    (now - t_admit) * 1e6)
                self._slot_t_last[slot] = now
                if tr.enabled:
                    tr.event("serve.request.prefill", rid=req.rid, slot=slot,
                             plen=plen, seg="prefill")
                    tr.event("serve.request.first_token", rid=req.rid,
                             slot=slot, seg="host",
                             ttft_us=int((now - req.t_submit) * 1e6))
                if len(req.output) < req.max_new:
                    # an instantly-finished request never becomes visible to
                    # the decoder
                    self.slot_ready[slot] = True
            if len(req.output) >= req.max_new:
                with self.lock.exclusive(0):
                    self._recycle(slot)
            admitted += 1

    def step(self) -> int:
        """One decode step over all lanes, each at its own position;
        returns the number of tokens emitted to active requests."""
        with self.lock.shared(0):
            active = [i for i in range(self.n_slots)
                      if not self.slot_free[i] and self.slot_ready[i]]
            if not active:
                return 0
            tokens = torch.as_tensor(self.slot_last, device=self.device)
            with self._cache_mu:
                cache = dict(self.cache)
                cache["len"] = torch.as_tensor(self.slot_pos, device=self.device)
                logits, self.cache = self.model.decode_step(self.params, tokens, cache)
            nxt = torch.argmax(logits, -1).cpu().numpy()
            emitted = 0
            finished = []
            tbt_hist = self.metrics.histogram("serve.tbt_us")
            for i in active:
                req = self.slot_req[i]
                if req is None:            # recycled concurrently mid-step
                    continue
                req.output.append(int(nxt[i]))
                self.slot_last[i] = int(nxt[i])
                self.slot_pos[i] += 1
                now = time.perf_counter()
                tbt_hist.observe((now - self._slot_t_last[i]) * 1e6)
                self._slot_t_last[i] = now
                emitted += 1
                if len(req.output) >= req.max_new or self.slot_pos[i] >= self.max_seq - 1:
                    finished.append(i)
        if finished:
            with self.lock.exclusive(0):
                for i in finished:
                    self._recycle(i)
        return emitted

    def serve_metrics(self) -> dict:
        """Request-latency summaries in microseconds: TTFT, TBT, and the
        queue-wait and prefill segments of TTFT."""
        return {
            "ttft_us": self.metrics.histogram("serve.ttft_us").summary(),
            "tbt_us": self.metrics.histogram("serve.tbt_us").summary(),
            "seg.queue_wait_us": self.metrics.histogram("seg.queue_wait_us").summary(),
            "seg.prefill_us": self.metrics.histogram("seg.prefill_us").summary(),
        }

    def schedule(self) -> ScheduleTick:
        """One unified scheduler tick: admit, decode, recycle."""
        before = self.recycled_total
        admitted = self.admit()
        emitted = self.step()
        return ScheduleTick(admitted, emitted, self.recycled_total - before)

    def _undrained_rids(self) -> tuple:
        queued = [r.rid for r in list(self.queue.queue)]
        slotted = [r.rid for r in self.slot_req if r is not None]
        return tuple(sorted(set(queued + slotted)))

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        """Schedule until queue and slots are empty; returns steps taken.
        Raises `DrainError` (with the undrained request ids) when
        `max_steps` runs out."""
        steps = 0
        while not self.queue.empty() or any(not f for f in self.slot_free):
            if steps >= max_steps:
                err = DrainError(f"not drained after {max_steps} steps",
                                 self._undrained_rids())
                obs_flight.on_error(err, tag="serve")
                raise err
            self.schedule()
            steps += 1
        return steps
