"""Closed-form cost models for the one-sided layer on one H100 (the
`repro.core.perfmodel` counterpart, rebuilt for the card).

The paper's models price each RMA function by its latency and bandwidth on
a network.  Here every rank is a row of one stacked device tensor, so a put
between ranks is an HBM-to-HBM copy on one card: its price is one kernel
launch plus the bytes it reads and writes at the card's copy rate.  NVLink
enters only with a `ProcMesh` whose ranks sit on different cards: there a
put's bytes cross the link at the data sheet's rate each way (`p_crossing`;
its latency is not measured yet, so it has no term).  The same objects
drive the plan's and the epochs' decisions:

  * `select_aggregation` — pack a same-signature group into one transfer or
    issue its ops one by one;
  * `select_sync_mode` — fence or PSCW for k neighbours out of p ranks;
  * `select_transfer_protocol` — push a request's KV block through the
    ring (eager), publish a descriptor for the decoder to pull
    (rendezvous), or ship a page table (paged);
  * `select_dispatch` — a sparse exchange through the notified queue or
    one dense all-to-all, the queue priced as the port runs it (O(p²)
    buffers, one constant fitted to the card);
  * `select_allreduce` — one flat ring over a (pod, data) grid or the
    hierarchical split, its cross-pod hop an HBM reduction on one card.

All sizes are the bytes the card moves (every rank's block), all results
seconds.

The serving models keep the reference's terms, each priced for one card.
The reference charges an ICI hop a link latency and a payload its link
time; on one card there is no link, so a hop becomes one kernel launch
(`launch_latency`) and a payload a copy read and written at `copy_bandwidth`
— exactly `p_put`.  A remote semaphore signal (the notification doorbell)
becomes one event handoff (`event_latency`), as every synchronisation
message is priced below.  The reference's HBM terms (bounce copies, the
owner's pack) stay at the data-sheet HBM rate.  The crossovers this gives
differ from the TPU's: a launch costs ~10 µs here against a ~1 µs hop, so
the per-message constants weigh far more against the bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One NVIDIA H100 SXM.  The HBM and bf16 rates are NVIDIA's H100 SXM
    data sheet (`chip_smoke.py` takes its bounds from them); the rest was measured
    by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
    the median of three runs (PERF.md, "H100 model constants")."""

    hbm_bandwidth: float = 3.35e12          # B/s, HBM3 (data sheet)
    link_bandwidth: float = 450e9           # B/s each way to another card over NVLink 4
    #                                         (data sheet, 900 GB/s both ways; not measured)
    peak_flops_bf16: float = 989e12         # FLOP/s, dense bf16 tensor cores (data sheet)
    hbm_capacity: float = 80e9              # bytes of HBM3 (data sheet; the dry-run's `fits`)
    launch_latency: float = 10.1e-6         # s per PyTorch op, back to back
    event_latency: float = 15.3e-6          # s: record an event + wait on it
    copy_bandwidth: float = 3.00e12         # B/s read + written by Tensor.copy_
    # The FSDP contraction's two arms (`PerfModel.p_ring_matmul`,
    # `p_allgather_matmul`), from chip_smoke.py's ring phase at the training
    # run's layer-0 MLP projections: two runs in one call on an NVIDIA H100
    # 80GB HBM3 at a 700 W power limit, each rate the combined one of both
    # projections and both runs (PERF.md, "allgather_matmul_plan's prices"):
    ring_call_latency: float = 69.2e-6      # s: one ring_matmul call at m = 16, host-bound
    ring_product_flops: float = 388.5e12    # FLOP/s of the ring kernel's "wgmma" products at
    #                                         n = 1 (one copy, no ring; x_t read again by
    #                                         every tile column included)
    ring_forward_bandwidth: float = 2.90e12  # B/s W's chunks cross the ring at: the n = 4
    #                                          call less 4 one-copy calls, over the
    #                                          forwarded bytes (up 5.66-5.80, down
    #                                          1.93-1.96 alone)
    ring_simt_flops: float = 45.1e12        # FLOP/s of the ring kernel's "simt" variant
    unfused_call_latency: float = 72.3e-6   # s: kernel row 7 + torch.matmul at m = 16,
    #                                         host-bound
    gemm_flops_bf16: float = 744.5e12       # FLOP/s of torch.matmul, bf16 in and out
    all_gather_bandwidth: float = 1.40e12   # B/s read + written by kernel row 7
    #                                         (ring_all_gather) gathering W, its launch in
    # The choices PR 28 adds (`select_put_backend`, `select_paged_attend`,
    # `select_accumulate_mode`, `select_flow_control`) and the host's lock and
    # flush, from chip_smoke.py's phase 27.1 (host ms of synchronised calls,
    # medians; PERF.md, "PR 28"):
    csrc_launch_latency: float = 18.0e-6    # s: one hand kernel's call through
    #                                         kernels.common.Entry, host-bound
    put_kernel_bandwidth: float = 2.86e12   # B/s read + written by kernel row 4 (put_shift)
    shift_latency: float = 23.0e-6          # s: one Mesh.shift call (two row slices and a
    #                                         torch.cat), host-bound: 5 µs above a csrc call
    shift_bandwidth: float = 2.36e12        # B/s read + written by Mesh.shift (torch.cat)
    #                                         at MILC's halo view
    attend_latency: float = 150.0e-6        # s: the plain attention over a packed block
    #                                         (disagg's "gather" attend), host-bound; fitted
    #                                         at 128 pages of 16 KiB
    lock_latency: float = 2.45e-6           # s: core.locks_sim's exclusive lock, uncontended
    flush_latency: float = 0.745e-6         # s: core.epoch.flush (a ledger record; stream
    #                                         order completes the ops)
    requeue_latency: float = 49.4e-6        # s: one rejected send: the slope of the retry
    #                                         arm's ms per message in its rejections
    flow_epoch_latency: float = 4.43e-3     # s: a flow.send + recv round beyond the retry
    #                                         arm's accept path, fitted at occupancy 0.5 and 0.9

H100 = HardwareSpec()

# Passes over its dense buffers that the port's queue exchange makes
# (`PerfModel.p_queue_exchange`), fitted to one card figure: at p = 4096,
# k = 6 items of 8 B and 24 slots a pair, `chip_smoke.py` measured the
# exchange at 39.860 ms on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
# A one-point fit, not a count of what the exchange reads and writes: the
# model gives that point by construction, and no other p, k or capacity
# has been measured against it.
QUEUE_EXCHANGE_PASSES = 11.4

# The ring kernel's "wgmma" variant (`kernels.ring_matmul.ops.variant`): one
# block a rank in a cluster of at most RING_MAX_RANKS, output tiles of
# RING_TILE rows of m; its TMA reads 16-byte rows of x_t [K, m] and w
# [n, K/n, N], so m and N are multiples of 8 bf16 words.
RING_MAX_RANKS, RING_TILE = 8, 128
F32_FLOPS = 67e12       # FLOP/s, f32 outside the tensor cores (data sheet)


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Parametrised cost functions; all return seconds."""

    hw: HardwareSpec = H100

    def _rw(self, nbytes: float, passes: float = 2.0) -> float:
        """Time to move `nbytes` `passes` times through device memory."""
        return passes * nbytes / self.hw.copy_bandwidth

    # -- communication functions ------------------------------------------
    def p_put(self, nbytes: float) -> float:
        """A put between stacked ranks: one copy kernel, read + write."""
        return self.hw.launch_latency + self._rw(nbytes)

    def p_get(self, nbytes: float) -> float:
        """A get is the same copy with the shift negated: on one card there
        is no request round trip."""
        return self.p_put(nbytes)

    def p_accumulate(self, nbytes: float) -> float:
        """Slotted accumulate: the put into the slot, then the owner's add
        (read slot + read acc + write)."""
        return self.p_put(nbytes) + self.hw.launch_latency + self._rw(nbytes, 3.0)

    def p_crossing(self, nbytes: float, link: bool = False) -> float:
        """`nbytes` from one rank's memory into another's: across cards over
        NVLink at the data sheet's rate each way (`link`); on one card read
        and written in HBM at its data-sheet rate.  It prices a crossing
        alone: the put-backend and sync-mode choices take no `link`, since
        both arms of each would cross it at the same rate, so a crossing
        leaves both choices as they are on one card."""
        if link:
            return nbytes / self.hw.link_bandwidth
        return 2.0 * nbytes / self.hw.hbm_bandwidth

    def p_put_kernel(self, nbytes: float) -> float:
        """Kernel row 4 (`kernels.rma.ops.put_shift`): one hand kernel's
        call, the payload read and written at the kernel's rate."""
        return self.hw.csrc_launch_latency + 2.0 * nbytes / self.hw.put_kernel_bandwidth

    def p_accumulate_kernel(self, nbytes: float) -> float:
        """Kernel row 6 (`accumulate_shift`), the slotted accumulate in one
        launch: the payload and the owner's block read, the sum written."""
        return self.hw.csrc_launch_latency + 3.0 * nbytes / self.hw.put_kernel_bandwidth

    def select_put_backend(self, nbytes: float) -> Literal["torch", "cuda"]:
        """A put's lowering (`core.plan.choose_backend`'s two backends):
        `Mesh.shift` ("torch": two row slices and a `torch.cat`) or kernel
        row 4 ("cuda": one hand kernel called through ctypes).  Both are
        copies; on the card the hand kernel costs less to call and moves
        the bytes faster, so it wins at every size, as `choose_backend`
        assumes (the reference's XLA path wins below ~4 KiB on the TPU)."""
        torch_arm = self.hw.shift_latency + 2.0 * nbytes / self.hw.shift_bandwidth
        return "cuda" if self.p_put_kernel(nbytes) < torch_arm else "torch"

    def p_message_rate(self, nbytes: float = 8.0) -> float:
        """Per-message cost of back-to-back transfers: launch-bound for small
        payloads, copy-bound for large."""
        return max(self.hw.launch_latency, self._rw(nbytes))

    # -- plan aggregation ---------------------------------------------------
    def p_direct_transfers(self, n_msgs: int, msg_bytes: float) -> float:
        """n transfers, one kernel each."""
        return n_msgs * self.p_message_rate(msg_bytes)

    def p_packed_transfer(self, n_msgs: int, msg_bytes: float) -> float:
        """One fused transfer as the plan issues it: a concatenation into
        the word buffer, the move, and one decode copy per message — n + 2
        launches and three passes over the payload."""
        total = n_msgs * msg_bytes
        return (n_msgs + 2) * self.hw.launch_latency + self._rw(total, 6.0)

    def select_aggregation(self, n_msgs: int,
                           msg_bytes: float) -> Literal["pack", "direct"]:
        """Pack a same-signature group into one transfer, or not.  On a
        network packing saves per-message injections; on one card every
        message is one launch either way and packing adds the pack and
        decode passes, so the direct transfers win at every size."""
        if n_msgs <= 1:
            return "direct"
        packed = self.p_packed_transfer(n_msgs, msg_bytes)
        direct = self.p_direct_transfers(n_msgs, msg_bytes)
        return "pack" if packed < direct else "direct"

    def aggregation_crossover_bytes(self, n_msgs: int = 16) -> float:
        """Smallest message size (geometric scan from 8 B) where packing
        stops winning."""
        s = 8.0
        while s < 64 * 2**20:
            if self.select_aggregation(n_msgs, s) == "direct":
                return s
            s *= 2.0
        return s

    # -- synchronisation ----------------------------------------------------
    # Each synchronisation message is priced as one event handoff (record +
    # wait).  On one card stream order already orders the ops, so this is
    # what the protocol's messages cost once ranks run on their own streams
    # or cards; the fence-vs-PSCW decision does not depend on the constant.
    def p_fence(self, p: int) -> float:
        """Dissemination barrier: ceil(log2 p) stages."""
        return self.hw.event_latency * max(1, math.ceil(math.log2(max(p, 2))))

    def p_post(self, k: int) -> float:
        return self.hw.event_latency * k

    def p_complete(self, k: int) -> float:
        return self.hw.event_latency * k

    def p_start(self) -> float:
        return self.hw.event_latency

    def p_wait(self) -> float:
        return self.hw.event_latency

    def p_pscw(self, k: int) -> float:
        """post + complete + start + wait: 2k + 2 handoffs, counted in whole
        messages so a tie with the fence stays a tie."""
        return self.hw.event_latency * (2 * k + 2)

    def p_lock_shared(self) -> float:
        """One atomic increment of the reader count: one small kernel."""
        return self.hw.launch_latency

    def p_lock_excl(self) -> float:
        """The exclusive lock the port takes (`core.locks_sim`'s writer
        lock, which `serve.engine` takes to change the slot table): the
        master's fetch-add and the local CAS, on the host."""
        return self.hw.lock_latency

    def p_unlock(self) -> float:
        return self.hw.launch_latency

    def p_flush(self) -> float:
        """`core.epoch.flush` on one card: stream order already completes
        the origin's ops, so it is the host's ledger record alone."""
        return self.hw.flush_latency

    def select_sync_mode(self, k: int, p: int) -> Literal["pscw", "fence"]:
        """Paper §6: PSCW iff P_post + P_complete + P_start + P_wait < P_fence."""
        return "pscw" if self.p_pscw(k) < self.p_fence(p) else "fence"

    # -- notified rings and page pools -------------------------------------
    def p_notified_put(self, nbytes: float) -> float:
        """Put-with-notification: the payload put plus the doorbell, one
        event handoff."""
        return self.p_put(nbytes) + self.hw.event_latency

    def notification_latency(self) -> float:
        """Doorbell alone: the receiver learns "a message arrived" — one
        event handoff plus the one launch that stands in for the hop."""
        return self.hw.event_latency + self.hw.launch_latency

    def p_queue_reserve(self) -> float:
        """Per-epoch reservation: one counter-window read (the 8-byte head /
        tail fetch), shared by every message of the epoch."""
        return self.p_get(8.0)

    def p_queue_enqueue(self, nbytes: float) -> float:
        """One message through the MPSC ring: the 8-byte fetch-and-add on
        the tail plus the notified put of the payload into its slot."""
        return self.p_message_rate(8.0) + self.p_notified_put(nbytes)

    def p_queue_dequeue(self, nbytes: float) -> float:
        """Owner-local drain of one message: one kernel copies the slot out
        of the ring (read + write at the HBM rate); the head publish rides
        it."""
        return self.hw.launch_latency + 2.0 * nbytes / self.hw.hbm_bandwidth

    def queue_msg_rate(self, nbytes: float = 8.0) -> float:
        """Messages a second one producer can push: launch-bound for small
        payloads, copy-bound for large (`p_message_rate` takes the max)."""
        return 1.0 / self.p_message_rate(nbytes)

    def p_credit_refresh(self, fused: bool = True) -> float:
        """Marginal cost of refreshing a sender's credit limit: nothing when
        it rides the enqueue epoch's reservation gather, else a standalone
        get of the published credit word (`notify.fetch_credits`)."""
        return 0.0 if fused else self.p_get(4.0)

    # -- flow control: credit vs reject / requeue ---------------------------
    def expected_rejects(self, occupancy: float) -> float:
        """Expected rejected attempts per accepted enqueue when the ring
        runs at occupancy fraction f: acceptance is geometric, f/(1-f)
        wasted attempts on average (unbounded as the ring saturates)."""
        f = min(max(occupancy, 0.0), 0.999999)
        return f / (1.0 - f)

    def p_reject(self, nbytes: float) -> float:
        """One rejected send as the port retries it
        (`serve.disagg._requeue_rejected`): spliced back onto the host's
        queue and its payload moved again in the next epoch, which the
        producer runs anyway (no launch of its own)."""
        return self.hw.requeue_latency + self._rw(nbytes)

    def p_enqueue_retry(self, nbytes: float, occupancy: float) -> float:
        """Reject / requeue at steady ring occupancy f: the accept path plus
        `p_reject` for each expected rejection.  The reference charges a
        rejection a reservation round and a doorbell; on one card the
        epoch is vectorised, so a rejected message rides the next one."""
        return (self.p_queue_enqueue(nbytes)
                + self.expected_rejects(occupancy) * self.p_reject(nbytes))

    def p_enqueue_credit(self, nbytes: float, credit_batch: int,
                         fused: bool = True) -> float:
        """Credit-gated enqueue (`rmaq.flow.send` / `recv`): the accept path
        plus, once an epoch of `credit_batch` messages, the credit books
        (`flow_epoch_latency`) and the refresh (free when it rides the
        reservation).  No reject term at any occupancy: an uncredited
        message waits at its origin."""
        return (self.p_queue_enqueue(nbytes)
                + (self.p_credit_refresh(fused) + self.hw.flow_epoch_latency)
                / max(credit_batch, 1))

    def select_flow_control(self, nbytes: float, occupancy: float, credit_batch: int,
                            fused: bool = True) -> Literal["credit", "retry"]:
        """Credits, or reject and requeue.  On one card the credit books
        cost host time every epoch while a rejection is nearly free, so
        retry wins at low occupancy and credit only once rejections pile
        up (the reference's fused refresh makes credit never worse)."""
        credit = self.p_enqueue_credit(nbytes, credit_batch, fused)
        retry = self.p_enqueue_retry(nbytes, occupancy)
        return "credit" if credit <= retry else "retry"

    def flow_crossover_occupancy(self, nbytes: float, credit_batch: int,
                                 fused: bool = False) -> float:
        """Smallest occupancy (1 % grid) where credit beats reject / retry;
        1.0 when it never does."""
        for i in range(100):
            f = i / 100.0
            if self.select_flow_control(nbytes, f, credit_batch, fused) == "credit":
                return f
        return 1.0

    def p_page_alloc(self, fused: bool = True) -> float:
        """Marginal cost of one remote page allocation: the fetch-and-op on
        the owner's free-list head word (one 8-byte message) plus the
        owner's stack pop.  Riding an existing epoch's fused gather
        (`heap.alloc_record` on a shared plan) makes the wire share free;
        standalone pays the head get as well."""
        amo = self.p_message_rate(8.0)
        return amo if fused else amo + self.p_get(8.0)

    def p_paged_gather(self, n_pages: int, page_bytes: float) -> float:
        """Fused gather of n scattered pages into one block
        (`kernels.paged_gather`): the id list, one packed reply, and the
        owner's pack copy — not n row round trips."""
        total = n_pages * page_bytes
        pack = 2.0 * total / self.hw.hbm_bandwidth
        return self.p_put(8.0 * n_pages) + self.p_put(total) + pack

    def p_paged_attention(self, n_pages: int, page_bytes: float) -> float:
        """Kernel row 1 (`kernels.paged_attention`): one hand kernel walks
        the scattered pages in place and folds them into its online softmax
        — one call, the pages read once, no packed block."""
        return (self.hw.csrc_launch_latency
                + (8.0 * n_pages + n_pages * page_bytes) / self.hw.hbm_bandwidth)

    def p_paged_gather_attend(self, n_pages: int, page_bytes: float) -> float:
        """Gather then attend (disagg's ``attend="gather"``): kernel row 3
        packs the pages into one block (read + written), then the plain
        attention reads the block again."""
        total = n_pages * page_bytes
        return (self.hw.csrc_launch_latency + (8.0 * n_pages + 2.0 * total) / self.hw.hbm_bandwidth
                + self.hw.attend_latency + total / self.hw.hbm_bandwidth)

    def select_paged_attend(self, n_pages: int,
                            page_bytes: float) -> Literal["fused", "gather"]:
        """Decode attention over scattered KV pages: stream them through
        row 1 ("fused") or gather then attend.  On one card there is no
        per-message injection cost for the gather to amortise, so the fused
        walk, one call with no pack and no re-read, wins at every size."""
        fused = self.p_paged_attention(n_pages, page_bytes)
        gather = self.p_paged_gather_attend(n_pages, page_bytes)
        return "fused" if fused <= gather else "gather"

    def paged_attend_crossover_bytes(self, n_pages: int = 4) -> float:
        """Smallest page size (geometric scan from 8 B) where the fused
        stream beats gather-then-attend."""
        s = 8.0
        while s < 64 * 2**20:
            if self.select_paged_attend(n_pages, s) == "fused":
                return s
            s *= 2.0
        return s

    # -- KV transport: inline, paged, eager push vs rendezvous pull ----------
    def p_append_inline(self, block_bytes: float) -> float:
        """Inline-payload KV append: the whole block through the ring."""
        return self.p_queue_enqueue(block_bytes)

    def p_append_paged(self, block_bytes: float, pages_per_block: int,
                       reuse_fraction: float) -> float:
        """Paged KV append at prefix-reuse fraction f: the page table
        through the ring (8 bytes a page), plus one page put and one
        free-list AMO (riding the table's epoch) for each of the (1 - f)
        novel pages."""
        f = min(max(reuse_fraction, 0.0), 1.0)
        page_bytes = block_bytes / pages_per_block
        novel = (1.0 - f) * pages_per_block
        return (self.p_queue_enqueue(8.0 * pages_per_block)
                + novel * (self.p_put(page_bytes) + self.p_message_rate(8.0)))

    def select_kv_transport(self, block_bytes: float, pages_per_block: int,
                            reuse_fraction: float) -> Literal["paged", "inline"]:
        """Page-table indirection vs the inline payload at reuse f."""
        paged = self.p_append_paged(block_bytes, pages_per_block, reuse_fraction)
        inline = self.p_append_inline(block_bytes)
        return "paged" if paged <= inline else "inline"

    def paged_crossover_reuse(self, block_bytes: float, pages_per_block: int,
                              tol: float = 1e-6) -> float:
        """Smallest reuse fraction where paged beats inline: 0.0 when paged
        always wins, 1.0 when inline always does.  The paged cost falls
        linearly in f against a constant, so the flip is unique and
        bisection lands within `tol` of it."""
        if self.select_kv_transport(block_bytes, pages_per_block, 0.0) == "paged":
            return 0.0
        if self.select_kv_transport(block_bytes, pages_per_block, 1.0) == "inline":
            return 1.0
        lo, hi = 0.0, 1.0                     # lo side inline, hi side paged
        while hi - lo > tol:
            mid = 0.5 * (lo + hi)
            if self.select_kv_transport(block_bytes, pages_per_block, mid) == "paged":
                hi = mid
            else:
                lo = mid
        return hi

    def prefix_hit_bytes_saved(self, block_bytes: float,
                               reuse_fraction: float) -> float:
        """Payload bytes one request keeps off the wire at reuse f."""
        return block_bytes * min(max(reuse_fraction, 0.0), 1.0)

    def p_append_eager(self, block_bytes: float) -> float:
        """Eager push end to end: the inline enqueue, the drain out of the
        ring slot, and the copy into pool-resident KV before attending."""
        return (self.p_append_inline(block_bytes)
                + self.p_queue_dequeue(block_bytes)
                + 2.0 * block_bytes / self.hw.hbm_bandwidth)

    def p_append_rendezvous(self, block_bytes: float,
                            pages_per_block: int) -> float:
        """Rendezvous pull end to end: the descriptor (8 bytes a page)
        through the ring and out, the decoder's fused gather of the pages,
        and the pin's one AMO on the owner's refcount."""
        table_bytes = 8.0 * pages_per_block
        page_bytes = block_bytes / max(pages_per_block, 1)
        return (self.p_queue_enqueue(table_bytes)
                + self.p_queue_dequeue(table_bytes)
                + self.p_paged_gather(pages_per_block, page_bytes)
                + self.p_message_rate(8.0))

    def p_append_paged_e2e(self, block_bytes: float, pages_per_block: int,
                           reuse_fraction: float) -> float:
        """Paged shipping end to end: the append (table + novel page puts
        straight into the consumer's pool) plus draining the table."""
        return (self.p_append_paged(block_bytes, pages_per_block, reuse_fraction)
                + self.p_queue_dequeue(8.0 * pages_per_block))

    def select_transfer_protocol(
        self, block_bytes: float, pages_per_block: int,
        reuse_fraction: float = 0.0,
    ) -> Literal["eager", "rendezvous", "paged"]:
        """The cheapest of eager, paged and rendezvous for one block; ties
        prefer eager, then paged (the simpler paths)."""
        best: Literal["eager", "rendezvous", "paged"] = "eager"
        cost = self.p_append_eager(block_bytes)
        paged = self.p_append_paged_e2e(block_bytes, pages_per_block,
                                        reuse_fraction)
        if paged < cost:
            best, cost = "paged", paged
        if self.p_append_rendezvous(block_bytes, pages_per_block) < cost:
            best = "rendezvous"
        return best

    def rendezvous_crossover_bytes(self, pages_per_block: int,
                                   tol: float = 1.0) -> float:
        """Block size where eager vs rendezvous flips.  Both costs are
        affine in the block bytes and rendezvous is the flatter (it skips
        the two bounce passes), so the flip is unique; bisection lands
        within `tol` bytes of it.  The lower bound if rendezvous already
        wins there, the upper if it never does."""
        def pull_wins(b: float) -> bool:
            return (self.p_append_rendezvous(b, pages_per_block)
                    <= self.p_append_eager(b))

        lo, hi = 8.0, float(2**30)
        if pull_wins(lo):
            return lo
        if not pull_wins(hi):
            return hi
        while hi - lo > tol:
            mid = 0.5 * (lo + hi)
            if pull_wins(mid):
                hi = mid
            else:
                lo = mid
        return hi

    # -- collective schedules (composed from the primitives) ----------------
    def ring_all_gather(self, shard_bytes: float, n: int,
                        bidirectional: bool = True) -> float:
        """The ring's puts, each moving every rank's shard on the card:
        n - 1 of them, or two per step over ceil((n - 1) / 2) steps."""
        puts = 2 * math.ceil((n - 1) / 2) if bidirectional else n - 1
        return puts * self.p_put(n * shard_bytes)

    def ring_reduce_scatter(self, shard_bytes: float, n: int) -> float:
        """n - 1 ring steps, each a put and the owner's add."""
        return (n - 1) * self.p_accumulate(n * shard_bytes)

    def all_reduce(self, nbytes: float, n: int) -> float:
        """Reduce-scatter then all-gather of `nbytes` a rank over n ranks."""
        shard = nbytes / n
        return self.ring_reduce_scatter(shard, n) + self.ring_all_gather(shard, n)

    def p_psum(self, shard_bytes: float, pods: int, per_pod: int) -> float:
        """The cross-pod hop of the hierarchical all-reduce on one card
        (`Mesh.psum`): one reduction over the pod dim, reading every rank's
        shard and writing one pod's worth at the HBM rate, then its copy
        back to every pod.  The reference prices a DCN hop here; with the
        pods stacked on one card no link is crossed."""
        total = pods * per_pod * shard_bytes
        return (2.0 * self.hw.launch_latency
                + (total + total / pods) / self.hw.hbm_bandwidth
                + (total / pods + total) / self.hw.copy_bandwidth)

    def hierarchical_all_reduce(self, nbytes: float, pods: int, per_pod: int) -> float:
        """In-pod reduce-scatter -> cross-pod `psum` -> in-pod all-gather of
        `nbytes` a rank.  The in-pod ring moves every pod's shard in each
        put (the pod dim rides along), so a step carries pods x per_pod
        shards of nbytes / per_pod; the cross-pod hop carries 1/per_pod of
        each rank's payload."""
        shard = nbytes / per_pod
        inpod = (self.ring_reduce_scatter(pods * shard, per_pod)
                 + self.ring_all_gather(pods * shard, per_pod))
        return inpod + self.p_psum(shard, pods, per_pod)

    def all_to_all(self, nbytes_per_pair: float, n: int) -> float:
        """Personalised exchange of `nbytes_per_pair` between every pair.
        The reference charges a torus axis's bisection; with the rank axis
        stacked on one card there is no link, so it is one launch plus a
        read and a write of the n(n - 1) pair blocks that leave their rank."""
        return self.hw.launch_latency + self._rw(nbytes_per_pair * n * (n - 1))

    # -- model-guided strategy selection ------------------------------------
    def select_allreduce(self, nbytes: float, pods: int, per_pod: int
                         ) -> Literal["flat_ring", "hierarchical"]:
        """One ring over all pods x per_pod ranks, or the two-level split:
        the split makes fewer launches (fewer ring steps) but moves its
        payload once more (the psum and its copy back), so it wins below a
        payload and the flat ring above it."""
        flat = self.all_reduce(nbytes, pods * per_pod)
        hier = self.hierarchical_all_reduce(nbytes, pods, per_pod)
        return "hierarchical" if hier < flat and pods > 1 else "flat_ring"

    def p_queue_exchange(self, n_msgs: int, msg_bytes: float, p: int,
                         capacity_per_pair: int) -> float:
        """The queue-backed exchange as the port runs it
        (`core.dsde.exchange_queue` over `rmaq.queue`): the reservation and
        a launch-priced enqueue per message, plus its dense buffers — every
        rank's p * n_msgs + 1 send rows (payload, a 4-byte sequence number
        and a 1-byte flag) and the drain of every rank's whole ring of
        p * `capacity_per_pair` rows rounded up to a power of two (payload,
        an 8-byte slot index and a 1-byte flag), `QUEUE_EXCHANGE_PASSES`
        times at the copy rate.  The buffers are O(p²) whoever sends what,
        so the per-message terms never decide."""
        ring = 1 << (max(2, p * capacity_per_pair) - 1).bit_length()
        send = p * (p * n_msgs + 1) * (msg_bytes + 5)
        drain = p * ring * (msg_bytes + 9)
        return (self.p_queue_reserve() + n_msgs * self.p_queue_enqueue(msg_bytes)
                + self._rw(send + drain, QUEUE_EXCHANGE_PASSES))

    def ring_variant(self, m: int, n: int, shards: int,
                     dtype_bytes: int = 2) -> Literal["wgmma", "simt"]:
        """The ring kernel's variant for Y = x [m, k] @ W [k, n] over `shards`
        ranks, from the shapes alone: "wgmma" (one clustered launch) iff bf16
        at 1 <= shards <= RING_MAX_RANKS with m and n whole 16-byte rows,
        else "simt".  `kernels.ring_matmul.ops.variant` is the rule the
        kernel follows; on contiguous tensors the two agree (tested)."""
        ok = (dtype_bytes == 2 and 1 <= shards <= RING_MAX_RANKS
              and m % 8 == 0 and n % 8 == 0)
        return "wgmma" if ok else "simt"

    def p_ring_matmul(self, m: int, k: int, n: int, shards: int,
                      dtype_bytes: int = 2) -> float:
        """The fused arm, kernel row 13 computing every rank's copy of Y
        (2 shards m k n flops), as the larger of its host time and its
        device time (a stream of calls overlaps the two).  "wgmma": the
        host's ring_matmul call; on the device, the products at the rate
        the kernel reaches without a ring (x_t read again by every tile
        column included) and W's shards forwarded round the ring once a
        RING_TILE-row tile of m: (shards - 1) k n words for each.  "simt":
        the same call with one launch a ring step (shards - 1 more), the
        products on the CUDA cores.  One
        forward rate serves every shape, so the two projections it was
        fitted at get one price each way of it (PERF.md)."""
        flops = 2.0 * shards * m * k * n
        hw = self.hw
        if self.ring_variant(m, n, shards, dtype_bytes) == "simt":
            return max(hw.ring_call_latency + (shards - 1) * hw.launch_latency,
                       flops / hw.ring_simt_flops)
        forwarded = math.ceil(m / RING_TILE) * (shards - 1) * k * n * dtype_bytes
        return max(hw.ring_call_latency,
                   flops / hw.ring_product_flops + forwarded / hw.ring_forward_bandwidth)

    def p_allgather_matmul(self, m: int, k: int, n: int, shards: int,
                           dtype_bytes: int = 2) -> float:
        """The unfused arm, as the larger of its host time and its device
        time: kernel row 7 (`kernels.rma.ops.ring_all_gather`) gathers W's
        shards (W read once and every rank's copy written, at row 7's rate),
        then one library GEMM of x against every rank's W at the rate
        torch.matmul reached (bf16; f32 at the CUDA cores' data-sheet peak),
        or its bytes at the HBM rate where they take longer."""
        hw = self.hw
        gather = (1 + shards) * k * n * dtype_bytes / hw.all_gather_bandwidth
        flops = 2.0 * shards * m * k * n
        rate = hw.gemm_flops_bf16 if dtype_bytes == 2 else F32_FLOPS
        mm_bytes = (m * k + shards * k * n + shards * m * n) * dtype_bytes
        return max(hw.unfused_call_latency,
                   gather + max(flops / rate, mm_bytes / hw.hbm_bandwidth))

    def select_accumulate_mode(self, nbytes: float,
                               k: int) -> Literal["slotted", "fetch_modify_writeback"]:
        """Paper §2.4's fallback (lock, get, add, put, unlock) vs the
        slotted accumulate, kernel row 6's one launch.  The fallback makes
        two hand-kernel calls, an add and the lock's round trips and moves
        the payload more often, so the slotted form wins at every size; `k`
        (the neighbours, whose slots cost memory) does not enter the time."""
        del k
        slotted = self.p_accumulate_kernel(nbytes)
        fallback = (self.p_lock_excl() + 2.0 * self.p_put_kernel(nbytes)
                    + self.hw.launch_latency + self._rw(nbytes, 3.0) + self.p_unlock())
        return "slotted" if slotted <= fallback else "fetch_modify_writeback"

    def select_dispatch(self, n_msgs: int, msg_bytes: float, p: int,
                        capacity_per_pair: int) -> Literal["queue", "alltoall"]:
        """Sparse exchange (DSDE, MoE dispatch): per-message notified puts
        through the queue (`p_queue_exchange`) vs one dense capacity-padded
        all-to-all, which pays one launch plus every slot of the p x
        `capacity_per_pair` matrix, occupied or not."""
        t_queue = self.p_queue_exchange(n_msgs, msg_bytes, p, capacity_per_pair)
        t_alltoall = self.all_to_all(capacity_per_pair * msg_bytes, p)
        return "queue" if t_queue < t_alltoall else "alltoall"


DEFAULT_MODEL = PerfModel()


def roofline_terms(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
                   chips: int, hw: HardwareSpec = H100) -> dict:
    """The three roofline terms (seconds) of whole-program totals, normalised
    per card: compute at the bf16 tensor-core peak, memory at the HBM rate.
    On one card the mesh's collectives are HBM copies between stacked
    ranks, so the collective term is their bytes at the copy rate
    (`copy_bandwidth`); the spec has no NVLink field until a mesh spans
    cards.  ``roofline_fraction`` is compute's share of the largest term."""
    compute_t = hlo_flops / (chips * hw.peak_flops_bf16)
    memory_t = hlo_bytes / (chips * hw.hbm_bandwidth)
    collective_t = collective_bytes / (chips * hw.copy_bandwidth)
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": collective_t}
    terms["dominant"] = max(terms, key=terms.get)
    bound = max(compute_t, memory_t, collective_t)
    terms["roofline_fraction"] = compute_t / bound if bound > 0 else 0.0
    return terms
