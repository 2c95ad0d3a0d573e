#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

  1. the card: name and power limit, as nvidia-smi reports them;
  2. build: nvcc compiles every kernel of the path for sm_90a, all at once;
  3. serving at full width — p=4 ranks (2 prefill, 2 decode), d_model=128
     and vocab=32000 (the head dim and vocab of llava-next-mistral-7b),
     page_tokens=16, block_tokens=2048 (128 pages a request), 8192 pool
     pages a rank (a 512 MiB f32 pool), queue 64, drain 16 a step, 2 lanes,
     128 novel slots; random weights from a seed.  256 requests with a 50%
     shared prefix in paged "fused" mode, then 64 each in paged "gather" and
     inline mode.  Every token must equal the engine's `reference()`;
     paged steps must move raw 8 -> wire 3 messages, nothing may be
     retried, pool and credit conservation must hold, and the fused run must
     launch the paged-attention kernel exactly once per step (its launch
     count is set to 0 just before the run and read just after);
  4. every kernel against its plain PyTorch version on the card, at the
     busiest decode step's inputs and at edge cases (masked pages, a fully
     masked row, Sq=4 causal; and the split page walk at k = 128: the
     decode path's q [64, 1, 128] with 2 valid rows, a ragged last split,
     whole masked splits, causal horizons inside the last split at Sq 4
     and 8, pt 16 and 4, three calls bit-equal): max abs error <= 1e-4
     (f32; the order of the sums differs);
  5. timings with CUDA events at the main-path inputs: kernel (host cost
     included; and its device time alone, from `torch.profiler`'s kernel
     events), plain version, F.scaled_dot_product_attention over
     pre-gathered K/V (a yardstick the port never calls) and the bound
     (bytes read at the H100 model's HBM rate, 3.35 TB/s, or f32 flops at
     67 TFLOP/s, whichever is larger);
  5a. rendezvous pull serving: the same 256 full-width requests with
     transport="rendezvous" (prefill-owned pools, descriptors on the ring,
     the decoder's fused pull); every token equal to `reference()` and to
     the fused run's, no payload on the ring, 256 descriptors, every page
     pulled and every pin dropped, pool and credit conservation, 4 wire
     transfers a step; ms/step beside the fused run's.  Then what
     transport="auto" picks at that block size (reuse 0 and 0.5) and that
     an engine built so reports it; the interrupted pull of
     `tests/subtests/rendezvous_sub.py:78-82` (one decoder, a drain of 1,
     one lane, 24 requests): a request holding pins is cancelled, the rest
     drain token-exact and every pool ends free;
  5b. the cross-rank kernels through their ops surfaces on the rendezvous
     run's own prefill-owned pools and busiest step's descriptors, counts
     zeroed before and read after: for each (decode rank -> owner) shift,
     `rmem.pages.gather_shift` (the paged-gather kernel) bit-equal to the
     block `gather_pages` pulled, and `paged_attention_shift` with q = w_q,
     scale 1.0 within 1e-4 of the readout's context; both against their
     plain versions at the path's shapes and edge cases (shifts 0, -1,
     >= p, p = 1, ids -1 and past the pool, a fully masked row, Sq = 4
     causal, int32 pages; k = 128 with one valid rank at shifts 0, 1, -1,
     9); the paged gather's hole mode (`gather_shift`'s one launch) and
     its clamp surface bit-equal to plain with every id a hole, no hole, ids past the pool,
     shifts 0, 1, -1, >= p, p = 1, int32 pages and 3-, 5-, 7- and 8-word
     rows; timings: kernel (and both kernels' device time), plain,
     `index_select` / SDPA over pre-gathered K/V, and the bound counted
     from this run's data; `gather_shift` (hole mode) by variant beside
     `index_select` + `masked_fill_` and its own bound;
  6. the MILC halo stencil (`repro_torch.apps.milc`) at p=131,072 ranks of
     the paper's weak-scaling local volume 8x4x4x4 sites x 6 f32 (a 1.5 GiB
     lattice, 192 MiB halos each way): 5 steps as a user calls them, every
     output equal to the plain whole-lattice stencil within 1e-5, 2
     put_shift launches a step (the halo views are read in place), per step
     OpCounter puts 2 / raw 2 / coalesced 2 and SyncStats post 2 /
     complete 2; ms/step, beside the same step with the plans' groups sent
     through the plain PyTorch put instead (for comparison only);
  7. RMA all-reduce (`core.collectives.all_reduce`) of p=8 ranks x 25 MiB
     f32 (PyTorch DDP's default bucket), as a user calls it: rel err <= 1e-5
     against x.sum(0) and (p-1) + 2*ceil((p-1)/2) = 15 put_shift launches;
  8. the `kernels.rma.ops` surface on the same data: a get-based halo pull,
     an accumulate into the neighbour's boundary slice and the kernel
     all-gather of the all-reduce's shards, each against the RMA schedule's
     own result;
  9. each rma kernel against its plain version at the halo and all-reduce
     chunk shapes and at edge cases (shift 0, -1, >= p, p = 1, rows that
     are not whole 16-byte vectors, a view whose rank block is not
     contiguous): bit-equal;
 10. rma kernel timings with CUDA events at the main paths' inputs (the
     halo views as the stencil passes them: kernel, plain, torch.roll /
     index_add / expand yardsticks, Tensor.copy_ of the same bytes, and the
     bytes bound at 3.35 TB/s), and the H100 model's measured constants:
     the PyTorch op's launch latency, the event latency, the copy_ rate,
     a csrc kernel's launch beside the torch op's, and that launch cut into
     its parts on the host (checks, allocation, stream lookup, binding,
     ctypes, cudaLaunchKernel) beside the parts of the path before it;
 11. dynamic sparse data exchange (`repro_torch.core.dsde`) at p=4096 ranks
     in the paper's Fig. 7b setting (`benchmarks/bench_dsde.py:14-20`): k=6
     items of 2 f32 a rank to uniform random targets from a seeded numpy
     generator, capacity_per_pair=24 (3 GiB of per-pair slots; a 4 GiB
     queue ring of 131,072 rows a rank).  All four protocols as a user
     calls them, each held to a plain numpy exchange (every item at its
     slot or in arrival order, per-pair or total counts, drops), their
     OpCounter and plan ledgers logged, ms/call, the queue exchange's
     split, and `dispatch_plan`'s choice beside the measured times;
 12. the rmaq kernels through their ops surfaces on that run's data:
     `notified_put` of the receive blocks with the received counts,
     `notify_accumulate` of the send counts into the queue's NOTIF column,
     and `queue_push` of each rank's items to rank r + 1 into the queue's
     ring in a wrapping and a backpressured round — each bit-equal to its
     plain version and to the protocol it stands for
     (`notify.notified_put_shift`, `notify.accumulate_counts`,
     `queue.enqueue_shift`), launches counted; then edge cases against the
     plain versions (notify_accumulate also at p = 4096 and 4099, shift 4
     and unaligned pointers) and timings (kernel, plain, library call,
     bytes bound; notify_accumulate's and queue_push's device time a call,
     queued behind a spin kernel: the profiler lost one of its 50 records
     in every window of some runs; beside them the launch floor,
     notify_accumulate at p = 1 queued the same way; every timed
     queue_push admits all k messages of every rank);
 13. the continuous-batching engine (`repro_torch.serve.engine`) on
     SmolLM-360M at its published widths (32 layers, d_model 960, 15/5
     heads of 64, vocab 49152; random bf16 weights from a seed), 8 slots,
     max_seq 1024: 32 requests of seeded prompt lengths 16-512 (so lanes sit
     at different positions), 32 new tokens each.  Every request is served
     in full and the lock window's words read 0 after the drain; 8 of the
     requests are re-run alone at batch 1, teacher-forced with the
     engine's tokens: logits within 0.125 of the engine's, and the
     argmax equal to the engine's token wherever the solo top-2 margin
     exceeds it (near-ties are counted).  TTFT, prefill, decode ms/step,
     tokens/s and a decode step's ATen calls are printed;
 14. `Model.forward_logits` on [4, 2048] tokens under
     `set_attention_backend("cuda")`: exactly 32 flash-attention launches
     (one a layer; the count is set to 0 just before), every one through
     the kernel's wgmma variant (bf16, hd 64), logits within
     FWD_BOUND of backend "torch" on the same weights and tokens, argmax
     agreement >= 99 % where the "torch" top-2 margin exceeds the bound
     (the raw agreement is printed: random-weight bf16 logits tie);
 15. the flash kernel against its plain version at layer 0's inputs of
     that forward, chatglm3-6b's head shape (hd 128, 16 query heads a KV
     head), the wgmma variant's edge cases (bf16 at hd 64 and 128: ragged
     tiles, GQA groups 1-16, Sq < Sk, Sq > Sk, non-causal, Sk - Sq = 64)
     and the simt variant's (f32: Sq < Sk, one row, non-causal S = 1000
     with g = 1 and B = 3, a ragged tile, rows that see no key; the SMOKE
     configs' head dims 16 and 20 and the reference test's 32, bf16 and
     f32, zero-padded to the 16 / 32 instances), each case launching the
     variant `ops.variant` names: bf16 within 2e-2, f32 within 1e-4;
     timings with CUDA events of the kernel, the plain version and
     F.scaled_dot_product_attention, TFLOP/s and the bound (causal flops
     2·B·Hq·Sq·Sk·hd at 989 TFLOP/s, or bytes at 3.35 TB/s) at layer 0's
     shape, chatglm3-6b's [1, 32, 4096, 128] with 2 KV heads and Jamba's
     attention layer [2, 32, 2048, 128] with 8;
 16. the moe and hybrid families: Jamba-v0.1-52b at its published widths
     (d_model 4096, 32/8 heads of 128, Mamba d_inner 8192, state 16, conv
     4, 16 experts top-2 of d_ff 14336, vocab 65536) cut to 16 of 32 layers
     (2 of its 4 periods: 26.05 B parameters, 48.5 GiB in bf16; all 32 do
     not fit the card), random bf16 weights from a seed (router, A_log and
     D_skip f32), through the engine: 8 slots, max_seq 2048, 24 requests of
     seeded prompt lengths 16-1024, 24 new tokens each, every one served in
     full, lock words 0; the selective-scan kernel's launches = 14 Mamba
     layers x the prefills (counted from 0 over the run); 4 requests re-run
     solo, teacher-forced and dispatched to the engine's experts, logits
     within 0.25, the argmax held where the margin exceeds it, and the
     routing choices the solo routers would make otherwise counted; then
     Jamba's cache-free `forward_logits` on [2, 2048] through the flash
     kernel, 2 launches (its attention layers), both through the wgmma
     variant (hd 128), held to backend "torch" as in 14;
 17. `ssm_scan` against its plain version at the longest prompt's first
     Mamba layer's inputs, the reference test's shapes in bf16 and edge
     cases (S = 1, S = 1000 with d = 200, h0, N = 8, h_last): f32 within
     1e-4 x the output's scale, bf16 within 5e-2; timings of the kernel
     and the plain version at the serving shape, and the bytes bound;
 18. qwen3-moe-30b-a3b at its published widths (d_model 2048, 128 experts
     top-8 of d_ff 768) cut to 4 of 48 layers (3.11 B parameters), through
     the engine (4 slots, 8 requests of 16-256 tokens, 16 new), held to its
     solo runs as in 16.
 19. training (T1): SmolLM-360M at its published widths, all 32 layers,
     bf16 params from a seed, `make_train_step` with remat and AdamW (lr
     3e-4, warmup 2) on the port's pipeline at [4, 2048], 20 steps under
     `set_attention_backend("cuda")`: the mean loss of the last 5 steps
     below the first 5's by 0.05, 64 flash launches every step (the forward
     and the remat recomputation; counts zeroed before each step), every
     one through the wgmma variant, no NaN;
     at the state before the last step the loss and grads twice more,
     bit-equal to each other and the loss to the step's, and once under
     backend "torch": loss within 1e-2, every leaf's grad within 5 %
     relative L2.  ms/step, tokens/s, peak memory and 6·N·tokens over the
     bf16 peak are printed;
 20. the launcher and restarts (T2): `repro_torch.launch.train.main` at
     --smoke on the card; the kill-and-resume contract of
     tests/test_training.py:52-72 on the card (SMOKE config, the flash
     backend): 10 steps uninterrupted, and stopped at 7 (checkpoints at 5
     and 7) then resumed, all params and moments bit-equal at step 10; one
     blocking checkpoint of layer 0's params and moments at full width,
     restored bit-equal, its MB/s and what that rate means for the whole
     state;
 21. kernel row 13 (T3): `kernels.ring_matmul.ops.ring_matmul` on T1's
     last step's layer-0 MLP input (x_t [960, 8192]) and weights (up
     [4, 240, 2560], down [4, 640, 960] for the hidden [2560, 8192]) at n = 4
     ranks, bf16, with `allgather_matmul_plan`'s choice printed; 2 launches,
     both "wgmma" (one clustered launch a call, counts zeroed before, read
     after); every rank's copy within 1e-4 x max |Y| of the plain version,
     also at n = 1, 3, 6 and 8, n = 7 with K/n = 37, K/n = 37 and m = 16
     (each "wgmma") and f32 and
     m = 300 (each "simt"), every case through the variant `ops.variant`
     names; three calls of each projection bit-equal; timings with CUDA
     events of the "wgmma" kernel, the same kernel at n = 1 (one copy,
     no ring), the "simt" variant on the same inputs,
     the plain version, the unfused `core.collectives.ring_all_gather` +
     `torch.matmul` (the library yardstick) and the bound (all n products
     at 989 TFLOP/s bf16, or the bytes at 3.35 TB/s); `allgather_matmul_plan`'s
     prices of both arms beside their measured times (its unfused arm is
     kernel row 7's all-gather + `torch.matmul`, each also timed alone):
     the run fails unless the plan's choice at each projection is the arm
     measured faster, or within 5 % of it; both arms at m = 16 are logged.
 22. the device page pool (`repro_torch.rmem.heap`) at the size of a
     disaggregated deployment's decode-side KV pool for llava-next-mistral-7b
     (8 KV heads of 128): p = 8 ranks of 4096 pages, a page one layer's K
     and V for 16 tokens in f32, [16, 2, 8, 128] (128 KiB; 4 GiB of pages),
     kmax 128 (one 2048-token request), following
     tests/subtests/rmem_sub.py sections 1-7, every epoch's integer results
     (ids, grants, freed counts, meta, free stack, head) bit-equal to the
     same calls on a copy of the pool on the CPU, conservation and stack
     consistency after every epoch: alloc epochs from all 8 origins until
     targets run dry and their grants clamp; a share round and two
     releases (pages free at zero, generations bumped on exactly the freed
     pages); a stale tag invalid after free and realloc; 32 epochs of
     seeded random alloc/free traffic, the host's census equal to the live
     count, then drained; a piggybacked alloc (raw 4, one wire transfer);
     seeded payloads scattered into the granted pages (raw 2, one wire
     transfer) and read back by kernel row 3 (one launch, counted from 0;
     bit-equal, and equal to its plain version); `pool_grow` by 1024 pages
     and `pool_shrink` back, a `DescriptorCache` refusing the detached
     regions and serving the new shapes, the shrink refused while a high
     page is live; one injected double free raising through
     `check_errors` with conservation kept.  Timings: an alloc epoch and a
     release epoch (host and CUDA-event µs, medians of 20 with the range,
     device µs queued, ATen calls) beside `p_page_alloc`; `pool_grow`; row
     3 at the pool's pages (kernel, device, plain, `index_select`, bound).
 23. the paper's last two application studies, as a user calls them (no
     kernel of the table runs here).  The distributed hashtable
     (`repro_torch.core.hashtable`) at Fig. 7a's batch: p = 1024 ranks,
     16,384 inserts a rank an epoch, 64 slots a pair, table and heap of
     2**16 a rank (a 2.7 GB volume); 4 epochs of distinct keys (load 1.0),
     a 5th re-inserting every 16th key with a new value (overwrites and
     heap duplicates), then one lookup epoch of 16,384 present and 16,384
     absent keys a rank at 128 slots a pair.  Checks: no item dropped;
     every present key returns its newest value and every absent key
     misses; epochs 1 and 5 of ranks 0 and p-1 bit-equal to
     `owner_insert_plain` on the same received batch; raw and wire counts
     by kind equal to the plans as the port's `select_aggregation` packs
     them.  Inserts/s and lookups/s (Fig. 7a's metric), the insert split
     into the DSDE exchange and the owner insert, ATen calls an epoch,
     peak memory.  The 3-D FFT (`repro_torch.apps.fft`) at NAS FT class
     C, a 512**3 complex64 grid over p = 64 ranks of 8 planes: `fft3d`
     and `fft3d_slabs` each within 1e-4 of `fft3d_reference` relative to
     its max abs; ms per transform for both schedules beside
     `torch.fft.fftn`, GFLOP/s by `fft_flops`, the pencil's four steps
     apart (the transposes' share) and the bytes bound at 3.35 TB/s.
 24. the rest of the model zoo at published widths, random bf16 weights
     from a seed (it runs right after the training phases).  xLSTM-1.3B
     (48 layers, 2.02 B params): the engine with 8 lanes, max_seq 1024,
     24 requests of 16-512 prompt tokens, 32 new each, every request served
     in full and the lock words 0; every prefill's lane equal to a fresh
     `init_cache` (the sLSTM m at -1e30), 8 requests re-run in their own
     lane of an idle 8-lane cache bit-equal to the engine.  With the
     weights in f32: the engine over 8 requests against batch-1 solo runs
     within 0.125 with the argmax held beyond that margin; a 512-token
     prefill in two chunks against one and prefill(512) + decode against
     `forward_logits` over 513 tokens (chunkwise vs recurrent), within
     0.125; the same comparisons in f64 within 1e-6 (rounding shrinks with the
     precision, a fault would not).  Decode ms/step, prefill ms,
     tokens/s, peak memory and the ATen calls of a decode step and of a
     512-token prefill.  whisper-small
     (12 + 12 layers): 8 requests with seeded frames [1500, 768] and
     prompts of 4-64 tokens, one `Model.prefill` of their common prefix
     with the frames under backend "cuda" (kernel row 11 launched exactly
     12 times, all wgmma, non-causal at [8, 12, 1500, 64]), then greedy
     `decode_step`s to 32 outputs each, max_seq 448; the outputs held to a
     teacher-forced `forward_logits` (backend "torch") within 0.125, the
     encoder output, backend cuda vs torch, within 0.25; row 11 at the
     encoder's inputs within 2e-2 x min(1, max |plain|) of its plain
     version (the outputs are far below 1), and timed beside
     SDPA and the bound (4 B Hq Sq Sk hd flops at 989 TFLOP/s); those
     numbers go on row 11's entry of the kernels line.

``python3 chip_smoke.py --gather-shift`` times only `rmem.pages.gather_shift`
and `paged_gather` at the rendezvous pull's shape on the package beside the
script (two trees in one call: copy the script into each);
``python3 chip_smoke.py --queue-push`` times only kernel rows 10 and 9 at the
DSDE shapes and the launch floor, the same way;
``python3 chip_smoke.py --pool`` runs only phase 22, the device page pool;
``python3 chip_smoke.py --apps`` runs only phase 23, the hashtable and the FFT;
``python3 chip_smoke.py --zoo`` runs only phase 24, xLSTM and whisper.

Each path is driven with the kernel launch counts set to 0 just before it
and read just after.

The second-to-last line is one JSON object of per-kernel numbers; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TOL = 1e-4                      # kernel vs plain, f32, different sum order
SOURCES = ("paged_attention", "rma", "paged_gather", "rmaq",    # csrc/<name>.cu, one nvcc each
           "flash_attention", "ssm_scan", "ring_matmul")
KERNELS = {
    # name -> (route, source, TPU kernel it replaces)
    "paged_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:99"),
    "put_shift": ("cuda", "src/repro_torch/csrc/rma.cu",
                  "src/repro/kernels/rma/kernel.py:48"),
    "get_shift": ("cuda", "src/repro_torch/csrc/rma.cu",
                  "src/repro/kernels/rma/kernel.py:80"),
    "accumulate_shift": ("cuda", "src/repro_torch/csrc/rma.cu",
                         "src/repro/kernels/rma/kernel.py:114"),
    "ring_all_gather": ("cuda", "src/repro_torch/csrc/rma.cu",
                        "src/repro/kernels/rma/kernel.py:168"),
    "paged_attention_shift": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention/kernel.py:219"),
    "paged_gather": ("cuda", "src/repro_torch/csrc/paged_gather.cu",
                     "src/repro/kernels/paged_gather/kernel.py:86"),
    "notified_put": ("cuda", "src/repro_torch/csrc/rmaq.cu",
                     "src/repro/kernels/rmaq/kernel.py:85"),
    "notify_accumulate": ("cuda", "src/repro_torch/csrc/rmaq.cu",
                          "src/repro/kernels/rmaq/kernel.py:128"),
    "queue_push": ("cuda", "src/repro_torch/csrc/rmaq.cu",
                   "src/repro/kernels/rmaq/kernel.py:221"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:75"),
    "ssm_scan": ("cuda", "src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:46"),
    "ring_matmul": ("cuda", "src/repro_torch/csrc/ring_matmul.cu",
                    "src/repro/kernels/ring_matmul/kernel.py:74"),
}
FULL = dict(n_prefill=2, d_model=128, vocab=32000, page_tokens=16,
            block_tokens=2048, pool_pages=8192, queue_capacity=64,
            max_recv_per_step=16, n_lanes=2, novel_slots=128)
N_FUSED, N_GATHER, N_INLINE = 256, 64, 64
N_CANCEL = 24                   # requests of the interrupted-pull run
N_PREFIX_GROUPS = 4             # requests share one of 4 half-length prefixes
MILC_P, MILC_LOCAL = 131072, (8, 4, 4, 4, 6)   # ranks; T_local, X, Y, Z, reals
MILC_STEPS, MILC_TOL = 5, 1e-5  # the example's own tolerance
AR_P, AR_MIB, AR_TOL = 8, 25, 1e-5
# DSDE: the paper's Fig. 7b setting (benchmarks/bench_dsde.py:14-20): k = 6
# items of 2 f32 a rank to uniform random targets, 4k slots a pair
DSDE_P, DSDE_K, DSDE_D, DSDE_CAP, DSDE_SEED, DSDE_REPS = 4096, 6, 2, 24, 0, 3
DSDE_PROTOCOLS = ("exchange_accumulate", "exchange_alltoall_baseline",
                  "exchange_reduce_scatter_baseline", "exchange_queue")
# the model-serving engine: SmolLM-360M at its published widths
# (src/repro/configs/smollm_360m.py), random bf16 weights from a seed
MODEL_ARCH, MODEL_SEED = "smollm-360m", 0
# 8 slots, max_seq 1024, 32 requests of 16-512 prompt tokens, 32 new each, 8
# of them re-run solo; bound: logits engine vs solo batch-1 run, and the tie margin
SMOLLM_ENGINE = dict(slots=8, max_seq=1024, requests=32, plen=(16, 512), new=32, seed=3,
                     checked=8, bound=0.125)
FWD_TOKENS, FWD_SEED = (4, 2048), 4
FWD_BOUND, FWD_AGREE = 0.25, 0.99   # logits: backend "cuda" vs "torch"; argmax share
BF16_TOL, F32_TOL = 2e-2, 1e-4  # flash kernel vs plain: one bf16 ulp at |x| 2-4; f32 sums


def scaled_tol(want) -> float:
    """BF16_TOL for outputs up to 1 and more, scaled down by max |want|
    below that: non-causal attention over 1000+ random keys averages v to
    outputs of a few hundredths, where a flat 2e-2 would pass a wrong
    kernel."""
    return BF16_TOL * min(1.0, float(want.float().abs().max()))
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
# the moe and hybrid families: Jamba-v0.1 at its published widths cut to 16
# of 32 layers (2 of its 4 periods; src/repro/configs/jamba_v0_1_52b.py) and
# qwen3-moe-30b-a3b cut to 4 of 48 layers, random bf16 weights from a seed
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_SEED = "jamba-v0.1-52b", 16, 0
HYBRID_ENGINE = dict(slots=8, max_seq=2048, requests=24, plen=(16, 1024), new=24, seed=5,
                     checked=4, bound=0.25)
HYBRID_FWD_TOKENS = (2, 2048)   # Jamba's cache-free forward_logits: the flash kernel's path
MOE_ARCH, MOE_LAYERS, MOE_SEED = "qwen3-moe-30b-a3b", 4, 1
MOE_ENGINE = dict(slots=4, max_seq=512, requests=8, plen=(16, 256), new=16, seed=6,
                  checked=4, bound=0.25)
SSM_F32_REL, SSM_BF16_TOL = 1e-4, 5e-2   # ssm_scan vs plain: f32 sums; the reference test's bf16
ROUTE_ULP = 1e-6                # f32 rounding of a probability gap (probabilities < 1)
# training: SmolLM-360M at its published widths, all 32 layers, bf16 params
# from a seed, AdamW with remat on the port's pipeline at [4, 2048]
TRAIN_SEED, TRAIN_BATCH, TRAIN_STEPS = 0, (4, 2048), 20
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
TRAIN_DROP = 0.05               # mean loss, first 5 steps - last 5 (tests/test_training.py:43-50)
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 1e-2, 0.05   # backend "cuda" vs "torch" at one state
# the kill-and-resume contract of tests/test_training.py:52-72 (SMOKE config)
RESUME_STEPS, RESUME_STOP, RESUME_EVERY = 10, 7, 5
# kernel row 13 through its ops surface at the training run's FSDP contraction
RING_N, RING_TOL = 4, 1e-4      # ranks; kernel vs plain, relative to max |Y| (f32 sums)
# the device page pool at a disaggregated deployment's decode-side KV pool
# for llava-next-mistral-7b (src/repro/configs/llava_next_mistral_7b.py:7-8:
# 8 KV heads of 128): a page is one layer's K and V for 16 tokens in f32, so
# row 3 moves it as 32-bit words (128 KiB); 4096 pages a rank, 4 GiB in all
POOL_P, POOL_PAGES, POOL_PAGE = 8, 4096, (16, 2, 8, 128)
POOL_KMAX = FULL["block_tokens"] // FULL["page_tokens"]   # one 2048-token request: 128 pages
POOL_RANDOM, POOL_GROW, POOL_SEED, POOL_REPS = 32, 1024, 7, 20
# the distributed hashtable at the paper's Fig. 7a batch
# (benchmarks/bench_hashtable.py:1-2): 16,384 inserts a rank an epoch over
# p = 1024 ranks, 64 slots a pair (a pair expects 16 items), table and heap
# of 2**16 cells a rank (a 2.7 GB volume).  4 epochs of distinct keys fill
# it to load 1.0, a 5th re-inserts every 16th of them with new values; the
# lookup epoch's 16,384 present and 16,384 absent keys a rank take 128
# slots a pair (a pair expects 32: at 64 the busiest of the 2**20 pairs
# would overflow about once in five runs)
HT_P, HT_BATCH, HT_CAP, HT_LOOKUP_CAP = 1024, 16384, 64, 128
HT_TABLE = HT_HEAP = 1 << 16
HT_EPOCHS, HT_REINSERT, HT_SEED, HT_REPS = 4, 16, 11, 3
HT_MUL = 0x2545F491             # odd: key j = j * HT_MUL mod 2**31 is one-to-one
# the 3-D FFT at NAS Parallel Benchmarks FT class C: a 512**3 grid of
# complex64 (1 GiB) over p = 64 ranks of 8 x-planes; examples/fft3d.py:68-69's
# criterion, relative to the spectrum's max abs
FFT_N, FFT_P, FFT_TOL, FFT_SEED, FFT_REPS = 512, 64, 1e-4, 12, 5
# the rest of the model zoo at its published widths, random bf16 weights from
# a seed.  xLSTM-1.3B (src/repro/configs/xlstm_1_3b.py: 48 layers, 6 periods
# of 7 mLSTM + 1 sLSTM blocks, d_model 2048, 4 heads) through the engine as
# SmolLM's, every lane held to a fresh cache at its prefill.  whisper-small
# (src/repro/configs/whisper_small.py: 12 + 12 layers, d_model 768, 12 heads
# of 64, 1500 frames) through Model.prefill with frames and decode_step, max
# seq 448 (Whisper's decoder context); its encoder output, backend cuda vs
# torch, takes the forward phases' bound for the same comparison.
# xLSTM-1.3B with random weights carries a rounding difference on through
# 48 layers and 512 recurrent steps to logits of its own size: bf16
# prefill(512) is 4.06 from `forward_logits` at that position on the card,
# f32 0.045, logits up to 3.54.  So the bf16 engine's requests are re-run in
# their own lane of an idle 8-lane cache, where a lane's rows meet the same
# kernels at the same shapes: bit-equal (bound 0).  In f32 (the weights
# cast, every cache leaf f32, TF32 off) the engine runs again over 8
# requests, held to batch-1 solo runs, and the S = 512 comparisons (two
# chunks vs one, prefill + decode vs forward_logits), which take other
# orders of sums, are made: all within the engine rule's 0.125, the argmax
# held beyond it.  The same three comparisons run in f64 too: rounding
# shrinks there by the precision ratio (2**-53 / 2**-24, about 2e-9; on
# the CPU at d_model 256 and 512, 48 layers, the f64 gap is 1.4e-13 to
# 2.3e-13 where f32's is up to 1.3e-4), while a fault in the chunking or
# the recurrence would stay near f32's 0.04; so they are held to 1e-6
XLSTM_ARCH, XLSTM_SEED, XLSTM_S = "xlstm-1.3b", 0, 512
XLSTM_ENGINE = dict(slots=8, max_seq=1024, requests=24, plen=(16, 512), new=32, seed=9,
                    checked=8, bound=0.0, same_lane=True)
XLSTM_F32_ENGINE = dict(slots=8, max_seq=1024, requests=8, plen=(16, 512), new=32, seed=9,
                        checked=8, bound=0.125)
XLSTM_F32_BOUND, XLSTM_F64_BOUND = 0.125, 1e-6
WHISPER_ARCH, WHISPER_SEED = "whisper-small", 0
WHISPER_RUN = dict(requests=8, plen=(4, 64), new=32, max_seq=448, seed=10, bound=0.125)
ENC_BOUND = FWD_BOUND


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def short_entry(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, as
    ptxas reports it: flash_fwd_wgmma<128,3>, flash_fwd_kernel<bf16,64>."""
    found = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not found:
        return mangled[:48]
    end = found.end() + int(found.group(1))
    name, rest = mangled[found.end():end], mangled[end:]
    close = rest.find("EEv")
    if not rest.startswith("I") or close < 0:
        return name
    args = [t.group(1) or ("bf16" if t.group(0).startswith("13") else "f32")
            for t in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f", rest[1:close])]
    return f"{name}<{','.join(args)}>"


def build_all(common) -> None:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        for name, path in zip(SOURCES, ex.map(common.build, SOURCES)):
            log(f"built {name}: {path.name}")
            entry = ""
            for line in common.BUILD_LOG.get(name, "").splitlines():
                found = re.search(r"entry function '(\w+)'", line)
                if found:
                    entry = short_entry(found.group(1))
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {entry}: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s")


def prompts(rng, n: int, cfg) -> dict:
    """n prompts whose first half is one of N_PREFIX_GROUPS shared prefixes.
    Consecutive pairs share one: the two prefill ranks stage them in the
    same step, so the second maps onto the prefix pages the first just took
    (a request lives one step here, and its pages are freed after it)."""
    import numpy as np

    half = cfg.block_tokens // 2
    prefixes = [rng.integers(0, cfg.vocab, size=half) for _ in range(N_PREFIX_GROUPS)]
    return {i: np.concatenate(
        [prefixes[(i // 2) % N_PREFIX_GROUPS], rng.integers(0, cfg.vocab, size=half)])
        for i in range(n)}


def serve(disagg, cfg, n: int, seed: int, setup=None) -> tuple:
    """Run n requests to completion and check them; returns (engine, seconds).
    `setup(engine)`, if given, runs before the first request."""
    import numpy as np
    import torch

    eng = disagg.DisaggEngine(4, cfg, seed=seed, device="cuda")
    if setup is not None:
        setup(eng)
    reqs = prompts(np.random.default_rng(seed), n, cfg)
    for rid, toks in reqs.items():
        eng.submit(rid, toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run_until_drained(max_steps=4 * n + 16)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [rid for rid, toks in reqs.items() if res.get(rid) != eng.reference(toks)]
    if len(res) != n or bad:
        raise AssertionError(f"{eng.mode} {cfg.attend}: {len(res)}/{n} results, "
                             f"tokens differ for {bad[:8]}")
    if eng.retries != 0:
        raise AssertionError(f"retries {eng.retries} != 0")
    if not eng.flow_stats()["conservation_ok"]:
        raise AssertionError("credit conservation violated")
    ms = eng.msg_stats
    want = {"inline": (6, 2), "paged": (8, 3), "rendezvous": (8, 4)}[eng.mode]
    got = (ms["raw_msgs_per_step"], ms["wire_msgs_per_step"])
    if got != want:
        raise AssertionError(f"{eng.mode}: raw -> wire per step {got}, want {want}")
    if eng.mode == "paged":
        ps = eng.paged_stats()
        if not ps["pool_conservation_ok"] or ps["prefix_hits"] == 0:
            raise AssertionError(f"paged stats: {ps}")
    if eng.mode != "inline" and (eng.lane_sends[cfg.n_prefill:].sum(axis=1) == 0).any():
        raise AssertionError(f"a decode rank got no work: {eng.lane_sends}")
    return eng, dt


def time_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def self_us(e) -> float:
    """A profiler event's device time in µs (the attribute's name differs
    between torch versions)."""
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def device_ms(fn, key: str, reps: int = 50) -> float:
    """Mean device time of one launch of the kernels whose name holds `key`
    over `reps` calls of `fn`, from `torch.profiler`'s kernel events: the
    host's cost of a launch left out, which `time_ms` includes.  The
    profiler must see exactly `reps` such launches.  It now and then drops
    kernel events (a window of a 2 µs kernel once saw 49 of 50; a window
    of the 97 µs gather at the device pool's pages saw 43), so a window
    that saw fewer is profiled again, three windows at most, each short
    one logged; a window that saw more fails at once.  After three short
    windows the time is taken by `queued_ms` instead, without the
    profiler, and the log says so: that time covers the whole call of
    `fn`, the gaps between its launches included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    attempts = 3
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if key in e.key]
        n = sum(e.count for e in events)
        if n == reps:
            return sum(map(self_us, events)) / n / 1e3
        log(f"device_ms: the profiler saw {n} launches of {key}, want {reps} "
            f"(window {attempt + 1} of {attempts})")
        if n > reps:
            raise AssertionError(f"the profiler saw {n} launches of {key}, want {reps}")
    log(f"device_ms: {key} timed by queued_ms, the profiler having come short "
        f"{attempts} times")
    return queued_ms(fn, reps)


def queued_ms(fn, reps: int = 50) -> float:
    """Mean device time of one call of `fn` with the host's cost taken out,
    without the profiler (whose kernel records of a 2 µs kernel came back
    one short in some windows): a spin kernel (`torch.cuda._sleep`) holds
    the stream while the host queues `reps` calls between two CUDA events,
    so the device then runs them back to back, the gaps between launches
    included.  Fails if the host had not queued them all before the spin
    ended."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)                    # ~25 ms at the card's clocks
    ev[1].record()
    t0 = time.perf_counter()
    ev[2].record()
    for _ in range(reps):
        fn()
    ev[3].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    if host_ms > 0.8 * spin_ms:
        raise AssertionError(f"queued_ms: the host took {host_ms:.3f} ms to queue {reps} "
                             f"calls, the spin only {spin_ms:.3f} ms")
    return ev[2].elapsed_time(ev[3]) / reps


def check_kernel(ops, ref, q, kv, ids, causal=False, scale=None) -> float:
    import torch

    out = ops.paged_attention(q, kv, ids, scale=scale, causal=causal)
    torch.cuda.synchronize()
    plain = ref.paged_attention_ref(q, kv, ids, scale=scale, causal=causal)
    err = float((out - plain).abs().max())
    if not torch.isfinite(out).all() or err > TOL:
        raise AssertionError(f"paged_attention vs plain: max abs err {err} "
                             f"(causal={causal}, shape {tuple(q.shape)})")
    return err


def edge_cases(ops, ref) -> float:
    """Masked pages, a fully masked row, Sq=4 causal, at hd=128, pt=16;
    then the split walk at k = 128: the decode path's q [64, 1, 128] with 2
    valid rows, and k = 130 (a ragged last split) with entries 8-15 masked
    (whole splits at pt 16) at Sq 1, 4 and 8, causal at 4 and 8 (the
    horizon inside the last split), pt 16 and 4; three calls bit-equal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    for Sq, causal in ((1, False), (4, False), (4, True)):
        q = torch.randn(3, Sq, 128, device="cuda", generator=g)
        kv = torch.randn(40, 16, 2, 128, device="cuda", generator=g)
        ids = torch.randint(0, 40, (3, 9), device="cuda", generator=g,
                            dtype=torch.int32)
        ids[0, 2] = ids[0, 5] = -1
        ids[2] = -1
        err = max(err, check_kernel(ops, ref, q, kv, ids, causal=causal))
        out = ops.paged_attention(q, kv, ids, causal=causal)
        if float(out[2].abs().max()) != 0.0:
            raise AssertionError("a fully masked row did not give zeros")

    def ids_for(m, k, n_pages, valid):
        ids = torch.full((m, k), -1, device="cuda", dtype=torch.int32)
        for i in valid:
            ids[i] = torch.randint(0, n_pages, (k,), device="cuda", generator=g,
                                   dtype=torch.int32)
            ids[i, 8:16] = -1
            ids[i, 3] = n_pages + 5
        return ids

    kv = torch.randn(2048, 16, 2, 128, device="cuda", generator=g)
    q = torch.randn(64, 1, 128, device="cuda", generator=g)
    ids = ids_for(64, 128, 2048, (33, 50))
    err = max(err, check_kernel(ops, ref, q, kv, ids, scale=1.0))
    outs = [ops.paged_attention(q, kv, ids, scale=1.0) for _ in range(3)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("three calls at k = 128 are not bit-equal")
    if float(outs[0][[i for i in range(64) if i not in (33, 50)]].abs().max()) != 0.0:
        raise AssertionError("a fully masked row at k = 128 did not give zeros")
    for pt in (16, 4):
        kv = torch.randn(600, pt, 2, 128, device="cuda", generator=g)
        ids = ids_for(3, 130, 600, (0, 1))
        for Sq, causal in ((1, False), (4, False), (4, True), (8, True)):
            q = torch.randn(3, Sq, 128, device="cuda", generator=g)
            err = max(err, check_kernel(ops, ref, q, kv, ids, causal=causal))
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.serve import disagg

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build
    build_all(common)

    # ---- the main path: paged fused serving at full width
    cfg = disagg.DisaggConfig(paged=True, attend="fused", **FULL)
    seen_ids = []
    real = ops.paged_attention

    def tap(q, kv, ids, **kw):   # keeps each step's page table; launches via the wrapper
        seen_ids.append(ids)
        return real(q, kv, ids, **kw)

    ops.paged_attention = tap
    ops.launches = 0
    try:
        eng, dt = serve(disagg, cfg, N_FUSED, seed=0)
    finally:
        ops.paged_attention = real
    launches = ops.launches
    if launches != eng.steps_run or launches == 0:
        raise AssertionError(f"fused run: {launches} kernel launches for "
                             f"{eng.steps_run} decode steps")
    fused = eng.serve_metrics()
    fused_tokens = dict(eng.results)
    fused_ms = dt / eng.steps_run * 1e3
    log(f"fused: {N_FUSED} requests, {eng.steps_run} steps, {dt:.3f} s, "
        f"{dt / eng.steps_run * 1e3:.3f} ms/step, attend_us p50 "
        f"{fused['attend_us']['p50']:.1f} p90 {fused['attend_us']['p90']:.1f}, "
        f"ttft_us p50 {fused['ttft_us']['p50']:.1f}, "
        f"prefix hits {eng.paged_stats()['prefix_hits']}, "
        f"novel pages {eng.novel_pages_shipped}, kernel launches {launches}")

    # the busiest decode step's kernel inputs, for the comparison and timing
    ids = max(seen_ids, key=lambda t: int((t >= 0).sum()))
    m, k = ids.shape
    pool = eng.pool.view((-1,) + tuple(eng.pool.shape[2:]))
    q = eng.params["w_q"].expand(m, 1, cfg.d_model).contiguous()
    valid_pages = int((ids >= 0).sum())
    rows = int((ids >= 0).any(dim=1).sum())
    del seen_ids

    # ---- kernel vs plain on the card
    err = check_kernel(ops, ref, q, pool, ids, scale=1.0)
    err = max(err, edge_cases(ops, ref))
    log(f"paged_attention vs plain: max abs err {err:.3g} (tol {TOL})")

    # ---- timings at the main-path inputs
    pt, hd = cfg.page_tokens, cfg.d_model
    kernel_ms = time_ms(lambda: ops.paged_attention(q, pool, ids, scale=1.0))
    kernel_dev_ms = device_ms(lambda: ops.paged_attention(q, pool, ids, scale=1.0),
                              "paged_attention_split")
    # a block serves `group` rows, `groups` apart, one after another: the
    # same valid rows in one block group show what sharing a block costs
    plan = ops.plan(m, 1, k, pt, hd)
    valid_rows = [int(i) for i in (ids >= 0).any(dim=1).nonzero().flatten()]
    shared = torch.full_like(ids, -1)
    for j, r in enumerate(valid_rows):
        shared[(j * plan.groups) % m] = ids[r]
    err = max(err, check_kernel(ops, ref, q, pool, shared, scale=1.0))
    shared_dev_ms = device_ms(lambda: ops.paged_attention(q, pool, shared, scale=1.0),
                              "paged_attention_split")
    plain_ms = time_ms(lambda: ref.paged_attention_ref(q, pool, ids, scale=1.0))
    safe = ids.clamp(min=0).long()
    kv_rows = pool[safe]                                 # [m, k, pt, 2, hd]
    k_all = kv_rows[:, :, :, 0].reshape(m, 1, k * pt, hd)
    v_all = kv_rows[:, :, :, 1].reshape(m, 1, k * pt, hd)
    mask = (ids >= 0).repeat_interleave(pt, dim=1)[:, None, None, :]
    q4 = q[:, None]                                      # [m, 1, 1, hd]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k_all, v_all, attn_mask=mask, scale=1.0))
    del kv_rows, k_all, v_all
    nbytes = valid_pages * pt * 2 * hd * 4 + 2 * q.numel() * 4 + ids.numel() * 4
    flops = 4 * valid_pages * pt * hd
    bytes_ms = nbytes / H100.hbm_bandwidth * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    log(f"paged_attention at the busiest step: q {tuple(q.shape)}, pool "
        f"{tuple(pool.shape)}, ids {tuple(ids.shape)}, {rows} valid rows, "
        f"{valid_pages} valid pages in rows {valid_rows}, plan {tuple(plan)}; kernel "
        f"{kernel_ms * 1e3:.1f} us (device {kernel_dev_ms * 1e3:.2f} us; "
        f"{shared_dev_ms * 1e3:.2f} us with those rows in one block group), plain "
        f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by})")
    del eng, pool
    torch.cuda.empty_cache()

    # ---- the A/B baseline and inline mode
    cfg_g = disagg.DisaggConfig(paged=True, attend="gather", **FULL)
    before = ops.launches
    eng, dt = serve(disagg, cfg_g, N_GATHER, seed=1)
    if ops.launches != before:
        raise AssertionError("the gather path launched the attention kernel")
    gather = eng.serve_metrics()
    log(f"gather: {N_GATHER} requests, {eng.steps_run} steps, "
        f"{dt / eng.steps_run * 1e3:.3f} ms/step, attend_us p50 "
        f"{gather['attend_us']['p50']:.1f} p90 {gather['attend_us']['p90']:.1f}")
    del eng
    torch.cuda.empty_cache()
    cfg_i = disagg.DisaggConfig(paged=False, **FULL)
    eng, dt = serve(disagg, cfg_i, N_INLINE, seed=2)
    log(f"inline: {N_INLINE} requests, {eng.steps_run} steps, "
        f"{dt / eng.steps_run * 1e3:.3f} ms/step, bytes_wire/step "
        f"{eng.msg_stats['bytes_wire_per_step']}")
    del eng

    kernels = [{
        "name": "paged_attention",
        "route": KERNELS["paged_attention"][0],
        "source": KERNELS["paged_attention"][1],
        "replaces": KERNELS["paged_attention"][2],
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "device_ms": kernel_dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    torch.cuda.empty_cache()
    kernels += rendezvous_phases(torch, F, disagg, fused_tokens, fused_ms, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += rma_phases(torch)
    torch.cuda.empty_cache()
    kernels += dsde_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += model_serve_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += hybrid_serve_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += training_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    zoo = zoo_phases(torch, H100.hbm_bandwidth)
    next(r for r in kernels if r["name"] == "flash_attention").update(zoo.pop("row11"))
    log(f"zoo phase numbers: {json.dumps(zoo)}")
    pool = pool_phase(torch, H100.hbm_bandwidth)
    next(r for r in kernels if r["name"] == "paged_gather").update(pool.pop("row3"))
    log(f"pool phase numbers: {json.dumps(pool)}")
    torch.cuda.empty_cache()
    log(f"apps phase numbers: {json.dumps(apps_phase(torch, H100.hbm_bandwidth))}")
    if len(kernels) != len(KERNELS):
        raise AssertionError(f"{len(kernels)} kernel rows, want {len(KERNELS)}")
    log(f"smoke wall time: {time.perf_counter() - T0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------- rendezvous pull serving
def rendezvous_serve(torch, disagg, fused_tokens: dict, fused_ms: float) -> dict:
    """256 full-width requests in rendezvous mode, token-exact against
    `reference()` and the fused run; keeps the busiest step's pull (its
    descriptors, the pulled block, the readout's context, the pool)."""
    from repro_torch.rmem import pages as rpg

    cfg = disagg.DisaggConfig(transport="rendezvous", **FULL)
    busiest = {"rows": -1}
    real_gather = rpg.gather_pages

    def setup(eng):
        real_emit = eng._emit

        def tap_gather(mesh, pool, entries, valid):
            block = real_gather(mesh, pool, entries, valid)
            rows = int(valid.sum())
            if rows > busiest["rows"]:
                busiest.update(rows=rows, entries=entries.clone(), valid=valid.clone(),
                               block=block.clone(), pool=pool.clone(), fresh=True)
            return block

        def tap_emit(ctx, mask, tags):
            if busiest.pop("fresh", False):
                busiest["ctx"] = ctx.clone()
            return real_emit(ctx, mask, tags)

        eng._emit = tap_emit
        rpg.gather_pages = tap_gather

    try:
        eng, dt = serve(disagg, cfg, N_FUSED, seed=0, setup=setup)
    finally:
        rpg.gather_pages = real_gather
    diff = [rid for rid, tok in eng.results.items() if fused_tokens.get(rid) != tok]
    if diff:
        raise AssertionError(f"rendezvous tokens differ from the fused run's for {diff[:8]}")
    rs = eng.rendezvous_stats()
    want = {"ring_payload_appends": 0, "descriptor_appends": N_FUSED,
            "descriptor_bytes": N_FUSED * cfg.table_nbytes,
            "pulled_pages": N_FUSED * cfg.pages_per_block - rs["prefix_hits"],
            "pins_outstanding": 0, "pool_conservation_ok": True,
            "wire_msgs_per_step": 4, "transport_selected": "rendezvous"}
    bad = {k: (rs[k], v) for k, v in want.items() if rs[k] != v}
    if bad or eng.mode != "rendezvous":
        raise AssertionError(f"rendezvous stats (got, want): {bad}, mode {eng.mode}")
    if any(c["live"] for c in eng.kv.conservation()["per_owner"].values()):
        raise AssertionError("rendezvous: pages still live after the drain")
    ms = dt / eng.steps_run * 1e3
    log(f"rendezvous: {N_FUSED} requests, {eng.steps_run} steps, {dt:.3f} s, "
        f"{ms:.3f} ms/step (paged fused {fused_ms:.3f}), tokens == reference() "
        f"== fused run; payload appends 0, {rs['descriptor_appends']} descriptors "
        f"({rs['descriptor_bytes']} B), {rs['pulled_pages']} pages pulled "
        f"({rs['pulled_bytes']} B), prefix hits {rs['prefix_hits']}, wire/step 4, "
        f"busiest pull {busiest['rows']} requests")
    busiest["params"] = eng.params
    busiest["cfg"] = cfg
    return busiest


def auto_phase(torch, disagg) -> None:
    """transport="auto" at FULL's block (2 MiB, 128 pages): what the H100
    model picks, and that an engine built so reports it."""
    from repro_torch.parallel.overlap import CollectiveStrategist

    for reuse in (0.0, 0.5):
        cfg = disagg.DisaggConfig(transport="auto", expected_reuse=reuse, **FULL)
        plan = CollectiveStrategist().transfer_plan(
            float(cfg.block_nbytes), cfg.pages_per_block, reuse)
        eng = disagg.DisaggEngine(4, cfg, device="cuda")
        mode = {"eager": "inline"}.get(plan["protocol"], plan["protocol"])
        if (disagg.resolve_transport(cfg), eng.transport_selected, eng.mode) != \
                (plan["protocol"], plan["protocol"], mode):
            raise AssertionError(f"auto at reuse {reuse}: plan {plan}, engine "
                                 f"{eng.transport_selected}/{eng.mode}")
        log(f"auto at {cfg.block_nbytes} B, {cfg.pages_per_block} pages, reuse {reuse}: "
            f"{plan['protocol']} (eager {plan['eager_s'] * 1e6:.2f} us, rendezvous "
            f"{plan['rendezvous_s'] * 1e6:.2f} us, paged {plan['paged_s'] * 1e6:.2f} us, "
            f"eager/rendezvous crossover {plan['crossover_bytes']:.0f} B); engine mode "
            f"{eng.mode}")
        del eng
        torch.cuda.empty_cache()


def cancel_phase(torch, disagg) -> None:
    """The interrupted pull (`tests/subtests/rendezvous_sub.py:78-82`): one
    decode rank, a drain of 1, one lane, so descriptors queue; cancel a
    request that holds pins; the rest drain token-exact, every pool free."""
    import numpy as np

    cfg = disagg.DisaggConfig(**{**FULL, "transport": "rendezvous", "n_prefill": 3,
                                 "max_recv_per_step": 1, "n_lanes": 1})
    eng = disagg.DisaggEngine(4, cfg, seed=0, device="cuda")
    reqs = prompts(np.random.default_rng(5), N_CANCEL, cfg)
    for rid, toks in reqs.items():
        eng.submit(rid, toks)
    live = []
    for _ in range(32):
        eng.step()
        live = sorted(rid for rid in eng._pins if rid not in eng.results)
        if live:
            break
    if not live:
        raise AssertionError("interrupted pull: no request ever held pins")
    victim = live[0]
    n_pins = len(eng._pins[victim])
    if not eng.cancel(victim) or victim in eng._pins or not eng.kv.conservation()["ok"]:
        raise AssertionError(f"cancel of {victim} did not roll back")
    res = eng.run_until_drained(max_steps=8 * N_CANCEL)
    bad = [rid for rid, toks in reqs.items()
           if rid != victim and res.get(rid) != eng.reference(toks)]
    live_pages = [c["live"] for c in eng.kv.conservation()["per_owner"].values()]
    if victim in res or bad or len(res) != N_CANCEL - 1 or eng._pins or any(live_pages):
        raise AssertionError(f"interrupted pull: victim in results {victim in res}, "
                             f"tokens differ {bad[:8]}, pins {len(eng._pins)}, "
                             f"live pages {live_pages}")
    log(f"interrupted pull: cancelled rid {victim} holding {n_pins} pins; the other "
        f"{len(res)} drained token-exact in {eng.steps_run} steps; every pool free")


def pull_ops_phase(torch, pa_ops, pg_ops, rpg, Mesh, run: dict) -> dict:
    """Kernels 2 and 3 through their ops surfaces on the rendezvous run's
    own data: for each (decode rank -> owner) shift, `gather_shift` against
    the block `gather_pages` pulled (bit-equal) and `paged_attention_shift`
    with q = w_q, scale 1.0 against the readout's context (<= TOL)."""
    cfg, pool, entries, valid = run["cfg"], run["pool"], run["entries"], run["valid"]
    p, m, ppb = valid.shape[0], valid.shape[1], cfg.pages_per_block
    mesh = Mesh(p, "serve", device="cuda")
    owner = entries[..., 0].long()                       # [p, m, ppb]
    page = entries[..., 1]
    me = torch.arange(p, device="cuda")[:, None, None]
    want = valid[..., None] & (page >= 0)
    block = run["block"].reshape(p, m * ppb, -1)
    q = run["params"]["w_q"].expand(p, 1, cfg.d_model).contiguous()
    ctx = run["ctx"].reshape(p, m, cfg.d_model)
    pg_ops.launches = pa_ops.shift_launches = 0
    combined = torch.zeros_like(block)
    err, shifts, att_ids = 0.0, [], {}
    for s in range(1, p):
        hit = want & (owner == (me + s) % p)             # [p, m, ppb]
        if not bool(hit.any()):
            continue
        shifts.append(s)
        ids = torch.where(hit, page, torch.full_like(page, -1)).reshape(p, m * ppb)
        got = rpg.gather_shift(mesh, pool, ids.contiguous(), s).reshape(p, m * ppb, -1)
        combined = torch.where(hit.reshape(p, m * ppb, 1), got, combined)
        for i in range(m):
            rows = hit[:, i].any(dim=1)                  # ranks whose request i lives at r + s
            if not bool(rows.any()):
                continue
            ids_i = torch.where(hit[:, i], page[:, i], torch.full_like(page[:, i], -1))
            att_ids[(s, i)] = ids_i.contiguous()
            out = pa_ops.paged_attention_shift(q, pool, att_ids[(s, i)], s, mesh,
                                               scale=1.0)[:, 0]
            err = max(err, float((out[rows] - ctx[rows, i]).abs().max()))
    torch.cuda.synchronize()
    launches = {"paged_gather": pg_ops.launches,
                "paged_attention_shift": pa_ops.shift_launches}
    if not torch.equal(combined.view(torch.int32), block.view(torch.int32)):
        raise AssertionError("gather_shift differs from the block gather_pages pulled")
    if err > TOL or min(launches.values()) == 0:
        raise AssertionError(f"paged_attention_shift vs the readout's context: max abs "
                             f"err {err} (tol {TOL}); launches {launches}")
    log(f"pull ops on the rendezvous data ({run['rows']} requests, shifts {shifts}): "
        f"gather_shift bit-equal to the pulled block, paged_attention_shift vs the "
        f"readout's context max abs err {err:.3g}; launches {launches}")
    return {"launches": launches, "shifts": shifts, "att_ids": att_ids, "ctx_err": err}


def check_pull_kernels(torch, pa_ops, pa_ref, pg_ops, pg_ref, Mesh, run, ops_run) -> dict:
    """Kernels 2 and 3 against their plain versions on the card: at the
    path's shapes (bit-equal gather, attention <= TOL) and at edge cases —
    shifts 0, -1, >= p, p = 1; ids of -1 and past the pool; a fully masked
    row; Sq = 4 causal; int32 pages."""
    pool, p = run["pool"], run["pool"].shape[0]
    mesh = Mesh(p, "serve", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = {"paged_gather": 0.0, "paged_attention_shift": 0.0}

    def gather(x, ids, s, msh, what):
        """Both surfaces (clamp, hole mode), bit-equal to plain."""
        for holes, plain in ((False, pg_ref.paged_gather_ref),
                             (True, pg_ref.paged_gather_holes_ref)):
            want = plain(x, ids, s, msh).view(torch.int32)
            out = pg_ops.paged_gather(x, ids, s, msh, holes=holes)
            if not torch.equal(out.view(torch.int32), want):
                raise AssertionError(f"paged_gather (holes={holes}) differs from its plain "
                                     f"version at {what}")

    def attend(q, kv, ids, s, msh, what, **kw):
        out = pa_ops.paged_attention_shift(q, kv, ids, s, msh, **kw)
        plain = pa_ref.paged_attention_shift_ref(q, kv, ids, s, msh, **kw)
        e = float((out - plain).abs().max())
        if not torch.isfinite(out).all() or e > TOL:
            raise AssertionError(f"paged_attention_shift vs plain at {what}: {e}")
        errs["paged_attention_shift"] = max(errs["paged_attention_shift"], e)
        return out

    k = run["entries"].shape[1] * run["entries"].shape[2]
    ids = torch.randint(-1, pool.shape[1] + 3, (p, k), generator=g, device="cuda",
                        dtype=torch.int32)
    every = torch.full_like(ids, -1)                   # every id a hole
    none = torch.randint(0, pool.shape[1], ids.shape, generator=g, device="cuda",
                         dtype=torch.int32)             # no hole
    for s in (0, 1, -1, p + 2):
        for name, i in (("mixed", ids), ("every id a hole", every), ("no hole", none)):
            gather(pool, i, s, mesh, f"the pool {tuple(pool.shape)}, ids {tuple(i.shape)} "
                   f"({name}), shift {s}")
    ints = torch.randint(-2**31, 2**31 - 1, (3, 7, 5), generator=g, device="cuda",
                         dtype=torch.int32)
    small = torch.tensor([[0, -1, 9, 2], [6, 1, -3, 7], [3, 3, 0, 8]], device="cuda",
                         dtype=torch.int32)
    m3 = Mesh(3, "x", device="cuda")
    for s in (0, 1, -1, 4):
        gather(ints, small, s, m3, f"int32 [3, 7, 5] shift {s}")
        for words in (3, 7, 8):
            x = torch.randn(3, 9, words, generator=g, device="cuda")
            gather(x, small, s, m3, f"[3, 9, {words}] shift {s}")
    one = Mesh(1, "x", device="cuda")
    gather(ints[:1], small[:1], 5, one, "p = 1")
    gather(pool[:1], ids[:1], 3, one, "p = 1, a serving page")

    q = run["params"]["w_q"].expand(p, 1, pool.shape[-1]).contiguous()
    for (s, _), a_ids in ops_run["att_ids"].items():
        attend(q, pool, a_ids, s, mesh, f"the path's shift {s}", scale=1.0)
    kv = torch.randn(p, 40, 16, 2, 128, generator=g, device="cuda")
    e_ids = torch.randint(0, 40, (p, 9), generator=g, device="cuda", dtype=torch.int32)
    e_ids[0, 2] = e_ids[0, 5] = -1
    e_ids[1, 0] = 40 + 3
    e_ids[2] = -1
    for Sq, causal in ((1, False), (4, False), (4, True)):
        qe = torch.randn(p, Sq, 128, generator=g, device="cuda")
        for s in (0, 1, -1, p + 1):
            out = attend(qe, kv, e_ids, s, mesh, f"Sq {Sq} causal {causal} shift {s}",
                         causal=causal)
            if float(out[2].abs().max()) != 0.0:
                raise AssertionError("a fully masked row did not give zeros")
    attend(qe[:1], kv[:1], e_ids[:1], 3, one, "p = 1", causal=True)
    # the split walk at k = 128: only rank 2 has pages (a masked split, an
    # id past the pool)
    kv = torch.randn(p, 256, 16, 2, 128, generator=g, device="cuda")
    e_ids = torch.full((p, 128), -1, device="cuda", dtype=torch.int32)
    e_ids[2] = torch.randint(0, 256, (128,), generator=g, device="cuda", dtype=torch.int32)
    e_ids[2, 20:28] = -1
    e_ids[2, 5] = 256 + 1
    for Sq, causal in ((1, False), (4, True)):
        qe = torch.randn(p, Sq, 128, generator=g, device="cuda")
        for s in (0, 1, -1, 9):
            out = attend(qe, kv, e_ids, s, mesh, f"k = 128 Sq {Sq} causal {causal} shift {s}",
                         scale=1.0, causal=causal)
            if float(out[[0, 1, 3]].abs().max()) != 0.0:
                raise AssertionError("a rank with no pages did not give zeros at k = 128")
    torch.cuda.synchronize()
    log("paged_gather vs plain (clamp surface and hole mode): "
        "bit-equal at the rendezvous pool with path-sized ids (mixed, every id a hole, no "
        "hole) and at shifts 0, 1, -1, >= p, p = 1, ids -1 and past the pool, int32 pages, "
        "3-, 5-, 7- and 8-word rows; "
        f"paged_attention_shift vs plain: max abs err {errs['paged_attention_shift']:.3g} "
        f"(tol {TOL}) at the path's ids and at masked pages, a fully masked row, Sq = 4 "
        "causal, shifts 0, -1, >= p, p = 1, and k = 128 with one valid rank at shifts "
        "0, 1, -1, 9")
    return errs


def time_pull_kernels(torch, F, pa_ops, pa_ref, pg_ops, pg_ref, rpg, Mesh, run, ops_run,
                      errs: dict, hbm: float) -> list:
    """Kernel, plain version, library yardstick and bytes bound at the
    rendezvous path's inputs (the busiest shift's ids)."""
    cfg, pool = run["cfg"], run["pool"]
    p, n_pages = pool.shape[0], pool.shape[1]
    mesh = Mesh(p, "serve", device="cuda")
    w = pool[0, 0].numel()
    # the gather: the shift with the most pulled pages on the busiest step
    owner, page = run["entries"][..., 0].long(), run["entries"][..., 1]
    me = torch.arange(p, device="cuda")[:, None, None]
    want = run["valid"][..., None] & (page >= 0)
    s = max(ops_run["shifts"], key=lambda t: int((want & (owner == (me + t) % p)).sum()))
    hit = want & (owner == (me + s) % p)
    ids = torch.where(hit, page, torch.full_like(page, -1)).reshape(p, -1).contiguous()
    k = ids.shape[1]
    flat = pool.view(p * n_pages, w)
    src = ((torch.arange(p, device="cuda")[:, None] + s) % p) * n_pages
    rows = (src + ids.clamp(0, n_pages - 1)).reshape(-1)
    # this run's data: every output row written once, each distinct pool row
    # read once (the holes all clamp to row 0 of their owner)
    g_bytes = (p * k + rows.unique().numel()) * w * 4 + ids.numel() * 4
    gather = (lambda: pg_ops.paged_gather(pool, ids, s, mesh),
              lambda: pg_ref.paged_gather_ref(pool, ids, s, mesh),
              lambda: flat.index_select(0, rows), (g_bytes, 0),
              f"pool {tuple(pool.shape)}, ids {tuple(ids.shape)}, shift {s}, "
              f"{int(hit.sum())} pulled pages")
    # attention: the path's call with the most valid pages
    (a_s, _), a_ids = max(ops_run["att_ids"].items(), key=lambda kv: int((kv[1] >= 0).sum()))
    q = run["params"]["w_q"].expand(p, 1, cfg.d_model).contiguous()
    pt, hd = cfg.page_tokens, cfg.d_model
    valid_pages = int((a_ids >= 0).sum())
    a_src = ((torch.arange(p, device="cuda")[:, None] + a_s) % p) * n_pages
    kv_rows = pool.view(p * n_pages, pt, 2, hd)[(a_src + a_ids.clamp(min=0)).reshape(-1)]
    kv_rows = kv_rows.reshape(p, -1, pt, 2, hd)
    k_all = kv_rows[:, :, :, 0].reshape(p, 1, -1, hd)
    v_all = kv_rows[:, :, :, 1].reshape(p, 1, -1, hd)
    mask = (a_ids >= 0).repeat_interleave(pt, dim=1)[:, None, None, :]
    q4 = q[:, None]
    a_bytes = valid_pages * pt * 2 * hd * 4 + 2 * q.numel() * 4 + a_ids.numel() * 4
    a_flops = 4 * valid_pages * pt * hd
    attend = (lambda: pa_ops.paged_attention_shift(q, pool, a_ids, a_s, mesh, scale=1.0),
              lambda: pa_ref.paged_attention_shift_ref(q, pool, a_ids, a_s, mesh, scale=1.0),
              lambda: F.scaled_dot_product_attention(q4, k_all, v_all, attn_mask=mask,
                                                     scale=1.0),
              (a_bytes, a_flops), f"q {tuple(q.shape)}, pool {tuple(pool.shape)}, ids "
              f"{tuple(a_ids.shape)}, shift {a_s}, {valid_pages} valid pages")
    out = []
    for name, (kern, plain, lib, (nbytes, flops), what) in (
            ("paged_attention_shift", attend), ("paged_gather", gather)):
        k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        row = {}
        if name == "paged_attention_shift":
            row["device_ms"] = device_ms(kern, "paged_attention_split")
        else:
            row = time_gather_shift(torch, pg_ops, pg_ref, rpg, mesh, pool, ids, s, flat, rows,
                                    hbm, k_ms)
        bound, bound_by = max((nbytes / hbm * 1e3, "bytes"),
                              (flops / F32_FLOPS_PER_S * 1e3, "operations"))
        dev = f" (device {row['device_ms'] * 1e3:.2f} us)" if row else ""
        log(f"{name} at {what}: kernel {k_ms * 1e3:.1f} us{dev}, plain {p_ms * 1e3:.1f} us, "
            f"library {l_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({bound_by}: "
            f"{nbytes} bytes, {flops} flops)")
        out.append({"name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
                    "replaces": KERNELS[name][2], "launches": ops_run["launches"][name],
                    "max_abs_err": errs[name], "ms": k_ms, **row, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms})
    return out


def time_gather_shift(torch, pg_ops, pg_ref, rpg, mesh, pool, ids, s, flat, rows,
                      hbm: float, clamp_ms: float) -> dict:
    """Row 3 beyond its clamp surface, at the pull's inputs: its device time,
    and `rmem.pages.gather_shift`
    (one launch in hole mode) against its library pair (`index_select`,
    then `masked_fill_` of the holes) and its bound: every output row
    written once, each distinct valid row read once, the ids.  Returns the
    kernels line's extra keys."""
    p, k, w = ids.shape[0], ids.shape[1], flat.shape[1]
    hole = (ids < 0).reshape(-1, 1)
    valid = int((~hole).sum())
    gs_bytes = (p * k + rows[~hole[:, 0]].unique().numel()) * w * 4 + ids.numel() * 4
    gs_bound = gs_bytes / hbm * 1e3
    t = {"device_ms": device_ms(lambda: pg_ops.paged_gather(pool, ids, s, mesh), "gather_rows"),
         "gather_shift_device_ms": device_ms(
             lambda: pg_ops.paged_gather(pool, ids, s, mesh, holes=True), "gather_rows")}
    before = pg_ops.launches
    t["gather_shift_ms"] = time_ms(lambda: rpg.gather_shift(mesh, pool, ids, s))
    if pg_ops.launches - before != 53:                   # 3 warm-up + 50 timed calls
        raise AssertionError(f"gather_shift: {pg_ops.launches - before} launches in 53 calls")
    t["gather_shift_library_ms"] = time_ms(lambda: flat.index_select(0, rows).masked_fill_(hole, 0))
    t["gather_shift_bound_ms"] = gs_bound
    log(f"paged_gather at the pull's inputs ({card_line()}): clamp surface {clamp_ms * 1e3:.1f} "
        f"us (device {t['device_ms'] * 1e3:.2f} us); gather_shift (hole mode, one launch) "
        f"{t['gather_shift_ms'] * 1e3:.1f} us (device {t['gather_shift_device_ms'] * 1e3:.2f} "
        f"us); index_select + masked_fill_ {t['gather_shift_library_ms'] * 1e3:.1f} us; bound "
        f"{gs_bound * 1e3:.2f} us ({gs_bytes} bytes: {p * k} rows written, {valid} valid)")
    return t


def rendezvous_phases(torch, F, disagg, fused_tokens: dict, fused_ms: float,
                      hbm: float) -> list:
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.paged_gather import ref as pg_ref
    from repro_torch.mesh import Mesh
    from repro_torch.rmem import pages as rpg

    run = rendezvous_serve(torch, disagg, fused_tokens, fused_ms)
    torch.cuda.empty_cache()
    auto_phase(torch, disagg)
    cancel_phase(torch, disagg)
    torch.cuda.empty_cache()
    ops_run = pull_ops_phase(torch, pa_ops, pg_ops, rpg, Mesh, run)
    errs = check_pull_kernels(torch, pa_ops, pa_ref, pg_ops, pg_ref, Mesh, run, ops_run)
    errs["paged_attention_shift"] = max(errs["paged_attention_shift"], ops_run["ctx_err"])
    rows = time_pull_kernels(torch, F, pa_ops, pa_ref, pg_ops, pg_ref, rpg, Mesh, run,
                             ops_run, errs, hbm)
    del run
    return rows


# ------------------------------------------------------- the one-sided layer
def zero_rma_launches(rma_ops) -> None:
    for k in rma_ops.launches:
        rma_ops.launches[k] = 0


@contextlib.contextmanager
def plain_route(plan_mod):
    """Sends every plan group through the plain PyTorch put (the mesh), for
    a comparison timing only: the counted runs never use it."""
    real = plan_mod._route
    plan_mod._route = lambda sig, ops, pack, backend: "torch"
    try:
        yield
    finally:
        plan_mod._route = real


def milc_phase(torch, plan_mod, epoch_mod, rma_ops, milc, Mesh, OpCounter) -> dict:
    """The MILC halo stencil at p=131,072 as a user calls it, checked and
    counted step by step; then timed, beside the plain put route."""
    mesh = Mesh(MILC_P, "t", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    lat = torch.randn((MILC_P,) + MILC_LOCAL, device="cuda", generator=g)
    log(f"milc: lattice {tuple(lat.shape)} f32, {lat.numel() * 4 / 2**30:.2f} GiB, "
        f"halo {lat[:, :1].numel() * 4 / 2**20:.0f} MiB each way")

    zero_rma_launches(rma_ops)
    v, err = lat, 0.0
    for step in range(MILC_STEPS):
        before = dict(rma_ops.launches)
        with OpCounter() as c, opened_epochs(epoch_mod) as eps:
            out = milc.stencil_step(v, mesh)
        want = milc.stencil_reference(v)
        e = float((out - want).abs().max())
        if not torch.isfinite(out).all() or e > MILC_TOL:
            raise AssertionError(f"milc step {step}: max abs err {e} > {MILC_TOL}")
        err = max(err, e)
        got = rma_ops.launches["put_shift"] - before["put_shift"]
        counts = (c.puts, c.raw_msgs, c.coalesced_msgs)
        sync = [(ep.stats.post_msgs, ep.stats.complete_msgs) for ep in eps]
        if got != 2 or counts != (2, 2, 2) or sync != [(2, 2)]:
            raise AssertionError(
                f"milc step {step}: {got} put_shift launches, puts/raw/coalesced "
                f"{counts}, PSCW post/complete {sync}; want 2, (2, 2, 2), [(2, 2)]")
        del want
        v = out * 0.0625                     # keep magnitudes O(1); exact in f32
    milc_launches = dict(rma_ops.launches)
    if milc_launches["put_shift"] != 2 * MILC_STEPS:
        raise AssertionError(f"milc: {milc_launches} launches in {MILC_STEPS} steps")
    log(f"milc: {MILC_STEPS} steps, max abs err {err:.3g} (tol {MILC_TOL}), "
        f"put_shift launches {milc_launches['put_shift']} (want {2 * MILC_STEPS}), "
        f"per step OpCounter puts/raw/coalesced 2/2/2 and SyncStats post/complete 2/2")

    cuda_ms = time_steps(torch, milc, mesh, lat)
    before = rma_ops.launches["put_shift"]
    with plain_route(plan_mod):
        torch_ms = time_steps(torch, milc, mesh, lat)
    if rma_ops.launches["put_shift"] != before:
        raise AssertionError("the plain put route launched the kernel")
    log(f"milc ms/step: {cuda_ms:.3f} through the put kernel, {torch_ms:.3f} "
        f"through the plain put")
    return {"launches": milc_launches, "err": err, "lat": lat, "mesh": mesh}


@contextlib.contextmanager
def opened_epochs(epoch_mod):
    """Collects the PSCW epochs the app opens inside the block, so their
    SyncStats can be read after the step."""
    seen = []
    real = epoch_mod.PSCWEpoch.__init__

    def tap(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self)

    epoch_mod.PSCWEpoch.__init__ = tap
    try:
        yield seen
    finally:
        epoch_mod.PSCWEpoch.__init__ = real


def time_steps(torch, milc, mesh, lat, n: int = MILC_STEPS) -> float:
    milc.stencil_step(lat, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        milc.stencil_step(lat, mesh)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def all_reduce_phase(torch, plan_mod, rma_ops, collectives, Mesh) -> dict:
    mesh = Mesh(AR_P, "dp", device="cuda")
    n = AR_MIB * 2**20 // 4
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(AR_P, n, device="cuda", generator=g)
    want = x.sum(0)
    expected = (AR_P - 1) + 2 * -(-(AR_P - 1) // 2)
    zero_rma_launches(rma_ops)
    out = collectives.all_reduce(x, mesh)
    torch.cuda.synchronize()
    launches = dict(rma_ops.launches)
    t0 = time.perf_counter()
    collectives.all_reduce(x, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rel = float((out - want).abs().max() / want.abs().max())
    if not torch.isfinite(out).all() or rel > AR_TOL:
        raise AssertionError(f"all_reduce: rel err {rel} > {AR_TOL}")
    if launches["put_shift"] != expected:
        raise AssertionError(f"all_reduce: {launches['put_shift']} put_shift launches, "
                             f"want {expected}")
    log(f"all_reduce p={AR_P} x {AR_MIB} MiB f32: rel err {rel:.3g} (tol {AR_TOL}), "
        f"put_shift launches {launches['put_shift']} (expected (p-1) + 2*ceil((p-1)/2) "
        f"= {expected}), {ms:.3f} ms")
    return {"launches": launches, "x": x, "mesh": mesh}


def ops_phase(torch, rma_ops, collectives, milc_run, ar_run) -> dict:
    """The `kernels.rma.ops` surface on the main paths' data, each result
    against the RMA schedule's own."""
    mesh, lat = milc_run["mesh"], milc_run["lat"]
    want = collectives.halo_exchange_1d(lat, 1, mesh, dim=0)
    zero_rma_launches(rma_ops)
    lo = rma_ops.get_shift(lat[:, :1], +1, mesh)       # the right neighbour's low slice
    hi = rma_ops.get_shift(lat[:, -1:], -1, mesh)      # the left neighbour's high slice
    acc = rma_ops.accumulate_shift(lat[:, -1:], lat[:, :1], +1, mesh)
    armesh = ar_run["mesh"]
    shard = ar_run["x"].reshape(AR_P, AR_P, -1)[:, 0].contiguous()
    gathered = rma_ops.ring_all_gather(shard, armesh)
    torch.cuda.synchronize()
    launches = dict(rma_ops.launches)
    if not (torch.equal(hi, want[:, :1]) and torch.equal(lo, want[:, -1:])):
        raise AssertionError("get-based halo pull differs from the put-based exchange")
    if not torch.equal(acc, lat[:, :1] + want[:, :1]):
        raise AssertionError("accumulate_shift differs from the boundary sum")
    if not torch.equal(gathered, collectives.ring_all_gather(shard, armesh)):
        raise AssertionError("ring_all_gather kernel differs from the RMA schedule")
    if min(launches[k] for k in ("get_shift", "accumulate_shift", "ring_all_gather")) == 0:
        raise AssertionError(f"ops path: {launches}")
    log(f"ops surface: get_shift {launches['get_shift']}, accumulate_shift "
        f"{launches['accumulate_shift']}, ring_all_gather {launches['ring_all_gather']} "
        f"launches; equal to the schedules' results")
    return {"launches": launches}


def check_rma(torch, rma_ops, ref, Mesh) -> dict:
    """Every rma kernel against its plain version, which it must equal bit
    for bit; returns each kernel's max abs error (0.0 when bit-equal)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    halo = torch.randn((MILC_P,) + MILC_LOCAL, device="cuda", generator=g)[:, -1:]
    chunk = torch.randn(AR_P, AR_MIB * 2**20 // 4 // AR_P, device="cuda", generator=g)
    odd = torch.randn(5, 3, 7, device="cuda", generator=g)        # 21 words a rank
    ints = torch.randint(-2**31, 2**31 - 1, (6, 8), device="cuda", generator=g,
                         dtype=torch.int32)
    one = torch.randn(1, 4, 3, device="cuda", generator=g)
    errs = dict.fromkeys(rma_ops.launches, 0.0)

    def compare(name, got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version at {what}")
        errs[name] = max(errs[name], float((got.double() - want.double()).abs().max()))

    inner = torch.randn(6, 4, 8, device="cuda", generator=g)[:, :, :3]   # copied
    for x, shifts in ((halo, (1, -1)), (chunk, (1, -1, 0, AR_P + 3)),
                      (odd, (0, 1, -1, 7, -12)), (ints, (2, -1)), (one, (0, 1, -1)),
                      (inner, (1, -2))):
        mesh = Mesh(x.shape[0], "x", device="cuda")
        for s in shifts:
            what = f"{tuple(x.shape)} {x.dtype} shift {s}"
            compare("put_shift", rma_ops.put_shift(x, s, mesh), ref.put_shift_ref(x, s, mesh), what)
            compare("get_shift", rma_ops.get_shift(x, s, mesh), ref.get_shift_ref(x, s, mesh), what)
            if x.dtype == torch.float32:
                acc = torch.randn(x.shape, device="cuda", generator=g)
                compare("accumulate_shift", rma_ops.accumulate_shift(x, acc, s, mesh),
                        ref.accumulate_shift_ref(x, acc, s, mesh), what)
        if x.shape[0] * x.numel() <= 2**28:
            compare("ring_all_gather", rma_ops.ring_all_gather(x, mesh),
                    ref.ring_all_gather_ref(x, mesh), f"{tuple(x.shape)} {x.dtype}")
    torch.cuda.synchronize()
    log("rma kernels vs plain: bit-equal at the halo and all-reduce chunk shapes and "
        f"at shifts 0, -1, >= p, p = 1, 21-word rows, int32, a non-contiguous rank "
        f"block; max abs err {errs}")
    return errs


def model_constants(torch, rma_ops, Mesh) -> dict:
    """The H100 model's measured constants (PERF.md cites them)."""
    tiny = torch.zeros(1, device="cuda")
    lat_torch = time_ms(lambda: tiny.add_(1.0), reps=2000, warmup=50) * 1e-3
    m1 = Mesh(1, "x", device="cuda")
    word = torch.zeros(1, 4, device="cuda")
    lat_kernel = time_ms(lambda: rma_ops.put_shift(word, 1, m1), reps=2000, warmup=50) * 1e-3
    ev = torch.cuda.Event()
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        ev.record()
        stream.wait_event(ev)
    torch.cuda.synchronize()
    event = (time.perf_counter() - t0) / 1000
    src = torch.empty(2**28, device="cuda")              # 1 GiB
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), reps=20)
    del src, dst
    out = {"launch_latency": lat_torch, "event_latency": event,
           "copy_bandwidth": 2 * 2**30 / (copy_ms * 1e-3)}
    log("model constants measured: " + ", ".join(f"{k} {v:.6g}" for k, v in out.items())
        + f"; a csrc kernel's ctypes launch {lat_kernel:.6g} s "
        f"({lat_kernel / lat_torch:.2f}x the torch op)")
    return out


def launch_breakdown(torch, common, rma_ops, rmaq_ops, Mesh, n: int = 10_000) -> dict:
    """One call of `rma.ops.put_shift` (a one-word put, p = 1, the launch
    figure of `model_constants`) and of `rmaq.ops.notify_accumulate` (the
    DSDE doorbell's p = 4096) cut into its parts, each timed alone on the
    host over n calls with `time.perf_counter_ns`: the argument checks, the
    rank-block test, the output's allocation, the stream lookup, the entry's
    binding, the ctypes call without a launch (a zero-size call returns
    before it) and cudaLaunchKernel (the call with a launch, less the call
    without).  Beside each part of the lean path stands the part as the
    path before it made it: ``x[0].is_contiguous()`` and ``x[0].numel()``,
    ``torch.empty(shape, dtype=, device=)``, a ``torch.cuda.Stream`` built
    to read ``.cuda_stream``, the build lock and the library's symbol
    lookup.  `rmaq.ops.queue_push` at the DSDE queue's p = 4096, k = 6 is
    timed whole, with its one [2, p] output beside the two outputs it made
    before.  Returns µs a call by part."""
    def per_call(fn):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        return (t1 - t0) / n / 1e3

    word = torch.zeros(1, 4, device="cuda")
    m1 = Mesh(1, "x", device="cuda")
    p = DSDE_P
    mp = Mesh(p, "x", device="cuda")
    cnt = torch.zeros(p, dtype=torch.int32, device="cuda")
    local = torch.zeros_like(cnt)
    tiny = torch.zeros(1, device="cuda")
    dev = word.get_device()
    stream = common.current_stream(dev)
    out1, outp = torch.empty_like(word), torch.empty_like(cnt)
    ring = torch.zeros(p, 64, DSDE_D, device="cuda")       # fills: the host's part is the same
    ctr = torch.zeros(p, 2, dtype=torch.int32, device="cuda")
    msgs = torch.zeros(p, DSDE_K, DSDE_D, device="cuda")
    put, acc = rma_ops._PUT, rmaq_ops._ACC
    put(word.data_ptr(), out1.data_ptr(), 1, 4, 4, 1, stream)     # bound before timing
    acc(cnt.data_ptr(), local.data_ptr(), outp.data_ptr(), p, 1, stream)
    parts = {
        "torch op (tiny.add_)": lambda: tiny.add_(1.0),
        "put_shift: whole call": lambda: rma_ops.put_shift(word, 1, m1),
        "put_shift: checks": lambda: (rma_ops._on_card("put_shift", m1, word),
                                      word.dtype.itemsize, word.dtype.is_complex),
        "put_shift: rank block from strides": lambda: rma_ops._rows(word),
        "put_shift: rank block by x[0] views (before)": lambda: (
            word[0].is_contiguous(), word[0].numel(), word.stride(0)),
        "put_shift: output, empty_like": lambda: rma_ops._fresh(word),
        "put_shift: output, torch.empty(shape, dtype, device) (before)": lambda: torch.empty(
            word.shape, dtype=word.dtype, device=word.device),
        "stream: raw handle": lambda: common.current_stream(word.get_device()),
        "stream: torch.cuda.current_stream().cuda_stream (before)": lambda: (
            torch.cuda.current_stream().cuda_stream),
        "binding: the bound entry": lambda: put.fn,
        "binding: lock, library and symbol lookup (before)": lambda: (
            getattr(common.load("rma"), "rma_put_shift").argtypes is None),
        "put_shift: ctypes call, no launch": lambda: put.fn(
            word.data_ptr(), out1.data_ptr(), 1, 0, 0, 1, stream),
        "put_shift: ctypes call with the launch": lambda: put.fn(
            word.data_ptr(), out1.data_ptr(), 1, 4, 4, 1, stream),
        "notify_accumulate: whole call": lambda: rmaq_ops.notify_accumulate(cnt, local, 1, mp),
        "notify_accumulate: checks": lambda: (
            cnt.shape != (p,) or local.shape != (p,),
            rma_ops._on_card("notify_accumulate", mp, cnt, local),
            cnt.dtype != torch.int32 or local.dtype != torch.int32,
            cnt.contiguous(), local.contiguous()),
        "notify_accumulate: output, empty_like": lambda: torch.empty_like(local),
        "notify_accumulate: ctypes call, no launch": lambda: acc.fn(
            cnt.data_ptr(), local.data_ptr(), outp.data_ptr(), 0, 1, stream),
        "notify_accumulate: ctypes call with the launch": lambda: acc.fn(
            cnt.data_ptr(), local.data_ptr(), outp.data_ptr(), p, 1, stream),
        "queue_push: whole call": lambda: rmaq_ops.queue_push(ring, ctr, msgs, 1, mp),
        "queue_push: output, one [2, p] new_empty and its rows": lambda: (
            ctr.new_empty((2, p)).unbind()),
        "queue_push: outputs, torch.empty + empty_like (before)": lambda: torch.empty_like(
            torch.empty(p, dtype=torch.int32, device=ctr.device)),
    }
    us = {name: per_call(fn) for name, fn in parts.items()}
    for op in ("put_shift", "notify_accumulate"):
        us[f"{op}: cudaLaunchKernel (with - without)"] = (
            us[f"{op}: ctypes call with the launch"] - us[f"{op}: ctypes call, no launch"])
    log(f"launch breakdown ({card_line()}; host µs a call, {n} calls each, "
        "perf_counter_ns): " + "; ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


def time_rma(torch, rma_ops, ref, Mesh, launches: dict, errs: dict, hbm: float) -> list:
    """Kernel, plain, yardsticks and bound at the main paths' inputs: the
    halo views as the stencil passes them, the all-reduce's shards."""
    g = torch.Generator(device="cuda").manual_seed(3)
    mesh = Mesh(MILC_P, "t", device="cuda")
    lat = torch.randn((MILC_P,) + MILC_LOCAL, device="cuda", generator=g)
    halo, acc = lat[:, -1:], lat[:, :1]          # read in place at the rank stride
    hbytes = halo.numel() * 4
    dst = (torch.arange(MILC_P, device="cuda") + 1) % MILC_P
    armesh = Mesh(AR_P, "dp", device="cuda")
    shard = torch.randn(AR_P, AR_MIB * 2**20 // 4 // AR_P, device="cuda", generator=g)
    sbytes = shard.numel() * 4

    def copy_like(nbytes):
        a = torch.empty(nbytes // 4, device="cuda")
        b = torch.empty_like(a)
        return time_ms(lambda: b.copy_(a))

    # name -> (kernel, plain, library call, bytes read + written, output bytes)
    rows = {
        "put_shift": (lambda: rma_ops.put_shift(halo, 1, mesh),
                      lambda: ref.put_shift_ref(halo, 1, mesh),
                      lambda: torch.roll(halo, 1, 0), 2 * hbytes, hbytes),
        "get_shift": (lambda: rma_ops.get_shift(halo, 1, mesh),
                      lambda: ref.get_shift_ref(halo, 1, mesh),
                      lambda: torch.roll(halo, -1, 0), 2 * hbytes, hbytes),
        "accumulate_shift": (lambda: rma_ops.accumulate_shift(halo, acc, 1, mesh),
                             lambda: ref.accumulate_shift_ref(halo, acc, 1, mesh),
                             lambda: acc.index_add(0, dst, halo), 3 * hbytes, hbytes),
        "ring_all_gather": (lambda: rma_ops.ring_all_gather(shard, armesh),
                            lambda: ref.ring_all_gather_ref(shard, armesh),
                            lambda: shard.unsqueeze(0).expand((AR_P,) + tuple(shard.shape)).contiguous(),
                            sbytes + AR_P * sbytes, AR_P * sbytes),
    }
    copied_ms = time_ms(lambda: rma_ops.put_shift(halo.contiguous(), 1, mesh))
    log(f"put_shift on a contiguous copy of the halo view (copy + kernel): "
        f"{copied_ms * 1e3:.1f} us")
    out = []
    for name, (kern, plain, lib, nbytes, out_bytes) in rows.items():
        k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        c_ms = copy_like(out_bytes)
        bound = nbytes / hbm * 1e3
        log(f"{name}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, library "
            f"{l_ms * 1e3:.1f} us, copy_ of the output bytes {c_ms * 1e3:.1f} us, bound "
            f"{bound * 1e3:.1f} us (bytes {nbytes})")
        out.append({"name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
                    "replaces": KERNELS[name][2], "launches": launches[name],
                    "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": "bytes", "library_ms": l_ms})
    return out


def rma_phases(torch) -> list:
    from repro_torch.apps import milc
    from repro_torch.core import collectives
    from repro_torch.core import epoch as epoch_mod
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.perfmodel import H100, HardwareSpec, PerfModel
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels import common
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref
    from repro_torch.kernels.rmaq import ops as rmaq_ops
    from repro_torch.mesh import Mesh

    milc_run = milc_phase(torch, plan_mod, epoch_mod, rma_ops, milc, Mesh, OpCounter)
    ar_run = all_reduce_phase(torch, plan_mod, rma_ops, collectives, Mesh)
    ops_run = ops_phase(torch, rma_ops, collectives, milc_run, ar_run)
    # each path's counts were zeroed before it and read after it
    launches = {k: sum(run["launches"][k] for run in (milc_run, ar_run, ops_run))
                for k in rma_ops.launches}
    del milc_run, ar_run
    torch.cuda.empty_cache()

    errs = check_rma(torch, rma_ops, ref, Mesh)
    torch.cuda.empty_cache()
    consts = model_constants(torch, rma_ops, Mesh)
    launch_breakdown(torch, common, rma_ops, rmaq_ops, Mesh)
    rows = time_rma(torch, rma_ops, ref, Mesh, launches, errs, H100.hbm_bandwidth)
    log("model constants, measured vs spec: " + ", ".join(
        f"{k} {v:.4g}/{getattr(H100, k):.4g}" for k, v in consts.items()))
    model = PerfModel(HardwareSpec(**consts))
    log(f"model on these constants: aggregation crossover "
        f"{model.aggregation_crossover_bytes():.0f} B (spec: "
        f"{plan_mod.DEFAULT_MODEL.aggregation_crossover_bytes():.0f} B), "
        f"choose_sync(2, {MILC_P}) {epoch_mod.choose_sync(2, MILC_P, model)}")
    return rows


# ------------------------------------------- notified access and DSDE
def plain_exchange(np, data, tg, cap_pair: int) -> dict:
    """The DSDE exchange in plain numpy: item j of rank r goes to rank
    tg[r, j]; its position among r's items for that target is its program
    order.  Returns the per-pair counts [dst, src], the slotted layout's
    (target, slot) of every kept item, the items in the queue's arrival
    order (target, then producer rank, then program order) and the drops."""
    p, k = tg.shape
    src = np.repeat(np.arange(p), k)
    dst = tg.reshape(-1).astype(np.int64)
    items = data.reshape(p * k, -1)
    pos = np.zeros(p * k, np.int64)
    seen: dict = {}
    for i, key in enumerate(zip(src.tolist(), dst.tolist())):
        pos[i] = seen.get(key, 0)
        seen[key] = pos[i] + 1
    counts = np.zeros((p, p), np.int64)
    np.add.at(counts, (dst, src), 1)
    keep = pos < cap_pair
    order = np.lexsort((np.arange(p * k), src, dst))        # dst, src, program
    return {"counts": counts, "dst": dst[keep], "slot": (src * cap_pair + pos)[keep],
            "items": items[keep], "dropped": np.bincount(src[~keep], minlength=p),
            "arrival_dst": dst[order], "arrival_items": items[order]}


def check_exchange(torch, np, name: str, res, want: dict, ring_cap: int) -> None:
    """One protocol's result against the plain exchange: every item at its
    slot (the slotted protocols) or in arrival order (the queue), the
    per-pair or total counts, nothing dropped that should not be."""
    p = want["counts"].shape[0]
    valid = res.recv_valid
    t_idx, s_idx = (a.cpu().numpy() for a in valid.nonzero(as_tuple=True))
    got = res.recv_data[valid].cpu().numpy()
    if name == "exchange_queue":
        if not (want["counts"].sum(1) <= ring_cap).all():
            raise AssertionError("the DSDE traffic overflows the queue's ring")
        ok = (np.array_equal(t_idx, want["arrival_dst"])
              and np.array_equal(got.view(np.uint32), want["arrival_items"].view(np.uint32))
              and int(res.sent_dropped.sum()) == 0)
    else:
        order = np.lexsort((want["slot"], want["dst"]))
        ok = (np.array_equal(t_idx, want["dst"][order])
              and np.array_equal(s_idx, want["slot"][order])
              and np.array_equal(got.view(np.uint32), want["items"][order].view(np.uint32))
              and np.array_equal(res.sent_dropped.cpu().numpy(), want["dropped"]))
    counts = res.recv_counts.cpu().numpy()
    if name == "exchange_reduce_scatter_baseline":
        ok = ok and np.array_equal(counts, np.repeat(want["counts"].sum(1)[:, None], p, 1))
    else:
        ok = ok and np.array_equal(counts, want["counts"])
    if not ok:
        raise AssertionError(f"{name}: differs from the plain numpy exchange")


def dsde_phase(torch, np, dsde, overlap, rq, Mesh, OpCounter) -> dict:
    """The four DSDE protocols at p = DSDE_P through `core.dsde`, each held
    to the plain numpy exchange, with their ledgers, times and the model's
    dispatch choice.  Keeps what the kernel phase runs on."""
    p, k, d, cap_pair = DSDE_P, DSDE_K, DSDE_D, DSDE_CAP
    mesh = Mesh(p, "x", device="cuda")
    rng = np.random.default_rng(DSDE_SEED)
    data_np = rng.standard_normal((p, k, d)).astype(np.float32)
    tg_np = rng.integers(0, p, (p, k)).astype(np.int32)
    data, tg = torch.from_numpy(data_np).cuda(), torch.from_numpy(tg_np).cuda()
    want = plain_exchange(np, data_np, tg_np, cap_pair)
    ring_cap = 1 << (p * cap_pair - 1).bit_length()
    log(f"dsde: p={p}, k={k} items of {d} f32 a rank to uniform random targets, "
        f"capacity_per_pair={cap_pair} (slots [p, p*{cap_pair}, {d}] = "
        f"{p * p * cap_pair * d * 4 / 2**30:.2f} GiB), queue ring {ring_cap} rows a rank "
        f"({p * ring_cap * d * 4 / 2**30:.2f} GiB), max items into one rank "
        f"{int(want['counts'].sum(1).max())}")

    keep: dict = {}
    real_drain = rq.drain

    def tap(desc, state):            # the queue's state after the enqueue
        keep["queue"] = (desc, state.buf, state.ctrs.clone())
        return real_drain(desc, state)

    ms = {}
    torch.cuda.reset_peak_memory_stats()
    for name in DSDE_PROTOCOLS:
        fn = getattr(dsde, name)
        rq.drain = tap
        try:
            with OpCounter() as c:
                res = fn(data, tg, mesh, cap_pair)
                torch.cuda.synchronize()
        finally:
            rq.drain = real_drain
        check_exchange(torch, np, name, res, want, ring_cap)
        if name == "exchange_accumulate":
            keep["recv"] = (res.recv_data, res.recv_counts)
        del res
        plans = [(pl["raw"], pl["coalesced"], pl["bytes_wire"]) for pl in c.plans]
        log(f"dsde {name}: every item at its place, counts and drops equal to the plain "
            f"exchange; OpCounter {c.snapshot()}; plans (raw, coalesced, bytes_wire) {plans}")
        times = []
        for _ in range(DSDE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(data, tg, mesh, cap_pair)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = sorted(times)[len(times) // 2]
        torch.cuda.empty_cache()
    log("dsde ms/call (median of %d, CUDA-synchronised): " % DSDE_REPS
        + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where the queue exchange's time goes: the ring, the enqueue epoch, the drain
    split = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    desc, state = rq.queue_allocate(mesh, ring_cap, (d,), data.dtype)
    torch.cuda.synchronize()
    split["allocate"] = time.perf_counter() - t0
    state, _ = rq.enqueue(desc, state, data, tg)
    torch.cuda.synchronize()
    split["enqueue"] = time.perf_counter() - t0 - split["allocate"]
    rq.drain(desc, state)
    torch.cuda.synchronize()
    split["drain"] = time.perf_counter() - t0 - split["allocate"] - split["enqueue"]
    del desc, state
    log("dsde exchange_queue split (ms, one call): "
        + ", ".join(f"{n} {t * 1e3:.3f}" for n, t in split.items()))

    strat = overlap.CollectiveStrategist()
    args = (k, 4.0 * d, p, cap_pair)
    choice = strat.dispatch_plan(*args)
    faster = ("queue" if ms["exchange_queue"] < ms["exchange_alltoall_baseline"]
              else "alltoall")
    log(f"dispatch_plan{args} -> {choice}; measured faster: {faster} (queue "
        f"{ms['exchange_queue']:.3f} ms, alltoall {ms['exchange_alltoall_baseline']:.3f} ms); "
        f"{'the model chose the faster' if choice == faster else 'the model chose the slower'}"
        f"; at the reference test's (4, 256.0, 64, 32) -> {strat.dispatch_plan(4, 256.0, 64, 32)}"
        f", (2048, 256.0, 8, 4) -> {strat.dispatch_plan(2048, 256.0, 8, 4)}")
    if choice != faster:
        raise AssertionError(f"dispatch_plan{args} picks {choice}, the slower exchange")
    keep.update(mesh=mesh, data=data, counts=torch.from_numpy(want["counts"]).cuda())
    return keep


def queue_round(torch, rq, ops, ref, run: dict, ctrs, u32_to_wire) -> dict:
    """One queue_push round of every rank's k DSDE items to rank r + 1 on
    the DSDE ring with counters `ctrs`, through the kernel, its plain
    version and `queue.enqueue_shift` on copies of the same state."""
    desc, ring, _ = run["queue"]
    mesh, msgs = run["mesh"], run["data"]
    ctr = u32_to_wire(ctrs[:, [rq.HEAD, rq.TAIL]]).contiguous()
    k_ring, k_ctr, n_sent, n_notif = ops.queue_push(ring.clone(), ctr.clone(), msgs, 1, mesh)
    p_ring, p_ctr, p_sent, p_notif = ref.queue_push_ref(ring.clone(), ctr.clone(), msgs, 1,
                                                        mesh, desc.capacity)
    state, receipt = rq.enqueue_shift(desc, rq.QueueState(ring.clone(), ctrs.clone()), msgs, 1)
    torch.cuda.synchronize()
    notif = (state.ctrs[:, rq.NOTIF] - ctrs[:, rq.NOTIF]) & 0xFFFFFFFF
    same = (torch.equal(k_ring, p_ring) and torch.equal(k_ctr, p_ctr)
            and torch.equal(n_sent, p_sent) and torch.equal(n_notif, p_notif))
    like_queue = (torch.equal(k_ring, state.buf)
                  and torch.equal(k_ctr[:, 1], u32_to_wire(state.ctrs[:, rq.TAIL]))
                  and torch.equal(n_sent.long(), receipt.n_sent)
                  and torch.equal(n_notif.long(), notif))
    return {"plain": same, "queue": like_queue, "n_sent": n_sent, "ctr": k_ctr}


def rmaq_ops_phase(torch, rq, notify, ops, ref, run: dict, u32_to_wire) -> dict:
    """The three kernels through their ops surfaces on the DSDE run's data,
    counts zeroed before and read after; each result held to its plain
    version and to the protocol it stands for."""
    mesh, p, k = run["mesh"], DSDE_P, DSDE_K
    recv, recv_counts = run["recv"]
    _, ring, ctrs = run["queue"]
    cap = ring.shape[1]
    cnt = recv_counts.sum(1, dtype=torch.int32)            # items each rank received
    send_counts = run["counts"].t().contiguous().to(torch.int32)   # [src, dst]
    to_next = send_counts[torch.arange(p, device="cuda"), (torch.arange(p, device="cuda") + 1) % p]
    local = u32_to_wire(ctrs[:, rq.NOTIF])
    # the wrapping round: every tail rebased to 2**32 - 2 (= cap - 2 mod cap),
    # occupancy kept, so k = 6 slots wrap the ring and the counter
    wrap = ctrs.clone()
    wrap[:, rq.HEAD] = (ctrs[:, rq.HEAD] + (2**32 - 2) - ctrs[:, rq.TAIL]) & 0xFFFFFFFF
    wrap[:, rq.TAIL] = 2**32 - 2
    # the backpressured round: every even rank's ring left 3 slots free
    bp = ctrs.clone()
    even = torch.arange(0, p, 2, device="cuda")
    bp[even, rq.HEAD] = (ctrs[even, rq.TAIL] - (cap - 3)) & 0xFFFFFFFF

    for key in ops.launches:
        ops.launches[key] = 0
    y, c = ops.notified_put(recv, cnt, 1, mesh)
    acc = ops.notify_accumulate(to_next, local, 1, mesh)
    rounds = {"wrap": queue_round(torch, rq, ops, ref, run, wrap, u32_to_wire),
              "backpressure": queue_round(torch, rq, ops, ref, run, bp, u32_to_wire)}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    want = {"notified_put": 1, "notify_accumulate": 1, "queue_push": 2}
    if launches != want:
        raise AssertionError(f"rmaq ops on the DSDE data: launches {launches}, want {want}")

    py, pc = ref.notified_put_ref(recv, cnt, 1, mesh)
    ny, _ = notify.notified_put_shift(recv, torch.zeros(p, dtype=torch.int64, device="cuda"),
                                      1, mesh)
    if not (torch.equal(y, py) and torch.equal(c, pc) and torch.equal(y, ny)):
        raise AssertionError("notified_put differs from its plain version or from "
                             "notify.notified_put_shift on the receive blocks")
    del py, ny
    landed = notify.accumulate_counts(send_counts, mesh)        # [dst, src]
    back = (torch.arange(p, device="cuda") - 1) % p
    doorbell = (local.long() + landed[torch.arange(p, device="cuda"), back]).to(torch.int32)
    if not (torch.equal(acc, ref.notify_accumulate_ref(to_next, local, 1, mesh))
            and torch.equal(acc, doorbell)):
        raise AssertionError("notify_accumulate differs from its plain version or from "
                             "accumulate_counts restricted to the shift")
    for name, r in rounds.items():
        if not (r["plain"] and r["queue"]):
            raise AssertionError(f"queue_push {name} round: equal to plain {r['plain']}, "
                                 f"to enqueue_shift {r['queue']}")
    wrapped = int(((wrap[:, rq.TAIL] % cap) + rounds["wrap"]["n_sent"].long() > cap).sum())
    held = int((rounds["backpressure"]["n_sent"] < k).sum())
    if wrapped == 0 or held == 0:
        raise AssertionError(f"queue_push rounds: {wrapped} rings wrapped, {held} held back")
    log(f"rmaq ops on the DSDE data: notified_put of the receive blocks "
        f"{tuple(recv.shape)} bit-equal to plain and to notify.notified_put_shift; "
        f"notify_accumulate of the send counts into NOTIF bit-equal to plain and to "
        f"accumulate_counts at shift 1; queue_push wrap round (tails from 2**32 - 2, "
        f"{wrapped} rings wrapped) and backpressure round ({held} producers held below "
        f"k={k}) bit-equal to plain and to queue.enqueue_shift; launches {launches}")
    return {"launches": launches, "recv": recv, "cnt": cnt, "to_next": to_next,
            "local": local}


def check_rmaq(torch, ops, ref, Mesh) -> dict:
    """Each rmaq kernel against its plain version at edge cases (shift 0,
    -1, >= p, p = 1, rows that are not whole 16-byte vectors, counters past
    2**31 and 2**32, a full ring): bit-equal; returns max abs errors."""
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = dict.fromkeys(ops.launches, 0.0)

    def compare(name, got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} differs from its plain version at {what}")
            errs[name] = max(errs[name], float((a.double() - b.double()).abs().max())
                             if a.numel() else 0.0)

    for p, shape in ((5, (3, 7)), (1, (4, 3)), (64, (16,))):
        mesh = Mesh(p, "x", device="cuda")
        x = torch.randn((p,) + shape, device="cuda", generator=g)
        cnt = torch.randint(-2**31, 2**31 - 1, (p,), device="cuda", generator=g,
                            dtype=torch.int32)
        for s in (0, 1, -1, p + 2):
            what = f"p={p} {shape} shift {s}"
            compare("notified_put", ops.notified_put(x, cnt, s, mesh),
                    ref.notified_put_ref(x, cnt, s, mesh), what)
            compare("notify_accumulate", (ops.notify_accumulate(cnt, cnt, s, mesh),),
                    (ref.notify_accumulate_ref(cnt, cnt, s, mesh),), what)
            for used, tail in ((0, 2**31 - 3), (5, 2**32 - 2), (8, 7)):
                buf = torch.randn(p, 8, 3, device="cuda", generator=g)
                t = torch.full((p,), tail, dtype=torch.int64, device="cuda")
                ctr = torch.stack([(t - used) & 0xFFFFFFFF, t], 1).to(torch.int32)
                msgs = torch.randn(p, 6, 3, device="cuda", generator=g)
                compare("queue_push", ops.queue_push(buf.clone(), ctr.clone(), msgs, s, mesh),
                        ref.queue_push_ref(buf.clone(), ctr.clone(), msgs, s, mesh, 8),
                        f"{what} used {used} tail {tail}")
    # notify_accumulate's two runs, its 16-byte vectors (local and out at an
    # aligned pointer; cnt too where off and p are multiples of 4) and its
    # single words (a pointer 1 or 3 words past a 16-byte boundary)
    for p in (1, 5, 4096, 4099):
        mesh = Mesh(p, "x", device="cuda")
        for lead_c, lead_l in ((0, 0), (1, 0), (1, 3)):
            cnt = torch.randint(-2**31, 2**31 - 1, (p + lead_c,), device="cuda", generator=g,
                                dtype=torch.int32)[lead_c:]
            local = torch.randint(-2**31, 2**31 - 1, (p + lead_l,), device="cuda", generator=g,
                                  dtype=torch.int32)[lead_l:]
            for s in (0, 1, -1, 4, p + 3):
                compare("notify_accumulate", (ops.notify_accumulate(cnt, local, s, mesh),),
                        (ref.notify_accumulate_ref(cnt, local, s, mesh),),
                        f"p={p} shift {s} pointer offsets {lead_c}, {lead_l} words")
    torch.cuda.synchronize()
    log("rmaq kernels vs plain: bit-equal at shifts 0, 1, -1, >= p, p = 1, 7- and 3-word "
        f"rows, tails past 2**31 and 2**32, a full ring; notify_accumulate at p = 1, 5, "
        f"4096, 4099, shifts 0, 1, -1, 4, p + 3, int32 sums past 2**31, cnt and local at "
        f"aligned and unaligned pointers; max abs err {errs}")
    return errs


def launch_floor_ms(torch, ops, Mesh) -> float:
    """The port's smallest launch: `notify_accumulate` at p = 1 (12 bytes),
    its device time a call queued behind a spin kernel: the yardstick of a
    launch-bound row."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    m1 = Mesh(1, "x", device="cuda")
    return queued_ms(lambda: ops.notify_accumulate(one, one, 1, m1))


def time_rmaq(torch, rq, ops, ref, run: dict, ops_run: dict, errs: dict, hbm: float,
              u32_to_wire, Mesh) -> list:
    """Kernel, plain, library call and bound at the DSDE run's inputs; the
    device time a call queued (rows 9 and 10) beside the launch floor."""
    mesh, p = run["mesh"], DSDE_P
    recv, cnt = ops_run["recv"], ops_run["cnt"]
    to_next, local = ops_run["to_next"], ops_run["local"]
    desc, ring, ctrs = run["queue"]
    msgs = run["data"]
    ctr = u32_to_wire(ctrs[:, [rq.HEAD, rq.TAIL]]).contiguous()
    k_ring, k_ctr, p_ring, p_ctr = ring.clone(), ctr.clone(), ring.clone(), ctr.clone()
    pushed = {}

    def push():                     # keeps the last call's counts
        pushed["out"] = ops.queue_push(k_ring, k_ctr, msgs, 1, mesh)

    w4 = 4
    push_bytes = (p * 8 + msgs.numel() * w4 + msgs.numel() * w4 + p * 4 + p * 8)
    rows = {
        "notified_put": (lambda: ops.notified_put(recv, cnt, 1, mesh),
                         lambda: ref.notified_put_ref(recv, cnt, 1, mesh),
                         lambda: (torch.roll(recv, 1, 0), torch.roll(cnt, 1, 0)),
                         2 * recv.numel() * w4 + 2 * p * w4),
        "notify_accumulate": (lambda: ops.notify_accumulate(to_next, local, 1, mesh),
                              lambda: ref.notify_accumulate_ref(to_next, local, 1, mesh),
                              lambda: local + to_next.roll(1),
                              3 * p * w4),
        # no one PyTorch call admits, places and publishes: no library time
        "queue_push": (push,
                       lambda: ref.queue_push_ref(p_ring, p_ctr, msgs, 1, mesh, desc.capacity),
                       None, push_bytes),
    }
    floor = launch_floor_ms(torch, ops, Mesh)
    out = []
    for name, (kern, plain, lib, nbytes) in rows.items():
        k_ms, p_ms = time_ms(kern), time_ms(plain)
        l_ms = time_ms(lib) if lib is not None else None
        row = {}
        if name in ("notify_accumulate", "queue_push"):   # launch-bound: device time a
            row = {"queued_ms": queued_ms(kern),         # call, gaps between launches in
                   "launch_floor_ms": floor}
        if name == "queue_push":
            # the ring only fills while it is timed, so if the last call
            # admitted all k messages of every rank, every timed call did
            sent = pushed["out"][2]
            torch.cuda.synchronize()
            if not bool((sent == DSDE_K).all()):
                raise AssertionError(f"queue_push timing: the last call admitted "
                                     f"{int(sent.min())}-{int(sent.max())} of {DSDE_K} messages")
        bound = nbytes / hbm * 1e3
        dev = (f" (device {row['queued_ms'] * 1e3:.2f} us a call queued back to back behind a "
               f"spin kernel; launch floor {floor * 1e3:.2f} us)") if row else ""
        log(f"{name}: kernel {k_ms * 1e3:.1f} us{dev}, plain {p_ms * 1e3:.1f} us, library "
            f"{'—' if l_ms is None else f'{l_ms * 1e3:.1f} us'}, bound {bound * 1e3:.3f} us "
            f"(bytes {nbytes})")
        out.append({"name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
                    "replaces": KERNELS[name][2], "launches": ops_run["launches"][name],
                    "max_abs_err": errs[name], "ms": k_ms, **row, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": "bytes", "library_ms": l_ms})
    return out


def dsde_phases(torch, hbm: float) -> list:
    import numpy as np

    from repro_torch.core import dsde
    from repro_torch.core.plan import u32_to_wire
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.rmaq import ops, ref
    from repro_torch.mesh import Mesh
    from repro_torch.parallel import overlap
    from repro_torch.rmaq import notify
    from repro_torch.rmaq import queue as rq

    run = dsde_phase(torch, np, dsde, overlap, rq, Mesh, OpCounter)
    ops_run = rmaq_ops_phase(torch, rq, notify, ops, ref, run, u32_to_wire)
    torch.cuda.empty_cache()
    errs = check_rmaq(torch, ops, ref, Mesh)
    rows = time_rmaq(torch, rq, ops, ref, run, ops_run, errs, hbm, u32_to_wire, Mesh)
    del run, ops_run
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------- the model-serving engine
class Chosen(collections.namedtuple("Chosen", "idx logits probs")):
    """A model call's routing: the experts each MoE layer's router picks
    [L, T, k] (sorted over k) and its f32 logits and probabilities [L, T, E]."""

    def rows(self, i: int) -> "Chosen":
        return Chosen(*(t[:, i:i + 1] for t in self))

    @staticmethod
    def cat(torch, parts: list) -> "Chosen":
        """Calls joined along T."""
        return Chosen(*(torch.cat(ts, dim=1) for ts in zip(*parts)))


class RouteTap:
    """Keeps what `models.moe.route` computes while it is recording: each
    MoE layer's chosen experts, logits and probabilities of each model
    call.  Given the choices of another run (`force`), each MoE layer
    dispatches to those experts instead, and the tap still keeps what the
    router itself would pick."""

    def __init__(self, moe_mod):
        self.mod, self.real = moe_mod, moe_mod.route
        self.calls, self.force = None, None

    def __enter__(self):
        self.mod.route = self._route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real

    def _route(self, params, xt, top_k, capacity_factor=1.25):
        r = self.real(params, xt, top_k, capacity_factor)
        if self.calls is not None:
            self.calls.append((r.expert_idx, r.logits, r.probs))
        if self.force is not None:
            r = self.mod.sort_dispatch(r.logits, r.probs, self.force[len(self.calls) - 1],
                                       capacity_factor)
        return r

    def record(self, fn, force=None):
        """fn()'s result, and its MoE layers' routing as a `Chosen`, or None
        without MoE layers; `force` [L, T, k] overrides the choices."""
        self.calls, self.force = [], force
        try:
            out = fn()
        finally:
            calls, self.calls, self.force = self.calls, None, None
        if not calls:
            return out, None
        import torch

        idx, logits, probs = (torch.stack(ts) for ts in zip(*calls))
        return out, Chosen(idx.sort(dim=-1).values, logits, probs)


class LogitTap:
    """Stands in for the model inside the engine: every call goes through to
    the model unchanged; it keeps the logits the engine got for the requests
    of `prompts` (prefill by prompt, decode by lane), their expert choices
    when a RouteTap is given, each decode call's host time (the call ends
    in a synchronise) and the number of prefills.  Every prefill first
    holds each leaf of its lane to `fresh`'s (a batch-1 `init_cache`): the
    engine's lane reset must give a recycled lane the values a new cache
    starts from."""

    def __init__(self, model, prompts: dict, routes, fresh: dict):
        self.model = model
        self.rid_of = {tuple(p): rid for rid, p in prompts.items()}
        self.logits = {rid: [] for rid in prompts}
        self.choices = {rid: [] for rid in prompts}
        self.routes = routes
        self.engine = None
        self.decode_s = []
        self.prefills = 0
        self.fresh = flat_leaves(fresh)
        self.lanes_checked = 0
        self.slot = {}                  # the lane each tapped request was served in

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def check_lane(self, cache):
        import torch

        lane = flat_leaves(cache)
        bad = [k for k, v in lane.items() if not torch.equal(v, self.fresh[k])]
        if list(lane) != list(self.fresh) or bad:
            raise AssertionError(f"prefill {self.prefills}: lane leaves {bad} differ from "
                                 "init_cache's")
        self.lanes_checked += 1

    def _call(self, fn):
        if self.routes is None:
            return fn(), None
        return self.routes.record(fn)

    def prefill(self, params, tokens, cache, extra):
        self.check_lane(cache)
        (logits, cache), chosen = self._call(
            lambda: self.model.prefill(params, tokens, cache, extra))
        self.prefills += 1
        rid = self.rid_of.get(tuple(tokens[0].tolist()))
        if rid is not None:
            self.slot[rid] = next(i for i, r in enumerate(self.engine.slot_req)
                                  if r is not None and r.rid == rid)
            self.logits[rid].append(logits[0].clone())
            if chosen is not None:
                self.choices[rid].append(chosen)                 # T = S
        return logits, cache

    def decode_step(self, params, tokens, cache):
        import torch

        t0 = time.perf_counter()
        (logits, cache), chosen = self._call(
            lambda: self.model.decode_step(params, tokens, cache))
        torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        eng = self.engine
        for i, req in enumerate(eng.slot_req):
            if req is not None and eng.slot_ready[i] and req.rid in self.logits:
                self.logits[req.rid].append(logits[i].clone())
                if chosen is not None:
                    self.choices[req.rid].append(chosen.rows(i))
        return logits, cache


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def aten_counter():
    """A dispatch mode that counts the ATen calls made inside it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def route_check(torch, what: str, ref: "Chosen", own: "Chosen") -> dict:
    """Routing of one run (`own`) that was dispatched to another's experts
    (`ref`): the choices its routers would make otherwise, each of which
    must be a near-tie of its router — the k-th probability exceeds the
    least it gives `ref`'s experts by no more than twice the largest
    ref-vs-own probability difference at that position (a correct top-k on
    both sides gives no more) — and the largest router-logit difference."""
    differ = (ref.idx != own.idx).any(-1)                     # [L, T]
    gap = 0.0
    if bool(differ.any()):
        p_o, p_r = own.probs[differ], ref.probs[differ]       # [flips, E]
        kth = p_o.topk(ref.idx.shape[-1], dim=-1).values[:, -1]
        gaps = kth - p_o.gather(-1, ref.idx[differ]).min(-1).values
        slack = 2 * (p_o - p_r).abs().max(-1).values + ROUTE_ULP
        bad = gaps > slack
        if bool(bad.any()):
            raise AssertionError(f"{what}: routing differs where the router is no near-tie "
                                 f"(probability gaps {gaps[bad].tolist()} beyond "
                                 f"{slack[bad].tolist()})")
        gap = float(gaps.max())
    return {"flips": int(differ.sum()), "choices": differ.numel(), "gap": gap,
            "err": float((own.logits - ref.logits).abs().max())}


def margins(torch, logits):
    """Top-1 minus top-2 logit a row, in f32."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def engine_phase(torch, np, model, params, engine_mod, spec: dict, routes=None,
                 around_run=contextlib.nullcontext) -> dict:
    """spec["requests"] requests of seeded prompt lengths through
    spec["slots"] lanes of the continuous-batching engine, every one served
    in full; spec["checked"] of them re-run alone at batch 1, teacher-forced
    with the engine's tokens: logits within spec["bound"] of the engine's
    and the argmax equal to the engine's token wherever the solo top-2
    margin exceeds it.  With `routes` (MoE models) the solo runs are also
    forced to the engine's expert choices, and the choices their own
    routers would make are counted where they differ: a batch rounds the
    router's input otherwise than a solo run, a near-tie can flip, and one
    flip sends a token through another expert (PERF.md §6).  The routers
    are held too: their logits within spec["bound"] of the engine's, and
    every differing choice a near-tie (`route_check`).
    `around_run()` wraps the engine's run (the launch counts and input taps
    of the caller).  Every prefill's lane is held to a fresh `init_cache`
    first (`LogitTap.check_lane`): a recycled lane must start where a new
    cache does.  With spec["same_lane"] a request is re-run in its own
    lane of an idle n_slots cache (`same_lane_rerun`), not at batch 1."""
    cfg = model.cfg
    name = cfg.name
    n, new = spec["requests"], spec["new"]
    bound = spec["bound"]
    rng = np.random.default_rng(spec["seed"])
    prompts = {i: rng.integers(0, cfg.vocab_size,
                               int(rng.integers(spec["plen"][0], spec["plen"][1] + 1))).tolist()
               for i in range(n)}
    checked = list(range(0, n, n // spec["checked"]))
    fresh = model.init_cache(1, spec["max_seq"], device="cuda")
    tap = LogitTap(model, {rid: prompts[rid] for rid in checked}, routes, fresh)
    eng = engine_mod.ServeEngine(tap, params, n_slots=spec["slots"],
                                 max_seq=spec["max_seq"], device="cuda")
    tap.engine = eng
    reqs = [engine_mod.Request(rid=i, prompt=p, max_new=new) for i, p in prompts.items()]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    with around_run():
        t0 = time.perf_counter()
        steps = eng.run_until_drained(max_steps=4 * n * new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    short = [r.rid for r in reqs if not r.done.is_set() or len(r.output) != new]
    words = [eng.lock_win.master.v] + [w.v for w in eng.lock_win.local]
    if short or any(words):
        raise AssertionError(f"engine ({name}): requests not served in full {short}, "
                             f"lock words {words}")
    if tap.lanes_checked != tap.prefills:
        raise AssertionError(f"engine ({name}): {tap.lanes_checked} lanes checked for "
                             f"{tap.prefills} prefills")

    # each checked request alone at batch 1, teacher-forced with the
    # engine's tokens; the first solo decode step's ATen calls are counted
    # (the engine's step runs the same code)
    err, near_ties, raw_agree, n_pos, flips, choices = 0.0, 0, 0, 0, 0, 0
    route_err, tie_gap = 0.0, 0.0
    aten_calls = aten_counter()
    for rid in checked:
        toks = reqs[rid].output
        eng_logits = torch.stack(tap.logits[rid]).float()
        if eng_logits.shape[0] != new or eng_logits.argmax(-1).tolist() != toks:
            raise AssertionError(f"engine ({name}): request {rid}'s tapped logits do not "
                                 "give its tokens")
        forced = tap.choices[rid] if routes is not None else [None] * new

        def call(fn, j):
            return (fn(), None) if routes is None else routes.record(fn, forced[j].idx)

        if spec.get("same_lane"):
            solo = same_lane_rerun(torch, np, model, params, engine_mod, spec, prompts[rid],
                                   toks, tap.slot[rid])
            solo_choice = None
        else:
            cache = model.init_cache(1, spec["max_seq"], device="cuda")
            (logits, cache), chosen = call(lambda: model.prefill(
                params, torch.tensor([prompts[rid]], device="cuda"), cache), 0)
            solo, solo_choice = [logits[0]], [chosen]
            for j, tok in enumerate(toks[:-1]):
                with (aten_calls if j == 0 and rid == checked[0] else contextlib.nullcontext()):
                    (logits, cache), chosen = call(lambda: model.decode_step(
                        params, torch.tensor([tok], device="cuda"), cache), j + 1)
                solo.append(logits[0])
                solo_choice.append(chosen)
            solo = torch.stack(solo).float()
        if routes is not None:
            r = route_check(torch, f"engine ({name}) request {rid}",
                            Chosen.cat(torch, forced), Chosen.cat(torch, solo_choice))
            flips, choices = flips + r["flips"], choices + r["choices"]
            route_err, tie_gap = max(route_err, r["err"]), max(tie_gap, r["gap"])
        err = max(err, float((solo - eng_logits).abs().max()))
        sure = margins(torch, solo) > bound
        agree = solo.argmax(-1) == torch.tensor(toks, device="cuda")
        if not bool(agree[sure].all()):
            raise AssertionError(f"engine ({name}): request {rid} differs from its solo run "
                                 f"where the margin exceeds {bound}")
        near_ties += int((~sure).sum())
        raw_agree += int(agree.sum())
        n_pos += len(toks)
    if err > bound or route_err > bound:
        raise AssertionError(f"engine ({name}) vs solo runs: logits max abs err {err}, router "
                             f"logits {route_err} (bound {bound})")
    sm = eng.serve_metrics()
    tokens = sum(len(r.output) for r in reqs)
    decode_ms = float(np.median(tap.decode_s)) * 1e3
    card = card_line()
    log(f"engine ({name}, {cfg.n_layers} layers, {spec['slots']} slots, max_seq "
        f"{spec['max_seq']}; {card}): {n} requests of {spec['plen'][0]}-{spec['plen'][1]} "
        f"prompt tokens, {new} new each, {steps} ticks, {tap.prefills} prefills, "
        f"{len(tap.decode_s)} decode steps, {dt:.3f} s, {tokens / dt:.1f} tokens/s; every "
        f"prefill's lane equal to a fresh init_cache ({max(0, tap.prefills - spec['slots'])} "
        f"of them recycled); "
        f"TTFT p50 {sm['ttft_us']['p50'] / 1e3:.2f} ms p99 {sm['ttft_us']['p99'] / 1e3:.2f} ms; "
        f"prefill p50 {sm['seg.prefill_us']['p50'] / 1e3:.2f} ms p99 "
        f"{sm['seg.prefill_us']['p99'] / 1e3:.2f} ms; decode {decode_ms:.3f} ms/step "
        f"(median); TBT p50 {sm['tbt_us']['p50'] / 1e3:.2f} ms; lock AMOs "
        f"{eng.lock_win.total_amos}, words 0"
        + (f"; a decode step makes {aten_calls.n} ATen calls ({aten_calls.n / cfg.n_layers:.0f}"
           " a layer, views included)" if aten_calls.n else ""))
    route_note = "" if routes is None else (
        f"; the solo runs dispatch to the engine's experts, and their own routers would "
        f"choose otherwise at {flips} of {choices} (position x MoE layer) choices, every "
        f"one a near-tie (largest solo probability gap {tie_gap:.3g}); router logits max "
        f"abs err {route_err:.4g} (bound {bound})")
    solo_how = ("re-run alone in their own lanes" if spec.get("same_lane")
                else "solo batch-1 runs")
    log(f"engine ({name}) vs {solo_how} ({len(checked)} requests, teacher-forced): "
        f"logits max abs err {err:.4g} (bound {bound}); argmax == engine token at "
        f"{raw_agree}/{n_pos} positions, at every one of the {n_pos - near_ties} whose solo "
        f"top-2 margin exceeds the bound; near-ties {near_ties}{route_note}")
    return {"tokens_per_s": tokens / dt, "decode_ms": decode_ms, "prefills": tap.prefills,
            "routing_flips": flips, "prefill_p50_ms": sm["seg.prefill_us"]["p50"] / 1e3,
            "logits_err": err, "positions": n_pos, "lanes_checked": tap.lanes_checked}


def same_lane_rerun(torch, np, model, params, engine_mod, spec: dict, prompt: list,
                    toks: list, slot: int):
    """One request alone, teacher-forced with its engine tokens, in lane
    `slot` of a fresh cache of the engine's spec["slots"] lanes, the other
    lanes idle: its prefill at batch 1 into the lane's views and its decode
    steps over every lane, as the engine ran it.  A lane's rows go through
    the same kernels at the same shapes, so its logits must equal the
    engine's bit for bit unless another lane reaches into it."""
    n = spec["slots"]
    full = model.init_cache(n, spec["max_seq"], device="cuda")
    views = engine_mod._lane_views(full, model.init_cache(1, spec["max_seq"], device="meta"),
                                   slot)
    logits, _ = model.prefill(params, torch.tensor([prompt], device="cuda"), views, None)
    solo, pos = [logits[0]], np.zeros(n, np.int64)
    for j, tok in enumerate(toks[:-1]):
        ids = np.zeros(n, np.int64)
        ids[slot], pos[slot] = tok, len(prompt) + j
        full = {**full, "len": torch.as_tensor(pos, device="cuda")}
        logits, full = model.decode_step(params, torch.as_tensor(ids, device="cuda"), full)
        solo.append(logits[slot])
    return torch.stack(solo).float()


def forward_phase(torch, model, params, L, fops, shape=FWD_TOKENS, n_attn=None,
                  routes=None) -> dict:
    """`Model.forward_logits` on `shape` tokens under backend "cuda" (the
    flash kernel, counts zeroed just before; one launch in each of the
    `n_attn` attention layers, every layer by default) against backend
    "torch".  With `routes` (MoE models) the cuda run dispatches to the
    torch run's experts, and the choices its routers would make otherwise
    must be near-ties (`route_check`)."""
    cfg = model.cfg
    n_attn = cfg.n_layers if n_attn is None else n_attn
    g = torch.Generator(device="cuda").manual_seed(FWD_SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")}

    def call(force=None):
        if routes is None:
            return model.forward_logits(params, batch).logits, None
        out, chosen = routes.record(lambda: model.forward_logits(params, batch), force)
        return out.logits, chosen

    first = {}
    real = fops.flash_attention

    def tap(q, k, v, causal=True):       # keeps layer 0's inputs; launches via the wrapper
        if not first:
            first.update(q=q.clone(), k=k.clone(), v=v.clone(), causal=causal)
        return real(q, k, v, causal=causal)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_routes = call()
        torch.cuda.synchronize()
        torch_s = time.perf_counter() - t0
        L.set_attention_backend("cuda")
        fops.flash_attention = tap
        fops.launches = 0
        fops.launches_by_variant.update(wgmma=0, simt=0)
        try:
            t0 = time.perf_counter()
            got, got_routes = call(None if routes is None else want_routes.idx)
            torch.cuda.synchronize()
            cuda_s = time.perf_counter() - t0
        finally:
            fops.flash_attention = real
            L.set_attention_backend("torch")
        launches, by_variant = fops.launches, dict(fops.launches_by_variant)
    if launches != n_attn or by_variant != {"wgmma": n_attn, "simt": 0}:
        raise AssertionError(f"forward ({cfg.name}): {launches} flash launches {by_variant}, "
                             f"want {n_attn}, every one through the wgmma variant")
    route_note = ""
    if routes is not None:
        r = route_check(torch, f"forward ({cfg.name})", want_routes, got_routes)
        if r["err"] > FWD_BOUND:
            raise AssertionError(f"forward ({cfg.name}): router logits max abs err {r['err']} "
                                 f"> {FWD_BOUND}")
        route_note = (f"; the cuda run dispatches to the torch run's experts, and its own "
                      f"routers would choose otherwise at {r['flips']} of {r['choices']} "
                      f"choices, every one a near-tie (largest probability gap "
                      f"{r['gap']:.3g}); router logits max abs err {r['err']:.4g}")
    err, sure_n, sure_agree, raw_agree = 0.0, 0, 0, 0
    for b in range(shape[0]):
        a, w = got[b].float(), want[b].float()
        err = max(err, float((a - w).abs().max()))
        agree = a.argmax(-1) == w.argmax(-1)
        sure = margins(torch, w) > FWD_BOUND
        raw_agree += int(agree.sum())
        sure_n += int(sure.sum())
        sure_agree += int(agree[sure].sum())
    n = shape[0] * shape[1]
    if not torch.isfinite(got).all() or err > FWD_BOUND or sure_agree < FWD_AGREE * sure_n:
        raise AssertionError(f"forward ({cfg.name}): logits max abs err {err} (bound "
                             f"{FWD_BOUND}), argmax agreement {sure_agree}/{sure_n} beyond "
                             "the bound")
    log(f"forward_logits ({cfg.name}) {list(shape)} at full width: {launches} flash launches "
        f"({n_attn} attention layers of {cfg.n_layers}), all {by_variant['wgmma']} through the "
        f"wgmma variant; backend cuda {cuda_s * 1e3:.1f} ms, torch "
        f"{torch_s * 1e3:.1f} ms (one call each); logits max abs err {err:.4g} (bound "
        f"{FWD_BOUND}); argmax agrees at {raw_agree}/{n} positions "
        f"({raw_agree / n:.4f}), at {sure_agree}/{sure_n} whose top-2 margin exceeds the "
        f"bound; near-ties {n - sure_n}{route_note}")
    del got, want
    return {"launches": launches, "first": first}


def check_flash(torch, fops, fref, first: dict) -> float:
    """The kernel against its plain version: layer 0's inputs of the forward,
    chatglm3-6b's head shape, the wgmma variant's edge cases (bf16 at hd 64
    and 128; non-causal at the whisper encoder's shape, ragged, and with
    keys past Sk that only a mask keeps out) and the simt variant's (f32,
    the SMOKE head dims); each case must launch the variant `fops.variant`
    names for it."""
    g = torch.Generator(device="cuda").manual_seed(6)

    def qkv(B, Hq, Hkv, Sq, Sk, hd, dtype):
        return (torch.randn(B, Hq, Sq, hd, generator=g, device="cuda").to(dtype),
                torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype),
                torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype))

    bf, f32 = torch.bfloat16, torch.float32
    cases = [("forward layer 0", (first["q"], first["k"], first["v"]), first["causal"]),
             ("chatglm3-6b heads", qkv(1, 32, 2, 4096, 4096, 128, bf), True),
             ("Sq < Sk", qkv(2, 4, 2, 40, 300, 64, f32), True),
             ("one row", qkv(1, 6, 3, 1, 77, 128, f32), True),
             ("non-causal, S 1000, g 1, B 3", qkv(3, 4, 4, 1000, 1000, 64, f32), False),
             ("ragged, hd 128", qkv(1, 8, 2, 130, 130, 128, f32), True)]
    # the SMOKE configs' head dims (16, 20) and the reference test's 32,
    # zero-padded to the 16 / 32 instances
    cases += [(f"hd {hd} {'bf16' if dt == bf else 'f32'}", qkv(2, 4, 2, 300, 300, hd, dt), True)
              for hd in (16, 20, 32) for dt in (bf, f32)]
    cases.append(("Sq > Sk", qkv(1, 4, 2, 90, 60, 64, f32), True))
    # the wgmma variant: ragged tiles, GQA groups 1-16, Sq != Sk, non-causal,
    # and Sk - Sq = 64, where a block's first warpgroup walks a tile it
    # cannot see
    cases += [("wgmma hd 64, S 1000, g 4", qkv(2, 8, 2, 1000, 1000, 64, bf), True),
              ("wgmma hd 128, S 2047, g 16", qkv(1, 16, 1, 2047, 2047, 128, bf), True),
              ("wgmma hd 64, Sq < Sk", qkv(2, 6, 2, 100, 700, 64, bf), True),
              ("wgmma hd 128, S 130, g 3", qkv(1, 6, 2, 130, 130, 128, bf), True),
              ("wgmma hd 128, non-causal, B 3, g 1", qkv(3, 4, 4, 1000, 1000, 128, bf), False),
              ("wgmma hd 64, Sk - Sq = 64", qkv(4, 16, 4, 1000, 1064, 64, bf), True),
              ("wgmma hd 128, Sq > Sk", qkv(1, 4, 2, 300, 200, 128, bf), True)]
    # the whisper encoder's shape (1500 = 7 x 192 + 156 query rows, 11 x 128 +
    # 92 keys), a ragged non-causal case with GQA, and keys past Sk that
    # must be masked: every real score is -8, so a padded key scored 0
    # would take nearly all of the softmax from them and the output (the
    # mean of v, about 1) would collapse towards 0
    tail_v = (1 + 0.1 * torch.randn(1, 4, 1111, 64, generator=g, device="cuda")).to(bf)
    scaled = {"whisper encoder shape, non-causal", "wgmma hd 64, non-causal, ragged, g 2",
              "wgmma hd 64, non-causal, keys past Sk masked"}
    cases += [("whisper encoder shape, non-causal", qkv(8, 12, 12, 1500, 1500, 64, bf), False),
              ("wgmma hd 64, non-causal, ragged, g 2", qkv(2, 8, 4, 333, 1111, 64, bf), False),
              ("wgmma hd 64, non-causal, keys past Sk masked",
               (torch.ones(1, 4, 200, 64, device="cuda", dtype=bf),
                -torch.ones(1, 4, 1111, 64, device="cuda", dtype=bf), tail_v), False)]
    errs, notes = {}, []
    for name, (q, k, v), causal in cases:
        kind = fops.variant(q.dtype, q.shape[-1])
        before = fops.launches_by_variant[kind]
        out = fops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if fops.launches_by_variant[kind] != before + 1:
            raise AssertionError(f"flash_attention ({name}): the {kind} variant did not run")
        if name == "wgmma hd 128, Sq > Sk" and out[:, :, :100].any():
            raise AssertionError("flash_attention (wgmma): rows that see no key are not zero")
        want = fref.attention_ref(q, k, v, causal=causal)
        err = float((out.float() - want.float()).abs().max())
        tol = scaled_tol(want) if name in scaled else BF16_TOL if q.dtype == bf else F32_TOL
        if not torch.isfinite(out).all() or err > tol:
            raise AssertionError(f"flash_attention vs plain ({name}): max abs err {err} > {tol}")
        errs[name] = err
        if name in scaled:
            notes.append(f"{name}: tol {tol:.3g}, |plain| mean "
                         f"{float(want.float().abs().mean()):.3g} max "
                         f"{float(want.float().abs().max()):.3g}")
        if name == "Sq > Sk" and out[:, :, :30].any():
            raise AssertionError("flash_attention: rows that see no key are not zero")
    log("flash_attention vs plain: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (bf16 tol {BF16_TOL}, f32 tol {F32_TOL}; scaled: " + "; ".join(notes) + ")")
    return errs


def time_flash(torch, F, fops, fref, q, k, v, hbm: float) -> dict:
    """Kernel, plain version and SDPA (the library yardstick the port never
    calls) with CUDA events over 50 calls, and the bound."""
    B, Hq, Sq, hd = q.shape
    Sk = k.shape[2]
    k_ms = time_ms(lambda: fops.flash_attention(q, k, v))
    p_ms = time_ms(lambda: fref.attention_ref(q, k, v))
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True))
    flops = 2 * B * Hq * Sq * Sk * hd          # causal: two products over the visible half
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = max((flops / BF16_FLOPS_PER_S * 1e3, "operations"),
                             (nbytes / hbm * 1e3, "bytes"))
    kind = fops.variant(q.dtype, hd)
    tflops = flops / k_ms / 1e9
    log(f"flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} ({kind}; "
        f"{card_line()}): kernel {k_ms * 1e3:.1f} us ({tflops:.1f} TFLOP/s), plain "
        f"{p_ms * 1e3:.1f} us, sdpa {l_ms * 1e3:.1f} us ({flops / l_ms / 1e9:.1f} TFLOP/s), "
        f"bound {bound_ms * 1e3:.1f} us ({bound_by})")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "variant": kind, "tflops": tflops}


def model_serve_phases(torch, hbm: float) -> list:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serve import engine as engine_mod

    model = build_model(get_config(MODEL_ARCH))
    params = model.init(MODEL_SEED, device="cuda")
    log(f"{MODEL_ARCH}: {model.param_count()} parameters (bf16, seed {MODEL_SEED})")
    with torch.no_grad():
        engine_phase(torch, np, model, params, engine_mod, SMOLLM_ENGINE)
    torch.cuda.empty_cache()
    fwd = forward_phase(torch, model, params, L, fops)
    del params
    torch.cuda.empty_cache()
    first = fwd["first"]
    errs = check_flash(torch, fops, fref, first)
    times = time_flash(torch, F, fops, fref, first["q"], first["k"], first["v"], hbm)
    g = torch.Generator(device="cuda").manual_seed(7)
    for B, Hq, Hkv, S in ((1, 32, 2, 4096), (2, 32, 8, 2048)):   # chatglm3-6b; Jamba
        qkv = [torch.randn(B, h, S, 128, generator=g, device="cuda").to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv)]
        time_flash(torch, F, fops, fref, *qkv, hbm)
    del qkv, first
    torch.cuda.empty_cache()
    return [{"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1],
             "replaces": KERNELS["flash_attention"][2], "launches": fwd["launches"],
             "max_abs_err": errs["forward layer 0"], **times}]


# ------------------------------------------- the moe and hybrid families
def check_ssm(torch, sops, sref, serving: tuple) -> dict:
    """The selective-scan kernel against its plain version: the serving
    run's inputs, the serving shape at unit scale, the reference test's
    shapes in bf16, and edge cases (one step, S and d that no block
    divides, a non-zero h0, N = 8); y and h_last.  f32 is held to
    SSM_F32_REL of the output's largest magnitude (the serving run's y is
    ~1e-5, so an absolute floor would pass a kernel that wrote zeros)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32

    def inputs(B, S, d, N, dtype, seeded):
        decay = (0.5 + 0.5 * torch.rand(B, S, d, N, generator=g, device="cuda")).to(dtype)
        drive = (0.1 * torch.randn(B, S, d, N, generator=g, device="cuda")).to(dtype)
        c = torch.randn(B, S, N, generator=g, device="cuda")
        return decay, drive, c, (torch.randn(B, d, N, generator=g, device="cuda")
                                 if seeded else None)

    def scale(t):
        return max(float(t.float().abs().max()), 1e-30)

    B, S, d, N = serving[0].shape
    cases = [("serving", lambda: serving),
             ("serving shape, unit scale", lambda: inputs(B, S, d, N, f32, True)),
             ("reference 2x64x32x8 bf16", lambda: inputs(2, 64, 32, 8, bf, False)),
             ("reference 1x128x64x16 bf16", lambda: inputs(1, 128, 64, 16, bf, False)),
             ("reference 1x256x128x16 bf16", lambda: inputs(1, 256, 128, 16, bf, False)),
             ("S 1, h0", lambda: inputs(3, 1, 8192, 16, f32, True)),
             ("S 1000, d 200, h0", lambda: inputs(2, 1000, 200, 16, f32, True)),
             ("N 8, h0", lambda: inputs(2, 77, 96, 8, f32, True))]
    errs, rels = {}, {}
    for name, make in cases:
        args = make()
        y, h = sops.selective_scan(*args)
        torch.cuda.synchronize()
        want_y, want_h = sref.ssm_scan_ref(*args)
        err_y = float((y.float() - want_y.float()).abs().max())
        err_h = float((h - want_h).abs().max())
        tol_y = SSM_BF16_TOL if y.dtype == bf else SSM_F32_REL * scale(want_y)
        tol_h = SSM_F32_REL * scale(want_h)
        if not (torch.isfinite(y).all() and torch.isfinite(h).all()) or err_y > tol_y \
                or err_h > tol_h:
            raise AssertionError(f"ssm_scan vs plain ({name}): y err {err_y} (tol {tol_y}), "
                                 f"h_last err {err_h} (tol {tol_h})")
        errs[name], rels[name] = err_y, err_y / scale(want_y)
        del args, y, h, want_y, want_h
    log("ssm_scan vs plain (y, max abs err / max |y|): "
        + ", ".join(f"{k} {errs[k]:.3g} / {rels[k]:.3g}" for k in errs)
        + f" (f32 tol {SSM_F32_REL} x max |y|, bf16 tol {SSM_BF16_TOL} abs); h_last within "
        f"{SSM_F32_REL} x max |h| everywhere")
    return {"max_abs_err": errs["serving"],
            "max_rel_err": max(v for k, v in rels.items() if "bf16" not in k)}


def time_ssm(torch, sops, sref, args: tuple, hbm: float) -> dict:
    """Kernel and plain version with CUDA events at the serving shape, and
    the bound: every input read once, every output written once."""
    decay, drive, c, h0 = args
    B, S, d, N = decay.shape
    k_ms = time_ms(lambda: sops.selective_scan(decay, drive, c, h0), reps=20)
    p_ms = time_ms(lambda: sref.ssm_scan_ref(decay, drive, c, h0), reps=5, warmup=1)
    es = decay.element_size()
    nbytes = (2 * B * S * d * N * es + B * S * N * 4 + B * S * d * es
              + (0 if h0 is None else B * d * N * 4) + B * d * N * 4)
    flops = 4 * B * S * d * N       # the FMA of h, the product with c, the sum over N
    bound_ms, bound_by = max((nbytes / hbm * 1e3, "bytes"),
                             (flops / F32_FLOPS_PER_S * 1e3, "operations"))
    log(f"ssm_scan decay/drive {tuple(decay.shape)} {decay.dtype} ({card_line()}): kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, library none, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 2**20:.1f} MiB at {hbm / 1e12:.2f} TB/s; "
        f"{nbytes / k_ms / 1e6:.1f} GB/s achieved, {bound_ms / k_ms:.1%} of the bound)")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


def full_width(torch, build_model, get_config, arch: str, layers: int, seed: int):
    """The arch at its published widths cut to `layers`, random bf16
    weights (f32 router, A_log, D_skip) from a seeded generator on the card."""
    import dataclasses

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    experts = (f"{cfg.moe_experts} experts top-{cfg.moe_top_k} of d_ff {cfg.moe_d_ff}, "
               if cfg.moe_experts else "")
    cut = f"cut to {layers} of" if layers != full.n_layers else "all"
    log(f"{arch} at its published widths (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, {experts}vocab {cfg.vocab_size}), {cut} "
        f"{full.n_layers} layers: {model.param_count()} parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card (seed {seed}, "
        f"{time.perf_counter() - t0:.1f} s)")
    return model, params


def hybrid_serve_phases(torch, hbm: float) -> list:
    """Jamba-v0.1 (16 layers at full width) through the continuous-batching
    engine with the selective-scan kernel on every Mamba layer's prefill
    (launches counted) and through the cache-free `forward_logits` with the
    flash kernel in its attention layers (launches counted), the scan
    against its plain version and its timings; then qwen3-moe-30b-a3b (4
    layers at full width) through the engine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import engine as engine_mod

    torch.cuda.reset_peak_memory_stats()
    model, params = full_width(torch, build_model, get_config, HYBRID_ARCH, HYBRID_LAYERS,
                               HYBRID_SEED)
    cfg = model.cfg
    n_mamba = cfg.n_layers // cfg.attn_period * (cfg.attn_period - 1)
    first: dict = {}
    real = sops.selective_scan

    def tap(decay, drive, c, h0=None):   # the longest prompt's first Mamba layer's inputs
        if decay.shape[1] > first.get("S", 0):
            first.update(S=decay.shape[1], args=tuple(
                None if t is None else t.clone() for t in (decay, drive, c, h0)))
        return real(decay, drive, c, h0)

    @contextlib.contextmanager
    def around_run():
        sops.selective_scan = tap
        sops.launches = 0
        try:
            yield
        finally:
            sops.selective_scan = real
            first["launches"] = sops.launches

    with torch.no_grad(), RouteTap(moe_mod) as routes:
        run = engine_phase(torch, np, model, params, engine_mod, HYBRID_ENGINE, routes,
                           around_run)
    launches = first["launches"]
    if launches == 0 or launches != n_mamba * run["prefills"]:
        raise AssertionError(f"ssm_scan: {launches} launches for {run['prefills']} prefills "
                             f"of {n_mamba} Mamba layers")
    log(f"ssm_scan: {launches} launches in the engine's run = {n_mamba} Mamba layers x "
        f"{run['prefills']} prefills; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    gc.collect()                        # the engine and its tap refer to each other
    torch.cuda.empty_cache()
    with RouteTap(moe_mod) as routes:
        forward_phase(torch, model, params, L, fops, HYBRID_FWD_TOKENS,
                      cfg.n_layers // cfg.attn_period, routes)
    del params, model
    gc.collect()                        # the engine and its tap refer to each other
    torch.cuda.empty_cache()
    errs = check_ssm(torch, sops, sref, first["args"])
    times = time_ssm(torch, sops, sref, first["args"], hbm)
    del first
    torch.cuda.empty_cache()

    model, params = full_width(torch, build_model, get_config, MOE_ARCH, MOE_LAYERS, MOE_SEED)
    with torch.no_grad(), RouteTap(moe_mod) as routes:
        engine_phase(torch, np, model, params, engine_mod, MOE_ENGINE, routes)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return [{"name": "ssm_scan", "route": KERNELS["ssm_scan"][0],
             "source": KERNELS["ssm_scan"][1], "replaces": KERNELS["ssm_scan"][2],
             "launches": launches, **errs, **times}]


# ------------------------------------------------------------ training
def train_phase(torch, np, model, L, fops) -> dict:
    """TRAIN_STEPS AdamW steps with remat on SmolLM-360M at full width, the
    flash kernel in every layer (counts zeroed before each step, read
    after); then, at the state before the last step: the loss and grads
    twice more under backend "cuda" (bit-equal to each other, the loss to
    the step's) and once under "torch" (loss and grads held)."""
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.train.train_step import StepConfig, loss_and_grads, make_train_step

    cfg = model.cfg
    B, S = TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    params = model.init(TRAIN_SEED, device="cuda")
    opt = init_opt_state(params)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, S, B), device="cuda")
    step_fn = make_train_step(model, AdamWConfig(**TRAIN_OPT), StepConfig(remat=True))
    real_mlp = L.mlp
    taps: dict = {}

    def tap(p, x, mlp_type="swiglu"):    # layer 0's MLP input and weights, last step
        if not taps:
            taps.update(x=x.detach().clone(), **{k: v.detach().clone() for k, v in p.items()})
        return real_mlp(p, x, mlp_type)

    losses, times, launches, wgmma = [], [], [], []
    L.set_attention_backend("cuda")
    try:
        for i in range(TRAIN_STEPS):
            batch = pipe.batch_at(i)
            if i == TRAIN_STEPS - 1:
                prev, last_batch = (params, opt), batch   # the step is functional
                L.mlp = tap
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fops.launches = 0
            fops.launches_by_variant.update(wgmma=0, simt=0)
            params, opt, met = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(fops.launches)
            wgmma.append(fops.launches_by_variant["wgmma"])
            losses.append(float(met["loss"]))
            L.mlp = real_mlp
    finally:
        L.mlp = real_mlp
        L.set_attention_backend("torch")
    peak = torch.cuda.max_memory_allocated()
    want_launches = 2 * cfg.n_layers            # the forward and the remat recomputation
    if any(n != want_launches for n in launches) or wgmma != launches:
        raise AssertionError(f"train: flash launches a step {launches} (wgmma {wgmma}), want "
                             f"{want_launches}, every one through the wgmma variant")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5 - TRAIN_DROP:
        raise AssertionError(f"train: mean loss {first5:.4f} over the first 5 steps, "
                             f"{last5:.4f} over the last 5 (must fall by {TRAIN_DROP})")
    if not all(torch.isfinite(t).all() for t in tree_leaves(params)):
        raise AssertionError("train: non-finite params after the run")
    n_params = model.param_count()
    ms = float(np.median(times[1:])) * 1e3
    tokens = B * S
    log(f"train {cfg.name} at full width ({n_params} parameters, bf16, seed {TRAIN_SEED}), "
        f"[{B}, {S}] tokens a step, AdamW {TRAIN_OPT}, remat on ({card_line()}): "
        f"{TRAIN_STEPS} steps, flash launches {launches[0]} a step every step, all through "
        f"the wgmma variant ({cfg.n_layers} forward + {cfg.n_layers} recomputed); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 {first5:.4f}, last 5 "
        f"{last5:.4f}); {ms:.1f} ms/step (median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{times[0] * 1e3:.1f} ms), {tokens / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; 6*N*tokens {6 * n_params * tokens / 1e12:.2f} TFLOP a "
        f"step = {6 * n_params * tokens / (ms / 1e3) / BF16_FLOPS_PER_S:.2%} of the "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 peak")
    log("train losses: " + " ".join(f"{x:.4f}" for x in losses))

    # the state before the last step: determinism and the plain attention
    p0, _ = prev
    L.set_attention_backend("cuda")
    try:
        l1, _, g1 = loss_and_grads(model, p0, last_batch, remat=True)
        l2, _, g2 = loss_and_grads(model, p0, last_batch, remat=True)
    finally:
        L.set_attention_backend("torch")
    same = torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in
                                       zip(tree_leaves(g1), tree_leaves(g2)))
    if not same or float(l1) != losses[-1]:
        raise AssertionError(f"train: the step is not deterministic on the card (loss "
                             f"{float(l1)!r} / {float(l2)!r}, the step's {losses[-1]!r}; "
                             f"grads equal {same})")
    del g2
    lt, _, gt = loss_and_grads(model, p0, last_batch, remat=True)
    rel = {}
    flat_c, flat_t = tree_leaves(g1), tree_leaves(gt)
    for (key, _), a, b in zip(flatten(p0), flat_c, flat_t):
        rel[key] = float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    if abs(float(l1) - float(lt)) > TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL:
        raise AssertionError(f"train: backend cuda vs torch at step {TRAIN_STEPS}: loss "
                             f"{float(l1)} / {float(lt)}, grad rel L2 {worst} {rel[worst]}")
    log(f"train at the state before step {TRAIN_STEPS}: backend cuda twice bit-equal "
        f"(loss {float(l1):.6f} = the step's), backend torch loss {float(lt):.6f} "
        f"(|diff| {abs(float(l1) - float(lt)):.3g}, bound {TRAIN_LOSS_TOL}); grads' relative "
        f"L2 difference max {rel[worst]:.3g} at {worst} (bound {TRAIN_GRAD_REL}), median "
        f"{float(np.median(list(rel.values()))):.3g}")
    del g1, gt, prev, p0
    profile_step(torch, step_fn, params, opt, pipe.batch_at(TRAIN_STEPS), L)
    return {"params": params, "opt": opt, "taps": taps, "launches": launches[-1]}


def profile_step(torch, step_fn, params, opt, batch, L, top: int = 8) -> None:
    """One more step (its result dropped) under `torch.profiler`: the device
    time by kernel and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    L.set_attention_backend("cuda")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        L.set_attention_backend("torch")
    # the kernels' own events (a CPU op's device time repeats its kernels')
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    busy = sum(self_us(e) for e in events)
    if busy <= 0:
        log("train profile: the profiler saw no device time (device idle share not measured)")
        return
    ranked = sorted(events, key=self_us, reverse=True)[:top]
    flash = [e for e in events if "flash_fwd" in e.key]
    log(f"train profile of one step ({card_line()}): wall {wall_us / 1e3:.1f} ms under the "
        f"profiler, device busy {busy / 1e3:.1f} ms ({busy / wall_us:.1%}; idle "
        f"{1 - busy / wall_us:.1%}); the flash kernel {sum(map(self_us, flash)) / 1e3:.1f} ms "
        f"x{sum(e.count for e in flash)} ({sum(map(self_us, flash)) / busy:.1%} of the busy "
        f"time); top device time: " + "; ".join(
            f"{e.key[:60]} {self_us(e) / 1e3:.1f} ms x{e.count}" for e in ranked))


def resume_phase(torch, np, state: dict) -> None:
    """The launcher at --smoke on the card; the kill-and-resume contract of
    tests/test_training.py on the card (bit-equal at the last step); one
    blocking checkpoint of layer 0's params and moments at full width."""
    import tempfile

    from repro_torch.ckpt.checkpoint import CheckpointManager, codec_name, flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train.optimizer import AdamWConfig, OptState, tree_leaves, tree_map
    from repro_torch.train.train_step import StepConfig, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        fops.launches = 0
        hist = launch_train.main(["--smoke", "--steps", "6", "--seq", "128", "--ckpt-dir",
                                  os.path.join(d, "launch"), "--ckpt-every", "3",
                                  "--device", "cuda"])
        got = CheckpointManager(os.path.join(d, "launch")).list_steps()
        if len(hist) != 6 or not all(np.isfinite(r["loss"]) for r in hist) or got != [3, 6] \
                or fops.launches == 0:
            raise AssertionError(f"launch.train --smoke: history {hist}, checkpoints {got}, "
                                 f"flash launches {fops.launches}")
        log(f"launch.train --smoke --device cuda: 6 steps, loss {hist[0]['loss']:.4f} -> "
            f"{hist[-1]['loss']:.4f}, checkpoints {got}, flash launches {fops.launches}")

        cfg = get_config(MODEL_ARCH, smoke=True)
        model = build_model(cfg)
        params0 = model.init(0, device="cuda")
        pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 32, 4), device="cuda")
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                               StepConfig())

        def trainer(sub, steps):
            path = os.path.join(d, sub)
            return Trainer(step, tree_map(torch.clone, params0), pipe,
                           TrainerConfig(total_steps=steps, ckpt_every=RESUME_EVERY,
                                         log_every=1, ckpt_dir=path),
                           ckpt=CheckpointManager(path))

        L.set_attention_backend("cuda")
        try:
            t = trainer("a", RESUME_STEPS)
            t.run()
            t1 = trainer("b", RESUME_STOP)
            t1.run()                                    # "crashes" after RESUME_STOP
            saved = t1.ckpt.list_steps()
            t2 = trainer("b", RESUME_STEPS)
            if not t2.maybe_resume() or t2.step != RESUME_STOP:
                raise AssertionError(f"resume: restarted at {t2.step}")
            t2.run()
        finally:
            L.set_attention_backend("torch")
        pairs = list(zip(tree_leaves(t.params) + tree_leaves(t.opt_state.mu)
                         + tree_leaves(t.opt_state.nu),
                         tree_leaves(t2.params) + tree_leaves(t2.opt_state.mu)
                         + tree_leaves(t2.opt_state.nu)))
        diff = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
        if diff:
            raise AssertionError(f"resume: {len(diff)} of {len(pairs)} leaves differ at step "
                                 f"{RESUME_STEPS}")
        log(f"resume on the card ({cfg.name}, [4, 32] tokens, flash backend): "
            f"{RESUME_STEPS} steps uninterrupted vs stopped at {RESUME_STOP} (checkpoints "
            f"{saved}) and resumed there: all {len(pairs)} params and "
            f"moments bit-equal at step {RESUME_STEPS}")

        # one checkpoint of layer 0 at full width
        params, opt = state["params"], state["opt"]

        def layer0(tree):
            return tree_map(lambda x: x[0], tree["blocks"])

        tree = (layer0(params), OptState(opt.step, layer0(opt.mu), layer0(opt.nu)))
        nbytes = sum(leaf.numel() * leaf.element_size() for _, leaf in flatten(tree))
        total = sum(leaf.numel() * leaf.element_size()
                    for leaf in tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu))
        mgr = CheckpointManager(os.path.join(d, "layer0"))
        t0 = time.perf_counter()
        mgr.save(int(opt.step), tree, extra={"step": int(opt.step)}, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = mgr.restore(tree)
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(back), flatten(tree))):
            raise AssertionError("checkpoint: layer 0 does not restore bit-equal")
        on_disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                      os.walk(os.path.join(d, "layer0")) for f in fs)
        rate = nbytes / save_s
        log(f"checkpoint of layer 0 at full width ({nbytes / 1e6:.1f} MB: bf16 params, f32 "
            f"moments; codec {codec_name()}, {on_disk / 1e6:.1f} MB on disk): save "
            f"{save_s:.2f} s = {rate / 1e6:.1f} MB/s, restore {restore_s:.2f} s, bit-equal; "
            f"the whole {total / 1e9:.2f} GB state would take {total / rate:.0f} s a save "
            f"at that rate (host CPU of the {card_line()} machine)")


def unfused_arm(torch, rma_ops, x_t, w, mesh):
    """`allgather_matmul_plan`'s unfused arm: kernel row 7 gathers every
    rank's copy of W [n, K/n, N] (bf16 pairs moved as 32-bit words), then
    one torch.matmul of x_t.T against each: [n, m, N] bf16."""
    n, ks, N = w.shape
    gathered = rma_ops.ring_all_gather(w.view(torch.int32), mesh).view(w.dtype)
    return torch.matmul(x_t.T, gathered.reshape(n, n * ks, N))


def fwd_rate(m: int, K: int, N: int, n: int, ring_ms: float, one_ms: float) -> float:
    """B/s the ring kernel's forward reached: W's chunks that cross the ring
    (ceil(m / 128) tiles of m, (n - 1) K N bf16 words each) over the time the
    n-rank call takes beyond n one-copy calls."""
    from repro_torch.core.perfmodel import RING_TILE

    forwarded = -(-m // RING_TILE) * (n - 1) * K * N * 2
    return forwarded / max(ring_ms - n * one_ms, 1e-9) * 1e3


def ring_phase(torch, taps: dict, hbm: float) -> dict:
    """Kernel row 13 through `ops.ring_matmul` on the training run's own
    layer-0 activations and weights, the MLP's up and down projections
    sharded over RING_N ranks (counts zeroed before, read after: one
    "wgmma" launch a call); every rank's copy against the plain version;
    edge cases, each through the variant `ops.variant` names; three calls
    bit-equal; timings of both variants, the library and the plain version."""
    import torch.nn.functional as F

    from repro_torch.core import collectives
    from repro_torch.kernels.ring_matmul import ops as rops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.ring_matmul import ref as rref
    from repro_torch.mesh import Mesh
    from repro_torch.parallel.overlap import CollectiveStrategist

    x = taps["x"].reshape(-1, taps["x"].shape[-1])              # [B*S, D] post-norm
    hidden = F.silu(x @ taps["w_gate"]) * (x @ taps["w_in"])     # [B*S, F], as L.mlp
    shard = lambda w, n: w.reshape(n, w.shape[0] // n, w.shape[1])  # noqa: E731
    cases = {"up": (x.T.contiguous(), taps["w_in"]),
             "down": (hidden.T.contiguous(), taps["w_out"])}
    mesh = Mesh(RING_N, device="cuda")
    strat = CollectiveStrategist()
    plans = {name: strat.allgather_matmul_plan(xt.shape[1], xt.shape[0], w.shape[1], RING_N)
             for name, (xt, w) in cases.items()}

    kept: dict = {}
    real = rops.ring_matmul_ranks

    def keep(x_t, w, m, variant=None):  # every rank's copy; launches via the wrapper
        kept[len(kept)] = real(x_t, w, m, variant)
        return kept[len(kept) - 1]

    rops.ring_matmul_ranks = keep
    rops.launches = 0
    rops.launches_by_variant.update(wgmma=0, simt=0)
    try:
        ys = {name: rops.ring_matmul(xt, shard(w, RING_N), mesh)
              for name, (xt, w) in cases.items()}
        torch.cuda.synchronize()
    finally:
        rops.ring_matmul_ranks = real
    launches, by_variant = rops.launches, dict(rops.launches_by_variant)
    if launches != len(cases) or by_variant["wgmma"] != len(cases):
        raise AssertionError(f"ring_matmul: {launches} launches ({by_variant}) for "
                             f"{len(cases)} calls, want one \"wgmma\" launch a call")

    def check(name, x_t, w, ranks):
        want = rref.ring_matmul_ref(x_t, w, Mesh(w.shape[0], device="cuda"))
        scale = float(want.abs().max())
        errs = [float((ranks[r] - want).abs().max()) for r in range(w.shape[0])]
        if not torch.isfinite(ranks).all() or max(errs) > RING_TOL * scale:
            raise AssertionError(f"ring_matmul vs plain ({name}): rank errors {errs}, "
                                 f"tol {RING_TOL} x {scale}")
        return max(errs), max(errs) / scale

    errs = {}
    for i, (name, (xt, w)) in enumerate(cases.items()):
        if not torch.equal(ys[name], kept[i][0]):
            raise AssertionError(f"ring_matmul ({name}): the returned Y is not rank 0's copy")
        errs[name] = check(name, xt, shard(w, RING_N), kept[i])
    xt, w = cases["up"]
    edge = {"n = 1": (xt, shard(w, 1), "wgmma"), "n = 8": (xt, shard(w, 8), "wgmma"),
            "n = 3": (xt, shard(w, 3), "wgmma"), "n = 6": (xt, shard(w, 6), "wgmma"),
            "n = 7, K/n = 37": (xt[:259].contiguous(), shard(w[:259], 7), "wgmma"),
            "K/n = 37": (xt[:148].contiguous(), shard(w[:148], RING_N), "wgmma"),
            "m = 16": (xt[:, :16].contiguous(), shard(w, RING_N), "wgmma"),
            "f32": (cases["down"][0].float(), shard(cases["down"][1].float(), RING_N), "simt"),
            "m = 300": (xt[:, :300].contiguous(), shard(w, RING_N), "simt")}
    for name, (ex, ew, want_kind) in edge.items():
        kind = rops.variant(ex.dtype, ew.shape[0], ex, ew)
        if kind != want_kind:
            raise AssertionError(f"ring_matmul ({name}): variant {kind!r}, want {want_kind!r}")
        before = dict(rops.launches_by_variant)
        ranks = rops.ring_matmul_ranks(ex, ew, Mesh(ew.shape[0], device="cuda"))
        if rops.launches_by_variant[kind] - before[kind] != (1 if kind == "wgmma" else ew.shape[0]):
            raise AssertionError(f"ring_matmul ({name}): launches {rops.launches_by_variant} "
                                 f"(before {before}) for one {kind!r} call")
        errs[f"{name} ({kind})"] = check(name, ex, ew, ranks)
    log("ring_matmul vs plain (every rank's copy; max abs err / max |Y|): "
        + ", ".join(f"{k} {a:.3g} / {r:.3g}" for k, (a, r) in errs.items())
        + f" (tol {RING_TOL} x max |Y|)")
    for name, (xt, w) in cases.items():
        first = rops.ring_matmul_ranks(xt, shard(w, RING_N), mesh)
        if not all(torch.equal(rops.ring_matmul_ranks(xt, shard(w, RING_N), mesh), first)
                   for _ in range(2)):
            raise AssertionError(f"ring_matmul ({name}): three calls are not bit-equal")
    log("ring_matmul: three calls of each projection bit-equal")

    times = {}
    for name, (xt, w) in cases.items():
        ws = shard(w, RING_N)
        n, ks, N = ws.shape
        K, m = xt.shape
        k_ms = time_ms(lambda: rops.ring_matmul_ranks(xt, ws, mesh), reps=20)
        w1, mesh1 = shard(w, 1), Mesh(1, device="cuda")      # one copy, no ring
        one_ms = time_ms(lambda: rops.ring_matmul_ranks(xt, w1, mesh1), reps=20)
        s_ms = time_ms(lambda: rops.ring_matmul_ranks(xt, ws, mesh, variant="simt"), reps=5,
                       warmup=1)
        p_ms = time_ms(lambda: rref.ring_matmul_ref(xt, ws, mesh), reps=5, warmup=1)
        l_ms = time_ms(lambda: torch.matmul(
            xt.T, collectives.ring_all_gather(ws, mesh).reshape(n, K, N)), reps=20)
        # the plan's unfused arm: kernel row 7 gathers W (its bf16 pairs as
        # 32-bit words), then one torch.matmul; each part also alone
        u_ms = time_ms(lambda: unfused_arm(torch, rma_ops, xt, ws, mesh), reps=20)
        if not torch.equal(unfused_arm(torch, rma_ops, xt, ws, mesh), torch.matmul(
                xt.T, collectives.ring_all_gather(ws, mesh).reshape(n, K, N))):
            raise AssertionError(f"ring_matmul ({name}): the unfused arm's gather differs "
                                 "from core.collectives.ring_all_gather's")
        gathered = collectives.ring_all_gather(ws, mesh).reshape(n, K, N)
        ag_ms = time_ms(lambda: rma_ops.ring_all_gather(ws.view(torch.int32), mesh), reps=20)
        mm_ms = time_ms(lambda: torch.matmul(xt.T, gathered), reps=20)
        del gathered
        flops = 2 * n * m * K * N
        nbytes = xt.numel() * xt.element_size() + ws.numel() * ws.element_size() + n * m * N * 4
        bound_ms, bound_by = max((flops / BF16_FLOPS_PER_S * 1e3, "operations"),
                                 (nbytes / hbm * 1e3, "bytes"))
        rate = ", ".join(f"{what} {t:.3f} ms ({flops / t / 1e9:.1f} TFLOP/s, "
                         f"{bound_ms / t:.1%} of the bound)"
                         for what, t in (("wgmma", k_ms), ("simt", s_ms),
                                         ("unfused ring_all_gather + torch.matmul", l_ms),
                                         ("plain", p_ms)))
        log(f"ring_matmul {name} projection of layer 0 ({card_line()}): x_t {tuple(xt.shape)}, "
            f"w {tuple(ws.shape)} {xt.dtype}, n = {RING_N}, {rops.plan(n, ks, N)}: "
            f"allgather_matmul_plan {plans[name]!r}; {rate}; the same kernel at n = 1 (one "
            f"copy, no ring, {rops.plan(1, K, N)}) {one_ms:.3f} ms, x {n} = "
            f"{n * one_ms:.3f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.1f} GFLOP for the {n} copies at "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {nbytes / 1e6:.1f} MB at "
            f"{hbm / 1e12:.2f} TB/s)")
        # the plan's choice against the two arms as measured here
        model = strat.model
        price = {"fused_ring": model.p_ring_matmul(m, K, N, n),
                 "unfused": model.p_allgather_matmul(m, K, N, n)}
        measured = {"fused_ring": k_ms, "unfused": u_ms}
        fastest = min(measured.values())
        log(f"allgather_matmul_plan at the {name} projection: {plans[name]!r}; priced "
            f"fused_ring {price['fused_ring'] * 1e3:.4f} / unfused {price['unfused'] * 1e3:.4f} "
            f"ms; measured fused_ring {k_ms:.4f} / unfused {u_ms:.4f} ms (row 7's all-gather "
            f"{ag_ms:.4f} ms, {(1 + n) * K * N * 2 / ag_ms / 1e9:.3f} TB/s; torch.matmul "
            f"{mm_ms:.4f} ms, {flops / mm_ms / 1e9:.1f} TFLOP/s; the kernel's forward at "
            f"{fwd_rate(m, K, N, n, k_ms, one_ms) / 1e12:.3f} TB/s, its one-copy products at "
            f"{flops / n / one_ms / 1e9:.1f} TFLOP/s; core.collectives.ring_all_gather + "
            f"torch.matmul {l_ms:.4f} ms)")
        if measured[plans[name]] > 1.05 * fastest:
            raise AssertionError(f"allgather_matmul_plan chose {plans[name]!r} at the {name} "
                                 f"projection: {measured[plans[name]]:.4f} ms, more than 5 % "
                                 f"above the faster arm's {fastest:.4f} ms")
        times[name] = {"ms": k_ms, "simt_ms": s_ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "one_copy_ms": one_ms,
                       "unfused_ms": u_ms, "all_gather_ms": ag_ms, "matmul_ms": mm_ms}
    # a 16-token call: one tile of m, where the model prices one launch above
    # the ring (recorded, not held: the plan's decision here is the model's)
    xt, w = cases["up"]
    x16, w16 = xt[:, :16].contiguous(), shard(w, RING_N)
    k16 = time_ms(lambda: rops.ring_matmul_ranks(x16, w16, mesh), reps=20)
    u16 = time_ms(lambda: unfused_arm(torch, rma_ops, x16, w16, mesh), reps=20)
    log(f"allgather_matmul_plan at m = 16 (the up projection's first 16 tokens): "
        f"{strat.allgather_matmul_plan(16, xt.shape[0], w.shape[1], RING_N)!r}; priced "
        f"fused_ring {strat.model.p_ring_matmul(16, xt.shape[0], w.shape[1], RING_N) * 1e3:.4f}"
        f" / unfused {strat.model.p_allgather_matmul(16, xt.shape[0], w.shape[1], RING_N) * 1e3:.4f}"
        f" ms; measured fused_ring {k16:.4f} / unfused {u16:.4f} ms")
    return {"variant": "wgmma", "launches": launches, "max_abs_err": errs["up"][0],
            **times["up"]}


def training_phases(torch, hbm: float) -> list:
    """SmolLM-360M trained at full width through the flash kernel (T1), the
    launcher and the resume contract on the card and a checkpoint's rate
    (T2), and kernel row 13 through its ops surface on T1's activations (T3)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    model = build_model(get_config(MODEL_ARCH))
    state = train_phase(torch, np, model, L, fops)
    torch.cuda.empty_cache()
    resume_phase(torch, np, state)
    ring = ring_phase(torch, state["taps"], hbm)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return [{"name": "ring_matmul", "route": KERNELS["ring_matmul"][0],
             "source": KERNELS["ring_matmul"][1], "replaces": KERNELS["ring_matmul"][2],
             **ring}]


# ------------------------------------------ the rest of the model zoo
def xlstm_checks(torch, model, params, toks, max_seq: int) -> dict:
    """Over toks [1, S + 1]: the next-token logits of a prefill of S tokens
    in two chunks against the one-shot prefill, and prefill(S) and
    prefill(S) + decode against `forward_logits` over S + 1 tokens at S - 1
    and S (chunkwise vs recurrent).  Returns (got, want) pairs, f32 (f64
    in an f64 run: f32 would round its differences to f32 ulps)."""
    S = toks.shape[1] - 1

    def wide(t):
        return t if t.dtype == torch.float64 else t.float()

    def prefill(lo, hi, cache=None):
        if cache is None:
            cache = model.init_cache(1, max_seq, device="cuda")
        return model.prefill(params, toks[:, lo:hi], cache)

    one, cache = prefill(0, S)
    _, half = prefill(0, S // 2)
    two, _ = prefill(S // 2, S, half)
    dec, _ = model.decode_step(params, toks[:, S], cache)
    full = wide(model.forward_logits(params, {"tokens": toks}).logits[0])
    return {"two-chunk prefill vs one-shot": (wide(two[0]), wide(one[0])),
            "prefill(S) vs forward_logits at S-1": (wide(one[0]), full[S - 1]),
            "prefill(S) + decode vs forward_logits at S": (wide(dec[0]), full[S])}


def xlstm_phase(torch) -> dict:
    """xLSTM-1.3B at its published widths: the continuous-batching engine
    in bf16 (every lane held to a fresh cache before its prefill; 8
    requests re-run in their own lane, bit-equal), a decode step's and a
    512-token prefill's ATen calls and time; then, the weights cast to f32,
    the engine over 8 requests held to batch-1 solo runs, a two-chunk
    prefill against the one-shot one and prefill(S) + decode against
    `forward_logits` over S + 1 tokens (chunkwise vs recurrent), with the
    bf16 differences of the same comparisons logged beside; then the same
    three comparisons in f64, the witness that tells rounding from a fault
    (rounding falls with the precision, a fault in the chunking or the
    recurrence does not), and each f32 result's distance from its f64
    counterpart."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import engine as engine_mod

    torch.cuda.reset_peak_memory_stats()
    model, params = full_width(torch, build_model, get_config, XLSTM_ARCH,
                               get_config(XLSTM_ARCH).n_layers, XLSTM_SEED)
    cfg, spec, bound, S = model.cfg, XLSTM_ENGINE, XLSTM_F32_BOUND, XLSTM_S
    g = torch.Generator(device="cuda").manual_seed(XLSTM_SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=g, device="cuda")
    with torch.no_grad():
        run = engine_phase(torch, np, model, params, engine_mod, spec)
        if run["prefills"] <= spec["slots"]:
            raise AssertionError(f"xlstm engine: no lane recycled in {run['prefills']} "
                                 "prefills")
        engine_peak = torch.cuda.max_memory_allocated()
        cache = model.init_cache(1, spec["max_seq"], device="cuda")
        _, cache = model.prefill(params, toks[:, :16], cache)
        decode_calls = aten_counter()
        with decode_calls:
            model.decode_step(params, toks[:, 16], cache)
        times = []
        for _ in range(2):
            cache = model.init_cache(1, spec["max_seq"], device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, toks[:, :S], cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        calls = aten_counter()
        with calls:
            model.prefill(params, toks[:, :S], cache)
        del cache
        bf16_errs = {k: float((a - b).abs().max())
                     for k, (a, b) in xlstm_checks(torch, model, params, toks,
                                                   spec["max_seq"]).items()}
        params = wide_tree(params, torch.float32)
        gc.collect()
        torch.cuda.empty_cache()
        f32_model = WideState(model, torch.float32)
        run32 = engine_phase(torch, np, f32_model, params, engine_mod, XLSTM_F32_ENGINE)
        checks = xlstm_checks(torch, f32_model, params, toks, spec["max_seq"])
        params = wide_tree(params, torch.float64)
        gc.collect()
        torch.cuda.empty_cache()
        checks64 = xlstm_checks(torch, WideState(model, torch.float64), params, toks,
                                spec["max_seq"])
    errs, bad = {}, []
    for what, (got, want) in checks.items():
        errs[what] = float((got - want).abs().max())
        sure = float(margins(torch, want)) > bound
        if not torch.isfinite(got).all() or errs[what] > bound or (
                sure and int(got.argmax()) != int(want.argmax())):
            bad.append(f"{what}: argmax {int(got.argmax())} vs {int(want.argmax())}")
    errs64 = {what: float((got - want).abs().max()) for what, (got, want) in checks64.items()}
    bad += [f"{what} in f64: {e}" for what, e in errs64.items()
            if not math.isfinite(e) or e > XLSTM_F64_BOUND]
    # how far f32 rounding moved each side of each comparison
    drift = {what: max(float((x.double() - y).abs().max())
                       for x, y in zip(checks[what], checks64[what])) for what in checks}
    scale = max(float(want.abs().max()) for _, want in checks.values())
    log("xlstm logits max abs err in f64 / f32 (bf16): " + ", ".join(
        f"{k} {errs64[k]:.3g} / {v:.4g} ({bf16_errs[k]:.4g})" for k, v in errs.items())
        + f"; f64 bound {XLSTM_F64_BOUND}, f32 bound {bound}, logits up to {scale:.3g}; each "
        "f32 run's largest distance from the f64 run of the same comparison: "
        + ", ".join(f"{k} {v:.4g}" for k, v in drift.items()))
    if bad:
        raise AssertionError(f"xlstm beyond the bounds: {bad}")
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = float(np.median(times)) * 1e3
    n_sl = cfg.n_layers // cfg.slstm_period
    log(f"xlstm ({cfg.name}, {cfg.n_layers} layers; {card_line()}): engine decode "
        f"{run['decode_ms']:.3f} ms/step (median, {spec['slots']} lanes), prefill p50 "
        f"{run['prefill_p50_ms']:.2f} ms, {run['tokens_per_s']:.1f} tokens/s; every one of the "
        f"{run['lanes_checked']} prefills found its lane equal to a fresh cache (the sLSTM m "
        f"at -1e30, {run['prefills'] - spec['slots']} of them on recycled lanes); "
        f"{spec['checked']} requests re-run in their own lane bit-equal to the engine over "
        f"{run['positions']} positions; in f32 the engine over {XLSTM_F32_ENGINE['requests']} "
        f"requests within {run32['logits_err']:.4g} of batch-1 solo runs (bound "
        f"{XLSTM_F32_ENGINE['bound']}); a batch-1 decode step makes {decode_calls.n} ATen "
        f"calls; a {S}-token prefill {prefill_ms:.1f} ms (median of 2) and {calls.n} ATen "
        f"calls ({n_sl} sLSTM loops of {S} steps); peak memory {engine_peak / 2**30:.2f} GiB "
        f"in the engine run, {peak / 2**30:.2f} GiB in all (the f32 and f64 copies included)")
    del params, model, checks, checks64
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_ms": run["decode_ms"], "prefill_p50_ms": run["prefill_p50_ms"],
            "tokens_per_s": run["tokens_per_s"], "decode_aten_calls": decode_calls.n,
            "prefill_512_ms": prefill_ms, "prefill_512_aten_calls": calls.n,
            "engine_peak_gib": engine_peak / 2**30, "peak_gib": peak / 2**30,
            "engine_logits_err": run["logits_err"], "lanes_checked": run["lanes_checked"],
            "f32_engine_logits_err": run32["logits_err"],
            **{k: v for k, v in zip(("chunked_err", "prefill_err", "decode_err"),
                                    errs.values())},
            **{k: v for k, v in zip(("f64_chunked_err", "f64_prefill_err", "f64_decode_err"),
                                    errs64.values())},
            **{k: v for k, v in zip(("f32_chunked_drift", "f32_prefill_drift",
                                     "f32_decode_drift"), drift.values())},
            **{k: v for k, v in zip(("bf16_chunked_err", "bf16_prefill_err", "bf16_decode_err"),
                                    bf16_errs.values())}}


def wide_tree(tree: dict, dtype) -> dict:
    return {k: wide_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


class WideState:
    """The model as it is, but every floating leaf of its caches in `dtype`
    (f32: the sLSTM h, bf16 otherwise; f64: every state leaf).  With
    weights in the same dtype the whole xLSTM then runs in it."""

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init_cache(self, *args, **kw):
        cache = self.model.init_cache(*args, **kw)
        return {k: (wide_tree(v, self.dtype) if isinstance(v, dict)
                    else v.to(self.dtype) if v.is_floating_point() else v)
                for k, v in cache.items()}


def whisper_decode(torch, model, params, prompts: list, frames, new: int, max_seq: int):
    """The requests' common prompt prefix in one `Model.prefill` with their
    frames, then `decode_step`s over all lanes: a lane feeds its next prompt
    token until its prompt is spent, then its greedy token, until each has
    `new` outputs.  Returns (outputs, the logits each output was taken
    from, the cache, prefill seconds, each decode step's seconds)."""
    n = len(prompts)
    m0 = min(len(p) for p in prompts)
    cache = model.init_cache(n, max_seq, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, torch.tensor([p[:m0] for p in prompts],
                                                       device="cuda"),
                                  cache, {"frames": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    outs, kept, step_s, pos = [[] for _ in range(n)], [[] for _ in range(n)], [], m0
    while True:
        greedy = logits.argmax(-1).tolist()
        nxt = []
        for i, p in enumerate(prompts):
            if pos < len(p):
                nxt.append(p[pos])
                continue
            if len(outs[i]) < new:
                outs[i].append(greedy[i])
                kept[i].append(logits[i].float().clone())
            nxt.append(greedy[i])
        if all(len(o) == new for o in outs):
            return outs, kept, cache, prefill_s, step_s
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, torch.tensor(nxt, device="cuda"), cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pos += 1


def whisper_phase(torch, hbm: float) -> dict:
    """whisper-small at its published widths: 8 requests' frames encoded in
    one `Model.prefill` under backend "cuda" (kernel row 11 launched once a
    encoder layer, all "wgmma", counts zeroed just before and read after),
    greedy `decode_step`s, the outputs held to a teacher-forced
    `forward_logits` (backend "torch") over prompt + output, the encoder
    output held to backend "torch", and row 11 at the encoder's shape
    against its plain version, SDPA and the bound."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    model, params = full_width(torch, build_model, get_config, WHISPER_ARCH,
                               get_config(WHISPER_ARCH).n_layers, WHISPER_SEED)
    cfg, spec = model.cfg, WHISPER_RUN
    n, new, bound = spec["requests"], spec["new"], spec["bound"]
    rng = np.random.default_rng(spec["seed"])
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(spec["plen"][0], spec["plen"][1] + 1))).tolist()
               for _ in range(n)]
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    frames = torch.randn(n, cfg.encoder_seq, cfg.d_model, generator=g, device="cuda")
    first: dict = {}
    real = fops.flash_attention

    def tap(q, k, v, causal=True):      # keeps encoder layer 0's inputs; launches via the wrapper
        if not first:
            first.update(q=q.clone(), k=k.clone(), v=v.clone(), causal=causal)
        return real(q, k, v, causal=causal)

    with torch.no_grad():
        L.set_attention_backend("cuda")
        fops.flash_attention = tap
        fops.launches = 0
        fops.launches_by_variant.update(wgmma=0, simt=0)
        try:
            outs, kept, cache, prefill_s, step_s = whisper_decode(
                torch, model, params, prompts, frames, new, spec["max_seq"])
        finally:
            fops.flash_attention = real
            L.set_attention_backend("torch")
        launches, by_variant = fops.launches, dict(fops.launches_by_variant)
        want_launches = cfg.encoder_layers
        if launches != want_launches or by_variant != {"wgmma": want_launches, "simt": 0} \
                or first.get("causal") is not False:
            raise AssertionError(f"whisper: {launches} flash launches {by_variant} for one "
                                 f"prefill, want {want_launches}, all wgmma and non-causal")
        enc_torch = T.encode(params, cfg, frames)
        enc = cache["enc_out"]
        enc_err = float((enc.float() - enc_torch.float()).abs().max())
        enc_mean = float((enc.float() - enc_torch.float()).abs().mean())
        if enc.dtype != torch.bfloat16 or not torch.isfinite(enc).all() or enc_err > ENC_BOUND:
            raise AssertionError(f"whisper encoder: backend cuda vs torch max abs err {enc_err} "
                                 f"(bound {ENC_BOUND}), dtype {enc.dtype}")
        del enc_torch, cache
        err, sure_n, agree_n = 0.0, 0, 0
        for i, p in enumerate(prompts):
            seq = torch.tensor([p + outs[i][:-1]], device="cuda")
            ref = model.forward_logits(params, {"tokens": seq, "frames": frames[i:i + 1]})
            ref = ref.logits[0, len(p) - 1:].float()
            got = torch.stack(kept[i])
            err = max(err, float((got - ref).abs().max()))
            sure = margins(torch, ref) > bound
            agree = ref.argmax(-1) == torch.tensor(outs[i], device="cuda")
            if not bool(agree[sure].all()) or not torch.isfinite(got).all():
                raise AssertionError(f"whisper request {i}: greedy tokens differ from the "
                                     f"teacher-forced forward where the margin exceeds {bound}")
            sure_n, agree_n = sure_n + int(sure.sum()), agree_n + int(agree.sum())
        if err > bound:
            raise AssertionError(f"whisper: decode logits vs teacher-forced forward_logits max "
                                 f"abs err {err} > {bound}")
    peak = torch.cuda.max_memory_allocated()
    decode_ms = float(np.median(step_s)) * 1e3
    B, Hq, Sq, hd = first["q"].shape
    Sk = first["k"].shape[2]
    xkv_flops = 2 * 2 * n * cfg.encoder_seq * cfg.d_model * cfg.n_kv_heads * cfg.hd * cfg.n_layers
    log(f"whisper ({cfg.name}, {cfg.encoder_layers} + {cfg.n_layers} layers; {card_line()}): "
        f"{n} requests of {min(map(len, prompts))}-{max(map(len, prompts))} prompt tokens, "
        f"{new} new each; one prefill of the common prefix with frames {tuple(frames.shape)} "
        f"{prefill_s * 1e3:.1f} ms with {launches} flash launches, all wgmma, non-causal at "
        f"q {tuple(first['q'].shape)}; {len(step_s)} decode steps, {decode_ms:.3f} ms/step "
        f"(median; each recomputes the cross K/V: {xkv_flops / 1e9:.1f} GFLOP a step), "
        f"{n * new / (prefill_s + sum(step_s)):.1f} tokens/s; encoder output backend cuda vs "
        f"torch max abs err {enc_err:.4g}, mean {enc_mean:.3g} (bound {ENC_BOUND}); decode "
        f"logits vs teacher-forced forward_logits (backend torch) max abs err {err:.4g} "
        f"(bound {bound}), argmax == token at {agree_n}/{n * new}, at every one of the "
        f"{sure_n} whose top-2 margin exceeds the bound; peak memory {peak / 2**30:.2f} GiB")
    del params, model, frames
    gc.collect()
    torch.cuda.empty_cache()

    q, k, v = first["q"], first["k"], first["v"]
    out = fops.flash_attention(q, k, v, causal=False)
    want = fref.attention_ref(q, k, v, causal=False)
    kerr = float((out.float() - want.float()).abs().max())
    ktol = scaled_tol(want)
    w_mean, w_max = float(want.float().abs().mean()), float(want.float().abs().max())
    if not torch.isfinite(out).all() or kerr > ktol:
        raise AssertionError(f"flash_attention vs plain (whisper encoder layer 0): max abs err "
                             f"{kerr} > {ktol}")
    del out, want
    k_ms = time_ms(lambda: fops.flash_attention(q, k, v, causal=False))
    p_ms = time_ms(lambda: fref.attention_ref(q, k, v, causal=False), reps=10, warmup=1)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=False))
    flops = 4 * B * Hq * Sq * Sk * hd           # non-causal: QK^T and PV over every key
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = max((flops / BF16_FLOPS_PER_S * 1e3, "operations"),
                             (nbytes / hbm * 1e3, "bytes"))
    log(f"flash_attention at the whisper encoder's shape q {tuple(q.shape)} kv "
        f"{tuple(k.shape)} {q.dtype} non-causal (wgmma; {card_line()}): max abs err vs plain "
        f"{kerr:.3g} (tol {ktol:.3g} = {BF16_TOL} x min(1, max |plain|); |plain| mean "
        f"{w_mean:.3g}, max {w_max:.3g}); kernel {k_ms * 1e3:.1f} us ({flops / k_ms / 1e9:.1f} "
        f"TFLOP/s), plain {p_ms * 1e3:.1f} us, sdpa {l_ms * 1e3:.1f} us "
        f"({flops / l_ms / 1e9:.1f} TFLOP/s), bound {bound_ms * 1e3:.1f} us ({bound_by})")
    del first, q, k, v
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_s * 1e3, "decode_ms": decode_ms, "decode_steps": len(step_s),
            "enc_err": enc_err, "logits_err": err, "peak_gib": peak / 2**30,
            "row11": {"encoder_launches": launches, "encoder_max_abs_err": kerr,
                      "encoder_tol": ktol, "encoder_out_mean": w_mean, "encoder_out_max": w_max,
                      "encoder_ms": k_ms, "encoder_plain_ms": p_ms, "encoder_library_ms": l_ms,
                      "encoder_bound_ms": bound_ms, "encoder_bound_by": bound_by,
                      "encoder_tflops": flops / k_ms / 1e9}}


def zoo_phases(torch, hbm: float) -> dict:
    """Phase 24: xLSTM-1.3B and whisper-small, each with its wall time."""
    out = {"card": card_line()}
    for name, fn in (("xlstm", lambda: xlstm_phase(torch)),
                     ("whisper", lambda: whisper_phase(torch, hbm))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["wall_s"] = time.perf_counter() - t0
        log(f"{name} phase: {out[name]['wall_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    out["row11"] = out["whisper"].pop("row11")
    return out


# ------------------------------------------------------ the device page pool
def pool_census(np, ids) -> list:
    """(owner, page id) of every granted id in an alloc epoch's
    [p(origin), p(target), kmax] ids."""
    o, t, j = np.nonzero(ids >= 0)
    return list(zip(t.tolist(), ids[o, t, j].tolist()))


def pool_rows(np, p: int, refs: list) -> tuple:
    """A refcount round's [p, k] ids and owners for `refs`, dealt to the
    origins in turn (-1 = a no-op slot)."""
    k = max(1, -(-len(refs) // p))
    ids = np.full((p, k), -1, np.int32)
    own = np.full((p, k), -1, np.int32)
    if refs:
        arr = np.asarray(refs, np.int32)
        j = np.arange(len(refs))
        ids[j % p, j // p] = arr[:, 1]
        own[j % p, j // p] = arr[:, 0]
    return ids, own


class PoolTwin:
    """The device pool and its copy on the CPU, driven by the same calls:
    every integer result (meta, free stack, head, ids, grants, freed
    counts) must be bit-equal, and conservation must hold on the card after
    every epoch."""

    def __init__(self, torch, np, heap, Mesh):
        self.torch, self.np, self.heap = torch, np, heap
        self.mesh = {k: Mesh(POOL_P, "kv", device=d)
                     for k, d in (("card", "cuda"), ("host", "cpu"))}
        self.desc, self.st = {}, {}
        for d, mesh in self.mesh.items():
            self.desc[d], self.st[d] = heap.pool_allocate(mesh, POOL_PAGES, POOL_PAGE)
        self.epochs = 0

    def same(self, what: str, outs: dict) -> None:
        torch = self.torch
        card, host = outs["card"], outs["host"]
        for name in ("meta", "free_stack", "head"):
            if not torch.equal(getattr(self.st["card"], name).cpu(), getattr(self.st["host"], name)):
                raise AssertionError(f"pool {what}: the card's {name} differs from the CPU copy's")
        for a, b in zip(card, host):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"pool {what}: a result differs from the CPU copy's")

    def check(self, what: str, errors: int = 0) -> dict:
        cons = self.heap.conservation(self.desc["card"], self.st["card"])
        if not ((cons["free_plus_live"] == cons["capacity"]).all()
                and cons["stack_consistent"].all()
                and int(cons["protocol_errors"].sum()) == errors):
            raise AssertionError(f"pool {what}: conservation broken: {cons}")
        return cons

    def call(self, what: str, fn, *arrays, check: bool = True):
        """fn(desc, state, *tensors) on both; returns the card's results
        after the state (as numpy)."""
        outs = {}
        for k, mesh in self.mesh.items():
            res = fn(self.desc[k], self.st[k],
                     *[self.torch.as_tensor(a).to(mesh.device) for a in arrays])
            self.st[k], outs[k] = res[0], res[1:]
        self.same(what, outs)
        self.epochs += 1
        if check:
            self.check(what)
        return [r.cpu().numpy() for r in outs["card"]]

    def alloc(self, what: str, want, check: bool = True):
        return self.call(what, lambda d, s, w: self.heap.alloc(d, s, w, POOL_KMAX), want,
                         check=check)

    def ref_update(self, what: str, refs: list, delta: int, check: bool = True):
        ids, own = pool_rows(self.np, POOL_P, refs)
        return self.call(what, self.heap.ref_update, ids, own,
                         self.np.full(ids.shape, delta, self.np.int32), check=check)[0]

    def resize(self, what: str, fn, n: int) -> tuple:
        """`pool_grow` / `pool_shrink` on both; returns the card's call's
        CUDA-event and host ms."""
        torch = self.torch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        t0 = time.perf_counter()
        self.desc["card"], self.st["card"] = fn(self.mesh["card"], self.desc["card"],
                                                self.st["card"], n)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        torch.cuda.synchronize()
        self.desc["host"], self.st["host"] = fn(self.mesh["host"], self.desc["host"],
                                                self.st["host"], n)
        self.same(what, {"card": (), "host": ()})
        self.check(what)
        return ev[0].elapsed_time(ev[1]), host_ms


def epoch_times(torch, fn, reps: int = POOL_REPS) -> dict:
    """One epoch call's host time (until the call returns) and CUDA-event
    time, each the median of `reps` calls with their spread, the device
    time a call queued behind a spin kernel (8 calls, so the host queues
    them inside the spin), and the ATen calls a call makes."""
    host, event = [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        ev[0].record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6)
        ev[1].record()
        torch.cuda.synchronize()
        event.append(ev[0].elapsed_time(ev[1]) * 1e3)
    counter = aten_counter()
    with counter:
        fn()
    host.sort()
    event.sort()
    return {"host_us": host[reps // 2], "host_us_range": [host[0], host[-1]],
            "event_us": event[reps // 2], "event_us_range": [event[0], event[-1]],
            "queued_us": queued_ms(fn, 8) * 1e3, "aten_calls": counter.n}


def pool_phase(torch, hbm: float) -> dict:
    """The device page pool (`rmem.heap`) at the size of a disaggregated
    deployment's decode-side KV pool, following `tests/subtests/rmem_sub.py`
    sections 1-7, every integer result held to the same calls on a CPU
    copy; row 3 reads the scattered pages back.  Returns the phase's
    numbers and row 3's at this page shape."""
    import numpy as np

    from repro_torch.core import plan as plan_mod
    from repro_torch.core import window as window_mod
    from repro_torch.core.perfmodel import DEFAULT_MODEL
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.paged_gather import ref as pg_ref
    from repro_torch.mesh import Mesh
    from repro_torch.rmem import heap, pages

    t_start = time.perf_counter()
    p, n, kmax = POOL_P, POOL_PAGES, POOL_KMAX
    tw = PoolTwin(torch, np, heap, Mesh)
    desc = tw.desc["card"]
    rng = np.random.RandomState(POOL_SEED)
    log(f"pool: p {p}, {n} pages of {POOL_PAGE} f32 ({desc.page_nbytes} bytes) a rank, "
        f"{tw.st['card'].pages.numel() * 4 / 2**30:.2f} GiB of pages, kmax {kmax}, "
        f"metadata {desc.metadata_nbytes()} bytes ({card_line()})")

    # 1. alloc epochs from all 8 origins (a full request to each of half of
    # the targets, 3/8 of one to the others) until grants clamp
    want = np.broadcast_to(np.where(np.arange(p) < p // 2, kmax, 3 * kmax // 8),
                           (p, p)).astype(np.int32)
    held, first = [], None
    while True:
        ids, granted = tw.alloc(f"alloc epoch {tw.epochs}", want)
        held += pool_census(np, ids)
        first = ids if first is None else first
        if (granted < want).any() or tw.epochs > 8:
            break
    free = tw.st["card"].head[:, heap.FREE_TOP].cpu().numpy()
    dry = [int(t) for t in np.nonzero(free == 0)[0]]
    if not dry or not (granted < want).any():
        raise AssertionError(f"pool: no target ran dry after {tw.epochs} epochs ({free})")
    log(f"pool alloc: {tw.epochs} epochs, targets {dry} dry and clamped, "
        f"{len(held)} pages live")

    # 2. share (+1), then two releases of the first epoch's pages
    refs = pool_census(np, first)
    gen0 = tw.st["card"].meta[..., heap.GEN].cpu().numpy()
    freed = [int(tw.ref_update(f"{what} round", refs, d).sum())
             for what, d in (("share", 1), ("release 1", -1), ("release 2", -1))]
    gen1 = tw.st["card"].meta[..., heap.GEN].cpu().numpy()
    mask = np.zeros((p, n), bool)
    mask[tuple(np.asarray(refs).T)] = True
    if freed != [0, 0, len(refs)] or not np.array_equal(gen1 != gen0, mask):
        raise AssertionError(f"pool share/release: freed {freed} of {len(refs)}, "
                             f"{int((gen1 != gen0).sum())} generations bumped")
    gone = set(refs)
    held = [r for r in held if r not in gone]

    # 3. a tag taken at alloc is stale after free and realloc
    t_pid, pid = refs[0]
    ids, _ = tw.alloc("realloc", want)
    held += pool_census(np, ids)
    tag_ids = torch.full((p, 1), -1, dtype=torch.int32, device="cuda")
    tag_ids[t_pid, 0] = pid
    gens = torch.zeros((p, 1), dtype=torch.int64, device="cuda")
    stale = heap.tag_valid(tw.st["card"], tag_ids, gens + int(gen0[t_pid, pid]))
    fresh = heap.tag_valid(tw.st["card"], tag_ids,
                           gens + tw.st["card"].meta[t_pid, pid, heap.GEN])
    if bool(stale.any()) or not bool(fresh[t_pid, 0]):
        raise AssertionError("pool ABA: a stale tag validated, or the fresh one did not")

    # 4. seeded random alloc/free traffic; conservation after every epoch
    for e in range(POOL_RANDOM):
        ids, _ = tw.alloc(f"random alloc {e}", rng.randint(0, kmax + 1, (p, p)).astype(np.int32))
        held += pool_census(np, ids)
        rng.shuffle(held)
        rel, held = held[:len(held) // 2], held[len(held) // 2:]
        tw.ref_update(f"random release {e}", rel, -1)
    live = int(tw.check("census")["live"].sum())
    if live != len(held):
        raise AssertionError(f"pool census: {live} live on the card, {len(held)} held")
    tw.ref_update("drain", held, -1)
    if int(tw.check("drained")["live"].sum()):
        raise AssertionError("pool: pages live after the drain")
    log(f"pool traffic: {POOL_RANDOM} random epochs, census {live} live pages, drained; "
        f"{tw.epochs} epochs bit-equal to the CPU copy")

    # timings at the drained pool: an alloc epoch (a full request from every
    # origin to every target) and the release of what it granted
    full = np.full((p, p), kmax, np.int32)
    st0 = tw.st["card"]
    want_d = torch.as_tensor(full, device="cuda")
    st_a, ids_a, _ = heap.alloc(desc, st0, want_d, kmax)
    rel_ids = ids_a.reshape(p, -1)
    rel_own = torch.arange(p, device="cuda").repeat_interleave(kmax).expand(p, -1)
    rel_own = torch.where(rel_ids >= 0, rel_own, torch.full_like(rel_own, -1))
    times = {"alloc": epoch_times(torch, lambda: heap.alloc(desc, st0, want_d, kmax)),
             "ref_update": epoch_times(torch, lambda: heap.release(desc, st_a, rel_ids, rel_own))}
    model = {"p_page_alloc_fused_us": DEFAULT_MODEL.p_page_alloc(True) * 1e6,
             "p_page_alloc_standalone_us": DEFAULT_MODEL.p_page_alloc(False) * 1e6}
    for name, t in times.items():
        log(f"pool {name} epoch at [{p}, {n}] ({p * p * kmax} pages asked): host "
            f"{t['host_us']:.1f} us ({t['host_us_range'][0]:.1f}-{t['host_us_range'][1]:.1f}), "
            f"event {t['event_us']:.1f} us ({t['event_us_range'][0]:.1f}-"
            f"{t['event_us_range'][1]:.1f}), device {t['queued_us']:.1f} us queued, "
            f"{t['aten_calls']} ATen calls (median of {POOL_REPS})")
    log(f"pool model: p_page_alloc fused {model['p_page_alloc_fused_us']:.2f} us, standalone "
        f"{model['p_page_alloc_standalone_us']:.2f} us")
    del st0, want_d, st_a, ids_a, rel_ids, rel_own

    # 5. a piggybacked alloc: a request from each origin to its neighbour
    # rides another epoch's gather (raw 4, one wire transfer)
    want_pg = np.zeros((p, p), np.int32)
    want_pg[np.arange(p), (np.arange(p) + 1) % p] = kmax
    other = torch.arange(p * 4, dtype=torch.int32, device="cuda").reshape(p, 4)

    def piggyback(d, s, w, o):
        pl = plan_mod.RmaPlan(d.mesh)
        h = pl.all_gather(o, kind="gets")
        handles = heap.alloc_record(pl, s, w)
        pl.flush(aggregate=True)
        return heap.alloc_apply(d, s, kmax, handles) + (h.result()[0],)

    with OpCounter() as c:
        ids_pg, granted_pg, rider = tw.call("piggyback", piggyback, want_pg, other)
    if (c.raw_msgs, c.coalesced_msgs) != (8, 2) or not np.array_equal(rider, other.cpu()):
        raise AssertionError(f"piggybacked alloc: raw {c.raw_msgs} wire {c.coalesced_msgs} "
                             f"over both copies, want 4 and 1 each")
    if not (granted_pg == want_pg).all():
        raise AssertionError("piggybacked alloc: a request was not granted in full")

    # 6. seeded payloads scattered into the granted pages, read back by row 3
    st = tw.st["card"]
    slot = torch.as_tensor(ids_pg[np.arange(p), (np.arange(p) + 1) % p], device="cuda")
    dest = ((torch.arange(p, device="cuda") + 1) % p)[:, None].expand(p, kmax)
    g = torch.Generator(device="cuda").manual_seed(POOL_SEED)
    payload = torch.randn((p, kmax) + POOL_PAGE, generator=g, device="cuda")
    with OpCounter() as c:
        pages.scatter_pages(tw.mesh["card"], st.pages, payload, slot, dest)
    if (c.raw_msgs, c.coalesced_msgs) != (2, 1):
        raise AssertionError(f"scatter_pages: raw {c.raw_msgs} wire {c.coalesced_msgs}")
    pg_ops.launches = 0
    got = pg_ops.paged_gather(st.pages, slot, 1, tw.mesh["card"])
    launches = pg_ops.launches
    if launches != 1 or not torch.equal(got, payload):
        raise AssertionError(f"pool read-back: {launches} row 3 launches, bit-equal "
                             f"{torch.equal(got, payload)}")
    if not torch.equal(got, pg_ref.paged_gather_ref(st.pages, slot, 1, tw.mesh["card"])):
        raise AssertionError("row 3 differs from its plain version at the pool's pages")
    flat = st.pages.view(p * n, -1)
    rows = (((torch.arange(p, device="cuda") + 1) % p)[:, None] * n + slot).reshape(-1)
    nbytes = 2 * p * kmax * desc.page_nbytes + slot.numel() * 4
    mesh_d = tw.mesh["card"]
    row3 = {"pool_launches": launches,
            "pool_ms": time_ms(lambda: pg_ops.paged_gather(st.pages, slot, 1, mesh_d)),
            "pool_device_ms": device_ms(lambda: pg_ops.paged_gather(st.pages, slot, 1, mesh_d),
                                        "gather_rows"),
            "pool_plain_ms": time_ms(lambda: pg_ref.paged_gather_ref(st.pages, slot, 1, mesh_d)),
            "pool_library_ms": time_ms(lambda: flat.index_select(0, rows)),
            "pool_bound_ms": nbytes / hbm * 1e3}
    log(f"paged_gather at the pool's pages ({p} x {kmax} pages of {desc.page_nbytes} bytes, "
        f"shift 1): kernel {row3['pool_ms'] * 1e3:.1f} us (device "
        f"{row3['pool_device_ms'] * 1e3:.2f} us), plain {row3['pool_plain_ms'] * 1e3:.1f} us, "
        f"index_select {row3['pool_library_ms'] * 1e3:.1f} us, bound "
        f"{row3['pool_bound_ms'] * 1e3:.2f} us ({nbytes} bytes); read-back bit-equal, "
        f"{launches} launch")
    del got, payload, flat, rows

    # 7. grow by POOL_GROW pages and shrink back through the dynamic window
    cache = window_mod.DescriptorCache()
    old = desc.regions
    if cache.lookup(desc.window, old[0])[1] != (n,) + POOL_PAGE:
        raise AssertionError("pool: the descriptor cache serves the wrong shape")
    old_pages = st.pages
    grow_ms, grow_host_ms = tw.resize("grow", heap.pool_grow, POOL_GROW)
    st, desc = tw.st["card"], tw.desc["card"]
    if not (torch.equal(st.pages[:, :n], old_pages) and not st.pages[:, n:].any()):
        raise AssertionError("pool_grow: the kept pages changed or the new ones are not zero")
    del old_pages
    try:
        cache.lookup(desc.window, old[0])
        raise AssertionError("the descriptor cache served a detached region")
    except window_mod.WindowError:
        pass
    if cache.lookup(desc.window, desc.regions[0])[1] != (n + POOL_GROW,) + POOL_PAGE:
        raise AssertionError("pool: the cache did not serve the grown region")
    hi = np.zeros((p, p), np.int32)
    hi[0] = 1                                            # the top of every stack: a new page
    ids_hi, _ = tw.alloc("alloc after grow", hi)
    hi_refs = pool_census(np, ids_hi)
    if min(i for _, i in hi_refs) < n:
        raise AssertionError(f"pool: the alloc after grow took old pages {hi_refs}")
    for k in tw.mesh:
        try:
            heap.pool_shrink(tw.mesh[k], tw.desc[k], tw.st[k], POOL_GROW)
            raise AssertionError("pool_shrink took live high pages")
        except heap.HeapError:
            pass
    tw.ref_update("release high pages", hi_refs, -1)
    grown = desc.regions
    shrink_ms, shrink_host_ms = tw.resize("shrink", heap.pool_shrink, POOL_GROW)
    try:
        cache.lookup(tw.desc["card"].window, grown[0])
        raise AssertionError("the descriptor cache served a detached region")
    except window_mod.WindowError:
        pass
    if cache.lookup(tw.desc["card"].window, tw.desc["card"].regions[0])[1] != (n,) + POOL_PAGE:
        raise AssertionError("pool: the cache did not serve the shrunk region")
    grow_bytes = (n * 2 + POOL_GROW) * p * desc.page_nbytes
    shrink_bytes = 2 * n * p * desc.page_nbytes
    log(f"pool_grow by {POOL_GROW} pages a rank: event {grow_ms:.3f} ms, host "
        f"{grow_host_ms:.3f} ms, bound {grow_bytes / hbm * 1e3:.3f} ms ({grow_bytes} bytes); "
        f"pool_shrink back: event {shrink_ms:.3f} ms, host {shrink_host_ms:.3f} ms, bound "
        f"{shrink_bytes / hbm * 1e3:.3f} ms; attach_id {tw.desc['card'].window.attach_id}, "
        f"cache remote ops {cache.remote_ops}")

    # 8. one injected double free: dropped whole, surfaced by check_errors
    victim = [pool_census(np, ids_pg)[0]]
    tw.ref_update("free", victim, -1)
    tw.ref_update("double free", victim, -1, check=False)
    tw.check("after the double free", errors=1)
    try:
        heap.check_errors(tw.desc["card"], tw.st["card"])
        raise AssertionError("check_errors let a double free pass")
    except heap.HeapError as e:
        log(f"pool double free: check_errors raised: {e}")
    out = {"epochs": tw.epochs, **{f"{k}_epoch": v for k, v in times.items()}, **model,
           "grow_ms": grow_ms, "grow_host_ms": grow_host_ms,
           "grow_bound_ms": grow_bytes / hbm * 1e3, "shrink_ms": shrink_ms,
           "shrink_host_ms": shrink_host_ms, "shrink_bound_ms": shrink_bytes / hbm * 1e3,
           "row3": row3,
           "seconds": time.perf_counter() - t_start}
    del tw, st, desc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"pool phase: {out['epochs']} epochs in {out['seconds']:.1f} s")
    return out


# ------------------------------------------ phase 23: hashtable and 3-D FFT
def sync_ms(torch, fn, reps: int = HT_REPS) -> list:
    """Host ms of `reps` calls of `fn`, each ended by a synchronise (the
    epochs synchronise inside, so the host clock is the call's span)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def ht_keys(j):
    """Key number j: distinct for every j < 2**31."""
    return (j * HT_MUL) & (2**31 - 1)


def ht_ledger(c, model, plans: list, kinds: dict) -> None:
    """An epoch's OpCounter against what it records: per plan (raw ops,
    bytes a rank), wire transfers as the port's `select_aggregation` packs
    them, and the counts by kind."""
    want = [(raw, nb, 1 if model.select_aggregation(raw, HT_P * nb / raw) == "pack" else raw)
            for raw, nb in plans]
    got = [(pl["raw"], pl["bytes_logical"], pl["coalesced"]) for pl in c.plans]
    snap = c.snapshot()
    wire = sum(w[2] for w in want)
    if (got != want or snap["coalesced_msgs"] != wire
            or any(snap[k] != v for k, v in kinds.items())):
        raise AssertionError(f"hashtable ledger {snap}, plans {got}; want plans {want}, "
                             f"kinds {kinds}, wire {wire}")


def profile_call(torch, what: str, fn, top: int = 6) -> dict:
    """One call of `fn` under `torch.profiler`: its wall time, the device's
    busy share of it, and the ATen ops that launched the most device time
    (their kernels' time, self)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(self_us(e) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    own = lambda e: (getattr(e, "self_device_time_total", None)  # noqa: E731
                     or getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    ranked = [(e.key, own(e), e.count) for e in sorted(ops, key=own, reverse=True)[:top]]
    log(f"{what} under the profiler: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall_ms:.1%}); most device time: "
        + "; ".join(f"{k} {t:.3f} ms x{n}" for k, t, n in ranked))
    return {"wall_ms": wall_ms, "busy_ms": busy, "top": ranked}


def hashtable_phase(torch) -> dict:
    """The distributed hashtable (`core.hashtable`) at Fig. 7a's batch, as a
    user calls it: insert epochs to load 1.0 and past it, a lookup epoch,
    every answer checked, two ranks' owner inserts held to the reference's
    loop, ledgers held to the plans they record; then inserts/s and
    lookups/s with the insert split into exchange and owner insert."""
    from repro_torch.core import dsde, hashtable as ht
    from repro_torch.core.perfmodel import DEFAULT_MODEL
    from repro_torch.core.rma import OpCounter
    from repro_torch.mesh import Mesh

    p, b = HT_P, HT_BATCH
    t_start = time.perf_counter()
    mesh = Mesh(p, "x", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(HT_SEED)
    n_keys = HT_EPOCHS * p * b
    newest = torch.randint(0, 2**62, (n_keys,), generator=g, device="cuda")  # by key number
    torch.cuda.reset_peak_memory_stats()
    vol = ht.make_volume(HT_TABLE, HT_HEAP, p, device="cuda")
    vol_bytes = sum(a.numel() * a.element_size() for a in vol)
    log(f"hashtable: p={p}, {b} inserts a rank an epoch, {HT_CAP} slots a pair, table and "
        f"heap {HT_TABLE} a rank ({vol_bytes / 1e9:.2f} GB of volume), "
        f"{HT_EPOCHS} epochs of distinct keys, a 5th re-inserting every {HT_REINSERT}th")

    kept, real = {}, ht.owner_insert

    def tap(v, k, val, ok):           # ranks 0 and p-1 of the epochs named in kept["now"]
        out = real(v, k, val, ok)
        if kept.get("now"):
            rows = torch.tensor([0, p - 1], device=k.device)
            kept[kept["now"]] = (ht.LocalVolume(*(a[rows].cpu() for a in v)),
                                 ht.LocalVolume(*(a[rows].cpu() for a in out)),
                                 k[rows].cpu(), val[rows].cpu(), ok[rows].cpu())
        return out

    insert_plans = lambda cap: [(3, 4 * p + p * cap * 2 * 8 + p * cap)]  # noqa: E731
    epoch_ms, vol1 = [], None
    ht.owner_insert = tap
    try:
        for e in range(HT_EPOCHS + 1):
            if e < HT_EPOCHS:
                j = torch.arange(e * p * b, (e + 1) * p * b, device="cuda").reshape(p, b)
            else:
                j = torch.arange(0, n_keys, HT_REINSERT, device="cuda").reshape(p, -1)
                newest[j.reshape(-1)] = torch.randint(0, 2**62, (j.numel(),), generator=g,
                                                      device="cuda")
            busiest = int(dsde._send_counts(ht.hash_owner(ht_keys(j), p), p).max())
            kept["now"] = f"epoch {e + 1}" if e in (0, HT_EPOCHS) else None
            with OpCounter() as c:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vol, dropped = ht.insert_epoch(vol, ht_keys(j), newest[j], mesh, HT_CAP)
                torch.cuda.synchronize()
                epoch_ms.append((time.perf_counter() - t0) * 1e3)
            ht_ledger(c, DEFAULT_MODEL, insert_plans(HT_CAP), {"puts": 1, "accs": 1, "raw_msgs": 3})
            if int(dropped.sum()):
                raise AssertionError(f"insert epoch {e + 1} dropped {int(dropped.sum())} items")
            if e == 0:
                vol1 = vol
            nf = vol.next_free
            log(f"hashtable insert epoch {e + 1}: {j.shape[1]} keys a rank, busiest pair "
                f"{busiest}, 0 dropped, {epoch_ms[-1]:.3f} ms; heap cells used a rank "
                f"{int(nf.min())}-{int(nf.max())}; OpCounter {c.snapshot()}")
    finally:
        ht.owner_insert = real
    kept.pop("now")
    for label, (before, after, k, val, ok) in kept.items():
        want = ht.owner_insert_plain(before, k, val, ok)
        for f, a, w in zip(ht.LocalVolume._fields, after, want):
            if not torch.equal(a, w):
                raise AssertionError(f"{label}: {f} of ranks 0, {p - 1} differs from "
                                     f"owner_insert_plain")
        log(f"hashtable {label}: ranks 0 and {p - 1} bit-equal to owner_insert_plain "
            f"over {int(ok.sum())} received items")
    del kept

    # one lookup epoch: b present keys a rank (any epoch's, the newest value
    # wins) and b never inserted
    jp = torch.randint(0, n_keys, (p, b), generator=g, device="cuda")
    ja = torch.arange(n_keys, n_keys + p * b, device="cuda").reshape(p, b)
    q = ht_keys(torch.cat((jp, ja), dim=1))
    busiest = int(dsde._send_counts(ht.hash_owner(q, p), p).max())
    if busiest > HT_LOOKUP_CAP:
        raise AssertionError(f"a lookup pair holds {busiest} queries, over {HT_LOOKUP_CAP}")
    with OpCounter() as c:
        vals, found = ht.lookup_epoch(vol, q, mesh, HT_LOOKUP_CAP)
    lc = HT_LOOKUP_CAP
    ht_ledger(c, DEFAULT_MODEL, insert_plans(lc) + [(2, p * lc * 3 * 8 + p * lc)],
              {"puts": 2, "accs": 1, "raw_msgs": 5})
    if not (bool(found[:, :b].all()) and torch.equal(vals[:, :b], newest[jp])
            and not bool(found[:, b:].any())):
        raise AssertionError(
            f"lookup: {int((~found[:, :b]).sum())} present keys missed, "
            f"{int((vals[:, :b] != newest[jp]).sum())} stale values, "
            f"{int(found[:, b:].sum())} absent keys found")
    log(f"hashtable lookup: {2 * b} keys a rank (busiest pair {busiest}), every present key "
        f"its newest value, every absent key missed; OpCounter {c.snapshot()}")
    del vals, found

    # timings: epoch 2 again from epoch 1's volume, split into its parts
    j2 = torch.arange(p * b, 2 * p * b, device="cuda").reshape(p, b)
    k2, v2 = ht_keys(j2), newest[j2]
    items, owners = torch.stack((k2, v2), dim=2), ht.hash_owner(k2, p)
    t_insert = sync_ms(torch, lambda: ht.insert_epoch(vol1, k2, v2, mesh, HT_CAP))
    t_exchange = sync_ms(torch, lambda: dsde.exchange_accumulate(items, owners, mesh, HT_CAP))
    res = dsde.exchange_accumulate(items, owners, mesh, HT_CAP)
    t_owner = sync_ms(torch, lambda: ht.owner_insert(vol1, res.recv_data[..., 0],
                                                     res.recv_data[..., 1], res.recv_valid))
    del res
    t_lookup = sync_ms(torch, lambda: ht.lookup_epoch(vol, q, mesh, HT_LOOKUP_CAP))
    res = dsde.exchange_accumulate(items, owners, mesh, HT_CAP)
    profiles = {
        "exchange": profile_call(torch, "hashtable exchange", lambda: dsde.exchange_accumulate(
            items, owners, mesh, HT_CAP)),
        "owner_insert": profile_call(torch, "hashtable owner insert", lambda: ht.owner_insert(
            vol1, res.recv_data[..., 0], res.recv_data[..., 1], res.recv_valid)),
        "lookup": profile_call(torch, "hashtable lookup epoch", lambda: ht.lookup_epoch(
            vol, q, mesh, HT_LOOKUP_CAP))}
    del res
    aten = {}
    for name, fn in (("insert", lambda: ht.insert_epoch(vol1, k2, v2, mesh, HT_CAP)),
                     ("lookup", lambda: ht.lookup_epoch(vol, q, mesh, HT_LOOKUP_CAP))):
        with aten_counter() as cnt:
            fn()
        aten[name] = cnt.n
    out = {"inserts_per_s": p * b / median(t_insert) * 1e3,
           "lookups_per_s": 2 * p * b / median(t_lookup) * 1e3,
           "insert_ms": t_insert, "exchange_ms": t_exchange, "owner_insert_ms": t_owner,
           "lookup_ms": t_lookup, "epoch_ms": epoch_ms, "aten_calls": aten,
           "profiles": profiles,
           "volume_gb": vol_bytes / 1e9,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t_start}
    log(f"hashtable: insert epoch {median(t_insert):.3f} ms ({out['inserts_per_s']:.4g} "
        f"inserts/s; exchange {median(t_exchange):.3f} ms, owner insert "
        f"{median(t_owner):.3f} ms), lookup epoch {median(t_lookup):.3f} ms "
        f"({out['lookups_per_s']:.4g} lookups/s); ATen calls {aten}; peak "
        f"{out['peak_gib']:.2f} GiB; {out['seconds']:.1f} s")
    return out


def fft_phase(torch, hbm: float) -> dict:
    """The 3-D FFT (`apps.fft`) at NAS FT class C: both schedules held to the
    global transform, then timed beside it with the pencil's four steps
    apart, GFLOP/s by `fft_flops` and the bytes bound."""
    from repro_torch.apps import fft
    from repro_torch.core import collectives
    from repro_torch.core.rma import OpCounter
    from repro_torch.mesh import Mesh

    n, p = FFT_N, FFT_P
    s = n // p
    t_start = time.perf_counter()
    mesh = Mesh(p, "x", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(FFT_SEED)
    x = torch.randn((p, s, n, n), dtype=torch.complex64, generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    want = fft.fft3d_reference(x)
    scale = float(want.abs().max())
    errs = {}
    for name in ("fft3d", "fft3d_slabs"):
        with OpCounter() as c:
            got = getattr(fft, name)(x, mesh)
        errs[name] = float((got - want).abs().max()) / scale
        if got.shape != x.shape or got.dtype != x.dtype or not errs[name] <= FFT_TOL:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype}, max abs err "
                                 f"{errs[name]:.3g} of the max abs (tol {FFT_TOL})")
        log(f"fft {name}: N={n} over p={p}, max abs err {errs[name]:.3g} of the max abs "
            f"(tol {FFT_TOL}); OpCounter {c.snapshot()}")
        del got
    del want
    ms = {name: time_ms(lambda f=getattr(fft, name): f(x, mesh), reps=FFT_REPS, warmup=1)
          for name in ("fft3d", "fft3d_slabs")}
    ms["reference"] = time_ms(lambda: fft.fft3d_reference(x), reps=FFT_REPS, warmup=1)
    # the pencil's four steps (`fft3d`), each on its own input.  On one card
    # an all-to-all is a view, and torch.fft keeps its input's layout, so a
    # transpose may move no byte: `transpose_copy`, the forward transpose
    # made contiguous (what separate memories would have to move), is a
    # yardstick outside the share
    v = torch.fft.fftn(x, dim=(2, 3))
    blocks = v.reshape(p, s, p, n // p, n).transpose(1, 2)
    xs = collectives.all_to_all(blocks, mesh).reshape(p, n, n // p, n)
    xf = torch.fft.fft(xs, dim=1)
    steps = {
        "yz_fft": lambda: torch.fft.fftn(x, dim=(2, 3)),
        "transpose": lambda: collectives.all_to_all(blocks, mesh).reshape(p, n, n // p, n),
        "x_fft": lambda: torch.fft.fft(xs, dim=1),
        "transpose_back": lambda: collectives.all_to_all(
            xf.reshape(p, p, s, n // p, n), mesh).transpose(1, 2).reshape(p, s, n, n)}
    step_ms = {k: time_ms(f, reps=FFT_REPS, warmup=1) for k, f in steps.items()}
    copy_ms = time_ms(lambda: collectives.all_to_all(blocks, mesh).contiguous(),
                      reps=FFT_REPS, warmup=1)
    views = {"x_fft input": xs.is_contiguous(), "x_fft output": xf.is_contiguous()}
    del v, blocks, xs, xf
    prof = profile_call(torch, "fft3d", lambda: fft.fft3d(x, mesh))
    flops = fft.fft_flops(n)
    nbytes = 2 * x.numel() * x.element_size()         # the grid read once, the spectrum written once
    bytes_ms, ops_ms = nbytes / hbm * 1e3, flops / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    out = {"ms": ms, "gflops": {k: flops / t / 1e6 for k, t in ms.items()},
           "steps_ms": step_ms, "transpose_copy_ms": copy_ms, "contiguous": views,
           "profile": prof,
           "transpose_share": (step_ms["transpose"] + step_ms["transpose_back"])
           / sum(step_ms.values()),
           "max_abs_err": errs, "bound_ms": bound_ms, "bound_by": bound_by,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t_start}
    log(f"fft: fft3d {ms['fft3d']:.3f} ms, fft3d_slabs {ms['fft3d_slabs']:.3f} ms, "
        f"torch.fft.fftn {ms['reference']:.3f} ms; GFLOP/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["gflops"].items())
        + "; pencil steps (ms) " + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items())
        + f", transposes {out['transpose_share']:.1%} (contiguous: {views}; the forward "
        f"transpose as a copy {copy_ms:.3f} ms); bound {bound_ms:.3f} ms ({bound_by}); "
        f"peak {out['peak_gib']:.2f} GiB")
    del x
    return out


def apps_phase(torch, hbm: float) -> dict:
    """Phase 23: the paper's §4.1 and §4.3 studies on the card."""
    out = {"card": card_line(), "hashtable": hashtable_phase(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["fft"] = fft_phase(torch, hbm)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def apps_only() -> int:
    """``python3 chip_smoke.py --apps``: phase 23 alone, on the package
    beside this file.  Prints one JSON line of its numbers."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100

    print(json.dumps({"tree": ROOT, **apps_phase(torch, H100.hbm_bandwidth)}), flush=True)
    return 0


def zoo_only() -> int:
    """``python3 chip_smoke.py --zoo``: phase 24 alone, on the package
    beside this file (the flash kernel builds on first use).  Prints one
    JSON line of its numbers, row 11's at the encoder shape included."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    print(json.dumps({"tree": ROOT, **zoo_phases(torch, H100.hbm_bandwidth)}), flush=True)
    return 0


def pool_only() -> int:
    """``python3 chip_smoke.py --pool``: the device page pool phase alone,
    on the package beside this file.  Prints one JSON line of its numbers."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100

    out = pool_phase(torch, H100.hbm_bandwidth)
    print(json.dumps({"card": card_line(), "tree": ROOT, **out}), flush=True)
    return 0


def gather_shift_only() -> int:
    """``python3 chip_smoke.py --gather-shift``: `rmem.pages.gather_shift`
    and `kernels.paged_gather.ops.paged_gather` (the surface every version
    of the port has) at the rendezvous pull's shape, on the package beside
    this file, so that two trees can be timed in one call: a pool of
    FULL's 8192 pages [16, 2, 128] f32 a rank over 4 ranks, ids [4, 2048]
    with one request's 128 pages valid (the busiest shift's pull), shift 1,
    seeded.  Prints one JSON line with the card and the CUDA-event times."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_gather import ops
    from repro_torch.mesh import Mesh
    from repro_torch.rmem import pages

    p, n_pages = 4, FULL["pool_pages"]
    pt, hd = FULL["page_tokens"], FULL["d_model"]
    k = 16 * FULL["block_tokens"] // pt
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn(p, n_pages, pt, 2, hd, generator=g, device="cuda")
    ids = torch.full((p, k), -1, dtype=torch.int32, device="cuda")
    ids[0, 256:384] = torch.randperm(n_pages, generator=g, device="cuda")[:128].to(torch.int32)
    mesh = Mesh(p, "serve", device="cuda")
    want = pool[1, ids[0, 256:384].long()]
    got = pages.gather_shift(mesh, pool, ids, 1)
    if not (torch.equal(got[0, 256:384], want) and not got[0, :256].any()
            and not got[1:].any()):
        raise AssertionError("gather_shift differs from the pages it names")
    out = {"card": card_line(), "tree": ROOT,
           "gather_shift_ms": time_ms(lambda: pages.gather_shift(mesh, pool, ids, 1)),
           "paged_gather_ms": time_ms(lambda: ops.paged_gather(pool, ids, 1, mesh))}
    print(json.dumps(out), flush=True)
    return 0


def queue_push_only() -> int:
    """``python3 chip_smoke.py --queue-push``: kernel rows 10 and 9 through
    `kernels.rmaq.ops` (the surface every version of the port has) on the
    package beside this file, so that two trees can be timed in one call:
    `queue_push` at the DSDE queue's shape (p = 4096 ranks, a drained ring
    of 131,072 slots of 2 f32 a rank, k = 6 seeded messages a rank, shift
    1), `notify_accumulate` at the DSDE doorbell's p = 4096 and the launch
    floor (`notify_accumulate` at p = 1).  The first push is held to the
    plain version, and the last timed push must admit all k messages of
    every rank.  Prints one JSON line with the card, the CUDA-event times
    and the device times a call queued behind a spin kernel."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.rmaq import ops, ref
    from repro_torch.mesh import Mesh

    p, k, w, cap = DSDE_P, DSDE_K, DSDE_D, 131072
    g = torch.Generator(device="cuda").manual_seed(DSDE_SEED)
    mesh = Mesh(p, "x", device="cuda")
    ring = torch.zeros(p, cap, w, device="cuda")
    ctr = torch.zeros(p, 2, dtype=torch.int32, device="cuda")
    msgs = torch.randn(p, k, w, generator=g, device="cuda")
    want = ref.queue_push_ref(ring.clone(), ctr.clone(), msgs, 1, mesh, cap)
    got = ops.queue_push(ring, ctr, msgs, 1, mesh)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("queue_push differs from its plain version")
    del want, got
    pushed = {}

    def push():
        pushed["out"] = ops.queue_push(ring, ctr, msgs, 1, mesh)

    cnt = torch.randint(0, 2**20, (p,), generator=g, device="cuda", dtype=torch.int32)
    local = torch.randint(0, 2**20, (p,), generator=g, device="cuda", dtype=torch.int32)

    def acc():
        ops.notify_accumulate(cnt, local, 1, mesh)

    out = {"card": card_line(), "tree": ROOT,
           "queue_push_ms": time_ms(push), "queue_push_queued_ms": queued_ms(push),
           "notify_accumulate_ms": time_ms(acc), "notify_accumulate_queued_ms": queued_ms(acc),
           "launch_floor_ms": launch_floor_ms(torch, ops, Mesh)}
    if not bool((pushed["out"][2] == k).all()):
        raise AssertionError("the last timed queue_push did not admit all k messages")
    print(json.dumps(out), flush=True)
    return 0


MODES = {"--gather-shift": gather_shift_only, "--queue-push": queue_push_only,
         "--pool": pool_only, "--apps": apps_only, "--zoo": zoo_only}

if __name__ == "__main__":
    sys.exit(MODES[sys.argv[1]]() if sys.argv[1:] else main())
