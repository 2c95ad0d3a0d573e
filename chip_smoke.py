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
 25. the parallel layer on SmolLM-360M at full width (it runs inside the
     training phases, on T1's weights and T2's layer-0 checkpoint).  P1:
     `parallel.overlap.overlapped_grad_sync` over a mesh {"pod": 2,
     "data": 2}, rank r's f32 gradients those of row r of T1's batch
     [4, 2048] (`loss_and_grads`, remat), ~5.8 GB stacked: under "auto"
     kernel row 4 carries every in-pod ring put (3 a leaf, counted from
     0), and with every plan group sent through the plain put the result
     is bit-equal; a flush a bucket; every rank's copy equal; within 1e-6
     of sum |g_r| of the sum of the four ranks' gradients and of 4 x the
     n_microbatches=4 step's averaged gradients; timed in turns beside one
     flat ring over a 4-rank axis, with `select_allreduce`'s pick and
     prices.  P2: `compress_decompress` on rank 0's gradients (ms a round,
     the dcn bytes ratio) and gradsync_sub.py's convergence check (40
     rounds, error < 0.05) on layer 0's largest leaf.  P3: the 32 blocks as
     4 stages of 8 over `pod` (`parallel.pipeline.pipeline_forward`), 4
     microbatches of [1, 2048], kernel row 11 in every layer (128
     launches, all wgmma): bit-equal to each microbatch through the stages
     in sequence, its logits within 0.25 of the whole batch's forward;
     the pipeline's, the sequential and the whole batch's host ms and
     `bubble_fraction`.  P4: SmolLM's logits under a `ShardingPolicy` of
     {"data": 4} bit-equal to no policy; qwen3-moe cut to 4 layers on
     [4, 512] tokens under it: 4 MoE layers in 4 dispatch groups, each
     bit-equal to its groups' no-policy `moe_ffn` calls; `elastic_restore`
     of T2's layer-0 checkpoint for 2 survivors, prefer_model 2: every
     leaf bit-equal on the card and tiled by its blocks.  Row 4's and row
     11's entries of the kernels line get P1's and P3's launches.
26. the host protocol mirrors held to the card, the race analysis of the
    card's plans, the full-width run traced, and the conformance suite (it
    runs after the apps phase).  26.1: `rmaq.queue.HostQueueGroup` at the
    DSDE shape (p = 4096, k = 6, the DSDE ring of 131,072 rows, the DSDE
    run's seeded data): the random-target epoch's flags, ring and five
    counters equal to `enqueue_epoch`'s and each rank's `drain` equal to
    `dequeue` slot for slot; the DSDE ops phase's wrap and backpressure
    rounds through the mirror, kernel row 10 (counted from 0; its launches
    go on row 10's entry) and `enqueue_shift`: flags the accepted prefix of
    `n_sent`, rings bit-equal, TAIL/ENQ/NOTIF/DROP equal mod 2**32.  26.2:
    `rmaq.flow.HostFlowChannel` against `flow.send` / `recv` at the
    disaggregated shape (p = 4, 2 lanes, queue 64) on a seeded schedule
    far past the credits: the same messages per (src, dest, lane) in
    order, none rejected, conservation after every epoch on both (where
    the two defer is logged).  26.3: the plans one `enqueue_epoch` flushes
    on the card (64 ranks) lowered by `analysis.ir.from_plan`, race-free;
    two puts aliasing one interval flagged.  26.4: FULL in fused paged and
    rendezvous mode, 64 requests each, untraced and under the `Tracer`:
    the same tokens (equal to `reference()`), wire counts and steps, row
    1's launches equal to the fused run's decode steps; every request's
    segments summing to its TTFT exactly, critical path within wall, the
    sync ledger's shares summing to its attributed wait, the Chrome export
    parsing in the wall-clock domain; the connected share, segment
    p50/p90, event count and traced vs untraced ms/step logged.  26.5:
    `sim.conformance.run_suite`, every protocol at 64 ranks, seeds 0-2,
    under reorder, delay and duplicate, all passing, then `tear` caught.
27. the tools of item 12 (it runs last).  27.1: each model choice the perf
    model adds against both arms measured on the card (host ms of
    synchronised calls, the median of 51 after a warm-up, the two arms
    taking turns, each arm's spread logged; the model must pick the
    faster arm or one within 5 % of it): `select_put_backend`,
    kernel row 4 against `Mesh.shift` at 8 KiB, 1 MiB and MILC's halo view
    at p = 131,072 (192 MiB, read in place); `select_paged_attend`, row 1
    against row 3 + the plain attention over the packed block, 128 pages
    of disagg's [16, 2, 128] f32 page and of the device pool's 128 KiB page
    as [16, 2, 1024] (the arms agree within 1e-4); `select_accumulate_mode`,
    row 6 against lock, get (row 5), add, put (row 4), unlock at 64 KiB and
    64 MiB (bit-equal); `select_flow_control` at the flow mirror's shape
    (p = 4, 2 producers into one ring of 64 slots) held at occupancy 0.5
    and 0.9 by a consumer draining what each round admits, each producer
    offering 32 messages a round: reject / requeue through
    `rmaq.queue.enqueue` (f / (1 - f) rejections per admitted message) against
    `rmaq.flow.send` / `recv`, ms per delivered message; and the host's
    exclusive lock and flush beside `p_lock_excl` and `p_flush`.  27.2:
    `launch.hlo_cost.analyze` over T1's step (SmolLM-360M, [4, 2048],
    remat) under backend "cuda" and "torch": equal non-attention product
    FLOPs, attention products 16·B·H·S²·hd a layer in both, totals within
    (1.2, 2.5) x 6·N·tokens, the predicted peak (memory before the call +
    mem_out + mem_temp) within 10 % of `max_memory_allocated`, the
    roofline terms beside the measured step.  27.3: `launch.dryrun --mesh
    card` over every (arch x shape) cell on meta tensors in 8 processes
    (attention on backend "torch"), every applicable cell "ok", and
    `launch.roofline`'s table.  27.4: the five example drivers
    (`repro_torch.examples`: disagg_serve, hashtable_kv, milc_stencil,
    moe_dsde, fft3d) on the card at the reference's sizes (milc_stencil
    on its 8 ranks, where the card's model picks the fence), each with its
    own self-checks; rows 1 and 4 must
    launch there (their launches go on their entries of the kernels line).
28. the one-sided layer with one rank a process (`repro_torch.procmesh`,
    4 processes sharing the card): MILC's 64³ x 96 lattice along T and the
    4 x 25 MiB all-reduce, every rank bit-equal to its row of the stacked
    `Mesh(4)` run; the peer forms of rows 4-7 (`csrc/rma_peer.cu`) through
    the ops surface, against their plain versions, timed alone; the
    synchronisation's own costs.
29. disaggregated serving with one rank a process: `DisaggEngine` at FULL
    (p = 4, 2 prefill and 2 decode, d_model 128, vocab 32000, 2048-token
    blocks of 128 pages, 8192 pages of [16, 2, 128] f32 a rank) over 4
    processes sharing the card, in fused-paged, inline (credit flow) and
    rendezvous transport, 64 requests each: every rank's tokens, steps,
    msg_stats, novel pages, retries and stalls equal to the stacked
    `Mesh(4)` run of the same requests and to `reference()`; the wire
    fingerprints (paged 8 -> 3, inline 2 a step, rendezvous 4 with no
    payload on the ring), pool, pin and credit conservation; ms a step
    beside the stacked run's, host barriers (held to `DISAGG_BARRIERS`),
    tokens and host gathers a step, device memory; every all-to-all of
    whole-word blocks (the queue's, the pull's) stored by row 4's peer
    form, its launches counted.  Then the peer forms of rows 2, 3 and 8-10
    through their ops surfaces on the runs' data (counts zeroed before,
    read after): the one-sided reads held to the two-plan `gather_pages`
    pull and the readout's context; each against its plain version on the
    same ranks (rows 3 and 8-10 bit-equal, row 2 within 1e-4); each timed
    alone by rank 0 while the others wait, beside its plain version, one
    PyTorch call where one computes the same function, and its bound.
30. DSDE, the MoE dispatch, the hashtable and the 3-D FFT with one rank a
    process (4 processes sharing the card), each from a fixed seed, the
    same inputs through the stacked `Mesh(4)` in this process: DSDE at
    k = 6,144 items of 2 f32 a rank, 2,048 slots a pair, a uniform and a
    skewed draw, all four protocols; qwen3-moe-30b-a3b's dispatch and
    combine (d 2048, 128 experts, top-8, bf16, 1,024 tokens a rank, a
    per-expert scale as the experts); the hashtable at 16,384 keys a rank
    an epoch into 2**16 table and heap cells a rank, 4 epochs, a
    re-insert and a lookup of present and absent keys; the FFT at 512³
    (`fft3d`, `fft3d_slabs`).  Every rank's results bit-equal to its row
    of the stacked run (the FFT within 1e-4 of the spectrum's max abs),
    ledgers and drops equal; every all-to-all block stored by row 4's
    peer form (p launches a transfer a rank, asserted; no whole-word
    block through `ProcMesh.all_to_all`).  Ms a call (median and spread),
    host barriers and row 4 launches a call, inserts/s, lookups/s and
    FFT GFLOP/s beside the stacked run's; the kernel and `copy_` arms of
    one all-to-all of each payload dtype, bit-equal, timed side by side.
31. the parallel layer with one rank a process: phase 25's P1-P4 and row
    13 on SmolLM-360M at full width (fresh weights from TRAIN_SEED, one
    [4, 2048] batch) over 4 processes as the grid `ProcMesh` {"pod": 2,
    "data": 2}, beside the stacked grid `Mesh` run of the same inputs in
    this process, whose tensors the ranks read through CUDA IPC.  P1:
    `overlapped_grad_sync`, rank r's f32 gradients of row r (each row
    checked against the stacked row first): every rank bit-equal to its
    stacked row (so within 1e-6 of sum |g_r|), ledgers and buckets equal,
    3 row 4 launches a leaf, host barriers a leaf counted; then timed in
    turns beside one flat ring over the same ranks as one axis of 4, with
    `select_allreduce`'s pick and prices.  P2: each rank's int8 round of
    its own gradients bit-equal to the stacked row's.  P3: the 32 blocks
    as 4 stages of 8, one a process holding only its stage's weights (the
    ranks as a pod axis of 4), 4 microbatches: bit-equal per rank, 32
    "wgmma" flash launches a rank, 7 row 4 puts; ms beside the stacked
    pipeline.  P4: `elastic_restore` of a layer-0 checkpoint onto the
    grid 4 survivors make with prefer_model 2, each rank restoring only
    its blocks, bit-equal to the stacked restore's at its coordinate.  Row
    13: layer 0's up projection over one axis of 4 processes (4 "wgmma"
    launches at n = 1 and 3 row 4 hops a rank a call) within 1e-4 x max
    |Y| of its plain version and of the stacked kernel's row, three calls
    bit-equal, timed beside the stacked kernel and a plain all-gather +
    `torch.matmul` over the same processes.
32. the model-vs-measured count gate (`repro_torch.obs.drift`) over the
    port's own protocol counts.  Set A: `obs.drift_docs.set_a` drives the
    port on p = 4 stacked ranks at the reference smoke benchmarks' shapes
    (32 puts of 8 B eagerly and as one plan; the 16-step flood of a 4-slot
    ring through `Channel.send` and `flow.send`; the retry and credit
    engines and both transport sizes with 12 requests; the crossover flip;
    the traced conformance slices at 64 ranks, "delay", seed 0; the
    inline, paged fused and paged gather engines on the 50 %-shared-prefix
    workload), each run with the launch counts zeroed before and read
    after (the fused decode must launch row 1).  Set B: the same fields of
    phases 3 and 5a's full-width fused, gather, inline and rendezvous
    runs, read from those engines when they finished.  Each set is
    written under the reference's three file names into a temporary
    directory and gated: a violation exits non-zero.  Counts only; no
    timing field.
33. a model step split over a `ProcMesh`'s ``model`` axis: qwen1.5-110b at
    its published widths cut to 8 of 80 layers (reduced: depth only),
    keyed random bf16 weights (each leaf one layer slice at a time from a
    generator keyed by seed, leaf and layer).  One process runs it whole:
    `make_prefill_step` on 4 prompts of 64-256 tokens (the flash kernel),
    `Model.prefill` of each into its row of one cache, 16 greedy
    `make_serve_step` steps; then freed.  Four processes on the card run
    it under ``ShardingPolicy(ProcMesh({"model": 4}), fsdp=False)``, each
    drawing the same slices and keeping only its blocks (its weight bytes
    must be its blocks' by the fitted specs), the same calls with the
    decode teacher-forced on the whole run's tokens: every logit within
    TP_REL (1/16) of the whole run's max |logit| of the whole run's, and
    the argmax equal wherever the whole run's top-2 margin exceeds twice
    that bound; 32 "wgmma" flash launches a rank (16 q
    / 2 KV heads of 128), and exactly the ring collectives' row 4 peer
    puts (1 + 2 x 8 all-reduces and one all-gather a forward), nothing
    else.  Host ms of a forward, a prefill and a decode step, the
    all-reduce at the decode shape beside `ProcMesh.psum`'s one round on
    the same bytes (rounds counted as host barriers), row 4's peer put at
    the all-reduce's chunk, and each rank's torch peak.
34. the train step split over a ``{"data": 2, "model": 2}`` `ProcMesh`:
    starcoder2-15b at its published widths cut to 4 of 40 layers
    (reduced: depth only), keyed random bf16 weights, AdamW (T1's
    settings) with remat, the synthetic pipeline's global batch [4, 2048],
    3 steps.  One process runs the 3 steps whole (backend "cuda") and
    keeps on the card the gradient of step 1 (its first moment over 1 -
    b1, unclipped) and the params after it; then the rest is freed.  Four
    processes on the card run `make_train_step` under the reference's
    `make_policy` (fsdp=True), each drawing the same slices and keeping
    only its 2-D blocks, its AdamW moments ZeRO-1 blocks, and taking its
    rows of each batch: every step's loss within 1e-2 of the whole run's;
    at step 1 every leaf's gradient block within 5 % relative L2 of the
    whole run's cut to it, the grad norm within 5 %, and the params
    within 2 lr plus one bf16 ulp of the whole run's (`tt_step1`); ranks
    holding one block hold the same bits after every step; each rank's bytes of
    params and both moments its blocks' by the fitted specs; 8 "wgmma"
    flash launches a step a rank (the forward and the recomputation of
    each layer) and exactly the schedule's row 4 peer puts (`tt_puts`),
    nothing else.  Host ms a step, fenced rounds (host barriers) a step,
    the device's busy share of a profiled step, each rank's torch peak,
    and row 4's peer put at an FSDP gather's block.
35. a KV cache split on its sequence over a `ProcMesh`'s ``model`` axis:
    chatglm3-6b at its published widths and all 28 layers, keyed random
    bf16 weights, 4 prompts of 2,036-7,600 tokens ending just short of
    the 2,048-position block boundaries of an 8,192-position cache (the
    fourth inside the last block; reduced from decode_32k's 32,768, which
    ``--kv-seq-procs --decode-32k`` runs with prompts of 8,180-30,000 in
    chunks of 5,000).  One process runs it whole: `make_prefill_step` on
    each prompt's first 2,048 tokens (the flash kernel), each prompt
    prefilled alone into its row in chunks of 1,500 (crossing the
    boundaries), 16 greedy `make_serve_step` steps; then
    freed.  Four processes on the card run it under the reference's
    `make_policy` for decode_32k over ``ProcMesh({"model": 4})`` (2 KV
    heads under 4 ranks: the cache's sequence in 4 blocks), each keeping
    only its blocks of the same slices, the decode teacher-forced on the
    whole run's tokens: every logit within TP_REL of the whole run's max
    |logit|, the argmax held wherever the top-2 margin exceeds twice that;
    each rank's cache 1/4 of the whole run's bytes, its layer 0 block
    equal to the whole run's positions bit for bit; 112 "wgmma" flash
    launches a rank and exactly the schedule's row 4 peer puts
    (`kv_schedule`: the ring collectives' puts, and 4 a partials'
    all-to-all), nothing else.  Part 2: its first 8 layers (reduced:
    depth) over ``{"data": 2, "model": 2}`` under `make_policy` for
    long_500k (the 2 KV heads split one a rank, FSDP over ``data``), an
    8,192-position cache, 4 rows of 4,082-4,094 tokens, 2 a data
    coordinate, with the same bounds.  Host ms of a prefill and a decode
    step beside the whole run's, fenced rounds (host barriers) a decode
    step, each rank's torch peak, and row 4's peer put at the partials'
    all-to-all block.
36. the MoE layer split over a `ProcMesh`'s ``model`` axis (tensor-parallel
    experts: every rank holds every expert's block of F, the router whole,
    as the reference's fitted specs place them).  Part 1: qwen3-moe-30b-a3b
    at its published widths cut to 8 of 48 layers over ``ProcMesh({"model":
    4})`` under `make_policy` for decode_32k (one KV head a rank), 4
    prompts of 256-2,048 tokens, each forwarded (`make_prefill_step`, the
    flash kernel) and prefilled alone, then 16 greedy `make_serve_step`
    steps.  Part 2: moonshot-v1-16b-a3b (a shared expert) cut to 4 of 48
    layers over ``{"data": 2, "model": 2}`` under `make_policy` (FSDP over
    ``data``): one [4, 1,024] forward, one [4, 512] prefill and 16 steps,
    2 rows a data coordinate, one dispatch group a rank (the reference's
    G = 2 over the global batch).  The ranks run first, their routing
    tapped; then one process runs the same keyed weights whole (part 2
    under a policy on a stacked `Mesh` of the same shape: the same groups),
    dispatched to the split's experts and teacher-forced on its tokens.
    Checked: every rank's choices, slots and overflow flags bit-equal to
    its row block's model rank 0's in every layer of every call, and its
    logits and tokens too; the forced whole run's slots and drops equal
    to the split's, every choice its own routers would make otherwise a
    near-tie (`route_check`); logits within TP_REL of the whole run's max
    |logit|, argmax held beyond twice that; each rank's weight bytes its
    blocks' by the fitted specs; 32 (part 2: 4) "wgmma" flash launches a
    rank and exactly `ms_schedule`'s row 4 peer puts (one ring all-reduce
    an MoE layer), nothing else.  Host ms of every call beside the whole
    run's, fenced rounds a decode step, drop fractions by call, each
    rank's torch peak, and row 4's peer put at the MoE all-reduce's block.

``python3 chip_smoke.py --gather-shift`` times only `rmem.pages.gather_shift`
and `paged_gather` at the rendezvous pull's shape on the package beside the
script (two trees in one call: copy the script into each);
``python3 chip_smoke.py --queue-push`` times only kernel rows 10 and 9 at the
DSDE shapes and the launch floor, the same way;
``python3 chip_smoke.py --pool`` runs only phase 22, the device page pool;
``python3 chip_smoke.py --apps`` runs only phase 23, the hashtable and the FFT;
``python3 chip_smoke.py --zoo`` runs only phase 24, xLSTM and whisper;
``python3 chip_smoke.py --parallel`` runs only phase 25, P1-P4, on fresh weights;
``python3 chip_smoke.py --conformance`` runs only phase 26 and ends with the
result line; ``python3 chip_smoke.py --tools`` runs only phase 27 (after
the kernels' build) and ends with the result line; ``--procs`` and
``--disagg-procs`` run only phase 28 and phase 29, their rows of the
kernels line, then the result line; ``--apps-procs`` runs only phase 30
and ends with the result line; ``--parallel-procs`` runs only phase 31,
its rows of the kernels line (rows 4's peer form, 11 and 13 with this
phase's launches and times), then the result line; ``--drift`` runs only
phase 32's set A (set B reads the whole smoke's full-width runs) and ends
with the result line; ``--tp-procs`` runs only phase 33, its rows of the
kernels line (row 4's peer form and row 11 with this phase's launches, row
11 timed at a rank's attention shape), then the result line;
``--tp-train-procs`` runs only phase 34 the same way; ``--kv-seq-procs``
runs only phase 35 the same way (row 4 timed at the partials' all-to-all
block, row 11 at a rank's attention shape), and ``--kv-seq-procs
--decode-32k`` with part 1 at decode_32k's 32,768 positions; ``--moe-procs``
runs only phase 36 the same way (row 4 timed at the MoE all-reduce's
block, row 11 at a part 1 rank's attention shape [1, 8, 2048, 128]).

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
import tempfile
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TOL = 1e-4                      # kernel vs plain, f32, different sum order
SOURCES = ("paged_attention", "rma", "paged_gather", "rmaq",    # csrc/<name>.cu, one nvcc each
           "flash_attention", "ssm_scan", "ring_matmul", "rma_peer", "rmaq_peer")
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
    # the peer forms of rows 4-7: one rank a process (phase 28)
    "put_shift_peer": ("cuda", "src/repro_torch/csrc/rma_peer.cu",
                       "src/repro/kernels/rma/kernel.py:48"),
    "get_shift_peer": ("cuda", "src/repro_torch/csrc/rma_peer.cu",
                       "src/repro/kernels/rma/kernel.py:80"),
    "accumulate_shift_peer": ("cuda", "src/repro_torch/csrc/rma_peer.cu",
                              "src/repro/kernels/rma/kernel.py:114"),
    "ring_all_gather_peer": ("cuda", "src/repro_torch/csrc/rma_peer.cu",
                             "src/repro/kernels/rma/kernel.py:168"),
    # the peer forms of rows 2, 3 and 8-10 (phase 29)
    "paged_attention_shift_peer": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/kernel.py:219"),
    "paged_gather_peer": ("cuda", "src/repro_torch/csrc/paged_gather.cu",
                          "src/repro/kernels/paged_gather/kernel.py:86"),
    "notified_put_peer": ("cuda", "src/repro_torch/csrc/rmaq_peer.cu",
                          "src/repro/kernels/rmaq/kernel.py:85"),
    "notify_accumulate_peer": ("cuda", "src/repro_torch/csrc/rmaq_peer.cu",
                               "src/repro/kernels/rmaq/kernel.py:128"),
    "queue_push_peer": ("cuda", "src/repro_torch/csrc/rmaq_peer.cu",
                        "src/repro/kernels/rmaq/kernel.py:221"),
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
# the parallel layer (phase 25) on the training run's SmolLM-360M.  P1: 4
# ranks as {"pod": 2, "data": 2}, one [1, 2048] row of T1's batch a rank.
# Four f32 terms summed in two orders differ by at most 3 ulp of their
# absolute sum (3 roundings each, 2**-24 relative): PAR_F32 is ~8 of them
PAR_GRID, PAR_RANKS, PAR_F32 = {"pod": 2, "data": 2}, 4, 1e-6
COMP_TIMED, COMP_ROUNDS, COMP_ERR = 3, 40, 0.05   # P2: gradsync_sub.py's check
PIPE_STAGES, PIPE_MICRO, PIPE_REPS = 4, 4, 3      # P3: 32 layers as 4 stages of 8
# P4: a policy over 4 data shards: the MoE dispatches B = 4 rows in 4 groups
POLICY_GRID, POLICY_GROUPS, POLICY_MOE_TOKENS = {"data": 4}, 4, (4, 512)
ELASTIC_SURVIVORS, ELASTIC_MODEL = 2, 2
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
# phase 26, the host mirrors and the tooling: the flow mirror at the
# disaggregated shape (p = 4, 2 producers, 2 lanes, FULL's queue of 64), a
# schedule of 120 messages a producer against 16 credits a lane; the race
# analysis of one enqueue epoch's plans at 64 ranks; the traced full-width
# runs; the conformance suite at 64 ranks, 3 seeds, 3 chaos schedules
FLOW_MIRROR = dict(p=4, producers=2, capacity=FULL["queue_capacity"], k=16, drain=6,
                   msgs=120, seed=13, max_epochs=200)
IR_P, IR_K, IR_SEED = 64, 6, 14
TRACED_N, TRACED_SEED = 64, 15
CONF_RANKS, CONF_SEEDS, CONF_SCHEDULES = 64, (0, 1, 2), ("reorder", "delay", "duplicate")
# phase 27, the tools: each model choice against both arms (host ms of
# synchronised calls, the median of TOOLS_REPS after a warm-up, the arms
# taking turns, each arm's spread logged; the pick must be the faster arm
# or within CHOICE_SLACK of it).  Puts of 8 KiB and 1 MiB
# over 8 ranks and of MILC's halo view (p = 131,072: 192 MiB, read in place);
# paged attention over 128 pages of disagg's [16, 2, 128] f32 page and of
# the device pool's 128 KiB page, as [16, 2, 1024]; accumulates of 64 KiB
# and 64 MiB; the flow channel held at occupancy 0.5 and 0.9
TOOLS_REPS, TOOLS_SEED, CHOICE_SLACK = 51, 16, 0.05
PUT_P, PUT_BYTES = 8, (8 << 10, 1 << 20)
ATTEND_K = 128
ATTEND_PAGES = {"disagg's 16 KiB page": (16, 128, 8192),
                "the pool's 128 KiB page": (16, 1024, 4096)}
ACC_BYTES = (64 << 10, 64 << 20)
FLOW_OCCUPANCY = (0.5, 0.9)
# 27.2: the counter over T1's step.  The total (products, elementwise ops,
# reductions, AdamW) within STEP_FACTOR of 6·N·tokens: at least 1.2 (remat
# adds a forward of the blocks, 8/6 of their share, the LM head 6/6), at
# most that plus the masked attention (0.46 at T1) and 60 % for the eager
# elementwise work; the predicted peak within MEM_REL of the allocator's
STEP_FACTOR, MEM_REL = (1.2, 2.5), 0.10
DRY_JOBS = 8
# phase 28, one rank a process: MILC's 64³ x 96 HISQ lattice split along T
# over p = 4 ranks ([24, 64, 64, 64, 6] f32 a rank, 144 MiB; 6 MiB halo
# slices each way) and the all-reduce of 4 x 25 MiB, 4 processes on the card
PROC_P, PROC_LOCAL, PROC_SEED, PROC_TIMEOUT = 4, (24, 64, 64, 64, 6), 17, 300.0
# phase 29: FULL's engine over PROC_P processes, DISAGG_N requests a transport
DISAGG_N, DISAGG_SEED = 64, 29
DISAGG_MODES = {"fused": dict(paged=True, attend="fused"), "inline": dict(paged=False),
                "rendezvous": dict(transport="rendezvous")}
DISAGG_SHIFT = FULL["n_prefill"]        # decode rank r reads its prefill owner r - 2 (p = 4)
DISAGG_PEER_ROWS = ("paged_attention_shift_peer", "paged_gather_peer", "notified_put_peer",
                    "notify_accumulate_peer", "queue_push_peer")
# phase 29 in a whole smoke before its all-to-alls took row 4 (PERF.md §5):
# host barriers and ms a step over processes
DISAGG_BARRIERS = {"fused": 4, "inline": 3, "rendezvous": 5}
DISAGG_PR30_MS = {"fused": 32.3, "inline": 18.0, "rendezvous": 33.0}
# phase 30: DSDE, MoE, the hashtable and the FFT over PROC_P processes, the
# same inputs through the stacked Mesh(PROC_P).  DSDE at the total of the
# DSDE phase (p = 4096 x k = 6 = 24,576 items): k = 6,144 items of DSDE_D
# f32 a rank, 2,048 slots a pair against a mean pair load of 1,536; a
# uniform draw and a skewed one (half of every rank's items to rank 0, so
# drops occur).  MoE at qwen3-moe-30b-a3b's published widths
# (src/repro/configs/qwen3_moe_30b_a3b.py: d_model 2048, 128 experts,
# top-8) in bf16, 1,024 tokens a rank, capacity factor 1.25, a per-expert
# scale as the experts.  The hashtable at HT_BATCH keys a rank an epoch
# into HT_TABLE / HT_HEAP cells a rank, HT_EPOCHS epochs and the re-insert,
# at the hashtable phase's multiple of the mean pair load (4x): 16,384
# slots a pair for the inserts (4,096 expected), 32,768 for the lookup's
# 2 x HT_BATCH keys a rank (8,192 expected).  The FFT at FFT_N³.
APPS_K, APPS_CAP, APPS_SEED = 6144, 2048, 30
APPS_MOE = dict(tokens=1024, d=2048, experts=128, top_k=8, cf=1.25)
APPS_HT_CAP, APPS_HT_LOOKUP_CAP = 16384, 32768
APPS_REPS, APPS_FFT_REPS, APPS_ARM_REPS = 7, 3, 11
# phase 31: phase 25's P1-P4 and row 13 with one rank a process, 4 processes
# as the grid {"pod": 2, "data": 2} (P3 the same ranks as a pod axis of 4, P4
# as the grid that 4 survivors make with prefer_model 2, row 13 as one axis)
PP_GRID, PP_ELASTIC, PP_GRID_ELASTIC = PAR_GRID, (4, 2), {"data": 2, "model": 2}
PP_TURNS, RING_REPS, PP_TIMEOUT = ("hf", "fh", "hf"), 5, 300.0
# phase 33: qwen1.5-110b at its published widths (src/repro/configs/qwen1_5_110b.py:
# d_model 8192, 64 heads and 8 KV heads of 128, F 49152, vocab 152064, q/k/v
# biases) cut to 8 of 80 layers, split over ProcMesh({"model": 4}) with
# fsdp=False (the reference's pure-TP setting), 4 processes sharing the
# card, against one process running the same weights whole.  The logits
# differ by the partial sums' extra roundings (each rank's projection is
# rounded to bf16 before the f32 sum, then again), which 8 random layers
# carry to logits of std ~1.8: bf16 rounding, so it grows with the
# logits' scale, as a bf16 run's own distance from an f32 one does.  Every
# logit is held within TP_REL of the whole run's max |logit| (a missing or
# doubled reduction moves them by their own scale), and the argmax
# wherever the whole run's top-2 margin exceeds twice that bound (two
# logits each within the bound cannot swap across a wider margin)
TP_ARCH, TP_LAYERS, TP_RANKS, TP_SEED = "qwen1.5-110b", 8, 4, 33
TP_PLENS, TP_STEPS, TP_REL, TP_TIMEOUT = (64, 128, 192, 256), 16, 2 ** -4, 600.0
TP_GRID, TP_AR_REPS = {"model": TP_RANKS}, 20
# phase 34: starcoder2-15b at its published widths (src/repro/configs/starcoder2_15b.py:
# d_model 6144, 48 heads and 4 KV heads of 128, F 24576 gelu, vocab 49152,
# q/k/v biases) cut to 4 of 40 layers, trained over ProcMesh({"data": 2,
# "model": 2}) under the reference's make_policy (fsdp=True), 4 processes
# sharing the card, against one process running the same 3 steps whole.
# T1's optimizer, batch and bounds (TRAIN_OPT, TRAIN_BATCH: 2 rows a data
# coordinate; TRAIN_LOSS_TOL and TRAIN_GRAD_REL, its cuda-vs-torch bounds)
TT_ARCH, TT_LAYERS, TT_RANKS, TT_SEED = "starcoder2-15b", 4, 4, 34
TT_GRID, TT_STEPS, TT_TIMEOUT = {"data": 2, "model": 2}, 3, 900.0
# phase 35: chatglm3-6b at its published widths and depth (src/repro/configs/chatglm3_6b.py:
# 28 layers, d_model 4096, 32 q heads and 2 KV heads of 128, F 13,696 swiglu, vocab
# 65,024, q/k/v biases, 2-D RoPE) served over ProcMesh({"model": 4}) under the
# reference's make_policy for decode_32k: 2 KV heads under 4 ranks put the cache's
# sequence on model, 4 blocks of 8,192 positions.  Prompts end just short of the block
# boundaries (the fourth inside rank 3's block), so three rows cross one while decoding;
# each prompt is prefilled in chunks that straddle them.  Part 2: the first 8 layers over
# {"data": 2, "model": 2} for long_500k (kv_seq_shard: the 2 KV heads split one a rank,
# FSDP over data, 2 rows a data coordinate), every row crossing 4,096.  TP_REL's bounds.
# The whole smoke cuts part 1's cache to 8,192 positions (blocks of 2,048; its time
# limit); ``--kv-seq-procs --decode-32k`` runs it at decode_32k's 32,768 (KV_32K)
KV_ARCH, KV_RANKS, KV_SEED, KV_TIMEOUT = "chatglm3-6b", 4, 35, 600.0
KV_MAX_SEQ, KV_PLENS, KV_CHUNK = 8192, (2036, 4084, 6130, 7600), 1500
KV_32K = (32_768, (8180, 16380, 24570, 30000), 5000)   # (max_seq, prompts, prefill chunk)
KV_STEPS, KV_FWD = 16, 2048     # decode steps; the cache-free forward's prefix (row 11)
KV_GRID, KV_GRID_LAYERS, KV_GRID_SEQ = {"data": 2, "model": 2}, 8, 8192
KV_GRID_PLENS = (4082, 4086, 4090, 4094)
# phase 36: the MoE layer split over model: tensor-parallel experts, as the
# reference's fitted specs place them (each expert's F over model, the
# router whole).  Part 1: qwen3-moe-30b-a3b at its published widths
# (src/repro/configs/qwen3_moe_30b_a3b.py: d_model 2048, 32 q heads and 4 KV
# heads of 128, 128 experts of F 768 top-8, vocab 151,936) cut to 8 of 48
# layers over ProcMesh({"model": 4}) under make_policy for decode_32k (one
# KV head a rank); each prompt forwarded and prefilled alone, 16 greedy
# steps over the 4 rows (at 2,048 tokens a row's capacity is 160 slots
# against 128 items an expert on average).  Part 2: moonshot-v1-16b-a3b
# (src/repro/configs/moonshot_v1_16b_a3b.py: 16 heads and 16 KV heads of
# 128, 64 experts of F 1,408 top-6, a shared expert of 1,408, vocab
# 163,840) cut to 4 of 48 layers over {"data": 2, "model": 2} under
# make_policy (fsdp=True): 4 rows, 2 a data coordinate, one forward of
# MS_GRID_FWD tokens a row, one prefill of MS_GRID_PROMPT, 16 greedy steps;
# the reference's G = 2 dispatch groups over the global batch are one a
# data coordinate.  The whole run in this process (part 2 under a policy
# on a stacked Mesh of the same shape: the same groups) is dispatched to
# the split's experts and teacher-forced on its tokens; TP_REL's bounds
MS_ARCHS, MS_LAYERS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"), (8, 4)
MS_RANKS, MS_SEED, MS_TIMEOUT, MS_STEPS = 4, 36, 600.0, 16
MS_PLENS, MS_GRID = (256, 512, 1024, 2048), {"data": 2, "model": 2}
MS_GRID_ROWS, MS_GRID_FWD, MS_GRID_PROMPT = 4, 1024, 512


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
    from repro_torch.obs import drift_docs
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
    set_b = {"fused": drift_docs.run_record(eng, N_FUSED)}   # phase 32's set B
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
    set_b["gather"] = drift_docs.run_record(eng, N_GATHER)
    log(f"gather: {N_GATHER} requests, {eng.steps_run} steps, "
        f"{dt / eng.steps_run * 1e3:.3f} ms/step, attend_us p50 "
        f"{gather['attend_us']['p50']:.1f} p90 {gather['attend_us']['p90']:.1f}")
    del eng
    torch.cuda.empty_cache()
    cfg_i = disagg.DisaggConfig(paged=False, **FULL)
    eng, dt = serve(disagg, cfg_i, N_INLINE, seed=2)
    set_b["inline"] = drift_docs.run_record(eng, N_INLINE)
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
    kernels += rendezvous_phases(torch, F, disagg, fused_tokens, fused_ms, H100.hbm_bandwidth,
                                 set_b)
    torch.cuda.empty_cache()
    kernels += rma_phases(torch)
    torch.cuda.empty_cache()
    kernels += dsde_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += model_serve_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    kernels += hybrid_serve_phases(torch, H100.hbm_bandwidth)
    torch.cuda.empty_cache()
    rows, par = training_phases(torch, H100.hbm_bandwidth)
    kernels += rows
    next(r for r in kernels if r["name"] == "put_shift").update(par.pop("row4"))
    next(r for r in kernels if r["name"] == "flash_attention").update(par.pop("row11"))
    log(f"parallel phase numbers: {json.dumps(par)}")
    torch.cuda.empty_cache()
    zoo = zoo_phases(torch, H100.hbm_bandwidth)
    next(r for r in kernels if r["name"] == "flash_attention").update(zoo.pop("row11"))
    log(f"zoo phase numbers: {json.dumps(zoo)}")
    pool = pool_phase(torch, H100.hbm_bandwidth)
    next(r for r in kernels if r["name"] == "paged_gather").update(pool.pop("row3"))
    log(f"pool phase numbers: {json.dumps(pool)}")
    torch.cuda.empty_cache()
    log(f"apps phase numbers: {json.dumps(apps_phase(torch, H100.hbm_bandwidth))}")
    torch.cuda.empty_cache()
    conf = conformance_phases(torch, disagg)
    next(r for r in kernels if r["name"] == "queue_push")["launches"] += conf.pop("row10_launches")
    log(f"conformance phase numbers: {json.dumps(conf)}")
    torch.cuda.empty_cache()
    tools = tools_phases(torch)
    drove = tools["drivers"]["launches"]
    row1 = drove["paged_attention"] + drove["paged_attention_shift"]
    for name, n in (("paged_attention", row1), ("paged_gather", drove["paged_gather"]),
                    *((k, drove[k]) for k in ("put_shift", "get_shift", "accumulate_shift",
                                              "ring_all_gather"))):
        next(r for r in kernels if r["name"] == name)["launches"] += n
    log(f"tools phase numbers: {json.dumps(tools, default=str)}")
    torch.cuda.empty_cache()
    rows, procs = procs_phases(torch, H100.hbm_bandwidth)
    kernels += rows
    log(f"procs phase numbers: {json.dumps(procs)}")
    torch.cuda.empty_cache()
    rows, dprocs = disagg_procs_phases(torch, H100.hbm_bandwidth)
    kernels += rows
    row4 = next(r for r in kernels if r["name"] == "put_shift_peer")
    row4["launches"] += dprocs.pop("row4_launches")
    log(f"disagg procs phase numbers: {json.dumps(dprocs)}")
    torch.cuda.empty_cache()
    aprocs = apps_procs_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += aprocs.pop("row4_launches")
    row4["all_to_all"] = {name: {"ms": median(a["ms"]), "torch_ms": median(a["torch_ms"]),
                                 "bound_ms": a["bound_ms"], "bytes": a["bytes"]}
                          for name, a in aprocs["arms"].items()}
    log(f"apps procs phase numbers: {json.dumps(aprocs)}")
    torch.cuda.empty_cache()
    pp = parallel_procs_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += pp.pop("row4_launches")
    pp.pop("row4_put")
    next(r for r in kernels if r["name"] == "flash_attention")["launches"] += pp.pop(
        "row11_launches")
    row13 = next(r for r in kernels if r["name"] == "ring_matmul")
    row13["launches"] += pp.pop("row13_launches")
    row13["procs"] = pp.pop("row13_procs")
    log(f"parallel procs phase numbers: {json.dumps(pp)}")
    torch.cuda.empty_cache()
    drift = drift_phase(torch, set_b)
    for run in drift["launches"].values():
        for name, n in run.items():
            next(r for r in kernels if r["name"] == name)["launches"] += n
    log(f"drift phase numbers: {json.dumps(drift)}")
    torch.cuda.empty_cache()
    tp = tp_serve_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += tp.pop("row4_launches")
    next(r for r in kernels if r["name"] == "ring_all_gather_peer")["launches"] += tp.pop(
        "row7_launches")
    next(r for r in kernels if r["name"] == "flash_attention")["launches"] += tp.pop(
        "row11_launches")
    row4["tensor_parallel_put"] = tp.pop("put")
    log(f"tp procs phase numbers: {json.dumps(tp)}")
    torch.cuda.empty_cache()
    tt = tt_train_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += tt.pop("row4_launches")
    next(r for r in kernels if r["name"] == "flash_attention")["launches"] += tt.pop(
        "row11_launches")
    row4["tensor_parallel_train_put"] = tt.pop("put")
    log(f"tp train procs phase numbers: {json.dumps(tt)}")
    torch.cuda.empty_cache()
    kv = kv_seq_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += kv.pop("row4_launches")
    next(r for r in kernels if r["name"] == "flash_attention")["launches"] += kv.pop(
        "row11_launches")
    row4["kv_seq_all_to_all_put"] = kv.pop("put")
    log(f"kv seq procs phase numbers: {json.dumps(kv)}")
    torch.cuda.empty_cache()
    ms = moe_split_phases(torch, H100.hbm_bandwidth)
    row4["launches"] += ms.pop("row4_launches")
    next(r for r in kernels if r["name"] == "flash_attention")["launches"] += ms.pop(
        "row11_launches")
    row4["moe_all_reduce_put"] = ms.pop("put")
    log(f"moe procs phase numbers: {json.dumps(ms)}")
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
    from repro_torch.obs import drift_docs
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
    busiest["drift"] = drift_docs.run_record(eng, N_FUSED)
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
                      hbm: float, set_b: dict) -> list:
    """Phases 5a and 5b; the rendezvous run's counts go to `set_b`."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.paged_gather import ref as pg_ref
    from repro_torch.mesh import Mesh
    from repro_torch.rmem import pages as rpg

    run = rendezvous_serve(torch, disagg, fused_tokens, fused_ms)
    set_b["rendezvous"] = run.pop("drift")
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
    plan_mod._route = lambda sig, ops, pack, backend, procs=False: "torch"
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

    def tap(p, x, *args, **kw):          # layer 0's MLP input and weights, last step
        if not taps:
            taps.update(x=x.detach().clone(), **{k: v.detach().clone() for k, v in p.items()})
        return real_mlp(p, x, *args, **kw)

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


def layer0_state(params: dict, opt) -> tuple:
    """Layer 0's params and AdamW moments (views), as T2 checkpoints them."""
    from repro_torch.train.optimizer import OptState, tree_map

    def layer0(tree):
        return tree_map(lambda x: x[0], tree["blocks"])

    return (layer0(params), OptState(opt.step, layer0(opt.mu), layer0(opt.nu)))


def resume_phase(torch, np, state: dict, d: str) -> tuple:
    """The launcher at --smoke on the card; the kill-and-resume contract of
    tests/test_training.py on the card (bit-equal at the last step); one
    blocking checkpoint of layer 0's params and moments at full width, in
    `d`.  Returns (its directory, the tree it saved)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager, codec_name, flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves, tree_map
    from repro_torch.train.train_step import StepConfig, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

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
    tree = layer0_state(params, opt)
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
    return os.path.join(d, "layer0"), tree


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


def training_phases(torch, hbm: float) -> tuple:
    """SmolLM-360M trained at full width through the flash kernel (T1), the
    launcher and the resume contract on the card and a checkpoint's rate
    (T2), kernel row 13 through its ops surface on T1's activations (T3),
    and the parallel layer on T1's model and T2's checkpoint (P1-P4).
    Returns (row 13's entry, the parallel phases' numbers)."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    model = build_model(get_config(MODEL_ARCH))
    state = train_phase(torch, np, model, L, fops)
    torch.cuda.empty_cache()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        layer0_dir, layer0_tree = resume_phase(torch, np, state, d)
        ring = ring_phase(torch, state.pop("taps"), hbm)
        torch.cuda.empty_cache()
        par = parallel_phases(torch, model, state["params"], layer0_dir, layer0_tree)
    del state, layer0_tree
    gc.collect()
    torch.cuda.empty_cache()
    return [{"name": "ring_matmul", "route": KERNELS["ring_matmul"][0],
             "source": KERNELS["ring_matmul"][1], "replaces": KERNELS["ring_matmul"][2],
             **ring}], par


# ------------------------------------------ the parallel layer (phase 25)
def stacked_grads(torch, model, params, batch, grid: dict) -> tuple:
    """Each rank's f32 gradients of its own row of `batch` (`loss_and_grads`,
    remat on), stacked leaf by leaf as the grid's global view [pod, data,
    ...]; and the bf16 per-rank trees' leaves are dropped as they go."""
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import loss_and_grads

    ranks = math.prod(grid.values())
    per = []
    for r in range(ranks):
        _, _, g = loss_and_grads(model, params, {k: v[r:r + 1] for k, v in batch.items()},
                                 remat=True)
        per.append(g)
    lead = tuple(grid.values())
    stacked = tree_map(lambda *gs: torch.stack([g.float() for g in gs]).reshape(
        lead + tuple(gs[0].shape)), *per)
    del per
    return stacked, len(tree_leaves(stacked))


def grad_sync_phase(torch, model, params, batch) -> dict:
    """P1: `parallel.overlap.overlapped_grad_sync` over {"pod": 2, "data": 2}
    on SmolLM-360M's f32 gradients, one [1, 2048] row of T1's batch a rank:
    under "auto" (kernel row 4 carries every in-pod ring put; counted from
    0) and with every plan group sent through the plain put, bit-equal;
    every rank's copy equal; within PAR_F32 x sum |g_r| of the sum of the
    four ranks' gradients and of 4 x the n_microbatches=4 step's averaged
    gradients; then timed beside one flat ring over a 4-rank axis, with
    `select_allreduce`'s pick."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.perfmodel import DEFAULT_MODEL
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.mesh import Mesh
    from repro_torch.parallel.overlap import CollectiveStrategist, overlapped_grad_sync
    from repro_torch.core.epoch import SyncStats
    from repro_torch.parallel.overlap import bucket_grads
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import StepConfig, step_grads

    t0 = time.perf_counter()
    stacked, n_leaves = stacked_grads(torch, model, params, batch, PAR_GRID)
    _, _, avg = step_grads(model, params, batch, StepConfig(n_microbatches=PAR_RANKS))
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    nbytes = sum(g.numel() * 4 for g in tree_leaves(avg))           # a rank's f32 bytes
    mesh = Mesh(PAR_GRID, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_rma_launches(rma_ops)
    with SyncStats() as sync:
        auto = overlapped_grad_sync(stacked, mesh)
    torch.cuda.synchronize()
    launches = dict(rma_ops.launches)
    buckets = len(bucket_grads(stacked, mesh=mesh))
    if sync.flush_msgs != buckets:
        raise AssertionError(f"P1: {sync.flush_msgs} flushes for {buckets} buckets")
    with plain_route(plan_mod):
        plain = overlapped_grad_sync(stacked, mesh)
    torch.cuda.synchronize()
    if rma_ops.launches != launches:
        raise AssertionError(f"P1: the plain route launched {rma_ops.launches} (after {launches})")
    # every leaf a reduce-scatter step (one put) and an all-gather step (two)
    want_puts = 3 * n_leaves
    if launches["put_shift"] != want_puts or sum(launches.values()) != want_puts:
        raise AssertionError(f"P1: rma launches {launches} under auto, want put_shift "
                             f"{want_puts} ({n_leaves} leaves) and nothing else")
    bitequal = all(torch.equal(a, b) for a, b in zip(tree_leaves(auto), tree_leaves(plain)))
    del plain
    if not bitequal:
        raise AssertionError("P1: the synced grads under auto and under the plain put differ")
    worst_sum = worst_avg = 0.0
    for got, g, a in zip(tree_leaves(auto), tree_leaves(stacked), tree_leaves(avg)):
        if not all(torch.equal(got[i, j], got[0, 0]) for i in range(2) for j in range(2)):
            raise AssertionError("P1: the ranks' copies of the synced grads differ")
        scale = g.abs().sum((0, 1)).clamp_min(1e-30)
        worst_sum = max(worst_sum, float(((got[0, 0] - g.sum((0, 1))).abs() / scale).max()))
        worst_avg = max(worst_avg, float(((got[0, 0] - PAR_RANKS * a).abs() / scale).max()))
    if worst_sum > PAR_F32 or worst_avg > PAR_F32:
        raise AssertionError(f"P1: |synced - sum| / sum|g_r| {worst_sum:.3g}, vs 4 x the "
                             f"microbatch average {worst_avg:.3g} (bound {PAR_F32})")
    peak = torch.cuda.max_memory_allocated()
    del auto, avg

    flat_mesh = Mesh({"data": PAR_RANKS}, device="cuda")
    flat_in = tree_map(lambda g: g.reshape((PAR_RANKS,) + tuple(g.shape[2:])), stacked)
    hier, flat = [], []
    for order in ("hf", "fh", "hf"):                 # in turns
        for arm in order:
            if arm == "h":
                hier += sync_ms(torch, lambda: overlapped_grad_sync(stacked, mesh), 1)
            else:
                flat += sync_ms(torch, lambda: overlapped_grad_sync(flat_in, flat_mesh,
                                                                    outer_axis=None), 1)
    st = CollectiveStrategist()
    leaf_picks = collections.Counter(st.allreduce_plan(g.numel() // PAR_RANKS * 4, 2, 2)
                                     for g in tree_leaves(stacked))
    pick = st.allreduce_plan(nbytes, 2, 2)
    model_h = sum(DEFAULT_MODEL.hierarchical_all_reduce(g.numel() // PAR_RANKS * 4, 2, 2)
                  for g in tree_leaves(stacked)) * 1e3
    model_f = sum(DEFAULT_MODEL.all_reduce(g.numel() // PAR_RANKS * 4, PAR_RANKS)
                  for g in tree_leaves(stacked)) * 1e3
    log(f"P1 hierarchical grad sync ({card_line()}): {MODEL_ARCH} at full width, mesh "
        f"{PAR_GRID}, rank r's f32 grads of row r of T1's batch {list(batch['tokens'].shape)} "
        f"({n_leaves} leaves, "
        f"{nbytes / 1e9:.3f} GB a rank, {PAR_RANKS * nbytes / 1e9:.3f} GB stacked; "
        f"grads {grads_s:.1f} s); auto vs plain put bit-equal, put_shift launches "
        f"{launches['put_shift']} (3 a leaf), {buckets} buckets and as many flushes, every "
        f"rank's copy equal; |synced - sum of the "
        f"ranks| max {worst_sum:.3g} of sum|g_r|, vs 4 x the n_microbatches=4 step's average "
        f"{worst_avg:.3g} (bound {PAR_F32}); peak {peak / 2**30:.2f} GiB")
    log(f"P1 timing, host ms of synchronised calls in turns: hierarchical "
        f"{' '.join(f'{t:.3f}' for t in hier)} (median {median(hier):.3f}), flat ring over "
        f"{PAR_RANKS} ranks {' '.join(f'{t:.3f}' for t in flat)} (median {median(flat):.3f}); "
        f"select_allreduce({nbytes}, 2, 2) = {pick!r} (priced hierarchical {model_h:.3f} ms, "
        f"flat {model_f:.3f} ms over the leaves; by leaf {dict(leaf_picks)}); measured faster: "
        f"{'hierarchical' if median(hier) < median(flat) else 'flat_ring'}")
    return {"stacked": stacked, "put_launches": launches["put_shift"],
            "numbers": {"grad_sync_bitequal": bitequal, "put_shift_launches": launches["put_shift"],
                        "rel_err_sum": worst_sum, "rel_err_avg": worst_avg,
                        "hier_ms": hier, "flat_ms": flat, "pick": pick,
                        "priced_hier_ms": model_h, "priced_flat_ms": model_f,
                        "peak_gib": peak / 2**30}}


def compression_phase(torch, stacked: dict) -> dict:
    """P2: `compress_decompress` on rank 0's gradient tree from P1 (what one
    rank would send across pods): ms a round and the dcn_bytes ratio; then
    gradsync_sub.py's convergence check (40 rounds, error < 0.05) on layer
    0's largest leaf."""
    from repro_torch.parallel.compression import compress_decompress, init_compression_state
    from repro_torch.train.optimizer import tree_map

    g0 = tree_map(lambda g: g[0, 0], stacked)
    state = init_compression_state(g0)
    out = {}

    def round_():
        nonlocal state
        out["comp"], state, out["met"] = compress_decompress(g0, state)

    times = sync_ms(torch, round_, COMP_TIMED)
    met = out["met"]
    ratio = met["dcn_bytes_compressed"] / met["dcn_bytes_uncompressed"]
    del out, state
    layer0 = tree_map(lambda g: g[0], g0["blocks"])
    name, leaf = max(flat_leaves(layer0).items(), key=lambda kv: kv[1].numel())
    g = {"w": leaf}
    st = init_compression_state(g)
    acc = torch.zeros_like(leaf)
    for _ in range(COMP_ROUNDS):
        comp, st, _ = compress_decompress(g, st)
        acc += comp["w"]
    err = float((acc / COMP_ROUNDS - leaf).abs().max() / leaf.abs().max())
    if not err < COMP_ERR:
        raise AssertionError(f"P2: error feedback after {COMP_ROUNDS} rounds {err:.4g} "
                             f"(bound {COMP_ERR})")
    log(f"P2 int8 error-feedback compression ({card_line()}): rank 0's grads "
        f"({met['dcn_bytes_uncompressed'] / 1e9:.3f} GB f32 -> "
        f"{met['dcn_bytes_compressed'] / 1e9:.3f} GB, ratio {ratio:.4f}): "
        f"{' '.join(f'{t:.3f}' for t in times)} ms a round (median {median(times):.3f}); "
        f"blocks/{name}[0] {tuple(leaf.shape)}: mean of {COMP_ROUNDS} rounds within "
        f"{err:.3g} of the gradient (bound {COMP_ERR})")
    return {"comp_ms": times, "dcn_ratio": ratio, "converge_err": err}


def stage_layers(torch, cfg, per: int) -> tuple:
    """(run_layers(blocks, n, h), stage_fn(stage, h)): the first n of the
    stacked `blocks` on h [mb, S, D] one after another, and a pipeline
    stage's `per` layers given its [1, per, ...] slice."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_map

    def run_layers(blocks: dict, n: int, h):
        pos = torch.arange(h.shape[1], device=h.device)[None, :].expand(h.shape[0], -1)
        start = torch.zeros((), dtype=torch.int32, device=h.device)
        for blk in T._unstack(blocks, n):
            h, _, _ = T._block(cfg, blk, h, pos, None, start)
        return h

    def stage_fn(sp, h):
        return run_layers(tree_map(lambda a: a[0], sp), per, h)

    return run_layers, stage_fn


def pipeline_phase(torch, model, params, tokens, L, fops) -> dict:
    """P3: SmolLM-360M's 32 blocks as PIPE_STAGES stages over the `pod` axis
    (`parallel.pipeline.pipeline_forward`), PIPE_MICRO microbatches of one
    row of T1's batch, the flash kernel in every layer (counted from 0):
    bit-equal to each microbatch through the 32 layers one at a time, and
    its logits within FWD_BOUND of the whole batch's forward (other batch
    shapes, other orders of sums in bf16)."""
    from repro_torch.mesh import Mesh
    from repro_torch.parallel.pipeline import PipelineConfig, pipeline_forward
    from repro_torch.train.optimizer import tree_map

    cfg = model.cfg
    per = cfg.n_layers // PIPE_STAGES
    stages = tree_map(lambda a: a.reshape((PIPE_STAGES, per) + tuple(a.shape[1:])),
                      params["blocks"])
    B, S = tokens.shape
    run_layers, stage_fn = stage_layers(torch, cfg, per)
    pcfg = PipelineConfig(PIPE_STAGES, PIPE_MICRO)
    mesh = Mesh(PIPE_STAGES, "pod", device="cuda")
    L.set_attention_backend("cuda")
    try:
        with torch.no_grad():
            x = L.embed(params["tok"], tokens)                     # [B, S, D] bf16
            x_micro = x.reshape((PIPE_MICRO, B // PIPE_MICRO) + tuple(x.shape[1:]))
            fops.launches = 0
            fops.launches_by_variant.update(wgmma=0, simt=0)
            out = pipeline_forward(stage_fn, stages, x_micro, pcfg, mesh)
            torch.cuda.synchronize()
            launches, wgmma = fops.launches, fops.launches_by_variant["wgmma"]
            seq = []
            for m in range(PIPE_MICRO):
                h = x_micro[m]
                for s in range(PIPE_STAGES):
                    h = stage_fn(tree_map(lambda a: a[s:s + 1], stages), h)
                seq.append(h)
            seq = torch.stack(seq)
            whole = run_layers(params["blocks"], cfg.n_layers, x)
            if not all(torch.equal(out[s], seq) for s in range(PIPE_STAGES)):
                raise AssertionError("P3: the pipeline differs from the stages in sequence")

            def logits(h):
                return L.unembed(params["tok"], L.rmsnorm(h, params["final_norm"]["scale"],
                                                          cfg.norm_eps)).float()

            gap = float((logits(out[0].reshape(x.shape)) - logits(whole)).abs().max())
            if gap > FWD_BOUND:
                raise AssertionError(f"P3: pipeline logits {gap:.4g} from the whole batch's "
                                     f"(bound {FWD_BOUND})")
            want = PIPE_MICRO * cfg.n_layers
            if launches != want or wgmma != want:
                raise AssertionError(f"P3: flash launches {launches} (wgmma {wgmma}), want "
                                     f"{want}")
            pipe_ms = sync_ms(torch, lambda: pipeline_forward(stage_fn, stages, x_micro, pcfg,
                                                              mesh), PIPE_REPS)
            seq_ms = sync_ms(torch, lambda: [run_layers(params["blocks"], cfg.n_layers,
                                                        x_micro[m]) for m in range(PIPE_MICRO)],
                             PIPE_REPS)
            whole_ms = sync_ms(torch, lambda: run_layers(params["blocks"], cfg.n_layers, x),
                               PIPE_REPS)
    finally:
        L.set_attention_backend("torch")
    log(f"P3 GPipe pipeline ({card_line()}): {MODEL_ARCH} at full width, {cfg.n_layers} layers "
        f"as {PIPE_STAGES} stages of {per} over pod, {PIPE_MICRO} microbatches of "
        f"[{B // PIPE_MICRO}, {S}], flash launches {launches} (all wgmma); bit-equal to the "
        f"stages in sequence; logits {gap:.4g} from the whole batch's (bound {FWD_BOUND}); "
        f"bubble_fraction {pcfg.bubble_fraction:.4f}; host ms: pipeline "
        f"{' '.join(f'{t:.3f}' for t in pipe_ms)}, the {cfg.n_layers} layers a microbatch at a "
        f"time {' '.join(f'{t:.3f}' for t in seq_ms)}, the whole batch "
        f"{' '.join(f'{t:.3f}' for t in whole_ms)}")
    return {"flash_launches": launches, "pipe_ms": pipe_ms, "seq_ms": seq_ms,
            "whole_ms": whole_ms, "bubble_fraction": pcfg.bubble_fraction, "logit_gap": gap}


def policy_phase(torch, model, params, tokens, L, layer0_dir: str, layer0_tree) -> dict:
    """P4: SmolLM-360M's logits under a `ShardingPolicy` of {"data": 4}
    bit-equal to no policy; a 4-layer qwen3-moe forward under it, each MoE
    layer bit-equal to one no-policy `moe_ffn` call a dispatch group; then
    `elastic_restore` of T2's layer-0 checkpoint for ELASTIC_SURVIVORS
    survivors with prefer_model ELASTIC_MODEL: values bit-equal, every
    leaf's blocks tiling it."""
    from repro_torch.ckpt.checkpoint import CheckpointManager, flatten
    from repro_torch.configs import get_config
    from repro_torch.ft.elastic import elastic_restore
    from repro_torch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import ShardingPolicy, current_policy, use_policy

    pol = ShardingPolicy(Mesh(POLICY_GRID, device="cuda"))
    L.set_attention_backend("cuda")
    try:
        with torch.no_grad():
            a = model.forward_logits(params, {"tokens": tokens}).logits
            with use_policy(pol):
                b = model.forward_logits(params, {"tokens": tokens}).logits
            same = torch.equal(a, b)
            del a, b
            if not same:
                raise AssertionError("P4: SmolLM's logits under the policy differ")
            moe_model, moe_params = full_width(torch, build_model, get_config, MOE_ARCH,
                                               MOE_LAYERS, MOE_SEED)
            toks = torch.randint(0, moe_model.cfg.vocab_size, POLICY_MOE_TOKENS,
                                 generator=torch.Generator(device="cuda").manual_seed(MOE_SEED),
                                 device="cuda")
            real, calls = moe_mod.moe_ffn, []

            def tap(p, x, top_k, capacity_factor=1.25, mlp_type="swiglu", **sizes):
                y, met = real(p, x, top_k, capacity_factor, mlp_type, **sizes)
                if current_policy() is not None:
                    calls.append((p, x, top_k, capacity_factor, mlp_type, y,
                                  moe_mod._n_groups(x.shape[0])))
                return y, met

            moe_mod.moe_ffn = tap
            try:
                with use_policy(pol):
                    moe_model.forward_logits(moe_params, {"tokens": toks})
            finally:
                moe_mod.moe_ffn = real
            groups = {c[-1] for c in calls}
            for p, x, k, cf, mt, y, g in calls:
                parts = [real(p, xg, k, cf, mt)[0] for xg in x.chunk(g)]
                if not torch.equal(y, torch.cat(parts)):
                    raise AssertionError("P4: a MoE layer under the policy differs from its "
                                         "groups run alone")
            if len(calls) != MOE_LAYERS or groups != {POLICY_GROUPS}:
                raise AssertionError(f"P4: {len(calls)} MoE calls in {groups} groups, want "
                                     f"{MOE_LAYERS} in {POLICY_GROUPS}")
            del moe_model, moe_params, calls
    finally:
        L.set_attention_backend("torch")
    torch.cuda.empty_cache()

    like = tree_like(torch, layer0_tree)
    t0 = time.perf_counter()
    tree, extra, mesh, epol = elastic_restore(CheckpointManager(layer0_dir), like,
                                              ELASTIC_SURVIVORS, ELASTIC_MODEL, device="cuda")
    restore_s = time.perf_counter() - t0
    saved, back = dict(flatten(layer0_tree)), dict(flatten(tree))
    if not all(torch.equal(back[k], v) for k, v in saved.items()) or set(back) != set(saved):
        raise AssertionError("P4: the elastic restore is not bit-equal")
    sh = dict(flatten(epol.tree_shardings(like)))
    n_blocks = 0
    for key, v in back.items():
        if v.device.type != mesh.device.type:
            raise AssertionError(f"P4: {key} restored on {v.device}")
        blocks = sh[key].blocks(v)
        tiled = torch.full_like(v, float("nan")) if v.is_floating_point() else v.clone()
        for c, blk in blocks.items():
            tiled[sh[key].index(c, v.shape)] = blk
        if not torch.equal(tiled, v) or len(blocks) != math.prod(mesh.shape.values()):
            raise AssertionError(f"P4: {key}'s blocks do not tile it")
        n_blocks += len(blocks)
    specs = collections.Counter(str(tuple(s.spec)) for s in sh.values())
    log(f"P4 sharding and elasticity ({card_line()}): SmolLM logits under ShardingPolicy "
        f"{POLICY_GRID} bit-equal to no policy; {MOE_ARCH} cut to {MOE_LAYERS} layers on "
        f"{list(POLICY_MOE_TOKENS)} tokens under it: {MOE_LAYERS} MoE layers in "
        f"{POLICY_GROUPS} dispatch groups, each bit-equal to its groups' no-policy calls; "
        f"elastic_restore of T2's layer-0 checkpoint (step {extra.get('step')}) for "
        f"{ELASTIC_SURVIVORS} survivors, prefer_model {ELASTIC_MODEL}: mesh {mesh.shape}, "
        f"{len(back)} leaves bit-equal on the card, {n_blocks} blocks tiling them, specs "
        f"{dict(specs)}; {restore_s:.2f} s")
    return {"restore_s": restore_s, "mesh": mesh.shape, "leaves": len(back)}


def tree_like(torch, tree):
    """`tree` with every tensor replaced by a meta tensor of its shape and dtype."""
    if isinstance(tree, dict):
        return {k: tree_like(torch, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_like(torch, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def parallel_phases(torch, model, params, layer0_dir: str, layer0_tree) -> dict:
    """P1-P4 on SmolLM-360M at full width (the training phases' model and
    state), each phase's line printed as it ends."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    B, S = TRAIN_BATCH
    batch = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, S, B),
                                   device="cuda").batch_at(0)
    L.set_attention_backend("cuda")
    try:
        p1 = grad_sync_phase(torch, model, params, batch)
    finally:
        L.set_attention_backend("torch")
    p2 = compression_phase(torch, p1.pop("stacked"))
    gc.collect()
    torch.cuda.empty_cache()
    p3 = pipeline_phase(torch, model, params, batch["tokens"], L, fops)
    p4 = policy_phase(torch, model, params, batch["tokens"], L, layer0_dir, layer0_tree)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"parallel phases P1-P4: {wall:.1f} s")
    return {"row4": {"grad_sync_launches": p1["put_launches"]},
            "row11": {"pipeline_launches": p3["flash_launches"]},
            "P1": p1["numbers"], "P2": p2, "P3": p3, "P4": p4, "wall_s": wall}


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


# -------------------------------- phase 26: the host mirrors and the tooling
def lift_ctrs(np, ctrs):
    """A device counter block [p, 5] (uint32 values) as `HostQueueGroup`'s
    64-bit one: the same values mod 2**32, with head <= tail as integers
    (the mirror's counters never wrap, so tail - head is its occupancy)."""
    c = ctrs.cpu().numpy().astype(np.uint64)
    occ = (c[:, 1] - c[:, 0]) & np.uint64(0xFFFFFFFF)     # TAIL - HEAD mod 2**32
    c[:, 1] += np.where(c[:, 1] < occ, np.uint64(1 << 32), np.uint64(0))
    c[:, 0] = c[:, 1] - occ
    return c


def same_ctrs(np, host, dev, cols) -> bool:
    """The mirror's counters equal the device's mod 2**32 in `cols`."""
    h = np.asarray(host, np.uint64)[:, cols] & np.uint64(0xFFFFFFFF)
    return bool(np.array_equal(h, dev.cpu().numpy().astype(np.uint64)[:, cols]))


def same_ring(np, host_buf, dev_buf) -> bool:
    return bool(np.array_equal(host_buf.view(np.int32), dev_buf.cpu().numpy().view(np.int32)))


def queue_mirror_phase(torch, np) -> dict:
    """26.1: `HostQueueGroup` at the DSDE shape (p = 4096, k = 6 items of 2
    f32, the DSDE ring of 131,072 rows a rank, the DSDE run's seeded data
    and targets) against the device: the random-target epoch through
    `enqueue_epoch` (flags, ring, the five counters) and its `dequeue`
    against `drain` slot for slot; then rmaq_ops_phase's wrap and
    backpressure rounds (every rank's k items to r + 1) through the mirror,
    kernel row 10 (`queue_push`, counted from 0) and `enqueue_shift`."""
    from repro_torch.core.plan import u32_to_wire
    from repro_torch.kernels.rmaq import ops, ref
    from repro_torch.mesh import Mesh
    from repro_torch.rmaq import queue as rq

    p, k, d = DSDE_P, DSDE_K, DSDE_D
    mesh = Mesh(p, "x", device="cuda")
    rng = np.random.default_rng(DSDE_SEED)
    data_np = rng.standard_normal((p, k, d)).astype(np.float32)
    tg_np = rng.integers(0, p, (p, k)).astype(np.int32)
    data, tg = torch.from_numpy(data_np).cuda(), torch.from_numpy(tg_np).cuda()
    cap = 1 << (p * DSDE_CAP - 1).bit_length()
    desc, state = rq.queue_allocate(mesh, cap, (d,), data.dtype)
    host = rq.HostQueueGroup(p, cap, d)
    out = {"p": p, "k": k, "capacity": cap}

    t0 = time.perf_counter()
    state, rec, _ = rq.enqueue_epoch(desc, state, data, tg)
    torch.cuda.synchronize()
    out["device_epoch_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    flags = host.step({r: [(int(tg_np[r, j]), data_np[r, j]) for j in range(k)]
                       for r in range(p)})
    out["host_step_ms"] = (time.perf_counter() - t0) * 1e3
    acc = rec.accepted.cpu().numpy()
    bad = [r for r in range(p) if flags[r] != acc[r].tolist()]
    if bad:
        raise AssertionError(f"queue mirror, random targets: flags differ at ranks {bad[:8]}")
    ring_np = state.buf.cpu().numpy()
    if not (same_ring(np, host.buf, state.buf) and same_ctrs(np, host.ctrs, state.ctrs, range(5))):
        raise AssertionError("queue mirror, random targets: ring or counters differ")
    n_max = int(rq.available(state).max())
    ctrs = state.ctrs.clone()
    _, items, valid = rq.dequeue(desc, rq.QueueState(state.buf, ctrs.clone()), n_max)
    items, valid = items.cpu().numpy(), valid.cpu().numpy()
    for r in range(p):
        rows = host.drain(r, n_max)
        n = len(rows)
        if n != int(valid[r].sum()) or (n and not np.array_equal(
                np.stack(rows).view(np.int32), items[r, :n].view(np.int32))):
            raise AssertionError(f"queue mirror: drain({r}) differs from dequeue")
    out["drained"] = int(valid.sum())

    wrap = ctrs.clone()
    wrap[:, rq.HEAD] = (ctrs[:, rq.HEAD] + (2**32 - 2) - ctrs[:, rq.TAIL]) & 0xFFFFFFFF
    wrap[:, rq.TAIL] = 2**32 - 2
    bp = ctrs.clone()
    even = torch.arange(0, p, 2, device="cuda")
    bp[even, rq.HEAD] = (ctrs[even, rq.TAIL] - (cap - 3)) & 0xFFFFFFFF
    sends = {r: [((r + 1) % p, data_np[r, j]) for j in range(k)] for r in range(p)}
    for key in ops.launches:
        ops.launches[key] = 0
    for name, c in (("wrap", wrap), ("backpressure", bp)):
        host.buf[...] = ring_np
        host.ctrs[...] = lift_ctrs(np, c)
        flags = host.step(sends)
        wire = u32_to_wire(c[:, [rq.HEAD, rq.TAIL]]).contiguous()
        k_ring, k_ctr, n_sent, n_notif = ops.queue_push(state.buf.clone(), wire.clone(),
                                                        data, 1, mesh)
        plain = ref.queue_push_ref(state.buf.clone(), wire.clone(), data, 1, mesh, cap)
        s_state, s_rec = rq.enqueue_shift(desc, rq.QueueState(state.buf.clone(), c.clone()),
                                          data, 1)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((k_ring, k_ctr, n_sent, n_notif), plain)):
            raise AssertionError(f"queue mirror {name}: queue_push differs from plain")
        del plain
        sent, s_acc = n_sent.cpu().numpy(), s_rec.accepted.cpu().numpy()
        bad = [r for r in range(p) if flags[r] != [True] * int(sent[r]) + [False] * (k - int(sent[r]))
               or flags[r] != s_acc[r].tolist()]
        if bad:
            raise AssertionError(f"queue mirror {name}: flags are not the accepted prefix of "
                                 f"n_sent at ranks {bad[:8]}")
        notif = (np.asarray(host.ctrs[:, rq.NOTIF], np.uint64)
                 - c[:, rq.NOTIF].cpu().numpy().astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        tail_k = k_ctr[:, 1].cpu().numpy().astype(np.uint32).astype(np.uint64)
        ok = (same_ring(np, host.buf, k_ring) and torch.equal(k_ring, s_state.buf)
              and same_ctrs(np, host.ctrs, s_state.ctrs, [rq.TAIL, rq.ENQ, rq.NOTIF, rq.DROP])
              and np.array_equal(np.asarray(host.ctrs[:, rq.TAIL], np.uint64)
                                 & np.uint64(0xFFFFFFFF), tail_k)
              and np.array_equal(notif, n_notif.cpu().numpy().astype(np.uint64)))
        if not ok:
            raise AssertionError(f"queue mirror {name}: ring rows or TAIL/ENQ/NOTIF/DROP "
                                 "differ between the mirror, queue_push and enqueue_shift")
        out[name] = {"admitted": int(sent.sum()), "held": int((sent < k).sum()),
                     "wrapped": int(((c[:, rq.TAIL] % cap).cpu().numpy() + sent > cap).sum())}
        del k_ring, k_ctr, s_state
    out["row10_launches"] = ops.launches["queue_push"]
    if out["row10_launches"] != 2 or out["wrap"]["wrapped"] == 0 \
            or out["backpressure"]["held"] == 0:
        raise AssertionError(f"queue mirror rounds: {out}")
    log(f"26.1 queue mirror at p={p}, k={k}, ring {cap}: the random-target epoch's flags, "
        f"ring and counters equal to enqueue_epoch ({out['device_epoch_ms']:.1f} ms on the "
        f"card, the mirror {out['host_step_ms']:.1f} ms on the host); drain equal to dequeue "
        f"slot for slot ({out['drained']} items); wrap round {out['wrap']} and backpressure "
        f"round {out['backpressure']}: flags the accepted prefix of queue_push's n_sent, rings "
        f"bit-equal to queue_push and enqueue_shift, TAIL/ENQ/NOTIF/DROP equal mod 2**32; "
        f"row 10 launches {out['row10_launches']}")
    del state, ring_np, host
    torch.cuda.empty_cache()
    return out


def flow_mirror_phase(torch, np) -> dict:
    """26.2: `HostFlowChannel` against `flow.send` / `flow.recv` at the
    disaggregated shape (p = 4, 2 producers, 2 lanes, queue 64): a seeded
    schedule of FLOW_MIRROR["msgs"] messages a producer, far past its 16
    credits a lane, each producer sending its oldest FLOW_MIRROR["k"]
    pending messages an epoch and keeping what is deferred, each consumer
    draining FLOW_MIRROR["drain"] an epoch.  The same messages must arrive
    per (src, dest, lane) in order, none rejected, conservation after
    every epoch on both; where the two defer, epoch by epoch, is logged."""
    from repro_torch.mesh import Mesh
    from repro_torch.rmaq import channel as rch
    from repro_torch.rmaq import flow as rfl
    from repro_torch.rmaq import queue as rq

    cfg = FLOW_MIRROR
    p, nprod, cap, k, drain = cfg["p"], cfg["producers"], cfg["capacity"], cfg["k"], cfg["drain"]
    rng = np.random.default_rng(cfg["seed"])
    todo = {r: [(int(rng.integers(nprod, p)), int(rng.integers(2)), 1000 * r + i)
                for i in range(cfg["msgs"])] for r in range(nprod)}
    lanes = [rch.Lane("a", (2,), torch.int32), rch.Lane("b", (2,), torch.int32)]
    hfc = rfl.HostFlowChannel(p, cap, lanes, n_producers=nprod)
    channel, qs, fs = rfl.flow_allocate(Mesh(p, "serve", device="cuda"), cap, lanes,
                                        n_producers=nprod)
    host_q = {r: list(v) for r, v in todo.items()}
    dev_q = {r: list(v) for r, v in todo.items()}
    got_h, got_d, deferred = {}, {}, []
    for epoch in range(cfg["max_epochs"]):
        if not (any(host_q.values()) or any(dev_q.values())
                or any(hfc.conservation(t)["occupancy"] for t in range(p))
                or int(rq.available(qs).sum())):
            break
        dh = hfc.deferred
        for r in range(nprod):
            keep = [m for m in host_q[r][:k]
                    if not hfc.send(r, "ab"[m[1]], [m[2], -m[2]], m[2], m[0])]
            host_q[r] = keep + host_q[r][k:]
        hfc.flush()
        for t in range(p):
            for m in hfc.recv(t, drain):
                got_h.setdefault((m["src"], t, m["lane"]), []).append(m["payload"].tolist())
        dest = torch.full((p, k), -1, dtype=torch.int64)
        lane = torch.zeros((p, k), dtype=torch.int64)
        tag = torch.zeros((p, k), dtype=torch.int64)
        for r in range(nprod):
            for j, (dd, ln, tg_) in enumerate(dev_q[r][:k]):
                dest[r, j], lane[r, j], tag[r, j] = dd, ln, tg_
        payload = torch.stack([tag, -tag], dim=-1).to(torch.int32)
        qs, fs, rec = rfl.send(channel, qs, fs, "a", payload.cuda(), tag.cuda(),
                               dest.cuda(), lane.cuda())
        if int(rec.rejected.sum()) or hfc.rejected:
            raise AssertionError(f"flow mirror epoch {epoch}: rejected {int(rec.rejected.sum())} "
                                 f"on the card, {hfc.rejected} in the mirror")
        acc = rec.accepted.cpu().tolist()
        for r in range(nprod):
            dev_q[r] = [m for m, ok in zip(dev_q[r][:k], acc[r]) if not ok] + dev_q[r][k:]
        qs, fs, batch = rfl.recv(channel, qs, fs, drain)
        words, ok = channel.payload_all(batch)
        words, ok = words.cpu().tolist(), ok.cpu().tolist()
        src, lid = batch.src.cpu().tolist(), batch.lane_id.cpu().tolist()
        for t in range(p):
            for i in range(drain):
                if ok[t][i]:
                    got_d.setdefault((src[t][i], t, "ab"[lid[t][i]]), []).append(words[t][i])
        deferred.append((hfc.deferred - dh, int(rec.n_deferred.sum())))
        c = rfl.conservation(channel, qs, fs)
        hc = [hfc.conservation(t) for t in range(p)]
        if not ((c["granted_minus_head"] == cap).all() and (c["outstanding_plus_occupancy"] == cap).all()
                and all(x["granted_minus_head"] == x["outstanding_plus_occupancy"] == cap for x in hc)):
            raise AssertionError(f"flow mirror epoch {epoch}: conservation {c} / {hc}")
    else:
        raise AssertionError(f"flow mirror: not drained in {cfg['max_epochs']} epochs")
    if got_h != got_d or sum(map(len, got_h.values())) != nprod * cfg["msgs"]:
        raise AssertionError("flow mirror: the messages received per (src, dest, lane) differ")
    for (s, _, _), seq in got_h.items():
        tags = [w[0] for w in seq]
        if tags != sorted(tags) or any(t // 1000 != s for t in tags):
            raise AssertionError(f"flow mirror: out of order from {s}: {tags[:8]}")
    differ = [e for e, (a, b) in enumerate(deferred) if a != b]
    out = {"epochs": len(deferred), "messages": nprod * cfg["msgs"],
           "deferred_host": hfc.deferred, "deferred_card": sum(b for _, b in deferred),
           "refreshes_host": hfc.refreshes, "epochs_deferring_differently": len(differ)}
    log(f"26.2 flow mirror at p={p}, {nprod} producers, 2 lanes, queue {cap}: "
        f"{out['messages']} messages delivered alike per (src, dest, lane), in order, "
        f"rejected 0 on both, conservation after each of {out['epochs']} epochs on both; "
        f"deferred: mirror {out['deferred_host']} ({hfc.refreshes} refreshes, each at the "
        f"send), card {out['deferred_card']} (the refresh rides the epoch and lands for the "
        f"next); {len(differ)} epochs deferred differently (first {differ[:6]}; per epoch "
        f"mirror/card {deferred[:12]})")
    return out


def plans_ir_phase(torch, np) -> dict:
    """26.3: the plans one device `enqueue_epoch` flushes on the card (at
    IR_P ranks, IR_K seeded random targets a rank), tapped at
    `RmaPlan.flush`, lowered by `analysis.ir.from_plan` race-free; two puts
    aliasing one `at` interval on a card plan flagged."""
    from repro_torch.analysis import ir, races
    from repro_torch.core import plan as plan_mod
    from repro_torch.mesh import Mesh
    from repro_torch.rmaq import queue as rq

    mesh = Mesh(IR_P, "x", device="cuda")
    desc, state = rq.queue_allocate(mesh, 64, (2,), torch.float32)
    g = torch.Generator(device="cuda").manual_seed(IR_SEED)
    msgs = torch.randn(IR_P, IR_K, 2, device="cuda", generator=g)
    dest = torch.randint(-1, IR_P, (IR_P, IR_K), device="cuda", generator=g)
    plans, real = [], plan_mod.RmaPlan.flush

    def tap(self, *a, **kw):
        plans.append(self)
        return real(self, *a, **kw)

    plan_mod.RmaPlan.flush = tap
    try:
        rq.enqueue_epoch(desc, state, msgs, dest)
        torch.cuda.synchronize()
    finally:
        plan_mod.RmaPlan.flush = real
    lowered = [ir.from_plan(pl, p=IR_P) for pl in plans]
    found = [races.check_ir(x) for x in lowered]
    if len(plans) != 2 or any(found):
        raise AssertionError(f"plans to IR: {len(plans)} plans, violations {found}")
    bad = plan_mod.RmaPlan(Mesh(4, "x", device="cuda"))
    x = torch.zeros(4, 4, device="cuda")
    bad.put_shift(x, 1, at=(0, 16))
    bad.put_shift(x, -1, at=(8, 24))
    flagged = races.check_ir(ir.from_plan(bad))
    if not flagged or {v.rule for v in flagged} != {"unsynchronized-conflict"}:
        raise AssertionError(f"plans to IR: the aliasing puts were not flagged: {flagged}")
    out = {"plans": [[op.sig[0] + ":" + str(op.kind) for op in pl.ops] for pl in plans],
           "accesses": [len(x.accesses) for x in lowered], "negative_flagged": len(flagged)}
    log(f"26.3 plans to IR: enqueue_epoch at p={IR_P} flushed {out['plans']}, lowered to "
        f"{out['accesses']} accesses, race-free; the aliasing puts at one interval flagged "
        f"{len(flagged)} times ({flagged[0].rule})")
    return out


def traced_serve_phase(torch, disagg) -> dict:
    """26.4: the main path's FULL config in fused paged and rendezvous mode,
    TRACED_N requests each, untraced and then under the port's `Tracer`
    with the same seed and prompts: tokens equal between the two and to
    `reference()`, the same wire counts, row 1's launches equal to the
    decode steps in fused mode; over the traced events every request's
    TTFT partitioned exactly by its segments (integer µs), its critical
    path within its wall time, the sync ledger's per-request shares summing
    to its attributed wait, and the Chrome export parsing with the request
    events in the wall-clock domain."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.obs import critpath
    from repro_torch.obs.causal import build_dags
    from repro_torch.obs.export import dumps_chrome_trace
    from repro_torch.obs.trace import Tracer

    out = {}
    for mode, kw in (("fused", dict(paged=True, attend="fused")),
                     ("rendezvous", dict(transport="rendezvous"))):
        cfg = disagg.DisaggConfig(**kw, **FULL)
        runs = []
        for traced in (False, True, False):         # untraced on either side of traced
            pa_ops.launches = pa_ops.shift_launches = pg_ops.launches = 0
            tr = Tracer() if traced else contextlib.nullcontext()
            with tr:
                eng, dt = serve(disagg, cfg, TRACED_N, seed=TRACED_SEED)
            runs.append(dict(eng=eng, dt=dt, tracer=tr if traced else None,
                             launches=(pa_ops.launches, pa_ops.shift_launches,
                                       pg_ops.launches)))
            if mode == "fused" and pa_ops.launches != eng.steps_run:
                raise AssertionError(f"traced serving {mode}: {pa_ops.launches} row-1 "
                                     f"launches for {eng.steps_run} decode steps")
        b = runs[1]["eng"]
        for a in (runs[0]["eng"], runs[2]["eng"]):
            if (a.results != b.results or a.msg_stats != b.msg_stats
                    or a.steps_run != b.steps_run):
                raise AssertionError(f"traced serving {mode}: tracing changed the tokens, "
                                     "the wire counts or the steps")
        tr = runs[1]["tracer"]
        events = list(tr.events)
        dags = build_dags(events)
        bds, connected, on_rank0, rank0_connected = [], 0, 0, 0
        for rid in b.results:
            dag = dags.get(rid)
            bd = critpath.ttft_breakdown(dag) if dag is not None else None
            if bd is None or bd["segment_sum"] != bd["ttft"]:
                raise AssertionError(f"traced serving {mode}: request {rid} breakdown {bd}")
            cp, _ = critpath.critical_path(dag)
            if cp > dag.wall():
                raise AssertionError(f"traced serving {mode}: request {rid} critical path "
                                     f"{cp} > wall {dag.wall()}")
            bds.append(bd)
            connected += dag.connected()
            prefill = {e["rank"] for e in dag.events
                       if e["rank"] < cfg.n_prefill and e["name"] != "serve.request.submit"}
            on_rank0 += prefill == {0}
            rank0_connected += prefill == {0} and dag.connected()
        ledger = critpath.SyncLedger.from_events(events)
        summ = ledger.summary()
        shares = sum(ledger.by_rid().values())
        if abs(shares - summ["attributed_wait"]) > 1e-6 or shares > ledger.total_wait() + 1e-6:
            raise AssertionError(f"traced serving {mode}: ledger shares {shares} vs {summ}")
        doc = json.loads(dumps_chrome_trace(tr))
        names = {e["name"] for e in doc["traceEvents"]}
        if not ({"serve.request.submit", "serve.request.first_token"} <= names
                and doc["metadata"]["clock_domain"] == tr.clock_domain == "wall_us"):
            raise AssertionError(f"traced serving {mode}: chrome export {doc['metadata']}")
        agg = critpath.aggregate(bds)
        seg = {s: (h["p50"], h["p90"]) for s, h in agg["segments"].items()}
        ms = [r["dt"] / r["eng"].steps_run * 1e3 for r in runs]
        out[mode] = {"requests": len(bds), "steps": b.steps_run, "events": len(events),
                     "connected": connected, "prefilled_on_rank0": on_rank0,
                     "rank0_connected": rank0_connected, "segments_p50_p90_us": seg,
                     "ttft_p50_us": agg["ttft"]["p50"],
                     "untraced_ms_per_step": [ms[0], ms[2]], "traced_ms_per_step": ms[1],
                     "launches_rows_1_2_3": runs[1]["launches"],
                     "sync_wait_us": ledger.total_wait()}
        log(f"26.4 traced {mode}: {len(bds)} requests, {b.steps_run} steps, tokens, wire "
            f"counts and steps equal untraced and traced; segment_sum == ttft for every "
            f"request; {connected}/{len(bds)} DAGs connected, {on_rank0} requests prefilled "
            f"on rank 0 ({rank0_connected} of them connected); {len(events)} events; "
            f"segments p50/p90 us {seg}; ttft p50 {agg['ttft']['p50']:.0f} us; ms/step "
            f"untraced {ms[0]:.3f} and {ms[2]:.3f}, traced {ms[1]:.3f}; rows 1/2/3 launches "
            f"{runs[1]['launches']}; sync wait {ledger.total_wait()} us")
        del runs, a, b, tr, events, dags
        gc.collect()
        torch.cuda.empty_cache()
    return out


def conformance_suite_phase() -> dict:
    """26.5: the conformance suite on the card's host (no JAX there): every
    protocol at CONF_RANKS ranks, seeds CONF_SEEDS, under reorder, delay
    and duplicate, all passing; then `tear`, which must be caught."""
    from repro_torch.sim import conformance as conf

    t0 = time.perf_counter()
    res = conf.run_suite(list(conf.PROTOCOLS), CONF_RANKS, CONF_SCHEDULES, CONF_SEEDS)
    wall = time.perf_counter() - t0
    failed = [str(r["error"]) for r in res if not r["ok"]]
    if failed:
        raise AssertionError(f"conformance suite: {len(failed)} runs failed: {failed[0]}")
    t0 = time.perf_counter()
    tear = conf.run_suite(list(conf.PROTOCOLS), CONF_RANKS, ["tear"], [0])
    tear_wall = time.perf_counter() - t0
    caught = sorted(r["spec"].protocol for r in tear if not r["ok"])
    if not caught:
        raise AssertionError("conformance suite: tear was not caught")
    out = {"runs": len(res), "wall_s": wall, "events": sum(r["report"]["events"] for r in res),
           "tear_caught": caught, "tear_wall_s": tear_wall}
    log(f"26.5 conformance suite on the host: {len(res)} runs ({len(conf.PROTOCOLS)} protocols "
        f"x {len(CONF_SCHEDULES)} schedules x {len(CONF_SEEDS)} seeds at {CONF_RANKS} ranks) "
        f"passed in {wall:.2f} s, {out['events']} simulated events; tear caught on {caught} "
        f"in {tear_wall:.2f} s")
    return out


def conformance_phases(torch, disagg) -> dict:
    """Phase 26: the host protocol mirrors against the card, the card's
    plans through the race analysis, the full-width disaggregated run
    traced, and the conformance suite."""
    out = {"card": card_line()}
    t0 = time.perf_counter()
    import numpy as np

    out["queue"] = queue_mirror_phase(torch, np)
    out["row10_launches"] = out["queue"].pop("row10_launches")
    out["flow"] = flow_mirror_phase(torch, np)
    out["ir"] = plans_ir_phase(torch, np)
    out["traced"] = traced_serve_phase(torch, disagg)
    out["suite"] = conformance_suite_phase()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 26: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------ the tools (phase 27, PR 28)
def arms_ms(torch, arms: dict, reps: int = TOOLS_REPS) -> tuple[dict, dict]:
    """The median host ms of `reps` synchronised calls of each arm, after
    one warm-up call each; the arms take turns, so a drift of the host's
    speed reaches both alike.  Also each arm's spread: half its
    interquartile range over its median."""
    for fn in arms.values():
        fn()
    times = {k: [] for k in arms}
    for _ in range(reps):
        for k, fn in arms.items():
            times[k] += sync_ms(torch, fn, 1)
    med = {k: median(v) for k, v in times.items()}
    spread = {}
    for k, v in times.items():
        v = sorted(v)
        spread[k] = (v[3 * len(v) // 4] - v[len(v) // 4]) / 2 / med[k]
    return med, spread


def picked(model_pick: str, times: dict, spread: dict) -> dict:
    """The model's pick against both arms' times: met if it is the faster
    arm or within CHOICE_SLACK of it."""
    fast = min(times, key=times.get)
    ok = times[model_pick] <= (1 + CHOICE_SLACK) * times[fast]
    return {"model": model_pick, "faster": fast, **{f"{k}_ms": v for k, v in times.items()},
            "spread": spread, "met": ok}


def attend_block(torch, q, blk, scale: float):
    """The plain attention over a packed block of pages [m, k, pt, 2, hd]:
    the "gather" arm's second half."""
    m, k, pt, _, hd = blk.shape
    kk = blk[:, :, :, 0].reshape(m, k * pt, hd)
    vv = blk[:, :, :, 1].reshape(m, k * pt, hd)
    sc = torch.einsum("mqd,mkd->mqk", q, kk) * scale
    return torch.einsum("mqk,mkd->mqd", torch.softmax(sc, dim=-1), vv)


def flow_arms(torch, occupancy: float) -> dict:
    """Host ms per delivered message at the flow mirror's shape (p = 4, 2
    producers into rank 2's ring of 64 slots, one lane of 2 int32) with the
    ring held at `occupancy` by a consumer that drains each round exactly
    what the round admitted: every round each producer offers 32 messages.
    Retry: `rmaq.queue.enqueue` admits what fits and the host requeues the
    rest, as `serve.disagg._requeue_rejected` does (the rejections per
    admitted message are then f / (1 - f)).  Credit: `rmaq.flow.send` admits
    what the credits allow and `flow.recv` returns them."""
    from repro_torch.mesh import Mesh
    from repro_torch.rmaq import channel as rch
    from repro_torch.rmaq import flow as rfl
    from repro_torch.rmaq import queue as rq

    p, cap, k = 4, FLOW_MIRROR["capacity"], 32
    occ = round(occupancy * cap)
    occ += occ % 2                                     # an even share a producer
    free = cap - occ
    lanes = [rch.Lane("a", (2,), torch.int32)]
    mesh = Mesh(p, "serve", device="cuda")

    def offer(n):
        dest = torch.full((p, k), -1, dtype=torch.int64, device="cuda")
        dest[:2, :n] = 2
        tag = torch.arange(p * k, device="cuda").reshape(p, k)
        return torch.stack([tag, -tag], -1).to(torch.int32), tag, dest

    # retry: the plain channel, nothing to count credits
    channel, qs = rch.channel_allocate(mesh, cap, lanes)
    payload, tag, dest = offer(occ // 2)
    qs, _ = rq.enqueue(channel.desc, qs, channel.packed("a", payload, tag), dest)
    payload, tag, dest = offer(k)
    msgs = channel.packed("a", payload, tag)
    retry = {"qs": qs, "admitted": 0, "rejected": 0, "rounds": 0}

    def retry_round():
        s, rec = rq.enqueue(channel.desc, retry["qs"], msgs, dest)
        ok = int(rec.accepted.sum())
        s, _ = channel.recv(s, ok)
        retry.update(qs=s, admitted=retry["admitted"] + ok, rounds=retry["rounds"] + 1,
                     rejected=retry["rejected"] + 2 * k - ok)

    # credit: the flow channel at the same occupancy
    fchannel, fqs, fs = rfl.flow_allocate(mesh, cap, lanes, n_producers=2)
    fpayload, ftag, fdest = offer(occ // 2)
    fqs, fs, _ = rfl.send(fchannel, fqs, fs, "a", fpayload, ftag, fdest)
    fpayload, ftag, fdest = offer(k)
    credit = {"qs": fqs, "fs": fs, "admitted": 0, "rounds": 0}

    def credit_round():      # a round that admits nothing drains nothing
        s, f, rec = rfl.send(fchannel, credit["qs"], credit["fs"], "a", fpayload, ftag, fdest)
        if int(rec.rejected.sum()):
            raise AssertionError("flow credit arm: a credited send was rejected")
        ok = int(rec.accepted.sum())
        if ok:
            s, f, _ = rfl.recv(fchannel, s, f, ok)
        credit.update(qs=s, fs=f, admitted=credit["admitted"] + ok,
                      rounds=credit["rounds"] + 1)

    rounds, spread = arms_ms(torch, {"retry": retry_round, "credit": credit_round})
    if retry["admitted"] != free * retry["rounds"]:
        raise AssertionError(f"flow retry arm at occupancy {occ}/{cap}: {retry['admitted']} "
                             f"admitted in {retry['rounds']} rounds, want {free} a round")
    per = credit["admitted"] / credit["rounds"]
    return {"retry": rounds["retry"] / free, "credit": rounds["credit"] / per,
            "rejects_per_admit": retry["rejected"] / retry["admitted"],
            "occupancy": occ / cap, "free": free, "credit_admitted": per,
            "nbytes": 4 * channel.desc.item_shape[0], "retry_round_ms": rounds["retry"],
            "credit_round_ms": rounds["credit"], "spread": spread}


def host_us(fn, setup=None, n: int = 10_000) -> float:
    """Mean host µs of `fn` over n calls, `setup` (untimed) before each."""
    total = 0
    for _ in range(n):
        if setup is not None:
            setup()
        t0 = time.perf_counter_ns()
        fn()
        total += time.perf_counter_ns() - t0
    return total / n / 1e3


def model_choices_phase(torch, np) -> dict:
    """27.1: each of the four model choices PR 28 ports against both of
    its arms measured on the card (host ms of synchronised calls, the median
    of TOOLS_REPS after a warm-up), and the host's lock and flush beside
    their prices."""
    from repro_torch.core import epoch
    from repro_torch.core.locks_sim import LockOrigin, LockWindow
    from repro_torch.core.perfmodel import DEFAULT_MODEL as pm
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.mesh import Mesh

    g = torch.Generator(device="cuda").manual_seed(TOOLS_SEED)
    out = {"put": {}, "attend": {}, "accumulate": {}, "flow": {}}
    # put: kernel row 4 against Mesh.shift
    mesh = Mesh(PUT_P, "x", device="cuda")
    lat = torch.randn((MILC_P,) + MILC_LOCAL, generator=g, device="cuda")
    halo_mesh = Mesh(lat.shape[0], "t", device="cuda")
    cases = {f"{n >> 10} KiB": (torch.randn(PUT_P, n // 4 // PUT_P, generator=g,
                                            device="cuda"), mesh) for n in PUT_BYTES}
    cases["MILC halo view"] = (lat.narrow(1, 0, 1), halo_mesh)
    for name, (x, m) in cases.items():
        if not torch.equal(rma_ops.put_shift(x, 1, m), m.shift(x, 1)):
            raise AssertionError(f"27.1 put {name}: row 4 and Mesh.shift differ")
        times, spread = arms_ms(torch, {"cuda": lambda: rma_ops.put_shift(x, 1, m),
                                        "torch": lambda: m.shift(x, 1)})
        out["put"][name] = {"nbytes": x.nbytes,
                            **picked(pm.select_put_backend(x.nbytes), times, spread)}
    del lat, cases
    # paged attention: row 1 against row 3 + the plain attention over the block
    for name, (pt, hd, n_pages) in ATTEND_PAGES.items():
        pool = torch.randn(n_pages, pt, 2, hd, generator=g, device="cuda")
        ids = torch.randperm(n_pages, generator=g, device="cuda")[:ATTEND_K].to(torch.int32)[None]
        q = torch.randn(1, 1, hd, generator=g, device="cuda")
        one = Mesh(1, "serve", device="cuda")
        scale = hd ** -0.5

        def gather_attend():
            blk = pg_ops.paged_gather(pool[None], ids, 0, one)
            return attend_block(torch, q, blk[0][None], scale)

        err = float((pa_ops.paged_attention(q, pool, ids) - gather_attend()).abs().max())
        if err > TOL:
            raise AssertionError(f"27.1 attend {name}: the two arms differ by {err}")
        times, spread = arms_ms(torch, {"fused": lambda: pa_ops.paged_attention(q, pool, ids),
                                        "gather": gather_attend})
        page_bytes = pt * 2 * hd * 4
        out["attend"][name] = {"page_bytes": page_bytes, "pages": ATTEND_K, "max_abs_err": err,
                               **picked(pm.select_paged_attend(ATTEND_K, page_bytes), times,
                                        spread)}
        del pool
    # accumulate: row 6 against lock, get, add, put, unlock
    lock = LockOrigin(LockWindow(p=1), rank=0)
    for n in ACC_BYTES:
        x = torch.randn(PUT_P, n // 4 // PUT_P, generator=g, device="cuda")
        acc = torch.randn(PUT_P, n // 4 // PUT_P, generator=g, device="cuda")

        def fallback():
            lock.lock_exclusive(0)
            try:
                return rma_ops.put_shift(rma_ops.get_shift(acc, 1, mesh) + x, 1, mesh)
            finally:
                lock.unlock_exclusive(0)

        if not torch.equal(rma_ops.accumulate_shift(x, acc, 1, mesh), fallback()):
            raise AssertionError(f"27.1 accumulate at {n} B: the two arms differ")
        times, spread = arms_ms(torch, {
            "slotted": lambda: rma_ops.accumulate_shift(x, acc, 1, mesh),
            "fetch_modify_writeback": fallback})
        out["accumulate"][f"{n >> 10} KiB"] = {"nbytes": n, **picked(
            pm.select_accumulate_mode(n, 2), times, spread)}
    # flow control at the flow mirror's shape
    for f in FLOW_OCCUPANCY:
        arms = flow_arms(torch, f)
        times = {"credit": arms.pop("credit"), "retry": arms.pop("retry")}
        spread = arms.pop("spread")
        out["flow"][f"{f:.1f}"] = {**arms, **picked(pm.select_flow_control(
            arms["nbytes"], arms["occupancy"], round(arms["credit_admitted"])), times, spread)}
    # the host's exclusive lock and flush beside their prices
    win = LockWindow(p=1)
    origin = LockOrigin(win, rank=0)
    held = []

    def release():
        if held:
            origin.unlock_exclusive(0)
            held.clear()

    lock_us = host_us(lambda: (origin.lock_exclusive(0), held.append(1)), setup=release)
    release()
    t = torch.zeros(4, device="cuda")
    flush_us = host_us(lambda: epoch.flush(t))
    out["lock_excl_us"] = {"measured": lock_us, "price": pm.p_lock_excl() * 1e6}
    out["flush_us"] = {"measured": flush_us, "price": pm.p_flush() * 1e6}
    for kind in ("put", "attend", "accumulate", "flow"):
        for name, r in out[kind].items():
            arms = ", ".join(f"{k[:-3]} {v:.4f} ms ±{r['spread'][k[:-3]]:.1%}"
                             for k, v in r.items()
                             if k.endswith("_ms") and not k.endswith("round_ms"))
            log(f"27.1 {kind} at {name}: model {r['model']}, measured faster {r['faster']} "
                f"({arms}) -> {'met' if r['met'] else 'MISSED'}"
                + (f"; rejects per admitted {r['rejects_per_admit']:.3f}, credit admits "
                   f"{r['credit_admitted']:.2f} a round; a round: retry "
                   f"{r['retry_round_ms']:.4f} ms, credit {r['credit_round_ms']:.4f} ms"
                   if kind == "flow" else ""))
    log(f"27.1 p_lock_excl: measured {lock_us:.3f} us, priced {pm.p_lock_excl() * 1e6:.3f} "
        f"us; p_flush: measured {flush_us:.3f} us, priced {pm.p_flush() * 1e6:.3f} us "
        f"({card_line()})")
    missed = [(k, n) for k in ("put", "attend", "accumulate", "flow")
              for n, r in out[k].items() if not r["met"]]
    out["missed"] = missed
    return out


def counter_phase(torch, np) -> dict:
    """27.2: `launch.hlo_cost.analyze` over SmolLM-360M's T1 step ([4, 2048],
    remat, bf16, AdamW) on the card, once under backend "cuda" and once
    under "torch": equal non-attention product FLOPs; attention's products
    16·B·H·S²·hd a layer under both ("torch" folds every block, the masked
    half included, in the forward, remat's second forward and the backward's
    two products each; "cuda": the flash kernel's causal half twice, then
    its backward recomputes and differentiates the plain full attention);
    the totals within STEP_FACTOR of 6·N·tokens; the footprint mem_out +
    mem_temp over the memory allocated before the call within MEM_REL of
    `torch.cuda.max_memory_allocated`; the roofline terms beside the
    measured step."""
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100, roofline_terms
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import hlo_cost
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, make_train_step

    model = build_model(get_config(MODEL_ARCH))
    cfg = model.cfg
    B, S = TRAIN_BATCH
    params = model.init(TRAIN_SEED, device="cuda")
    opt = init_opt_state(params)
    batch = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, S, B), device="cuda").batch_at(0)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), StepConfig(remat=True))
    n, tokens = model.param_count(), B * S
    attn = 16.0 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers
    out = {"n_params": n, "tokens": tokens, "six_n_tokens": 6.0 * n * tokens,
           "attention_want": attn}
    for backend in ("cuda", "torch"):
        L.set_attention_backend(backend)
        try:
            step(params, opt, batch)                       # builds, warms the allocator
            times = sync_ms(torch, lambda: step(params, opt, batch), 3)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fops.launches = 0
            s = hlo_cost.analyze(step, params, opt, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            L.set_attention_backend("torch")
        predicted = base + s.mem_out + s.mem_temp
        terms = roofline_terms(s.flops, s.hbm_bytes, s.collective_bytes, chips=1)
        step_ms = median(times)
        bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
        out[backend] = {
            "flops": s.flops, "hbm_bytes": s.hbm_bytes, "product_flops": s.product_flops,
            "non_attention_products": s.product_flops_by_scope.get("", 0.0),
            "attention_products": s.product_flops_by_scope.get("attention", 0.0),
            "kernel_flops": dict(s.kernel_flops), "flash_launches": fops.launches,
            "ops": s.n_ops, "mem_args": s.mem_args, "mem_out": s.mem_out, "mem_temp": s.mem_temp,
            "allocated_before": base, "predicted_peak": predicted, "max_memory_allocated": peak,
            "step_ms": step_ms, **{k: terms[k] for k in ("compute_s", "memory_s", "dominant",
                                                         "roofline_fraction")},
            "roofline_share": bound / (step_ms / 1e3)}
        r = out[backend]
        log(f"27.2 counter over T1's step, backend {backend} ({card_line()}): {s.n_ops} ops, "
            f"{s.flops / 1e12:.3f} TFLOP ({s.flops / out['six_n_tokens']:.3f} x 6*N*tokens), "
            f"products {s.product_flops / 1e12:.3f} (non-attention "
            f"{r['non_attention_products'] / 1e12:.4f}, attention "
            f"{r['attention_products'] / 1e12:.4f}, want {attn / 1e12:.4f}), kernels "
            f"{ {k: v / 1e12 for k, v in s.kernel_flops.items()} } TFLOP, "
            f"{s.hbm_bytes / 1e12:.3f} TB; memory args {s.mem_args / 2**30:.3f} + out "
            f"{s.mem_out / 2**30:.3f} + temp {s.mem_temp / 2**30:.3f} GiB, predicted peak "
            f"{predicted / 2**30:.3f} GiB vs max_memory_allocated {peak / 2**30:.3f} GiB; "
            f"roofline compute {terms['compute_s'] * 1e3:.1f} ms, memory "
            f"{terms['memory_s'] * 1e3:.1f} ms ({terms['dominant']}), step {step_ms:.1f} ms "
            f"(median of 3): {r['roofline_share']:.1%} of the roofline")
        if abs(r["attention_products"] - attn) > 1e-9 * attn:
            raise AssertionError(f"27.2 {backend}: attention products "
                                 f"{r['attention_products']:.6e}, want {attn:.6e}")
        if not STEP_FACTOR[0] <= s.flops / out["six_n_tokens"] <= STEP_FACTOR[1]:
            raise AssertionError(f"27.2 {backend}: {s.flops / out['six_n_tokens']:.3f} x "
                                 f"6*N*tokens, outside {STEP_FACTOR}")
        if abs(predicted - peak) > MEM_REL * peak:
            raise AssertionError(f"27.2 {backend}: predicted peak {predicted} vs "
                                 f"max_memory_allocated {peak}, beyond {MEM_REL:.0%}")
    if out["cuda"]["non_attention_products"] != out["torch"]["non_attention_products"]:
        raise AssertionError(f"27.2: non-attention products differ, cuda "
                             f"{out['cuda']['non_attention_products']} vs torch "
                             f"{out['torch']['non_attention_products']}")
    if out["cuda"]["flash_launches"] != 2 * cfg.n_layers or "flash_attention" not in \
            out["cuda"]["kernel_flops"]:
        raise AssertionError(f"27.2: the counted cuda step launched the flash kernel "
                             f"{out['cuda']['flash_launches']} times")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_phase() -> dict:
    """27.3: `launch.dryrun --mesh card` over every (arch x shape) cell on
    meta tensors in parallel processes, every applicable cell "ok"; then
    `launch.roofline`'s table of them."""
    import tempfile

    from repro_torch.configs import get_config, shape_applicable
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        recs = dryrun.main(["--mesh", "card", "--out", d, "--jobs", str(DRY_JOBS)])
        rows = roofline.main(["--dir", d])
    bad = [r for r in recs
           if r["status"] != ("ok" if shape_applicable(get_config(r["arch"]),
                                                       SHAPES[r["shape"]])[0] else "skipped")]
    if bad:
        raise AssertionError(
            f"27.3 dry-run: {[(r['arch'], r['shape'], r['status']) for r in bad]}")
    ok = [r for r in recs if r["status"] == "ok"]
    out = {"cells": len(recs), "ok": len(ok), "fits": sum(r["fits"] for r in ok),
           "rows": len(rows) - 1, "wall_s": time.perf_counter() - t0}
    log(f"27.3 dry-run --mesh card: {out['ok']} of {out['cells']} cells ok, the rest skipped "
        f"as the reference skips them; {out['fits']} fit the card's {80} GB; "
        f"{out['wall_s']:.1f} s with {DRY_JOBS} processes")
    return out


def drivers_phase(torch) -> dict:
    """27.4: the five example drivers at the reference's sizes on the card;
    each raises unless its own checks hold, and nothing here catches that.
    Kernel launches are counted from 0 over the five runs: row 1 (the
    paged fused decode) and row 4 (the plans' puts) must be among them."""
    from repro_torch.examples import disagg_serve, fft3d, hashtable_kv, milc_stencil, moe_dsde
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.rma import ops as rma_ops

    pa_ops.launches = pa_ops.shift_launches = pg_ops.launches = 0
    zero_rma_launches(rma_ops)
    out = {}
    for mod in (disagg_serve, hashtable_kv, milc_stencil, moe_dsde, fft3d):
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        out[name] = mod.main(["--device", "cuda"])
        out[name + "_s"] = time.perf_counter() - t0
    out["launches"] = {"paged_attention": pa_ops.launches,
                       "paged_attention_shift": pa_ops.shift_launches,
                       "paged_gather": pg_ops.launches, **rma_ops.launches}
    if not (pa_ops.launches and rma_ops.launches["put_shift"]):
        raise AssertionError(f"27.4: the drivers did not go through rows 1 and 4: "
                             f"{out['launches']}")
    log(f"27.4 drivers on the card: disagg_serve {out['disagg_serve']}, hashtable_kv "
        f"{out['hashtable_kv']}, milc_stencil {out['milc_stencil']}, moe_dsde "
        f"{out['moe_dsde']}, fft3d {out['fft3d']}; launches {out['launches']}")
    return out


def tools_phases(torch) -> dict:
    """Phase 27: 27.1-27.4."""
    import numpy as np

    t0 = time.perf_counter()
    out = {"choices": model_choices_phase(torch, np)}
    torch.cuda.empty_cache()
    out["counter"] = counter_phase(torch, np)
    out["dryrun"] = dryrun_phase()
    out["drivers"] = drivers_phase(torch)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 27: {out['wall_s']:.1f} s")
    if out["choices"]["missed"]:
        raise AssertionError(f"27.1: the model's pick is neither the faster arm nor within "
                             f"{CHOICE_SLACK:.0%} of it at {out['choices']['missed']}")
    return out


# ------------------------------------------------- one rank a process (28)
def digest(torch, t) -> str:
    """A block's bits, hashed on the host: bit-equality across processes."""
    import hashlib

    flat = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.blake2b(flat, digest_size=16).hexdigest()


def host_ms(torch, mesh, fn, reps: int) -> float:
    """Host ms a call of a collective `fn`, every rank in step: a barrier
    before, the stream drained after."""
    fn()
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def proc_milc(torch, mesh, rma_ops, epoch_mod, milc, OpCounter) -> dict:
    """28.1 in one rank: MILC's 64³ x 96 lattice along T, this rank's
    [1, 24, 64, 64, 64, 6] block (the stacked run's row, from the same
    seed), 5 steps as a user calls them, each step checked and hashed."""
    r, p, dev = mesh.rank, mesh.p, mesh.device
    g = torch.Generator(device=dev).manual_seed(PROC_SEED)
    full = torch.randn((p,) + PROC_LOCAL, device=dev, generator=g)
    lat = full[r:r + 1].clone()
    del full
    torch.cuda.empty_cache()
    v, steps = lat, []
    zero_rma_launches(rma_ops)
    for step in range(MILC_STEPS):
        before = dict(rma_ops.launches)
        held = mesh.barriers, mesh.tokens
        with OpCounter() as c, opened_epochs(epoch_mod) as eps:
            out = milc.stencil_step(v, mesh)
        torch.cuda.synchronize()
        got = {k: rma_ops.launches[k] - before[k] for k in before}
        counts = (c.puts, c.raw_msgs, c.coalesced_msgs)
        sync = [(ep.stats.post_msgs, ep.stats.complete_msgs) for ep in eps]
        held = (mesh.barriers - held[0], mesh.tokens - held[1])
        if got != {"put_shift": 2, "get_shift": 0, "accumulate_shift": 0,
                   "ring_all_gather": 0} or counts != (2, 2, 2) or sync != [(2, 2)] \
                or held != (0, 4):
            raise AssertionError(f"28.1 rank {r} step {step}: launches {got}, puts/raw/coalesced "
                                 f"{counts}, PSCW post/complete {sync}, host barriers/tokens "
                                 f"{held}; want 2 put_shift, (2, 2, 2), [(2, 2)], (0, 4)")
        if not torch.isfinite(out).all():
            raise AssertionError(f"28.1 rank {r} step {step}: non-finite output")
        steps.append(digest(torch, out))
        v = out * 0.0625                     # keep magnitudes O(1); exact in f32
    launches = dict(rma_ops.launches)
    ms = host_ms(torch, mesh, lambda: milc.stencil_step(lat, mesh), MILC_STEPS)
    return {"digests": steps, "launches": launches, "ms_per_step": ms, "lat": lat}


def proc_all_reduce(torch, mesh, rma_ops, collectives) -> dict:
    """28.2 in one rank: this rank's 25 MiB f32 row of the stacked run's
    [4, 25 MiB] (the same seed) through `core.collectives.all_reduce`."""
    r, p, dev = mesh.rank, mesh.p, mesh.device
    n = AR_MIB * 2**20 // 4
    g = torch.Generator(device=dev).manual_seed(PROC_SEED + 1)
    x = torch.randn(p, n, device=dev, generator=g)
    want = x.sum(0)
    xr = x[r:r + 1].clone()
    del x
    zero_rma_launches(rma_ops)
    out = collectives.all_reduce(xr, mesh)
    torch.cuda.synchronize()
    launches = dict(rma_ops.launches)
    expected = (p - 1) + 2 * -(-(p - 1) // 2)
    rel = float((out[0] - want).abs().max() / want.abs().max())
    if not torch.isfinite(out).all() or rel > AR_TOL or launches["put_shift"] != expected:
        raise AssertionError(f"28.2 rank {r}: rel err {rel} (tol {AR_TOL}), put_shift launches "
                             f"{launches['put_shift']} (want {expected})")
    ms = host_ms(torch, mesh, lambda: collectives.all_reduce(xr, mesh), 3)
    return {"digest": digest(torch, out), "launches": launches, "rel": rel, "ms": ms,
            "expected": expected, "x": xr}


def proc_ops(torch, mesh, rma_ops, collectives, lat, xr) -> dict:
    """28.3 in one rank: the peer forms through `kernels.rma.ops` on the
    same data, each against the schedule's own result."""
    p = mesh.p
    want = collectives.halo_exchange_1d(lat, 1, mesh, dim=0)
    shard = xr.reshape(1, p, -1)[:, 0].contiguous()
    zero_rma_launches(rma_ops)
    lo = rma_ops.get_shift(lat[:, :1], +1, mesh)        # the right neighbour's low slice
    hi = rma_ops.get_shift(lat[:, -1:], -1, mesh)       # the left neighbour's high slice
    acc = rma_ops.accumulate_shift(lat[:, -1:], lat[:, :1], +1, mesh)
    gathered = rma_ops.ring_all_gather(shard, mesh)
    torch.cuda.synchronize()
    launches = dict(rma_ops.launches)
    if not (torch.equal(hi, want[:, :1]) and torch.equal(lo, want[:, -1:])):
        raise AssertionError(f"28.3 rank {mesh.rank}: the get-based halo pull differs "
                             "from the put-based exchange")
    if not torch.equal(acc, lat[:, :1] + want[:, :1]):
        raise AssertionError(f"28.3 rank {mesh.rank}: accumulate_shift differs from the "
                             "boundary sum")
    if not torch.equal(gathered, collectives.ring_all_gather(shard, mesh)):
        raise AssertionError(f"28.3 rank {mesh.rank}: the peer all-gather differs from "
                             "the ring schedule")
    if min(launches[k] for k in ("get_shift", "accumulate_shift", "ring_all_gather")) == 0:
        raise AssertionError(f"28.3 rank {mesh.rank}: ops path {launches}")
    return {"launches": launches}


def check_peer(torch, mesh, rma_ops, ref) -> dict:
    """28.4: each peer kernel against its plain version, bit for bit, at
    the halo and all-reduce chunk shapes and at the edge cases (shift 0,
    -1, >= p; 21-word rows; int32; a rank block that is not contiguous);
    returns each op's max abs error (0.0 when bit-equal)."""
    dev, p = mesh.device, mesh.p
    g = torch.Generator(device=dev).manual_seed(PROC_SEED + 2 + mesh.rank)
    halo = torch.randn((1, 1) + PROC_LOCAL[1:], device=dev, generator=g)
    chunk = torch.randn(1, AR_MIB * 2**20 // 4 // p, device=dev, generator=g)
    odd = torch.randn(1, 3, 7, device=dev, generator=g)
    ints = torch.randint(-2**31, 2**31 - 1, (1, 8), device=dev, generator=g, dtype=torch.int32)
    inner = torch.randn(1, 4, 8, device=dev, generator=g)[:, :, :3]
    errs = dict.fromkeys(rma_ops.launches, 0.0)

    def compare(name, got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} (peer) differs from its plain version at {what}, "
                                 f"rank {mesh.rank}")
        errs[name] = max(errs[name], float((got.double() - want.double()).abs().max()))

    for x, shifts in ((halo, (1, -1)), (chunk, (1, -1, 0, p + 3)),
                      (odd, (0, 1, -1, 7, -12)), (ints, (2, -1)), (inner, (1, -2))):
        for s in shifts:
            what = f"{tuple(x.shape)} {x.dtype} shift {s}"
            compare("put_shift", rma_ops.put_shift(x, s, mesh), ref.put_shift_ref(x, s, mesh), what)
            compare("get_shift", rma_ops.get_shift(x, s, mesh), ref.get_shift_ref(x, s, mesh), what)
            if x.dtype == torch.float32:
                acc = torch.randn(x.shape, device=dev, generator=g)
                compare("accumulate_shift", rma_ops.accumulate_shift(x, acc, s, mesh),
                        ref.accumulate_shift_ref(x, acc, s, mesh), what)
        compare("ring_all_gather", rma_ops.ring_all_gather(x, mesh),
                ref.ring_all_gather_ref(x, mesh), f"{tuple(x.shape)} {x.dtype}")
    torch.cuda.synchronize()
    return errs


def time_peer(torch, mesh, rma_ops, Mesh, lat, xr, hbm: float) -> dict:
    """28.5: each peer kernel alone (its launches, no fence; CUDA events
    over 50 calls), its plain copy, the stacked kernel of rows 4-7 on the
    same bytes and the bytes bound, timed by one rank while the others
    wait at a barrier (ranks take turns); then each whole op (kernel,
    fence, copy-out) with every rank in step, by host clock.  The put's
    and the get's plain copies are one PyTorch call each (``copy_`` into
    the peer's mapped block, ``clone`` of it), so their time is also the
    row's library time; the accumulate (a copy and an add) and the
    gather (p - 1 copies) have no one call."""
    from repro_torch.kernels import common
    from repro_torch.procmesh import as_bytes

    p, r = mesh.p, mesh.rank
    halo, low = lat[:, -1:].contiguous(), lat[:, :1].contiguous()
    shard = xr.reshape(1, p, -1)[:, 0].contiguous()
    hb, sb = halo.nbytes, shard.nbytes
    seg, off = mesh.round(p * max(hb, sb))       # a slot every rank has mapped
    table, stream = seg.table_ptr, common.current_stream(mesh.device.index)
    right, words, swords = (r + 1) % p, halo.numel(), shard.numel()
    stacked = Mesh(p, "t", device=mesh.device)
    hstk, sstk = halo.reshape(p, -1), shard.reshape(p, -1)
    slot = seg.view(r, off, hb).view(torch.float32).reshape(halo.shape)

    def hops(x, n):
        for hop in range(p - 1):
            rma_ops._PEER_HOP(x.data_ptr(), table, p, r, hop, off, n, stream)

    def plain_hops(x, nb):
        src = as_bytes(x)
        for hop in range(p - 1):
            b = (r - hop) % p
            if hop:
                src = seg.view(r, off + b * nb, nb)
            seg.view(right, off + b * nb, nb).copy_(src)

    out_h = torch.empty_like(halo)
    hbytes = as_bytes(halo)
    rows = {   # name -> (kernel's launches, plain copy, stacked kernel, bound bytes)
        "put_shift": (
            lambda: rma_ops._PEER_PUT(halo.data_ptr(), table, p, r, 1, off, words, stream),
            lambda: seg.view(right, off, hb).copy_(hbytes),
            lambda: rma_ops.put_shift(hstk, 1, stacked), 2 * hb),
        "get_shift": (
            lambda: rma_ops._PEER_GET(out_h.data_ptr(), table, p, r, 1, off, words, stream),
            lambda: seg.view(right, off, hb).clone(),
            lambda: rma_ops.get_shift(hstk, 1, stacked), 2 * hb),
        "accumulate_shift": (
            lambda: (rma_ops._PEER_PUT(halo.data_ptr(), table, p, r, 1, off, words, stream),
                     rma_ops._PEER_ACC(low.data_ptr(), table, out_h.data_ptr(), r, off, words,
                                       stream)),
            lambda: (seg.view(right, off, hb).copy_(as_bytes(halo)), low + slot),
            lambda: rma_ops.accumulate_shift(hstk, low.reshape(p, -1), 1, stacked), 3 * hb),
        "ring_all_gather": (
            lambda: hops(shard, swords), lambda: plain_hops(shard, sb),
            lambda: rma_ops.ring_all_gather(sstk, stacked), (1 + p) * sb),
    }
    out = {}
    for turn in range(p):
        mesh.barrier()
        if turn == r:
            for name, (kern, plain, stk, nbytes) in rows.items():
                plain_ms = time_ms(plain)
                out[name] = {"ms": time_ms(kern), "plain_ms": plain_ms,
                             "library_ms": plain_ms if name in ("put_shift", "get_shift")
                             else None,
                             "stacked_ms": time_ms(stk), "bound_ms": nbytes / hbm * 1e3,
                             "bytes": nbytes}
        torch.cuda.synchronize()
    mesh.fence()
    ops_ms = {
        "put_shift": host_ms(torch, mesh, lambda: rma_ops.put_shift(halo, 1, mesh), 10),
        "get_shift": host_ms(torch, mesh, lambda: rma_ops.get_shift(halo, 1, mesh), 10),
        "accumulate_shift": host_ms(torch, mesh, lambda: rma_ops.accumulate_shift(
            halo, low, 1, mesh), 10),
        "ring_all_gather": host_ms(torch, mesh, lambda: rma_ops.ring_all_gather(shard, mesh), 10),
    }
    for name, ms in ops_ms.items():
        out[name]["op_ms"] = ms
    return out


def time_epochs(torch, mesh, epoch_mod) -> dict:
    """28.6: what synchronisation costs on its own (host ms, every rank in
    step): the stream drain, a barrier of the bootstrap, a fence epoch
    (open + close), a PSCW epoch with MILC's k = 2 (post, start,
    complete, wait)."""
    def fence():
        ep = epoch_mod.FenceEpoch(mesh)
        ep.close(ep.open(None))

    def pscw():
        ep = epoch_mod.PSCWEpoch(mesh, [0, 1])
        ep.wait(ep.complete(ep.start(ep.post(None))))

    return {"stream_drain_ms": host_ms(torch, mesh, mesh.flush, 50),
            "barrier_ms": host_ms(torch, mesh, mesh.barrier, 50),
            "fence_epoch_ms": host_ms(torch, mesh, fence, 20),
            "pscw_epoch_ms": host_ms(torch, mesh, pscw, 20)}


def proc_rank(mesh, hbm: float) -> dict:
    """Phase 28 in one rank's process: 28.1-28.6; raises on any failure."""
    import torch

    from repro_torch.apps import milc
    from repro_torch.core import collectives
    from repro_torch.core import epoch as epoch_mod
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref
    from repro_torch.mesh import Mesh

    t0 = time.perf_counter()
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    m = proc_milc(torch, mesh, rma_ops, epoch_mod, milc, OpCounter)
    a = proc_all_reduce(torch, mesh, rma_ops, collectives)
    o = proc_ops(torch, mesh, rma_ops, collectives, m["lat"], a["x"])
    out["main_path"] = {k: m["launches"][k] + a["launches"][k] + o["launches"][k]
                        for k in rma_ops.launches}
    out["used_bytes"] = torch.cuda.mem_get_info(mesh.device)
    out["peak_allocated"] = torch.cuda.max_memory_allocated(mesh.device)
    out["errs"] = check_peer(torch, mesh, rma_ops, ref)
    out["times"] = time_peer(torch, mesh, rma_ops, Mesh, m.pop("lat"), a.pop("x"), hbm)
    out["epochs"] = time_epochs(torch, mesh, epoch_mod)
    out.update(milc=m, all_reduce=a, wall_s=time.perf_counter() - t0)
    return out


def procs_phases(torch, hbm: float) -> tuple:
    """Phase 28: the one-sided layer with one rank a process, 4 processes
    on the card (the rows of kernels 4-7's peer forms, and its numbers)."""
    from repro_torch import procmesh
    from repro_torch.apps import milc
    from repro_torch.core import collectives
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref
    from repro_torch.mesh import Mesh

    t0 = time.perf_counter()
    p = PROC_P
    log(f"phase 28: {p} processes time-sharing one card ({card_line()}); no link is "
        "crossed, so no time here is an NVLink time")
    # the stacked Mesh(4) run of the same data, in this process
    mesh = Mesh(p, "t", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(PROC_SEED)
    v = torch.randn((p,) + PROC_LOCAL, device="cuda", generator=g)
    lat0, digests, err = v, [], 0.0
    for step in range(MILC_STEPS):
        out = milc.stencil_step(v, mesh)
        e = float((out - milc.stencil_reference(v)).abs().max())
        if not torch.isfinite(out).all() or e > MILC_TOL:
            raise AssertionError(f"28.1 stacked step {step}: max abs err {e} > {MILC_TOL}")
        err = max(err, e)
        digests.append([digest(torch, out[r]) for r in range(p)])
        v = out * 0.0625
    stacked_ms = time_steps(torch, milc, mesh, lat0)
    del v, out, lat0
    n = AR_MIB * 2**20 // 4
    g = torch.Generator(device="cuda").manual_seed(PROC_SEED + 1)
    x = torch.randn(p, n, device="cuda", generator=g)
    ar = collectives.all_reduce(x, mesh)
    ar_rows = {digest(torch, ar[r]) for r in range(p)}
    t1 = time.perf_counter()
    collectives.all_reduce(x, mesh)
    torch.cuda.synchronize()
    ar_stacked_ms = (time.perf_counter() - t1) * 1e3
    if len(ar_rows) != 1:
        raise AssertionError("28.2 stacked: the ranks' all-reduce rows differ")
    del x, ar
    torch.cuda.empty_cache()
    log(f"28 stacked Mesh({p}): MILC {PROC_LOCAL} a rank, {MILC_STEPS} steps, max abs err "
        f"{err:.3g} vs stencil_reference (tol {MILC_TOL}), {stacked_ms:.3f} ms/step; "
        f"all-reduce {p} x {AR_MIB} MiB {ar_stacked_ms:.3f} ms")

    t1 = time.perf_counter()
    ranks = procmesh.run(proc_rank, p, device="cuda", args=(hbm,), axis="t",
                         timeout=PROC_TIMEOUT)
    run_s = time.perf_counter() - t1
    for r, res in enumerate(ranks):
        got = res["milc"]["digests"]
        if got != [d[r] for d in digests]:
            bad = [s for s in range(MILC_STEPS) if got[s] != digests[s][r]]
            raise AssertionError(f"28.1 rank {r}: steps {bad} differ from the stacked run's row")
        if {res["all_reduce"]["digest"]} != ar_rows:
            raise AssertionError(f"28.2 rank {r}: the all-reduce differs from the stacked run")
    ms_steps = [res["milc"]["ms_per_step"] for res in ranks]
    log(f"28.1 MILC over {p} processes: every rank's {MILC_STEPS} steps bit-equal to its row "
        f"of the stacked run (so within {MILC_TOL} of stencil_reference: {err:.3g}); 2 peer "
        f"put_shift launches a step a rank, OpCounter 2/2/2 and SyncStats post/complete 2/2 "
        f"a step, and a step's synchronisation its PSCW epoch's alone: 4 tokens sent a rank "
        f"(post and complete to the 2 T neighbours), no host barrier; ms/step by rank {[round(x, 3) for x in ms_steps]} beside the stacked "
        f"{stacked_ms:.3f}")
    a = ranks[0]["all_reduce"]
    log(f"28.2 all-reduce {p} x {AR_MIB} MiB: rel err {max(x['all_reduce']['rel'] for x in ranks):.3g} "
        f"(tol {AR_TOL}), bit-equal to the stacked run, {a['expected']} peer put_shift "
        f"launches a rank; ms by rank {[round(x['all_reduce']['ms'], 3) for x in ranks]} "
        f"beside the stacked {ar_stacked_ms:.3f}")
    log(f"28.3 ops surface by rank: {[x['main_path'] for x in ranks]} (main path: 28.1-28.3)")

    # p = 1: a one-rank mesh in this process
    solo = procmesh.ProcMesh(1, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(PROC_SEED + 9)
    errs1 = dict.fromkeys(rma_ops.launches, 0.0)
    for xs in (torch.randn(1, 3, 7, device="cuda", generator=g),
               torch.randn(1, 64, device="cuda", generator=g)):
        for s in (0, 1, -1):
            for name, got, want in (
                    ("put_shift", rma_ops.put_shift(xs, s, solo), ref.put_shift_ref(xs, s, solo)),
                    ("get_shift", rma_ops.get_shift(xs, s, solo), ref.get_shift_ref(xs, s, solo)),
                    ("accumulate_shift", rma_ops.accumulate_shift(xs, xs, s, solo),
                     ref.accumulate_shift_ref(xs, xs, s, solo))):
                if not (torch.equal(got, want) and torch.equal(got, xs * (2 if "acc" in name else 1))):
                    raise AssertionError(f"28.4 p = 1: {name} shift {s} differs from plain")
        if not torch.equal(rma_ops.ring_all_gather(xs, solo), ref.ring_all_gather_ref(xs, solo)):
            raise AssertionError("28.4 p = 1: ring_all_gather differs from plain")
    solo.close()
    errs = {k: max([res["errs"][k] for res in ranks] + [errs1[k]]) for k in errs1}
    log(f"28.4 peer kernels vs plain: bit-equal at the halo {PROC_LOCAL[1:]} and chunk shapes, "
        f"shifts 0, -1, >= p, p = 1, 21-word rows, int32, a non-contiguous block; max abs "
        f"err {errs}")
    times = ranks[0]["times"]
    for name, t in times.items():
        lib = "one PyTorch call, so also the library time" if t["library_ms"] is not None \
            else "no one PyTorch call computes it"
        log(f"28.5 {name} (peer, rank 0 alone): kernel {t['ms'] * 1e3:.1f} us, plain copy "
            f"{t['plain_ms'] * 1e3:.1f} us ({lib}), stacked rma.cu kernel on the same bytes "
            f"{t['stacked_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.1f} us (bytes "
            f"{t['bytes']}); the whole op (kernel, fence, copy-out, {p} ranks in step) "
            f"{t['op_ms']:.3f} ms; by rank: kernel "
            f"{[round(x['times'][name]['ms'] * 1e3, 1) for x in ranks]} us")
    ep = {k: max(x["epochs"][k] for x in ranks) for k in ranks[0]["epochs"]}
    used = max(x["used_bytes"][1] - x["used_bytes"][0] for x in ranks)
    log(f"28.6 synchronisation on its own (host ms, slowest rank): {json.dumps(ep)}; device "
        f"memory in use at the end of the main path {used / 2**30:.2f} GiB (all {p} "
        f"contexts), torch peak a rank {max(x['peak_allocated'] for x in ranks) / 2**20:.0f} MiB; "
        f"ranks' run {run_s:.1f} s, phase {time.perf_counter() - t0:.1f} s")
    rows = []
    for name in ("put_shift", "get_shift", "accumulate_shift", "ring_all_gather"):
        peer = f"{name}_peer"
        t = times[name]
        rows.append({"name": peer, "route": KERNELS[peer][0], "source": KERNELS[peer][1],
                     "replaces": KERNELS[peer][2],
                     "launches": sum(x["main_path"][name] for x in ranks),
                     "launches_per_rank": [x["main_path"][name] for x in ranks],
                     "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["library_ms"],
                     "stacked_ms": t["stacked_ms"], "op_ms": t["op_ms"]})
    numbers = {"milc_ms_per_step": ms_steps, "milc_stacked_ms": stacked_ms,
               "all_reduce_ms": [x["all_reduce"]["ms"] for x in ranks],
               "all_reduce_stacked_ms": ar_stacked_ms, "epochs": ep, "used_bytes": used,
               "run_s": run_s, "wall_s": time.perf_counter() - t0}
    return rows, numbers


# ------------------------------- disaggregated serving over processes (29)
def disagg_summary(eng, reqs: dict) -> dict:
    """The framework-independent outcome of one engine run (the stacked and
    each process's must agree), and its checks."""
    ms = {k: v for k, v in eng.msg_stats.items()}
    out = {"results": {int(r): int(t) for r, t in eng.results.items()},
           "steps_run": eng.steps_run, "msg_stats": ms,
           "novel_pages_shipped": eng.novel_pages_shipped, "retries": eng.retries,
           "credit_stalls": eng.credit_stalls, "pool_stalls": eng.pool_stalls,
           "lane_sends": eng.lane_sends.tolist(), "appends": eng.appends,
           "ring_payload_appends": eng.ring_payload_appends,
           "paged_stats": eng.paged_stats(), "rendezvous_stats": eng.rendezvous_stats(),
           "flow_ok": eng.flow_stats()["conservation_ok"],
           "queue": {k: v.tolist() for k, v in eng.queue_stats().items()}}
    bad = [rid for rid, toks in reqs.items() if out["results"].get(rid) != eng.reference(toks)]
    want = {"inline": (6, 2), "paged": (8, 3), "rendezvous": (8, 4)}[eng.mode]
    pool_ok = (out["paged_stats"] or out["rendezvous_stats"] or {"pool_conservation_ok": True}
               )["pool_conservation_ok"]
    rs = out["rendezvous_stats"]
    if bad or len(out["results"]) != len(reqs) or eng.retries or not out["flow_ok"] \
            or not pool_ok or (ms["raw_msgs_per_step"], ms["wire_msgs_per_step"]) != want \
            or (rs and (rs["ring_payload_appends"] or rs["pins_outstanding"])):
        raise AssertionError(
            f"29 {eng.mode}: {len(out['results'])}/{len(reqs)} results, tokens differ for "
            f"{bad[:8]}, retries {eng.retries}, credit conservation {out['flow_ok']}, pool "
            f"conservation {pool_ok}, raw -> wire {ms['raw_msgs_per_step']} -> "
            f"{ms['wire_msgs_per_step']} (want {want}), rendezvous {rs}")
    return out


def disagg_serve_rank(torch, np, disagg, mesh) -> tuple:
    """29.1 in one rank: the three transports at FULL over the process mesh;
    returns each one's summary and numbers, and the runs' engines."""
    from repro_torch import procmesh
    from repro_torch.kernels.rma import ops as rma_ops

    out, engines = {}, {}
    for name, kw in DISAGG_MODES.items():
        cfg = disagg.DisaggConfig(**kw, **FULL)
        held = mesh.barriers, mesh.tokens, mesh.host_gathers
        seen, restore = a2a_watch(torch, procmesh, rma_ops)
        row4 = rma_ops.launches["put_shift"]
        eng = disagg.DisaggEngine(mesh.p, cfg, seed=DISAGG_SEED, mesh=mesh)
        reqs = prompts(np.random.default_rng(DISAGG_SEED), DISAGG_N, cfg)
        for rid, toks in reqs.items():
            eng.submit(rid, toks)
        init = (mesh.barriers - held[0], mesh.tokens - held[1], mesh.host_gathers - held[2])
        torch.cuda.synchronize()
        mesh.barrier()
        held = mesh.barriers, mesh.tokens, mesh.host_gathers
        t0 = time.perf_counter()
        eng.run_until_drained(max_steps=4 * DISAGG_N + 16)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        restore()
        steps = eng.steps_run
        sync = ((mesh.barriers - held[0]) / steps, (mesh.tokens - held[1]) / steps,
                (mesh.host_gathers - held[2]) / steps)
        out[name] = {"summary": disagg_summary(eng, reqs), "ms_per_step": dt / steps * 1e3,
                     "per_step": sync, "init": init, "host_gathers": eng.host_gathers,
                     "row4_launches": rma_ops.launches["put_shift"] - row4,
                     "copy_a2a": dict(seen),
                     "device_bytes": torch.cuda.mem_get_info(mesh.device),
                     "peak_allocated": torch.cuda.max_memory_allocated(mesh.device)}
        engines[name] = eng
    return out, engines


def disagg_peer_inputs(torch, mesh, engines) -> dict:
    """The peer kernels' inputs at the disagg shape, from the runs: the
    rendezvous engine's pool (symmetric, FULL's 8192 pages of [16, 2, 128]
    f32) read at shift DISAGG_SHIFT (each decode rank from its prefill
    owner), 128 seeded page ids (one request's pull) and the same ids as
    slots 0-127 of the pull's 2048 (the rest holes); q = w_q; one request's
    KV block [1, 2048, 2, 128] (the inline message) and a count word; the
    inline run's NOTIF counter; and two symmetric copies of the rendezvous
    run's descriptor ring [64, 260] with its (head, tail), and its last
    descriptor as the message."""
    import numpy as np

    from repro_torch.core.plan import u32_to_wire
    from repro_torch.rmaq import queue as rq

    r, dev = mesh.rank, mesh.device
    rdv, inline = engines["rendezvous"], engines["inline"]
    pool, cfg = rdv.pool, rdv.cfg
    ppb, m = cfg.pages_per_block, cfg.max_recv_per_step
    g = torch.Generator(device=dev).manual_seed(DISAGG_SEED + r)
    ids128 = torch.randperm(cfg.pool_pages, generator=g, device=dev)[:ppb].to(torch.int32)[None]
    ids_pull = torch.full((1, m * ppb), -1, dtype=torch.int32, device=dev)
    ids_pull[:, :ppb] = ids128
    toks = torch.as_tensor(prompts(np.random.default_rng(DISAGG_SEED + r), 1, cfg)[0],
                           device=dev)
    ring = [mesh.symmetric(tuple(rdv.qstate.buf.shape[1:]), torch.float32) for _ in range(2)]
    ctr = [mesh.symmetric((2,), torch.int32) for _ in range(2)]
    c = rdv.qstate.ctrs
    for b, k in zip(ring, ctr):
        b.copy_(rdv.qstate.buf)
        k.copy_(u32_to_wire(c[:, [rq.HEAD, rq.TAIL]]))
    last = int((c[0, rq.TAIL] - 1) & (cfg.queue_capacity - 1))
    return {"pool": pool, "ids128": ids128, "ids_pull": ids_pull,
            "q": rdv.params["w_q"].reshape(1, 1, -1).contiguous(),
            "block": inline._compute_kv(toks)[None].contiguous(),
            "cnt": torch.tensor([r + 1], dtype=torch.int32, device=dev),
            "notif": u32_to_wire(inline.qstate.ctrs[:, rq.NOTIF]).contiguous(),
            "ring": ring, "ctr": ctr, "msg": rdv.qstate.buf[:, last:last + 1].clone(),
            "cfg": cfg}


def disagg_peer_path(torch, mesh, ins: dict, mods: dict) -> dict:
    """29.2 in one rank: rows 2, 3 and 8-10 through their ops surfaces (and
    `rmem.pages.gather_shift`) on the runs' data, counts zeroed before and
    read after, each held to what it stands for: the one-sided reads to
    the two-plan pull `gather_pages` of the same descriptor and to the
    readout's context over it, the notified put's delivery (hashed for the
    parent), the accumulate to the counter + 1, the push's accept."""
    from repro_torch.core.plan import u32_to_wire

    pg_ops, pa_ops, rq_ops, rpg = mods["pg"], mods["pa"], mods["rq"], mods["rpg"]
    s, cfg, r, p = DISAGG_SHIFT, ins["cfg"], mesh.rank, mesh.p
    ppb, m = cfg.pages_per_block, cfg.max_recv_per_step
    entries = torch.full((1, m, ppb, 2), -1, dtype=torch.int32, device=mesh.device)
    entries[0, 0, :, 0] = (r + s) % p
    entries[0, 0, :, 1] = ins["ids128"][0]
    valid = torch.zeros((1, m), dtype=torch.bool, device=mesh.device)
    valid[0, 0] = True
    block = rpg.gather_pages(mesh, ins["pool"], entries, valid)   # the two-plan pull
    pg_ops.launches, pa_ops.shift_launches = 0, 0
    rq_ops.launches.update(dict.fromkeys(rq_ops.launches, 0))
    pulled = rpg.gather_shift(mesh, ins["pool"], ins["ids_pull"], s)
    rows = pg_ops.paged_gather(ins["pool"], ins["ids128"], s, mesh)
    ctx = pa_ops.paged_attention_shift(ins["q"], ins["pool"], ins["ids128"], s, mesh, scale=1.0)
    got, cnt = rq_ops.notified_put(ins["block"], ins["cnt"], s, mesh)
    notif = rq_ops.notify_accumulate(torch.ones_like(ins["cnt"]), ins["notif"], s, mesh)
    _, ctr, n_sent, n_notif = rq_ops.queue_push(ins["ring"][0], ins["ctr"][0], ins["msg"], s,
                                                mesh)
    torch.cuda.synchronize()
    launches = {"paged_gather_peer": pg_ops.launches,
                "paged_attention_shift_peer": pa_ops.shift_launches,
                **{f"{k}_peer": v for k, v in rq_ops.launches.items()}}
    want = block[0, 0].reshape(ppb, cfg.page_tokens, 2, cfg.d_model)
    k_in = want[:, :, 0].reshape(-1, cfg.d_model)
    v_in = want[:, :, 1].reshape(-1, cfg.d_model)
    ref_ctx = torch.softmax(k_in @ ins["q"][0, 0], dim=0) @ v_in
    ctx_err = float((ctx[0, 0] - ref_ctx).abs().max())
    checks = {
        "gather_shift == gather_pages": torch.equal(pulled[0, :ppb], want)
        and not pulled[0, ppb:].any(),
        "paged_gather == gather_pages": torch.equal(rows[0], want),
        "attention ~ readout": ctx_err <= TOL,
        "notified count": int(cnt[0]) == (r - s) % p + 1,
        "accumulate == counter + 1": torch.equal(
            notif, u32_to_wire(ins["notif"].long() + 1)),
        "push admitted": int(n_sent[0]) == 1 and int(n_notif[0]) == 1,
    }
    if not all(checks.values()):
        raise AssertionError(f"29.2 rank {r}: {checks} (attention err {ctx_err})")
    return {"launches": launches, "ctx_err": ctx_err, "block": digest(torch, ins["block"]),
            "delivered": digest(torch, got), "checks": checks}


def disagg_peer_check(torch, mesh, ins: dict, mods: dict) -> dict:
    """29.3: each peer kernel against its plain version on the same ranks at
    the path's inputs and at shifts 0, 1, -1 and p + 1: rows 3 and 8-10
    bit-equal, row 2 within TOL; returns each row's max abs error."""
    pg_ops, pa_ops, rq_ops = mods["pg"], mods["pa"], mods["rq"]
    pg_ref, pa_ref, rq_ref = mods["pg_ref"], mods["pa_ref"], mods["rq_ref"]
    cap = ins["cfg"].queue_capacity
    errs = dict.fromkeys(DISAGG_PEER_ROWS, 0.0)

    def same(name, got, want, what):
        for a, b in zip(got, want):
            if name != "paged_attention_shift_peer" and not torch.equal(a, b):
                raise AssertionError(f"29.3 {name} differs from its plain version at {what}, "
                                     f"rank {mesh.rank}")
            errs[name] = max(errs[name], float((a.double() - b.double()).abs().max()))
        if errs[name] > TOL:
            raise AssertionError(f"29.3 {name}: max abs err {errs[name]} at {what}")

    for s in (DISAGG_SHIFT, 0, 1, -1, mesh.p + 1):
        what = f"shift {s}"
        for ids in (ins["ids128"], ins["ids_pull"]):
            for holes in (False, True):
                same("paged_gather_peer",
                     [pg_ops.paged_gather(ins["pool"], ids, s, mesh, holes=holes)],
                     [pg_ref.paged_gather_peer_ref(ins["pool"], ids, s, mesh, holes)], what)
        same("paged_attention_shift_peer",
             [pa_ops.paged_attention_shift(ins["q"], ins["pool"], ins["ids128"], s, mesh,
                                           scale=1.0)],
             [pa_ref.paged_attention_peer_ref(ins["q"], ins["pool"], ins["ids128"], s, mesh,
                                              scale=1.0)], what)
        same("notified_put_peer", rq_ops.notified_put(ins["block"], ins["cnt"], s, mesh),
             rq_ref.notified_put_peer_ref(ins["block"], ins["cnt"], s, mesh), what)
        same("notify_accumulate_peer",
             [rq_ops.notify_accumulate(ins["cnt"], ins["notif"], s, mesh)],
             [rq_ref.notify_accumulate_peer_ref(ins["cnt"], ins["notif"], s, mesh)], what)
        pushed = []
        for fn in (rq_ops.queue_push, rq_ref.queue_push_peer_ref):
            ins["ring"][1].copy_(ins["ring"][0])
            ins["ctr"][1].copy_(ins["ctr"][0])
            pushed.append([t.clone() for t in fn(ins["ring"][1], ins["ctr"][1], ins["msg"], s,
                                                 mesh, cap)])
        same("queue_push_peer", pushed[0], pushed[1], what)
    torch.cuda.synchronize()
    return errs


def disagg_peer_times(torch, mesh, ins: dict, mods: dict, hbm: float) -> dict:
    """29.4: each peer kernel alone (its launches, no fence; CUDA events over
    50 calls) beside its plain version and, where one PyTorch call computes
    the same function, that call, timed by one rank while the others wait
    at a barrier (the ranks take turns); the bound from this run's inputs."""
    import torch.nn.functional as F

    from repro_torch.core.plan import U32_MASK, u32_to_wire
    from repro_torch.kernels import common
    from repro_torch.procmesh import aligned, as_bytes

    pg_ops, pa_ops, rq_ops = mods["pg"], mods["pa"], mods["rq"]
    pa_ref = mods["pa_ref"]
    s, r, p, cfg = DISAGG_SHIFT, mesh.rank, mesh.p, ins["cfg"]
    t, stream = (r + s) % p, common.current_stream(mesh.device.index)
    pool, ids, q, block = ins["pool"], ins["ids128"], ins["q"], ins["block"]
    pseg, poff = mesh.locate(pool)
    n_pages, w, k = pool.shape[1], pool[0, 0].numel(), ids.shape[1]
    pt, hd = cfg.page_tokens, cfg.d_model
    owner = mesh.peer(pool, t)[0]
    safe = ids[0].long()
    out_rows = torch.empty((1, k) + tuple(pool.shape[2:]), device=mesh.device)
    local_ids = torch.arange(k, device=mesh.device)[None]       # ids are valid: no mask
    kv = owner[safe]                                            # [k, pt, 2, hd]
    k_all, v_all = kv[:, :, 0].reshape(1, 1, -1, hd), kv[:, :, 1].reshape(1, 1, -1, hd)
    # the exchange slots the stores go to: one collective round before the turns
    xb = aligned(block.nbytes)
    xseg, xoff = mesh.round(xb + 8)
    bbytes, cnt, local = as_bytes(block), ins["cnt"], ins["notif"]
    acc_out = torch.empty_like(local)
    ring, ctr, msg = ins["ring"][1], ins["ctr"][1], ins["msg"]
    (bseg, boff), (cseg, coff) = mesh.locate(ring), mesh.locate(ctr)
    counts = torch.empty((2, 1), dtype=torch.int32, device=mesh.device)
    ring_t, ctr_t = mesh.peer(ring, t), mesh.peer(ctr, t)
    cap = cfg.queue_capacity
    slot_here = xseg.tensor(r, (1,), torch.int32, xoff + xb)

    def push_plain():
        head, tail = (ctr_t[0].long() & U32_MASK).tolist()
        acc = min((cap - ((tail - head) & U32_MASK)) & U32_MASK, msg.shape[1])
        ring_t[0, (tail + torch.arange(acc, device=mesh.device)) & (cap - 1)] = msg[0, :acc]
        xseg.view(t, xoff + xb, 4).copy_(as_bytes(torch.tensor([acc], dtype=torch.int32,
                                                               device=mesh.device)))
        ctr[:, 1] = u32_to_wire(ctr[:, 1].long() + slot_here.long())

    valid = int((ids >= 0).sum())
    rows = {   # name -> (kernel's launches, plain, library or None, (bytes, flops))
        "paged_gather_peer": (
            lambda: pg_ops._PEER(pseg.table_ptr, poff, ids.data_ptr(), out_rows.data_ptr(), p,
                                 r, s, n_pages, w, k, 0, stream),
            lambda: owner[safe.clamp(0, n_pages - 1)],
            lambda: torch.index_select(owner, 0, safe),
            (2 * k * w * 4 + ids.nbytes, 0)),
        "paged_attention_shift_peer": (
            lambda: pa_ops._launch(pa_ops._PEER, q, (pseg.table_ptr, poff), ids, 1.0, False,
                                   n_pages, pt, (p, r, s)),
            lambda: pa_ref.paged_attention_ref(q, owner[safe], local_ids, scale=1.0),
            lambda: F.scaled_dot_product_attention(q[:, None], k_all, v_all, scale=1.0),
            (valid * pt * 2 * hd * 4 + 2 * q.nbytes + ids.nbytes, 4 * valid * pt * hd)),
        "notified_put_peer": (
            lambda: rq_ops._PEER_PUT(block.data_ptr(), cnt.data_ptr(), xseg.table_ptr, p, r, s,
                                     xoff, xoff + xb, block.numel(), 1, stream),
            lambda: (xseg.view(t, xoff, block.nbytes).copy_(bbytes),
                     xseg.view(t, xoff + xb, 4).copy_(as_bytes(cnt))),
            None, (2 * (block.nbytes + 4), 0)),
        "notify_accumulate_peer": (
            lambda: (rq_ops._PEER_STORE(cnt.data_ptr(), xseg.table_ptr, p, r, s, xoff + xb, 1,
                                        stream),
                     rq_ops._PEER_ADD(local.data_ptr(), xseg.table_ptr, acc_out.data_ptr(), r,
                                      xoff + xb, 1, stream)),
            lambda: (xseg.view(t, xoff + xb, 4).copy_(as_bytes(cnt)),
                     u32_to_wire(local.long() + slot_here.long())),
            None, (5 * 4, 0)),
        "queue_push_peer": (
            lambda: (rq_ops._PEER_PUSH(msg.data_ptr(), bseg.table_ptr, boff, cseg.table_ptr,
                                       coff, xseg.table_ptr, xoff + xb, counts.data_ptr(), p,
                                       r, s, cap, msg.shape[1], msg.shape[2], stream),
                     rq_ops._PEER_PUBLISH(ctr.data_ptr(), xseg.table_ptr, r, xoff + xb,
                                          counts[1].data_ptr(), stream)),
            push_plain, None, (2 * msg.nbytes + 8 + 4 + 4 + 4 + 8 + 4, 0)),
    }
    out = {}
    mesh.fence()
    for turn in range(p):
        mesh.barrier()
        if turn == r:
            for name, (kern, plain, lib, (nbytes, flops)) in rows.items():
                k_ms, p_ms = time_ms(kern), time_ms(plain)
                bound, bound_by = max((nbytes / hbm * 1e3, "bytes"),
                                      (flops / F32_FLOPS_PER_S * 1e3, "operations"))
                out[name] = {"ms": k_ms, "plain_ms": p_ms,
                             "library_ms": None if lib is None else time_ms(lib),
                             "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                             "flops": flops}
            torch.cuda.synchronize()
            out["push_admitted"] = int(counts[0, 0])
        torch.cuda.synchronize()
    mesh.fence()
    return out


def disagg_rank(mesh, hbm: float) -> dict:
    """Phase 29 in one rank's process: 29.1-29.4; raises on any failure."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.paged_gather import ref as pg_ref
    from repro_torch.kernels.rmaq import ops as rq_ops
    from repro_torch.kernels.rmaq import ref as rq_ref
    from repro_torch.rmem import pages as rpg
    from repro_torch.serve import disagg

    mods = {"pg": pg_ops, "pa": pa_ops, "rq": rq_ops, "rpg": rpg, "pg_ref": pg_ref,
            "pa_ref": pa_ref, "rq_ref": rq_ref}
    t0 = time.perf_counter()
    out, engines = disagg_serve_rank(torch, np, disagg, mesh)
    ins = disagg_peer_inputs(torch, mesh, engines)
    path = disagg_peer_path(torch, mesh, ins, mods)
    errs = disagg_peer_check(torch, mesh, ins, mods)
    times = disagg_peer_times(torch, mesh, ins, mods, hbm)
    if mesh.rank == 0 and times["push_admitted"] != 1:
        raise AssertionError(f"29.4: the last timed push admitted {times['push_admitted']}")
    return {"rank": mesh.rank, "serve": out, "path": path, "errs": errs, "times": times,
            "wall_s": time.perf_counter() - t0}


def disagg_procs_phases(torch, hbm: float) -> tuple:
    """Phase 29: `DisaggEngine` at FULL with one rank a process, 4 processes
    on the card, beside the stacked `Mesh(4)` engine on the same requests,
    and the peer forms of rows 2, 3 and 8-10 (their rows of the kernels
    line, and the phase's numbers)."""
    import numpy as np

    from repro_torch import procmesh
    from repro_torch.serve import disagg

    t0 = time.perf_counter()
    p = PROC_P
    card = card_line()
    log(f"phase 29: disaggregated serving over {p} processes time-sharing one card ({card}); "
        "no link is crossed, so no time here is an NVLink time")
    stacked = {}
    for name, kw in DISAGG_MODES.items():
        cfg = disagg.DisaggConfig(**kw, **FULL)
        eng, dt = serve(disagg, cfg, DISAGG_N, seed=DISAGG_SEED)
        reqs = prompts(np.random.default_rng(DISAGG_SEED), DISAGG_N, cfg)
        stacked[name] = {"summary": disagg_summary(eng, reqs),
                         "ms_per_step": dt / eng.steps_run * 1e3}
        del eng
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = procmesh.run(disagg_rank, p, device="cuda", args=(hbm,), timeout=PROC_TIMEOUT)
    run_s = time.perf_counter() - t1
    for name in DISAGG_MODES:
        want = stacked[name]["summary"]
        for res in ranks:
            got = res["serve"][name]["summary"]
            if got != want:
                diff = sorted(k for k in want if got.get(k) != want[k])
                raise AssertionError(f"29.1 {name} rank {res['rank']}: {diff} differ from the "
                                     "stacked run's")
        ms = want["msg_stats"]
        per = [res["serve"][name]["per_step"] for res in ranks]
        row4 = [res["serve"][name]["row4_launches"] for res in ranks]
        copies = [res["serve"][name]["copy_a2a"] for res in ranks]
        if any(c["carriable"] for c in copies) or min(row4) == 0:
            raise AssertionError(f"29.1 {name}: row 4 launches by rank {row4}, "
                                 f"ProcMesh.all_to_all calls by rank {copies}: every "
                                 "all-to-all of whole-word blocks must take the kernel")
        if any(round(pr[0], 9) != DISAGG_BARRIERS[name] for pr in per):
            raise AssertionError(f"29.1 {name}: host barriers a step by rank "
                                 f"{[pr[0] for pr in per]}, want {DISAGG_BARRIERS[name]}")
        log(f"29.1 {name}: {DISAGG_N} requests, {want['steps_run']} steps, every rank's tokens, "
            f"steps, msg_stats, novel pages {want['novel_pages_shipped']}, retries "
            f"{want['retries']}, stalls {want['credit_stalls']}/{want['pool_stalls']} equal to "
            f"the stacked run's and to reference(); raw -> wire {ms['raw_msgs_per_step']} -> "
            f"{ms['wire_msgs_per_step']} a step, ring payload appends "
            f"{want['ring_payload_appends']}; ms/step by rank "
            f"{[round(res['serve'][name]['ms_per_step'], 3) for res in ranks]} beside the "
            f"stacked {stacked[name]['ms_per_step']:.3f} (before row 4 took the all-to-alls: "
            f"{DISAGG_PR30_MS[name]} over processes); host barriers / tokens / host gathers "
            f"a step by rank {[tuple(round(x, 2) for x in pr) for pr in per]} (want "
            f"{DISAGG_BARRIERS[name]} barriers: an all-to-all through row 4 takes one fence, "
            f"as through copy_); row 4 launches a step by rank "
            f"{[round(n / want['steps_run'], 2) for n in row4]}, ProcMesh.all_to_all calls "
            f"{copies}; device memory in "
            f"use {max(res['serve'][name]['device_bytes'][1] - res['serve'][name]['device_bytes'][0] for res in ranks) / 2**30:.2f} GiB "
            f"(all contexts), torch peak a rank "
            f"{max(res['serve'][name]['peak_allocated'] for res in ranks) / 2**20:.0f} MiB")
    s = DISAGG_SHIFT
    for res in ranks:
        src = ranks[(res["rank"] - s) % p]["path"]["block"]
        if res["path"]["delivered"] != src:
            raise AssertionError(f"29.2 rank {res['rank']}: the notified put delivered another "
                                 "block than its producer's")
    launches = {name: sum(res["path"]["launches"][name] for res in ranks)
                for name in DISAGG_PEER_ROWS}
    if min(launches.values()) == 0:
        raise AssertionError(f"29.2: a peer kernel of the path launched no time: {launches}")
    log(f"29.2 rows 2, 3, 8-10 through their ops surfaces on the runs' data at shift {s} "
        f"(decode rank <- its prefill owner): gather_shift and paged_gather bit-equal to the "
        f"two-plan gather_pages pull, paged_attention_shift within "
        f"{max(res['path']['ctx_err'] for res in ranks):.3g} of the readout's context, the "
        f"notified put's block its producer's, the accumulate the counter + 1, the push "
        f"admitted; launches {launches}")
    errs = {k: max(res["errs"][k] for res in ranks) for k in DISAGG_PEER_ROWS}
    log(f"29.3 peer kernels vs plain on the same ranks (the path's inputs, shifts {s}, 0, 1, "
        f"-1, {p + 1}; rows 3 and 8-10 bit-equal, row 2 within {TOL}): max abs err {errs}")
    times = ranks[0]["times"]
    rows = []
    for name in DISAGG_PEER_ROWS:
        t = times[name]
        lib = (f"library {t['library_ms'] * 1e3:.1f} us" if t["library_ms"] is not None
               else "no one PyTorch call computes it")
        log(f"29.4 {name} (rank 0 alone; {card}): kernel {t['ms'] * 1e3:.1f} us, plain "
            f"{t['plain_ms'] * 1e3:.1f} us, {lib}, bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}: {t['bytes']} bytes, {t['flops']} flops), launches "
            f"{launches[name]}; kernel by rank "
            f"{[round(x['times'][name]['ms'] * 1e3, 1) for x in ranks]} us")
        rows.append({"name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
                     "replaces": KERNELS[name][2], "launches": launches[name],
                     "launches_per_rank": [x["path"]["launches"][name] for x in ranks],
                     "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    numbers = {name: {"ms_per_step": [x["serve"][name]["ms_per_step"] for x in ranks],
                      "stacked_ms_per_step": stacked[name]["ms_per_step"],
                      "per_step": [x["serve"][name]["per_step"] for x in ranks],
                      "steps": stacked[name]["summary"]["steps_run"]}
               for name in DISAGG_MODES}
    numbers.update(run_s=run_s, wall_s=time.perf_counter() - t0,
                   ranks_wall_s=[x["wall_s"] for x in ranks],
                   row4_launches=sum(x["serve"][m]["row4_launches"] for x in ranks
                                     for m in DISAGG_MODES))
    log(f"29: ranks' run {run_s:.1f} s, phase {time.perf_counter() - t0:.1f} s")
    return rows, numbers


# ------------- DSDE, MoE, the hashtable and the FFT over processes (30)
def a2a_watch(torch, procmesh, rma_ops):
    """Counts `ProcMesh.all_to_all` calls (the mesh's `copy_` route) in this
    process, split by whether the kernel could have carried the blocks:
    under "auto" a call of whole-word CUDA blocks is a fault."""
    seen = {"carriable": 0, "other": 0}
    real = procmesh.ProcMesh.all_to_all

    def counted(self, x):
        seen["carriable" if x.is_cuda and rma_ops.block_words(x) else "other"] += 1
        return real(self, x)

    procmesh.ProcMesh.all_to_all = counted
    return seen, lambda: setattr(procmesh.ProcMesh, "all_to_all", real)


def apps_rows(torch, mesh, t):
    """This process's rows of a stacked [p, ...] tensor made from a seed
    (all of them on a stacked `Mesh`)."""
    return t[mesh.rank:mesh.rank + 1].contiguous() if hasattr(mesh, "rank") else t


def apps_call(torch, mesh, rma_ops, OpCounter, fn) -> tuple:
    """One checked call: (result, OpCounter snapshot and plans, row 4
    launches)."""
    launched = rma_ops.launches["put_shift"]
    with OpCounter() as c:
        res = fn()
    torch.cuda.synchronize()
    return res, {"ops": c.snapshot(), "plans": c.plans}, rma_ops.launches["put_shift"] - launched


def apps_times(torch, mesh, fn, reps: int = APPS_REPS) -> dict:
    """Host ms of `reps` synchronised calls after a warm-up, every rank in
    step (a barrier of the bootstrap before each call, outside its time),
    and the host barriers a warm call takes (the first call's include the
    exchange segment's growth)."""
    fn()
    times, barriers = [], 0
    for _ in range(reps):
        torch.cuda.synchronize()
        getattr(mesh, "barrier", lambda: None)()
        held = getattr(mesh, "barriers", 0)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        barriers += getattr(mesh, "barriers", 0) - held
    return {"ms": times, "barriers": barriers / reps}


def row_digests(torch, res) -> list:
    """Each local row's digest of every tensor of a result: [rows][tensors]."""
    ts = list(res) if isinstance(res, (tuple, list)) else [res]
    return [[digest(torch, t[i]) for t in ts] for i in range(ts[0].shape[0])]


def apps_inputs(torch, mesh) -> dict:
    """Phase 30's inputs, every rank's from one seed (the same tensors in the
    stacked run and in each process, which keeps its own rows)."""
    p, dev = mesh.p, mesh.device
    g = torch.Generator(device=dev).manual_seed(APPS_SEED)
    k, m = APPS_K, APPS_MOE
    data = torch.randn(p, k, DSDE_D, generator=g, device=dev)
    uniform = torch.randint(0, p, (p, k), generator=g, device=dev, dtype=torch.int32)
    skew = uniform.clone()
    skew[:, :k // 2] = 0                  # half of every rank's items to rank 0
    tokens = torch.randn(p, m["tokens"], m["d"], generator=g, device=dev).to(torch.bfloat16)
    logits = torch.randn(p, m["tokens"], m["experts"], generator=g, device=dev)
    gate, idx = torch.topk(torch.softmax(logits, dim=-1), m["top_k"])
    gate = (gate / gate.sum(-1, keepdim=True)).to(torch.bfloat16)
    scale = (torch.rand(m["experts"], generator=g, device=dev) + 0.5).to(torch.bfloat16)
    b = HT_BATCH
    n_keys = HT_EPOCHS * p * b
    newest = torch.randint(0, 2**62, (n_keys,), generator=g, device=dev)
    fresh = torch.randint(0, 2**62, (n_keys,), generator=g, device=dev)  # the re-insert's values
    jp = torch.randint(0, n_keys, (p, b), generator=g, device=dev)
    x = torch.randn((p, FFT_N // p, FFT_N, FFT_N), dtype=torch.complex64, generator=g,
                    device=dev)
    return {"data": data, "uniform": uniform, "skew": skew, "tokens": tokens, "idx": idx,
            "gate": gate, "scale": scale, "newest": newest, "fresh": fresh, "jp": jp, "x": x}


def apps_dsde(torch, mesh, rma_ops, OpCounter, ins: dict) -> dict:
    """30.1: the four protocols on both draws, checked and hashed; each
    protocol timed on the uniform draw."""
    from repro_torch.core import dsde

    data = apps_rows(torch, mesh, ins["data"])
    out = {}
    for draw in ("uniform", "skew"):
        tg = apps_rows(torch, mesh, ins[draw])
        for proto in DSDE_PROTOCOLS:
            fn = lambda f=getattr(dsde, proto): f(data, tg, mesh, APPS_CAP)  # noqa: E731
            res, led, launched = apps_call(torch, mesh, rma_ops, OpCounter, fn)
            row = {"digests": row_digests(torch, res), "ledger": led, "launches": launched,
                   "dropped": res.sent_dropped.tolist(),
                   "received": res.recv_valid.sum(1).tolist()}
            if draw == "uniform":
                row.update(apps_times(torch, mesh, fn))
            out[f"{proto}/{draw}"] = row
            del res
    return out


def apps_moe(torch, mesh, rma_ops, OpCounter, ins: dict) -> dict:
    """30.2: qwen3-moe's dispatch and combine, a per-expert scale as the
    experts; checked, hashed and timed."""
    from repro_torch.core import dsde

    m = APPS_MOE
    tokens, idx, gate = (apps_rows(torch, mesh, ins[k]) for k in ("tokens", "idx", "gate"))
    local_e = m["experts"] // mesh.p
    mine = mesh.axis_index()[:, None] * local_e + torch.arange(local_e, device=mesh.device)
    scale = ins["scale"][mine][..., None, None]

    def dispatch():
        return dsde.moe_dispatch(tokens, idx, gate, m["experts"], mesh, capacity_factor=m["cf"])

    disp, led_d, launch_d = apps_call(torch, mesh, rma_ops, OpCounter, dispatch)
    combine = lambda: dsde.moe_combine(disp.expert_inputs * scale, disp, m["tokens"], mesh)  # noqa: E731
    comb, led_c, launch_c = apps_call(torch, mesh, rma_ops, OpCounter, combine)
    if not torch.isfinite(comb.float()).all():
        raise AssertionError("30.2: non-finite combine output")
    return {"dispatch": {"digests": row_digests(torch, disp), "ledger": led_d,
                         "launches": launch_d,
                         **apps_times(torch, mesh, dispatch)},
            "combine": {"digests": row_digests(torch, comb), "ledger": led_c,
                        "launches": launch_c,
                        **apps_times(torch, mesh, combine)}}


def apps_hashtable(torch, mesh, rma_ops, OpCounter, ins: dict) -> dict:
    """30.3: 4 insert epochs of distinct keys and a re-insert of every
    HT_REINSERT-th, then a lookup of present and absent keys, every answer
    checked; volumes and answers hashed; insert and lookup epochs timed."""
    from repro_torch.core import hashtable as ht

    p, b, dev = mesh.p, HT_BATCH, mesh.device
    n_keys = HT_EPOCHS * p * b
    newest = ins["newest"].clone()
    vol = ht.make_volume(HT_TABLE, HT_HEAP, mesh.local_ranks, device=dev)
    out, vol1 = {}, None
    for e in range(HT_EPOCHS + 1):
        if e < HT_EPOCHS:
            j = torch.arange(e * p * b, (e + 1) * p * b, device=dev).reshape(p, b)
        else:
            j = torch.arange(0, n_keys, HT_REINSERT, device=dev).reshape(p, -1)
            newest[j.reshape(-1)] = ins["fresh"][j.reshape(-1)]
        j = apps_rows(torch, mesh, j)
        (vol, dropped), led, launched = apps_call(
            torch, mesh, rma_ops, OpCounter,
            lambda: ht.insert_epoch(vol, ht_keys(j), newest[j], mesh, APPS_HT_CAP))
        if int(dropped.sum()):
            raise AssertionError(f"30.3 insert epoch {e + 1} dropped {int(dropped.sum())}")
        out[f"insert{e + 1}"] = {"digests": row_digests(torch, list(vol) + [dropped]),
                                 "ledger": led, "launches": launched}
        if e == 0:
            vol1 = vol
    jp = apps_rows(torch, mesh, ins["jp"])
    ja = apps_rows(torch, mesh, torch.arange(n_keys, n_keys + p * b, device=dev).reshape(p, b))
    q = ht_keys(torch.cat((jp, ja), dim=1))
    (vals, found), led, launched = apps_call(
        torch, mesh, rma_ops, OpCounter,
        lambda: ht.lookup_epoch(vol, q, mesh, APPS_HT_LOOKUP_CAP))
    if not (bool(found[:, :b].all()) and torch.equal(vals[:, :b], newest[jp])
            and not bool(found[:, b:].any())):
        raise AssertionError("30.3 lookup: a present key missed or stale, or an absent key found")
    out["lookup"] = {"digests": row_digests(torch, (vals, found)), "ledger": led,
                     "launches": launched}
    j2 = apps_rows(torch, mesh, torch.arange(p * b, 2 * p * b, device=dev).reshape(p, b))
    k2, v2 = ht_keys(j2), newest[j2]
    out["insert"] = apps_times(torch, mesh, lambda: ht.insert_epoch(vol1, k2, v2, mesh,
                                                                    APPS_HT_CAP))
    out["lookup"].update(apps_times(torch, mesh, lambda: ht.lookup_epoch(
        vol, q, mesh, APPS_HT_LOOKUP_CAP)))
    if hasattr(mesh, "rank"):         # each rank's device busy share of one call
        out["profiles"] = {
            "insert": profile_call(torch, f"30.3 rank {mesh.rank} insert epoch",
                                   lambda: ht.insert_epoch(vol1, k2, v2, mesh, APPS_HT_CAP)),
            "lookup": profile_call(torch, f"30.3 rank {mesh.rank} lookup epoch",
                                   lambda: ht.lookup_epoch(vol, q, mesh, APPS_HT_LOOKUP_CAP))}
    return out


def apps_fft(torch, mesh, rma_ops, OpCounter, ins: dict) -> dict:
    """30.4: NAS FT class C, both schedules held to `fft3d_reference`
    (FFT_TOL of the spectrum's max abs) and timed."""
    from repro_torch.apps import fft

    x = apps_rows(torch, mesh, ins["x"])
    ref = fft.fft3d_reference(ins["x"])
    want, scale = apps_rows(torch, mesh, ref), float(ref.abs().max())
    del ref
    out = {}
    for name in ("fft3d", "fft3d_slabs"):
        fn = lambda f=getattr(fft, name): f(x, mesh)  # noqa: E731
        got, led, launched = apps_call(torch, mesh, rma_ops, OpCounter, fn)
        err = float((got - want).abs().max()) / scale
        if got.shape != x.shape or not err <= FFT_TOL:
            raise AssertionError(f"30.4 {name}: {tuple(got.shape)}, max abs err {err:.3g} of "
                                 f"the max abs (tol {FFT_TOL})")
        del got
        out[name] = {"err": err, "ledger": led, "launches": launched,
                     **apps_times(torch, mesh, fn, reps=APPS_FFT_REPS)}
    if hasattr(mesh, "rank"):
        out["profile"] = profile_call(torch, f"30.4 rank {mesh.rank} fft3d",
                                      lambda: fft.fft3d(x, mesh))
    return out


def apps_arms(torch, mesh, rma_ops, ins: dict, hbm: float) -> dict:
    """30.5: one all-to-all of each payload dtype at its path's shape, the
    kernel arm (row 4's peer form, p launches) beside the "torch" arm
    (`ProcMesh.all_to_all`, a `copy_` a block), each held to the other bit
    for bit and timed with every rank in step (host ms, fence and copy-out
    included); the bound is the payload read once and written once."""
    p, dev = mesh.p, mesh.device
    m = APPS_MOE
    cap = int(m["cf"] * m["tokens"] * m["top_k"] / m["experts"]) + 1
    slots = m["experts"] // p * cap
    g = torch.Generator(device=dev).manual_seed(APPS_SEED + 1 + mesh.rank)
    payloads = {
        "float32 (DSDE slots)": torch.randn(1, p, APPS_CAP, DSDE_D, generator=g, device=dev),
        "int32 (DSDE counts)": torch.randint(0, APPS_CAP, (1, p), generator=g, device=dev,
                                             dtype=torch.int32),
        "bool (DSDE validity)": torch.rand(1, p, APPS_CAP, generator=g, device=dev) < 0.5,
        "bfloat16 (MoE tokens)": torch.randn(1, p, slots, m["d"], generator=g,
                                             device=dev).to(torch.bfloat16),
        "int64 (hashtable items)": torch.randint(-2**62, 2**62, (1, p, APPS_HT_CAP, 2),
                                                 generator=g, device=dev),
        "complex64 (FFT y-blocks)": ins["x"][mesh.rank:mesh.rank + 1].reshape(
            1, FFT_N // p, p, FFT_N // p, FFT_N).transpose(1, 2),
    }
    out = {}
    for name, x in payloads.items():
        a, b = rma_ops.all_to_all(x, mesh), mesh.all_to_all(x)
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"30.5 {name}: the kernel arm differs from ProcMesh.all_to_all")
        before = rma_ops.launches["put_shift"]
        kern = apps_times(torch, mesh, lambda: rma_ops.all_to_all(x, mesh), APPS_ARM_REPS)["ms"]
        launched = rma_ops.launches["put_shift"] - before
        plain = apps_times(torch, mesh, lambda: mesh.all_to_all(x), APPS_ARM_REPS)["ms"]
        if launched != p * (APPS_ARM_REPS + 1):
            raise AssertionError(f"30.5 {name}: {launched} launches in {APPS_ARM_REPS + 1} calls")
        out[name] = {"bytes": x.nbytes, "ms": kern, "torch_ms": plain,
                     "bound_ms": 2 * x.nbytes / hbm * 1e3, "contiguous": x.is_contiguous()}
    return out


def apps_rank(mesh, hbm: float) -> dict:
    """Phase 30 in one rank's process (and, on a stacked `Mesh`, the stacked
    run): 30.1-30.4, with each call's row 4 launches and host barriers;
    raises on any failure."""
    import torch

    from repro_torch import procmesh
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.rma import ops as rma_ops

    t0 = time.perf_counter()
    ins = apps_inputs(torch, mesh)
    seen, restore = a2a_watch(torch, procmesh, rma_ops)
    try:
        out = {"rank": getattr(mesh, "rank", None),
               "dsde": apps_dsde(torch, mesh, rma_ops, OpCounter, ins),
               "moe": apps_moe(torch, mesh, rma_ops, OpCounter, ins),
               "ht": apps_hashtable(torch, mesh, rma_ops, OpCounter, ins),
               "fft": apps_fft(torch, mesh, rma_ops, OpCounter, ins)}
        out["copy_a2a"] = dict(seen)
    finally:
        restore()
    if isinstance(mesh, procmesh.ProcMesh):
        out["arms"] = apps_arms(torch, mesh, rma_ops, ins, hbm)
        out["peak_allocated"] = torch.cuda.max_memory_allocated(mesh.device)
        out["device_bytes"] = torch.cuda.mem_get_info(mesh.device)
    out["wall_s"] = time.perf_counter() - t0
    return out


def apps_calls(res: dict) -> dict:
    """Every checked call of a phase-30 run by name: {name: its row}."""
    calls = {f"dsde {k}": v for k, v in res["dsde"].items()}
    calls.update({f"moe {k}": v for k, v in res["moe"].items()})
    calls.update({f"hashtable {k}": v for k, v in res["ht"].items() if "ledger" in v})
    calls.update({f"fft {k}": v for k, v in res["fft"].items() if "ledger" in v})
    return calls


def apps_timed(res: dict) -> dict:
    """Every timed call of a phase-30 run by name: {name: {"ms", "barriers"}}
    (the hashtable's insert timed from epoch 1's volume)."""
    calls = {k: v for k, v in apps_calls(res).items() if "ms" in v}
    calls["hashtable insert"] = res["ht"]["insert"]
    return calls


def spread(xs: list) -> str:
    return f"{median(xs):.3f} ms (min {min(xs):.3f}, max {max(xs):.3f}, n {len(xs)})"


def apps_procs_phases(torch, hbm: float) -> dict:
    """Phase 30: DSDE, the MoE dispatch, the hashtable and the 3-D FFT with
    one rank a process (PROC_P processes on the card), every all-to-all
    block stored by row 4's peer form, against the stacked `Mesh(4)` run of
    the same inputs in this process.  Returns the phase's numbers, row 4's
    launches among them."""
    from repro_torch import procmesh
    from repro_torch.apps import fft
    from repro_torch.mesh import Mesh

    t0 = time.perf_counter()
    p = PROC_P
    card = card_line()
    log(f"phase 30: DSDE, MoE, the hashtable and the FFT over {p} processes time-sharing one "
        f"card ({card}); no link is crossed, so no time here is an NVLink time")
    stacked = apps_rank(Mesh(p, "x", device="cuda"), hbm)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = procmesh.run(apps_rank, p, device="cuda", args=(hbm,), axis="x",
                         timeout=PROC_TIMEOUT)
    run_s = time.perf_counter() - t1
    want_calls = apps_calls(stacked)
    transfers = apps_transfers(p)
    for res in ranks:
        r = res["rank"]
        if res["copy_a2a"]["carriable"]:
            raise AssertionError(f"30 rank {r}: {res['copy_a2a']['carriable']} all-to-alls of "
                                 "whole-word CUDA blocks went through ProcMesh.all_to_all")
        for name, got in apps_calls(res).items():
            want = want_calls[name]
            if "digests" in want and got["digests"] != [want["digests"][r]]:
                raise AssertionError(f"30 rank {r} {name}: differs from the stacked run's row")
            if got["ledger"] != want["ledger"]:
                raise AssertionError(f"30 rank {r} {name}: ledger {got['ledger']['ops']} vs the "
                                     f"stacked {want['ledger']['ops']}")
            if "dropped" in want and got["dropped"] != [want["dropped"][r]]:
                raise AssertionError(f"30 rank {r} {name}: drops {got['dropped']} vs "
                                     f"{want['dropped'][r]}")
            if got["launches"] != p * transfers[name]:
                raise AssertionError(f"30 rank {r} {name}: {got['launches']} row 4 launches, "
                                     f"want {p} x {transfers[name]} all-to-all transfers")
    for name, want in want_calls.items():
        if "received" in want and sum(want["received"]) + sum(want["dropped"]) != p * APPS_K:
            raise AssertionError(f"30.1 stacked {name}: items not conserved")
    skew = {k.split(" ")[1]: want_calls[k]["dropped"] for k in want_calls
            if k.endswith("/skew")}
    if not all(sum(d) > 0 for d in skew.values()):
        raise AssertionError(f"30.1: the skewed draw dropped nothing: {skew}")
    launches = sum(res_call["launches"] for res in ranks
                   for res_call in apps_calls(res).values())
    log(f"30 checks: every rank's DSDE results (4 protocols x 2 draws), MoE dispatch and "
        f"combine, volumes after {HT_EPOCHS + 1} insert epochs and lookup answers bit-equal "
        f"to its row of the stacked Mesh({p}) run, ledgers (by kind, raw, wire, plans) equal, "
        f"drops on the skewed draw equal ({skew}); FFT within "
        f"{max(res['fft'][k]['err'] for res in ranks for k in ('fft3d', 'fft3d_slabs')):.3g} "
        f"of the max abs (tol {FFT_TOL}); row 4 launches {launches} in the checked calls = "
        f"{p} a rank per all-to-all transfer, no all-to-all of whole-word blocks through "
        f"copy_ (ProcMesh.all_to_all calls by rank "
        f"{[res['copy_a2a'] for res in ranks]}); ranks' run {run_s:.1f} s")
    numbers = {"card": card, "calls": {}}
    for name, want in apps_timed(stacked).items():
        ms = [x for res in ranks for x in apps_timed(res)[name]["ms"]]
        got = apps_timed(ranks[0])[name]
        numbers["calls"][name] = {"ms": ms, "stacked_ms": want["ms"],
                                  "barriers_per_call": got["barriers"],
                                  "launches_per_call": p * transfers[name]}
        log(f"30 {name}: over {p} processes {spread(ms)} (all ranks' calls), stacked "
            f"Mesh({p}) {spread(want['ms'])}; host barriers a warm call {got['barriers']:g}, "
            f"row 4 launches a call a rank {p * transfers[name]}")
    ht_ms = {k: [x for res in ranks for x in res["ht"][k]["ms"]] for k in ("insert", "lookup")}
    b = HT_BATCH
    rates = {"inserts_per_s": p * b / median(ht_ms["insert"]) * 1e3,
             "lookups_per_s": 2 * p * b / median(ht_ms["lookup"]) * 1e3,
             "stacked_inserts_per_s": p * b / median(stacked["ht"]["insert"]["ms"]) * 1e3,
             "stacked_lookups_per_s": 2 * p * b / median(stacked["ht"]["lookup"]["ms"]) * 1e3}
    log(f"30.3 hashtable: {rates['inserts_per_s']:.4g} inserts/s over processes "
        f"({rates['stacked_inserts_per_s']:.4g} stacked), {rates['lookups_per_s']:.4g} "
        f"lookups/s ({rates['stacked_lookups_per_s']:.4g} stacked)")
    prof = {f"rank {res['rank']} {k}": {"wall_ms": v["wall_ms"], "busy_ms": v["busy_ms"]}
            for res in ranks for k, v in list(res["ht"]["profiles"].items())
            + [("fft3d", res["fft"]["profile"])]}
    log(f"30 profiles (one call each, every rank in step): " + "; ".join(
        f"{k} wall {v['wall_ms']:.3f} ms, device busy {v['busy_ms']:.3f} ms "
        f"({v['busy_ms'] / v['wall_ms']:.1%})" for k, v in prof.items()))
    flops = fft.fft_flops(FFT_N)
    for name in ("fft3d", "fft3d_slabs"):
        ms = median(numbers["calls"][f"fft {name}"]["ms"])
        sms = median(numbers["calls"][f"fft {name}"]["stacked_ms"])
        numbers["calls"][f"fft {name}"].update(gflops=flops / ms / 1e6,
                                                stacked_gflops=flops / sms / 1e6)
        log(f"30.4 {name} at {FFT_N}³: {ms:.3f} ms over processes ({flops / ms / 1e6:.1f} "
            f"GFLOP/s), stacked {sms:.3f} ms ({flops / sms / 1e6:.1f} GFLOP/s)")
    arms = {name: {"ms": [x for res in ranks for x in res["arms"][name]["ms"]],
                   "torch_ms": [x for res in ranks for x in res["arms"][name]["torch_ms"]],
                   "bound_ms": ranks[0]["arms"][name]["bound_ms"],
                   "bytes": ranks[0]["arms"][name]["bytes"]} for name in ranks[0]["arms"]}
    for name, a in arms.items():
        log(f"30.5 all-to-all of {name}, {a['bytes']} bytes a rank ({card}): kernel arm "
            f"{spread(a['ms'])}, torch arm {spread(a['torch_ms'])}, bit-equal; bound "
            f"{a['bound_ms'] * 1e3:.2f} us (bytes)")
    used = max(x["device_bytes"][1] - x["device_bytes"][0] for x in ranks)
    numbers.update(rates=rates, arms=arms, profiles=prof, row4_launches=launches, run_s=run_s,
                   used_gib=used / 2**30,
                   peak_mib=max(x["peak_allocated"] for x in ranks) / 2**20,
                   wall_s=time.perf_counter() - t0)
    log(f"30: device memory in use {used / 2**30:.2f} GiB (all contexts), torch peak a rank "
        f"{numbers['peak_mib']:.0f} MiB; phase {numbers['wall_s']:.1f} s")
    return numbers


def apps_transfers(p: int) -> dict:
    """All-to-all transfers a call of each checked function (the plans'
    unpacked groups, the queue's packed one, and one a plane of
    `fft3d_slabs` plus the transpose back): p row 4 launches each."""
    dsde = {"exchange_accumulate": 3, "exchange_alltoall_baseline": 4,
            "exchange_reduce_scatter_baseline": 3, "exchange_queue": 1}
    out = {f"dsde {k}/{d}": v for k, v in dsde.items() for d in ("uniform", "skew")}
    out.update({"moe dispatch": 4, "moe combine": 3, "hashtable lookup": 5,
                "fft fft3d": 2, "fft fft3d_slabs": FFT_N // p + 1})
    out.update({f"hashtable insert{e + 1}": 3 for e in range(HT_EPOCHS + 1)})
    out["hashtable insert"] = 3
    return out


# ------------------------------------ the parallel layer over processes (31)
def grads_equal(torch, tree, stacked, at: tuple) -> bool:
    """Whether every leaf of `tree` is bit-equal to the block `at` of the
    matching stacked leaf (leaves in `tree_leaves` order)."""
    from repro_torch.train.optimizer import tree_leaves

    i, j = at
    return all(torch.equal(a, b[i:i + 1, j:j + 1])
               for a, b in zip(tree_leaves(tree), tree_leaves(stacked), strict=True))


def pp_put_row(torch, mesh, rma_ops, ref, nwords: int, hbm: float, axis: str = "data",
               phase: int = 31) -> dict:
    """Row 4's peer form on the `axis` sub-axis at `nwords` f32 (phase 31:
    P1's largest in-pod hop): bit-equal to its plain version on every rank;
    then the kernel alone (its launch, no fence; CUDA events) and its plain
    copy into the right neighbour's block, timed by rank 0 while the others
    wait at a barrier."""
    from repro_torch.kernels import common
    from repro_torch.procmesh import as_bytes

    sub = mesh.along(axis)
    g = torch.Generator(device=mesh.device).manual_seed(PROC_SEED + phase + mesh.rank)
    x = torch.randn(1, 1, nwords, device=mesh.device, generator=g)
    if not torch.equal(rma_ops.put_shift(x, 1, sub), ref.put_shift_ref(x, 1, sub)):
        raise AssertionError(f"{phase} rank {mesh.rank}: row 4's peer form on the {axis} "
                             "axis differs from its plain version")
    seg, off = sub.round(x.nbytes)
    stream, xb = common.current_stream(mesh.device.index), as_bytes(x)
    right = seg.view(sub.rank + 1, off, x.nbytes)
    out = {}
    mesh.barrier()
    if mesh.rank == 0:
        out = {"ms": time_ms(lambda: rma_ops._PEER_PUT(x.data_ptr(), seg.table_ptr, sub.p,
                                                       sub.rank, 1, off, nwords, stream)),
               "plain_ms": time_ms(lambda: right.copy_(xb)),
               "bound_ms": 2 * x.nbytes / hbm * 1e3, "bytes": 2 * x.nbytes}
    torch.cuda.synchronize()
    mesh.fence()
    return out


def pp_rank(mesh, ins: dict, hbm: float) -> dict:
    """Phase 31 in one rank's process of the {"pod": 2, "data": 2} grid: P1
    (the sync, then its arms in turns beside one flat ring over the same
    four ranks as one axis), P2, P3 (the ranks as a pod axis of 4), P4 (as
    the survivors' {"data": 2, "model": 2} grid) and row 13 (as one axis of
    4), each against the stacked run's results the parent shares; raises
    on any failure."""
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager, flatten
    from repro_torch.configs import get_config
    from repro_torch.core.epoch import SyncStats
    from repro_torch.core.rma import OpCounter
    from repro_torch.ft.elastic import elastic_restore
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ring_matmul import ops as rops
    from repro_torch.kernels.ring_matmul import ref as rref
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref
    from repro_torch.models import layers as L
    from repro_torch.parallel.compression import compress_decompress, init_compression_state
    from repro_torch.parallel.overlap import bucket_grads, overlapped_grad_sync
    from repro_torch.parallel.pipeline import PipelineConfig, pipeline_forward
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t0 = time.perf_counter()
    r, at = mesh.rank, mesh.coords
    out = {"rank": r, "coords": at}

    # P1: this rank's row, held to the stacked row before the sync
    row = tree_map(lambda g: g[at[0]:at[0] + 1, at[1]:at[1] + 1].clone(), ins["grads"])
    out["row_equal"] = grads_equal(torch, row, ins["grads"], at)
    n_leaves = len(tree_leaves(row))
    zero_rma_launches(rma_ops)
    held = mesh.barriers
    with SyncStats() as sync, OpCounter() as c:
        synced = overlapped_grad_sync(row, mesh)
    torch.cuda.synchronize()
    out["p1"] = {"launches": dict(rma_ops.launches), "barriers": mesh.barriers - held,
                 "ledger": {"ops": c.snapshot(), "plans": c.plans, "flushes": sync.flush_msgs},
                 "buckets": bucket_grads(row, mesh=mesh),
                 "equal": grads_equal(torch, synced, ins["synced"], at)}
    del synced
    flat = mesh.regrid({"data": PAR_RANKS})
    flat_row = tree_map(lambda g: g[0], row)
    zero_rma_launches(rma_ops)
    held = mesh.barriers
    overlapped_grad_sync(flat_row, flat, outer_axis=None)
    torch.cuda.synchronize()
    out["p1"]["flat"] = {"launches": dict(rma_ops.launches), "barriers": mesh.barriers - held}
    arms = {"h": lambda: overlapped_grad_sync(row, mesh),
            "f": lambda: overlapped_grad_sync(flat_row, flat, outer_axis=None)}
    times = {"h": [], "f": []}
    for order in PP_TURNS:
        for arm in order:
            times[arm].append(host_ms(torch, mesh, arms[arm], 1))
    out["p1"]["hier_ms"], out["p1"]["flat_ms"] = times["h"], times["f"]
    for arm in "hf":                 # a warm call's barriers: the segments have grown
        held = mesh.barriers
        arms[arm]()
        out["p1"]["warm_barriers_" + arm] = mesh.barriers - held
    del flat_row
    big = max(g.numel() for g in tree_leaves(row))
    out["put"] = pp_put_row(torch, mesh, rma_ops, ref, -(-big // 2), hbm)

    # P2: one int8 error-feedback round of this rank's own gradients
    dec, st, met = compress_decompress(row, init_compression_state(row))
    torch.cuda.synchronize()
    want_dec, want_res = ins["comp"][r]
    out["p2"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(dec) + tree_leaves(st.residual),
        tree_leaves(want_dec) + tree_leaves(want_res), strict=True))
    del row, dec, st
    torch.cuda.empty_cache()

    # P3: one stage a process, its own 8 layers' weights
    pod = mesh.regrid({"pod": PIPE_STAGES})
    cfg = get_config(MODEL_ARCH)
    per = cfg.n_layers // PIPE_STAGES
    stage = tree_map(lambda a: a[pod.rank:pod.rank + 1].clone(), ins["stages"])
    x_micro = ins["x_micro"].clone()
    _, stage_fn = stage_layers(torch, cfg, per)
    pcfg = PipelineConfig(PIPE_STAGES, PIPE_MICRO)
    L.set_attention_backend("cuda")
    try:
        with torch.no_grad():
            fops.launches = 0
            fops.launches_by_variant.update(wgmma=0, simt=0)
            zero_rma_launches(rma_ops)
            pout = pipeline_forward(stage_fn, stage, x_micro, pcfg, pod)
            torch.cuda.synchronize()
            out["p3"] = {"flash": fops.launches, "wgmma": fops.launches_by_variant["wgmma"],
                         "launches": dict(rma_ops.launches), "digest": digest(torch, pout),
                         "ms": [host_ms(torch, mesh, lambda: pipeline_forward(
                             stage_fn, stage, x_micro, pcfg, pod), 1)
                             for _ in range(PIPE_REPS)]}
    finally:
        L.set_attention_backend("torch")
    del stage, x_micro, pout

    # P4: the survivors' grid, this rank's blocks only
    grid = mesh.regrid(PP_GRID_ELASTIC)
    t1 = time.perf_counter()
    tree, extra, emesh, _ = elastic_restore(CheckpointManager(ins["ckpt"]), ins["like"],
                                            *PP_ELASTIC, mesh=grid)
    torch.cuda.synchronize()
    out["p4"] = {"s": time.perf_counter() - t1, "coords": grid.coords, "extra": extra,
                 "shape": emesh.shape,
                 "blocks": {k: (digest(torch, v), tuple(v.shape), str(v.device))
                            for k, v in flatten(tree)}}
    del tree

    # row 13 over processes: the ranks as one axis of RING_N
    ring = mesh.regrid({"model": RING_N})
    x_t = ins["ring_x"].clone()
    K, N = ins["ring_w"].shape
    w_r = ins["ring_w"].reshape(RING_N, K // RING_N, N)[ring.rank:ring.rank + 1].clone()
    rops.launches = 0
    rops.launches_by_variant.update(wgmma=0, simt=0)
    zero_rma_launches(rma_ops)
    y = rops.ring_matmul_ranks(x_t, w_r, ring)
    torch.cuda.synchronize()
    launches = {"ring_matmul": rops.launches, "wgmma": rops.launches_by_variant["wgmma"],
                **rma_ops.launches}
    plain = rref.ring_schedule_ref(x_t, w_r, ring)
    scale = float(plain.abs().max())
    out["ring"] = {
        "launches": launches, "scale": scale,
        "err_plain": float((y - plain).abs().max()),
        "err_stacked": float((y[0] - ins["ring_y"][ring.rank]).abs().max()),
        "three": all(torch.equal(rops.ring_matmul_ranks(x_t, w_r, ring), y) for _ in range(2)),
        "ms": host_ms(torch, ring, lambda: rops.ring_matmul_ranks(x_t, w_r, ring), RING_REPS),
        "plain_ms": host_ms(torch, ring, lambda: rref.ring_schedule_ref(x_t, w_r, ring),
                            RING_REPS),
        "allgather_matmul_ms": host_ms(torch, ring, lambda: torch.matmul(
            x_t.T, ring.all_gather(w_r)[0].reshape(K, N)), RING_REPS)}
    out["peak_allocated"] = torch.cuda.max_memory_allocated(mesh.device)
    out["wall_s"] = time.perf_counter() - t0
    ins.clear()          # release the parent's tensors before this process exits
    return out


def pp_inputs(torch, hbm: float, d: str) -> dict:
    """The stacked side of phase 31 in this process, on SmolLM-360M's fresh
    weights from TRAIN_SEED and one [4, 2048] batch: P1's four rows and the
    stacked grid sync, P2's round of each row, P3's stacked pipeline, P4's
    stacked restore of a layer-0 checkpoint saved under `d`, row 13 on
    Mesh(RING_N); the tensors a rank reads are shared with the ranks."""
    from repro_torch.ckpt.checkpoint import CheckpointManager, flatten
    from repro_torch.configs import get_config
    from repro_torch.core.epoch import SyncStats
    from repro_torch.core.perfmodel import DEFAULT_MODEL
    from repro_torch.core.rma import OpCounter
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.ft.elastic import elastic_restore
    from repro_torch.kernels.ring_matmul import ops as rops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.parallel.compression import compress_decompress, init_compression_state
    from repro_torch.parallel.overlap import (CollectiveStrategist, bucket_grads,
                                              overlapped_grad_sync)
    from repro_torch.parallel.pipeline import PipelineConfig, pipeline_forward
    from repro_torch.train.optimizer import init_opt_state, tree_leaves, tree_map

    t0 = time.perf_counter()
    model = build_model(get_config(MODEL_ARCH))
    params = model.init(TRAIN_SEED, device="cuda")
    cfg = model.cfg
    B, S = TRAIN_BATCH
    batch = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, S, B),
                                   device="cuda").batch_at(0)
    ins, st = {}, {}
    L.set_attention_backend("cuda")
    try:
        stacked, n_leaves = stacked_grads(torch, model, params, batch, PAR_GRID)
    finally:
        L.set_attention_backend("torch")
    mesh = Mesh(PAR_GRID, device="cuda")
    with SyncStats() as sync, OpCounter() as c:
        synced = overlapped_grad_sync(stacked, mesh)
    torch.cuda.synchronize()
    st["ledger"] = {"ops": c.snapshot(), "plans": c.plans, "flushes": sync.flush_msgs}
    st["buckets"] = bucket_grads(stacked, mesh=mesh)
    worst = 0.0
    for got, g in zip(tree_leaves(synced), tree_leaves(stacked)):
        scale = g.abs().sum((0, 1)).clamp_min(1e-30)
        worst = max(worst, float(((got[0, 0] - g.sum((0, 1))).abs() / scale).max()))
    if worst > PAR_F32:
        raise AssertionError(f"31 P1 stacked: |synced - sum| / sum|g_r| {worst:.3g} "
                             f"(bound {PAR_F32})")
    st["worst_sum"], st["n_leaves"] = worst, n_leaves
    st["nbytes"] = sum(g[0, 0].numel() * 4 for g in tree_leaves(stacked))
    st["hier_ms"] = sync_ms(torch, lambda: overlapped_grad_sync(stacked, mesh), len(PP_TURNS))
    strat = CollectiveStrategist()
    st["pick"] = strat.allreduce_plan(st["nbytes"], 2, 2)
    sizes = [g[0, 0].numel() * 4 for g in tree_leaves(stacked)]
    st["priced_hier_ms"] = sum(DEFAULT_MODEL.hierarchical_all_reduce(n, 2, 2)
                               for n in sizes) * 1e3
    st["priced_flat_ms"] = sum(DEFAULT_MODEL.all_reduce(n, PAR_RANKS) for n in sizes) * 1e3
    st["leaf_picks"] = dict(collections.Counter(strat.allreduce_plan(n, 2, 2) for n in sizes))
    ins["grads"], ins["synced"] = stacked, synced
    ins["comp"] = []
    for r in range(PAR_RANKS):
        i, j = divmod(r, PAR_GRID["data"])
        row = tree_map(lambda g, i=i, j=j: g[i:i + 1, j:j + 1], stacked)
        dec, res, _ = compress_decompress(row, init_compression_state(row))
        ins["comp"].append((dec, res.residual))
    torch.cuda.synchronize()

    # P3 stacked, and layer 0's MLP input for row 13
    per = cfg.n_layers // PIPE_STAGES
    stages = tree_map(lambda a: a.reshape((PIPE_STAGES, per) + tuple(a.shape[1:])),
                      params["blocks"])
    run_layers, stage_fn = stage_layers(torch, cfg, per)
    pcfg = PipelineConfig(PIPE_STAGES, PIPE_MICRO)
    pmesh = Mesh(PIPE_STAGES, "pod", device="cuda")
    real_mlp, taps = L.mlp, {}

    def tap(p, x, *args, **kw):
        if not taps:
            taps.update(x=x.detach().clone(), w_in=p["w_in"].detach().clone())
        return real_mlp(p, x, *args, **kw)

    L.set_attention_backend("cuda")
    try:
        with torch.no_grad():
            x = L.embed(params["tok"], batch["tokens"])
            ins["x_micro"] = x.reshape((PIPE_MICRO, B // PIPE_MICRO) + tuple(x.shape[1:]))
            pout = pipeline_forward(stage_fn, stages, ins["x_micro"], pcfg, pmesh)
            torch.cuda.synchronize()
            st["pipe_digests"] = [digest(torch, pout[s]) for s in range(PIPE_STAGES)]
            st["pipe_ms"] = sync_ms(torch, lambda: pipeline_forward(
                stage_fn, stages, ins["x_micro"], pcfg, pmesh), PIPE_REPS)
            L.mlp = tap
            try:
                run_layers(params["blocks"], 1, x)
            finally:
                L.mlp = real_mlp
    finally:
        L.set_attention_backend("torch")
    ins["stages"] = stages
    del pout, x

    # P4 stacked: a layer-0 checkpoint of these weights, restored onto the grid
    tree0 = layer0_state(params, init_opt_state(params))
    ckpt = os.path.join(d, "layer0")
    CheckpointManager(ckpt).save(0, tree0, extra={"step": 0}, blocking=True)
    like = tree_like(torch, tree0)
    del tree0
    tree, extra, emesh, pol = elastic_restore(CheckpointManager(ckpt), like, *PP_ELASTIC,
                                              device="cuda")
    sh = dict(flatten(pol.tree_shardings(like)))
    st["blocks"], n_blocks = {}, 0
    for key, v in flatten(tree):
        blocks = sh[key].blocks(v)
        tiled = torch.full_like(v, float("nan")) if v.is_floating_point() else v.clone()
        for c_, blk in blocks.items():
            tiled[sh[key].index(c_, v.shape)] = blk
            st["blocks"].setdefault(c_, {})[key] = (digest(torch, blk), tuple(blk.shape))
        if not torch.equal(tiled, v) or len(blocks) != math.prod(emesh.shape.values()):
            raise AssertionError(f"31 P4 stacked: {key}'s blocks do not tile it")
        n_blocks += len(blocks)
    st["extra"], st["emesh"], st["n_blocks"] = extra, emesh.shape, n_blocks
    st["specs"] = dict(collections.Counter(str(tuple(s.spec)) for s in sh.values()))
    ins["ckpt"], ins["like"] = ckpt, like
    del tree

    # row 13 stacked: T1's up projection shape at layer 0 of these weights
    xt = taps["x"].reshape(-1, taps["x"].shape[-1]).T.contiguous()      # [D, B*S]
    w = taps["w_in"]                                                    # [D, F]
    ws = w.reshape(RING_N, w.shape[0] // RING_N, w.shape[1])
    rmesh = Mesh(RING_N, device="cuda")
    ins["ring_x"], ins["ring_w"] = xt, w
    ins["ring_y"] = rops.ring_matmul_ranks(xt, ws, rmesh)
    st["ring_stacked_ms"] = time_ms(lambda: rops.ring_matmul_ranks(xt, ws, rmesh), reps=20)
    K, m = xt.shape
    flops = 2 * RING_N * m * K * w.shape[1]
    nbytes = xt.nbytes + w.nbytes + RING_N * m * w.shape[1] * 4
    st["ring_bound_ms"], st["ring_bound_by"] = max(
        (flops / BF16_FLOPS_PER_S * 1e3, "operations"), (nbytes / hbm * 1e3, "bytes"))
    st["ring_shape"] = {"x_t": tuple(xt.shape), "w": tuple(ws.shape), "plan": tuple(
        rops.plan(1, ws.shape[1], ws.shape[2]))}
    del params, stacked, synced
    torch.cuda.synchronize()
    st["inputs_s"] = time.perf_counter() - t0
    zero_rma_launches(rma_ops)
    return ins, st


def parallel_procs_phases(torch, hbm: float) -> dict:
    """Phase 31: phase 25's P1-P4 and row 13 with one rank a process, 4
    processes on the card as a grid `ProcMesh` {"pod": 2, "data": 2},
    against the stacked grid run of the same inputs in this process.
    Returns the phase's numbers and the kernel rows' launches."""
    import tempfile

    from repro_torch import procmesh
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    card = card_line()
    layers = get_config(MODEL_ARCH).n_layers
    log(f"phase 31: the parallel layer over {PAR_RANKS} processes time-sharing one card "
        f"({card}) as the grid {PP_GRID}; no link is crossed, so no time here is an NVLink "
        "time")
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        ins, st = pp_inputs(torch, hbm, d)
        t1 = time.perf_counter()
        ranks = procmesh.run(pp_rank, PAR_RANKS, device="cuda", args=(ins, hbm),
                             axes=PP_GRID, timeout=PP_TIMEOUT)
        run_s = time.perf_counter() - t1
    del ins
    gc.collect()
    torch.cuda.ipc_collect()         # the ranks are gone: release what they were lent
    torch.cuda.empty_cache()
    n = st["n_leaves"]
    for res in ranks:
        r, p1 = res["rank"], res["p1"]
        if not res["row_equal"]:
            raise AssertionError(f"31 P1 rank {r}: its gradient row differs from the stacked row")
        if not p1["equal"]:
            raise AssertionError(f"31 P1 rank {r}: the synced grads differ from the stacked row")
        if p1["ledger"] != st["ledger"] or p1["buckets"] != st["buckets"]:
            raise AssertionError(f"31 P1 rank {r}: ledger {p1['ledger']['ops']} / buckets "
                                 f"{len(p1['buckets'])} vs the stacked "
                                 f"{st['ledger']['ops']} / {len(st['buckets'])}")
        if p1["ledger"]["flushes"] != len(st["buckets"]):
            raise AssertionError(f"31 P1 rank {r}: {p1['ledger']['flushes']} flushes for "
                                 f"{len(st['buckets'])} buckets")
        if p1["launches"]["put_shift"] != 3 * n or sum(p1["launches"].values()) != 3 * n:
            raise AssertionError(f"31 P1 rank {r}: rma launches {p1['launches']}, want "
                                 f"put_shift {3 * n} (3 a leaf) and nothing else")
        if not res["p2"]:
            raise AssertionError(f"31 P2 rank {r}: the int8 round differs from the stacked row")
        p3 = res["p3"]
        want_puts = PIPE_MICRO + PIPE_STAGES - 1
        if p3["digest"] != st["pipe_digests"][r]:
            raise AssertionError(f"31 P3 rank {r}: the outputs differ from the stacked row")
        per = PIPE_MICRO * layers // PIPE_STAGES
        if p3["flash"] != per or p3["wgmma"] != per or p3["launches"]["put_shift"] != want_puts:
            raise AssertionError(f"31 P3 rank {r}: flash {p3['flash']} (wgmma {p3['wgmma']}), "
                                 f"want {per}; row 4 {p3['launches']}, want {want_puts}")
        p4 = res["p4"]
        want = st["blocks"][tuple(p4["coords"])]
        got = {k: v[:2] for k, v in p4["blocks"].items()}
        if got != want or p4["extra"] != st["extra"] or p4["shape"] != st["emesh"]:
            bad = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"31 P4 rank {r}: blocks {bad} differ from the stacked "
                                 "restore's at its coordinate")
        if any(dev.split(":")[0] != "cuda" for _, _, dev in p4["blocks"].values()):
            raise AssertionError(f"31 P4 rank {r}: a block restored off the card")
        rg = res["ring"]
        tol = RING_TOL * rg["scale"]
        if not (rg["err_plain"] <= tol and rg["err_stacked"] <= tol and rg["three"]):
            raise AssertionError(f"31 row 13 rank {r}: err vs plain {rg['err_plain']:.3g}, vs "
                                 f"the stacked row {rg['err_stacked']:.3g} (tol {tol:.3g}), "
                                 f"three calls bit-equal {rg['three']}")
        lc = rg["launches"]
        if (lc["ring_matmul"], lc["wgmma"], lc["put_shift"]) != (RING_N, RING_N, RING_N - 1):
            raise AssertionError(f"31 row 13 rank {r}: launches {lc}, want {RING_N} wgmma "
                                 f"and {RING_N - 1} put_shift")
    seen = {tuple(res["p4"]["coords"]) for res in ranks}
    if len(seen) != PAR_RANKS:
        raise AssertionError(f"31 P4: the ranks hold the coordinates {seen}")
    p1s = [res["p1"] for res in ranks]
    hier = [t for p in p1s for t in p["hier_ms"]]
    flat = [t for p in p1s for t in p["flat_ms"]]
    bar_h = p1s[0]["barriers"] / n
    bar_f = p1s[0]["flat"]["barriers"] / n
    warm_h, warm_f = p1s[0]["warm_barriers_h"] / n, p1s[0]["warm_barriers_f"] / n
    log(f"31 P1 grad sync over processes ({card}): {MODEL_ARCH} at full width, rank r's f32 "
        f"grads of row r of a {list(TRAIN_BATCH)} batch ({n} leaves, "
        f"{st['nbytes'] / 1e9:.3f} GB a rank), each rank's row checked against the stacked "
        f"row before the sync; every rank's result bit-equal to its row of the stacked grid "
        f"run (so within {st['worst_sum']:.3g} of sum|g_r| of the rows' sum, bound "
        f"{PAR_F32}); ledgers and buckets equal ({len(st['buckets'])} buckets, as many "
        f"flushes); row 4 peer launches a rank {p1s[0]['launches']['put_shift']} (3 a leaf), "
        f"host barriers a leaf {warm_h:g} in a warm call, {bar_h:g} in the first (the "
        f"segments grow); the flat ring over 4: {warm_f:g} and {bar_f:g}, row 4 launches "
        f"{p1s[0]['flat']['launches']['put_shift'] / n:g} a leaf")
    log(f"31 P1 timing, host ms a sync in turns (all ranks' samples): hierarchical "
        f"{spread(hier)}, flat ring over {PAR_RANKS} processes {spread(flat)}; the stacked "
        f"grid sync {spread(st['hier_ms'])}; select_allreduce({st['nbytes']}, 2, 2) = "
        f"{st['pick']!r} (priced hierarchical {st['priced_hier_ms']:.3f} ms, flat "
        f"{st['priced_flat_ms']:.3f} ms over the leaves; by leaf {st['leaf_picks']}); measured "
        f"faster over processes: {'hierarchical' if median(hier) < median(flat) else 'flat_ring'}")
    log(f"31 P2: every rank's int8 error-feedback round of its own gradients bit-equal to "
        f"the stacked row's (outputs and residuals)")
    pipe = [t for res in ranks for t in res["p3"]["ms"]]
    log(f"31 P3 GPipe over processes ({card}): {layers} layers as "
        f"{PIPE_STAGES} stages of {layers // PIPE_STAGES}, one a process "
        f"holding its stage's weights, {PIPE_MICRO} microbatches: every rank's outputs "
        f"bit-equal to the stacked pipeline's; flash launches a rank "
        f"{ranks[0]['p3']['flash']} (all wgmma, {sum(x['p3']['flash'] for x in ranks)} in all), "
        f"row 4 puts a rank {ranks[0]['p3']['launches']['put_shift']}; host ms {spread(pipe)} "
        f"beside the stacked {spread(st['pipe_ms'])}")
    log(f"31 P4 elastic restore over processes: {PP_ELASTIC[0]} survivors, prefer_model "
        f"{PP_ELASTIC[1]} -> {st['emesh']}, each rank's {len(ranks[0]['p4']['blocks'])} blocks "
        f"bit-equal to the stacked restore's at its coordinate, the four ranks' blocks tiling "
        f"every leaf ({st['n_blocks']} blocks; specs {st['specs']}); "
        f"{max(x['p4']['s'] for x in ranks):.2f} s (slowest rank)")
    rg = [res["ring"] for res in ranks]
    log(f"31 row 13 over processes ({card}): x_t {st['ring_shape']['x_t']}, w "
        f"{st['ring_shape']['w']} bf16 over one axis of {RING_N} processes, {RING_N} "
        f"wgmma launches ({st['ring_shape']['plan']}) and {RING_N - 1} row 4 hops a rank a "
        f"call; max abs err vs plain {max(x['err_plain'] for x in rg):.3g}, vs the stacked "
        f"kernel's row {max(x['err_stacked'] for x in rg):.3g} (tol {RING_TOL} x max |Y| = "
        f"{RING_TOL * max(x['scale'] for x in rg):.3g}); three calls bit-equal; host ms a "
        f"call: kernel ring {spread([x['ms'] for x in rg])}, plain ring_schedule_ref "
        f"{spread([x['plain_ms'] for x in rg])}, plain all-gather + torch.matmul "
        f"{spread([x['allgather_matmul_ms'] for x in rg])}; the stacked kernel "
        f"{st['ring_stacked_ms']:.3f} ms; bound {st['ring_bound_ms']:.4f} ms "
        f"({st['ring_bound_by']})")
    put = ranks[0]["put"]
    log(f"31 row 4 peer form on the data axis (rank 0 alone, {put['bytes'] // 2} bytes, P1's "
        f"largest in-pod hop): kernel {put['ms'] * 1e3:.1f} us, plain copy_ "
        f"{put['plain_ms'] * 1e3:.1f} us, bound {put['bound_ms'] * 1e3:.1f} us (bytes)")
    wall = time.perf_counter() - t0
    log(f"31: stacked side {st['inputs_s']:.1f} s, ranks' run {run_s:.1f} s, torch peak a rank "
        f"{max(x['peak_allocated'] for x in ranks) / 2**30:.2f} GiB; phase {wall:.1f} s")
    row4 = sum(x["p1"]["launches"]["put_shift"] + x["p3"]["launches"]["put_shift"]
               + x["ring"]["launches"]["put_shift"] for x in ranks)
    return {"card": card, "row4_launches": row4,
            "row11_launches": sum(x["p3"]["flash"] for x in ranks),
            "row13_launches": sum(x["ring"]["launches"]["ring_matmul"] for x in ranks),
            "row13_procs": {"ms": median([x["ms"] for x in rg]),
                            "plain_ms": median([x["plain_ms"] for x in rg]),
                            "allgather_matmul_ms": median([x["allgather_matmul_ms"] for x in rg]),
                            "stacked_ms": st["ring_stacked_ms"], "bound_ms": st["ring_bound_ms"],
                            "bound_by": st["ring_bound_by"],
                            "max_abs_err": max(x["err_plain"] for x in rg)},
            "row4_put": put,
            "P1": {"hier_ms": hier, "flat_ms": flat, "stacked_ms": st["hier_ms"],
                   "barriers_per_leaf": warm_h, "flat_barriers_per_leaf": warm_f,
                   "first_call_barriers_per_leaf": [bar_h, bar_f],
                   "put_launches_per_rank": p1s[0]["launches"]["put_shift"],
                   "pick": st["pick"], "priced_hier_ms": st["priced_hier_ms"],
                   "priced_flat_ms": st["priced_flat_ms"], "rel_err_sum": st["worst_sum"]},
            "P3": {"ms": pipe, "stacked_ms": st["pipe_ms"]},
            "P4": {"s": [x["p4"]["s"] for x in ranks], "blocks": st["n_blocks"]},
            "run_s": run_s, "wall_s": wall}


def parallel_procs_only() -> int:
    """``python3 chip_smoke.py --parallel-procs``: phase 31 alone, on the
    package beside this file (the kernels build first).  Prints the kernels
    line of rows 4 (peer), 11 and 13 with this phase's launches and times,
    then the result line."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    pp = parallel_procs_phases(torch, H100.hbm_bandwidth)
    # row 11 at the pipeline's attention shape: [1, 2048] a microbatch
    cfg = get_config(MODEL_ARCH)
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    S = TRAIN_BATCH[1]
    q, k, v = (torch.randn(1, h, S, cfg.hd, generator=g, device="cuda").to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    err = float((fops.flash_attention(q, k, v).float() - fref.attention_ref(q, k, v).float())
                .abs().max())
    if err > 2e-2:
        raise AssertionError(f"flash_attention at the pipeline's shape: {err:.3g} from plain")
    flash = time_flash(torch, F, fops, fref, q, k, v, H100.hbm_bandwidth)
    put, ring = pp.pop("row4_put"), pp.pop("row13_procs")
    rows = [{"name": "put_shift_peer", "route": KERNELS["put_shift_peer"][0],
             "source": KERNELS["put_shift_peer"][1], "replaces": KERNELS["put_shift_peer"][2],
             "launches": pp.pop("row4_launches"), "max_abs_err": 0.0, "ms": put["ms"],
             "plain_ms": put["plain_ms"], "bound_ms": put["bound_ms"], "bound_by": "bytes",
             "library_ms": put["plain_ms"]},
            {"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1], "replaces": KERNELS["flash_attention"][2],
             "launches": pp.pop("row11_launches"), "max_abs_err": err,
             **{key: flash[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}},
            {"name": "ring_matmul", "route": KERNELS["ring_matmul"][0],
             "source": KERNELS["ring_matmul"][1], "replaces": KERNELS["ring_matmul"][2],
             "launches": pp.pop("row13_launches"), "max_abs_err": ring["max_abs_err"],
             "ms": ring["ms"], "plain_ms": ring["plain_ms"], "bound_ms": ring["bound_ms"],
             "bound_by": ring["bound_by"], "library_ms": ring["allgather_matmul_ms"],
             "stacked_ms": ring["stacked_ms"], "over": "processes"}]
    log(f"parallel procs phase numbers: {json.dumps(pp)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def apps_procs_only() -> int:
    """``python3 chip_smoke.py --apps-procs``: phase 30 alone, on the package
    beside this file (the kernels build first).  Prints its numbers, then
    the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common

    log(card_line())
    build_all(common)
    numbers = apps_procs_phases(torch, H100.hbm_bandwidth)
    log(f"apps procs phase numbers: {json.dumps(numbers)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def disagg_procs_only() -> int:
    """``python3 chip_smoke.py --disagg-procs``: phase 29 alone, on the
    package beside this file (the kernels build first).  Prints the kernels
    line of its five rows, then the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    rows, numbers = disagg_procs_phases(torch, H100.hbm_bandwidth)
    log(f"disagg procs phase numbers: {json.dumps(numbers)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def procs_only() -> int:
    """``python3 chip_smoke.py --procs``: phase 28 alone, on the package
    beside this file (the kernels build first).  Prints the kernels line of
    its four rows, then the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common

    log(card_line())
    build_all(common)
    rows, numbers = procs_phases(torch, H100.hbm_bandwidth)
    log(f"procs phase numbers: {json.dumps(numbers)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tools_only() -> int:
    """``python3 chip_smoke.py --tools``: phase 27 alone, on the package
    beside this file (the kernels build first).  Prints one JSON line of
    its numbers, then the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    out = tools_phases(torch)
    print(json.dumps({"tree": ROOT, **out}, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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


def parallel_only() -> int:
    """``python3 chip_smoke.py --parallel``: phase 25 (P1-P4) alone, on the
    package beside this file, with SmolLM-360M's weights and moments fresh
    from the seed (no training run) and a layer-0 checkpoint of them.
    Prints one JSON line of its numbers."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    model = build_model(get_config(MODEL_ARCH))
    params = model.init(TRAIN_SEED, device="cuda")
    tree = layer0_state(params, init_opt_state(params))
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        CheckpointManager(os.path.join(d, "layer0")).save(0, tree, extra={"step": 0},
                                                          blocking=True)
        out = parallel_phases(torch, model, params, os.path.join(d, "layer0"), tree)
    print(json.dumps({"tree": ROOT, **out}), flush=True)
    return 0


# --------------------------------------------- phase 32: the count gate
def row_launches() -> dict:
    """Every stacked-mesh kernel row's launch count, by row name."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rmaq import ops as rmaq_ops

    return {"paged_attention": pa_ops.launches, "paged_attention_shift": pa_ops.shift_launches,
            "paged_gather": pg_ops.launches, **rma_ops.launches, **rmaq_ops.launches}


def zero_row_launches() -> None:
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_gather import ops as pg_ops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rmaq import ops as rmaq_ops

    pa_ops.launches = pa_ops.shift_launches = pg_ops.launches = 0
    zero_rma_launches(rma_ops)
    for k in rmaq_ops.launches:
        rmaq_ops.launches[k] = 0


def gate_set(name: str, docs: dict) -> dict:
    """Write `docs` under the reference's file names into a temporary
    directory and gate them; a violation raises SystemExit, uncaught."""
    from repro_torch.obs import drift, drift_docs

    with tempfile.TemporaryDirectory() as d:
        drift_docs.write(docs, d)
        log(f"32: set {name}")
        entries = drift.gate(d)
    if not entries:
        raise AssertionError(f"32: set {name}: no entries")
    gated = sum(e["gate"] for e in entries)
    log(f"32: set {name}: {len(entries)} entries, {gated} gated, "
        f"{len(entries) - gated} informational, 0 violations")
    return {"entries": len(entries), "gated": gated, "info": len(entries) - gated}


def drift_phase(torch, set_b: dict | None) -> dict:
    """Phase 32: set A driven here, on the card, each run's kernel launches
    by row counted from 0; set B from the full-width runs' records (None:
    set A only).  Returns the sets' entry counts, the launches by run and
    the phase's wall time."""
    from repro_torch.obs import drift_docs

    t0 = time.perf_counter()
    launches = {}

    def counted(name, fn):
        zero_row_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in row_launches().items() if v}
        log(f"32: {name}: {time.perf_counter() - t0:.1f} s in, launches {launches[name]}")
        return out

    out = {"A": gate_set("A", drift_docs.set_a("cuda", run=counted))}
    if not launches["rmem.fused"].get("paged_attention"):
        raise AssertionError(f"32: the fused decode launched no row 1: {launches}")
    if set_b is not None:
        out["B"] = gate_set("B", drift_docs.set_b(**set_b))
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 32: {out['wall_s']:.1f} s ({card_line()})")
    return out


def drift_only() -> int:
    """``python3 chip_smoke.py --drift``: phase 32's set A alone, on the
    package beside this file (rows 1, 3 and 4 build on first use).  Prints
    one JSON line of its numbers, then the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common

    log(card_line())
    build_all(common)
    out = drift_phase(torch, None)
    print(json.dumps({"tree": ROOT, **out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def conformance_only() -> int:
    """``python3 chip_smoke.py --conformance``: phase 26 alone, on the
    package beside this file (row 10 and rows 1-3 build on first use).
    Prints one JSON line of its numbers, then the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import common
    from repro_torch.serve import disagg

    build_all(common)
    out = conformance_phases(torch, disagg)
    print(json.dumps({"tree": ROOT, **out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ----------------------- phase 33: a model step split over the model axis
def tp_config(get_config):
    import dataclasses

    return dataclasses.replace(get_config(TP_ARCH), n_layers=TP_LAYERS)


def tp_std(cfg, path: str):
    """The std of a leaf's draw (None: the norm scales, ones): the port's
    init scales (an expert's or the shared expert's ``w_out`` at its own F,
    the router at d_model^-0.5), and 0.02 for the q/k/v biases (the port's
    init makes them 0), so that their split is exercised too."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "scale":
        return None
    if leaf in ("embed", "lm_head", "bq", "bk", "bv"):
        return 0.02
    if leaf != "w_out":
        return cfg.d_model ** -0.5
    f = (cfg.moe_d_ff if "/experts/" in path else cfg.moe_shared_ff if "/shared/" in path
         else cfg.d_ff)
    return f ** -0.5


def keyed_params(torch, cfg, seed: int, policy=None) -> dict:
    """Random bf16 weights (the MoE router f32) of a dense or moe `cfg` on
    the card, each leaf drawn one layer slice at a time from a
    `torch.Generator` keyed by (seed, leaf, layer).  Under a policy that
    splits the model over processes each slice is drawn whole and only this
    rank's block of it is kept, so the ranks hold the blocks of the very
    values a whole run makes, and no process holds more than one slice of
    a leaf beyond its blocks."""
    from repro_torch.ckpt.checkpoint import _unflatten_like, flatten
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.registry import F32_LEAVES

    shapes = build_model(cfg).init_shapes()
    cut = dict(flatten(policy.tree_shardings(shapes))) if policy is not None else {}
    out = {}
    for i, (path, leaf) in enumerate(flatten(shapes)):
        shape, std = tuple(leaf.shape), tp_std(cfg, path)
        stacked = path.startswith("blocks/")
        one = shape[1:] if stacked else shape
        at = (cut[path].index(policy.mesh.coords, shape)[1 if stacked else 0:]
              if path in cut else None)
        dst = None
        dtype = torch.float32 if path.rsplit("/", 1)[-1] in F32_LEAVES else torch.bfloat16
        for j in range(shape[0] if stacked else 1):
            if std is None:
                full = torch.ones(one, dtype=dtype, device="cuda")
            else:
                g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + i * 1_009 + j)
                full = L._normal(g, one, std, dtype, "cuda")
            blk = full if at is None else full[at]
            if not stacked:
                dst = blk.clone()
                break
            if dst is None:
                dst = torch.empty((shape[0],) + tuple(blk.shape), dtype=blk.dtype, device="cuda")
            dst[j] = blk
            del full, blk
        out[path] = dst
    return _unflatten_like(shapes, out)


def tp_bytes(torch, cfg, policy) -> dict:
    """The weight bytes a rank holds by the fitted specs: each leaf's block
    at this rank's coordinate; and the whole model's, split and whole."""
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.models import build_model

    shapes = build_model(cfg).init_shapes()
    out = {"rank": 0, "whole": 0, "split_whole": 0}
    for (path, leaf), (_, ns) in zip(flatten(shapes), flatten(policy.tree_shardings(shapes))):
        n = leaf.numel() * leaf.element_size()
        block = math.prod(len(range(*s.indices(d))) for s, d in
                          zip(ns.index(policy.mesh.coords, leaf.shape), leaf.shape))
        out["whole"] += n
        out["rank"] += block * leaf.element_size()
        if block != leaf.numel():
            out["split_whole"] += n
    return out


def tp_prompts(torch, cfg) -> list:
    g = torch.Generator(device="cuda").manual_seed(TP_SEED)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g, device="cuda")
            for n in TP_PLENS]


def tp_serve(torch, model, params, prompts: list, policy, tokens=None) -> dict:
    """Phase 33's main path, under `policy` (None: whole): make_prefill_step
    on each prompt alone (`forward_logits`, the flash kernel), Model.prefill
    of each into its own row of one cache made under the policy, then
    TP_STEPS make_serve_step steps over the rows, greedy or teacher-forced
    on `tokens` [TP_STEPS, rows].  Logits, the tokens fed and host ms."""
    from repro_torch.parallel.sharding import use_policy
    from repro_torch.train.train_step import make_prefill_step, make_serve_step

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    pre, serve = make_prefill_step(model, policy), make_serve_step(model, policy)
    fwd, fwd_ms = [], []
    for p in prompts:
        lg, ms = timed(lambda: pre(params, {"tokens": p[None]}))
        fwd.append(lg[0])
        fwd_ms.append(ms)
    with use_policy(policy):
        cache = model.init_cache(len(prompts), max(TP_PLENS) + TP_STEPS, device="cuda")
    last, pre_ms = [], []
    for b, p in enumerate(prompts):
        row = {"kv": {k: v[:, b:b + 1] for k, v in cache["kv"].items()},
               "len": torch.zeros((), dtype=torch.int32, device="cuda")}
        with torch.no_grad(), use_policy(policy):
            (lg, _), ms = timed(lambda: model.prefill(params, p[None], row))
        last.append(lg[0])
        pre_ms.append(ms)
    cache["len"] = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    tok = torch.stack(last).argmax(-1)
    fed, steps, step_ms = [], [], []
    for s in range(TP_STEPS):
        if tokens is not None:
            tok = tokens[s]
        fed.append(tok)
        (lg, cache), ms = timed(lambda: serve(params, tok, cache))
        steps.append(lg)
        step_ms.append(ms)
        tok = lg.argmax(-1)
    return {"forward": fwd, "prefill": torch.stack(last), "steps": torch.stack(steps),
            "tokens": torch.stack(fed), "forward_ms": fwd_ms, "prefill_ms": pre_ms,
            "step_ms": step_ms}


def tp_margin(torch, logits):
    """The top-2 margin of each row of logits [..., V] (f32)."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def tp_bounds(want: dict) -> dict:
    """Each part's bound: TP_REL of the whole run's max |logit| there (no
    bound for a run with no forward)."""
    out = {part: TP_REL * float(want[part].float().abs().max()) for part in ("prefill", "steps")}
    if want["forward"]:
        out["forward"] = TP_REL * max(float(b.float().abs().max()) for b in want["forward"])
    return out


def tp_check(torch, got: dict, want: dict) -> dict:
    """Max abs logit error of each part, and the count of argmax changes
    where the whole run's top-2 margin exceeds twice the part's bound."""
    bound = tp_bounds(want)
    pairs = {"forward": list(zip(got["forward"], want["forward"])),
             "prefill": [(got["prefill"], want["prefill"])],
             "steps": list(zip(got["steps"], want["steps"]))}
    out, flips = {}, 0
    for part, ab in pairs.items():
        if part not in bound:
            continue
        errs = [float((a.float() - b.float()).abs().max()) for a, b in ab]
        out[part] = max(errs)
        for a, b in ab:
            sure = tp_margin(torch, b) > 2 * bound[part]
            flips += int(((a.argmax(-1) != b.argmax(-1)) & sure).sum())
        if part == "steps":
            out["steps_by_step"] = errs
    out["argmax_flips_beyond_bound"] = flips
    return out


def tp_rank(mesh, ref: dict, hbm: float) -> dict:
    """Phase 33 in one rank's process of ProcMesh({"model": 4}): its blocks
    of the keyed weights, the main path under ShardingPolicy(mesh,
    fsdp=False) teacher-forced on the whole run's tokens (its launch counts
    zeroed before and read after), the logits held to the whole run's; then
    one decode-shape all-reduce timed beside `ProcMesh.psum` on the same
    bytes, and row 4's peer put at the all-reduce's chunk."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref as rma_ref
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import ShardingPolicy

    t0 = time.perf_counter()
    cfg = tp_config(get_config)
    model = build_model(cfg)
    policy = ShardingPolicy(mesh, fsdp=False)
    torch.cuda.reset_peak_memory_stats()
    params = keyed_params(torch, cfg, TP_SEED, policy)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "model_rank": policy.model_rank, "init_s": time.perf_counter() - t0,
           "bytes": sum(v.nbytes for v in flat_leaves(params).values()),
           "want_bytes": tp_bytes(torch, cfg, policy)}
    L.set_attention_backend("cuda")
    fops.launches = 0
    fops.launches_by_variant = {k: 0 for k in fops.launches_by_variant}
    zero_rma_launches(rma_ops)
    b0 = mesh.barriers
    try:
        with OpCounter() as c:
            run = tp_serve(torch, model, params, ref["prompts"], policy, ref["tokens"])
        torch.cuda.synchronize()
    finally:
        L.set_attention_backend("torch")
    out["launches"] = {"flash": fops.launches, "wgmma": fops.launches_by_variant["wgmma"],
                       **rma_ops.launches}
    out["puts"], out["barriers"] = c.puts, mesh.barriers - b0
    out["err"] = tp_check(torch, run, ref)
    out["tokens_equal"] = bool(torch.equal(run["tokens"], ref["tokens"]))
    for k in ("forward_ms", "prefill_ms", "step_ms"):
        out[k] = run[k]
    del run
    out["peak_allocated"] = torch.cuda.max_memory_allocated()

    # one all-reduce at the decode shape, beside psum's one round on the same bytes
    g = torch.Generator(device="cuda").manual_seed(TP_SEED + 1 + mesh.rank)
    y = torch.randn(len(TP_PLENS), 1, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    ring = policy.all_reduce(y)
    one = mesh.psum(y.float()[None], "model")[0].to(y.dtype)
    out["ar_vs_psum"] = float((ring.float() - one.float()).abs().max())
    b1 = mesh.barriers
    out["ar_ms"] = host_ms(torch, mesh, lambda: policy.all_reduce(y), TP_AR_REPS)
    b2 = mesh.barriers
    out["psum_ms"] = host_ms(torch, mesh, lambda: mesh.psum(y.float()[None], "model"),
                             TP_AR_REPS)
    b3 = mesh.barriers
    # host_ms runs the call once more before its timed reps, and one barrier
    out["ar_rounds"] = (b2 - b1 - 1) / (TP_AR_REPS + 1)
    out["psum_rounds"] = (b3 - b2 - 1) / (TP_AR_REPS + 1)
    out["ar_bytes"] = y.numel() * 4
    out["put"] = pp_put_row(torch, mesh, rma_ops, rma_ref, y.numel() // TP_RANKS, hbm,
                            axis="model", phase=33)
    out["s"] = time.perf_counter() - t0
    return out


def tp_serve_phases(torch, hbm: float) -> dict:
    """Phase 33: qwen1.5-110b at full width, 8 of 80 layers, split over
    ProcMesh({"model": 4}) in 4 processes on the card, against one process
    running the same keyed weights whole (run first, then freed).  Returns
    the phase's numbers and the kernel rows' launches."""
    from repro_torch import procmesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    card = card_line()
    cfg = tp_config(get_config)
    log(f"phase 33: {TP_ARCH} at full width, {TP_LAYERS} of 80 layers (reduced: depth only), "
        f"split over ProcMesh({TP_GRID}) with fsdp=False in {TP_RANKS} processes sharing one "
        f"card ({card}); no link is crossed")
    model = build_model(cfg)
    params = keyed_params(torch, cfg, TP_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    whole_bytes = sum(v.nbytes for v in flat_leaves(params).values())
    prompts = tp_prompts(torch, cfg)
    L.set_attention_backend("cuda")
    before = fops.launches
    try:
        want = tp_serve(torch, model, params, prompts, None)
    finally:
        L.set_attention_backend("torch")
    whole_flash = fops.launches - before
    fops.launches = before          # the comparison run's launches are not the path's
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ref = {"prompts": prompts, "tokens": want["tokens"], "forward": want["forward"],
           "prefill": want["prefill"], "steps": want["steps"]}
    t1 = time.perf_counter()
    ranks = procmesh.run(tp_rank, TP_RANKS, device="cuda", args=(ref, hbm), axes=TP_GRID,
                         timeout=TP_TIMEOUT)
    run_s = time.perf_counter() - t1
    margins = float(tp_margin(torch, want["steps"]).min())
    bounds = tp_bounds(want)
    scale = {k: v / TP_REL for k, v in bounds.items()}
    del ref
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()

    n_fwd = 2 * len(TP_PLENS) + TP_STEPS
    gather = 2 * -(-(TP_RANKS - 1) // 2)
    want_puts = n_fwd * ((1 + 2 * TP_LAYERS) * (TP_RANKS - 1 + gather) + gather)
    want_flash = len(TP_PLENS) * TP_LAYERS
    for res in ranks:
        r, e, lc = res["rank"], res["err"], res["launches"]
        wb = res["want_bytes"]
        if res["bytes"] != wb["rank"] or wb["rank"] != (wb["whole"] - wb["split_whole"]
                                                       + wb["split_whole"] // TP_RANKS):
            raise AssertionError(f"33 rank {r}: {res['bytes']} weight bytes, its blocks' "
                                 f"{wb}")
        if wb["whole"] != whole_bytes:
            raise AssertionError(f"33: the whole model is {whole_bytes} bytes, the specs "
                                 f"say {wb['whole']}")
        over = [k for k in bounds if e[k] > bounds[k]]
        if over or e["argmax_flips_beyond_bound"] or not res["tokens_equal"]:
            raise AssertionError(f"33 rank {r}: logits {e} vs the whole run (bounds {bounds}),"
                                 f" tokens fed equal {res['tokens_equal']}")
        if (lc["flash"], lc["wgmma"]) != (want_flash, want_flash):
            raise AssertionError(f"33 rank {r}: flash launches {lc['flash']} (wgmma "
                                 f"{lc['wgmma']}), want {want_flash}, all wgmma")
        if lc["put_shift"] != want_puts or res["puts"] != want_puts or any(
                lc[k] for k in lc if k not in ("flash", "wgmma", "put_shift")):
            raise AssertionError(f"33 rank {r}: rma launches {lc}, puts {res['puts']}, want "
                                 f"{want_puts} row 4 peer puts and nothing else")
        if res["ar_vs_psum"] > 2 ** -7 * 8:
            raise AssertionError(f"33 rank {r}: the ring all-reduce is {res['ar_vs_psum']:.3g} "
                                 "from psum's")
    if sorted(x["model_rank"] for x in ranks) != list(range(TP_RANKS)):
        raise AssertionError(f"33: model ranks {[x['model_rank'] for x in ranks]}")
    wb = ranks[0]["want_bytes"]
    steps = [t for x in ranks for t in x["step_ms"][1:]]
    fwd = [t for x in ranks for t in x["forward_ms"][1:]]
    pre = [t for x in ranks for t in x["prefill_ms"][1:]]
    errs = {k: max(x["err"][k] for x in ranks) for k in ("forward", "prefill", "steps")}
    log(f"33 whole run in this process ({card}): {whole_bytes / 1e9:.3f} GB of weights "
        f"(keyed init {init_s:.1f} s), peak {whole_peak / 2**30:.2f} GiB, {want_flash} flash "
        f"launches; ms: forward {[round(t, 2) for t in want['forward_ms']]}, prefill "
        f"{[round(t, 2) for t in want['prefill_ms']]}, decode step median "
        f"{median(want['step_ms'][1:]):.2f}; smallest top-2 margin of a step {margins:.4f}")
    log(f"33 split over {TP_RANKS} processes ({card}): each rank {wb['rank'] / 1e9:.3f} GB "
        f"of weights = the split leaves' 1/{TP_RANKS} ({wb['split_whole'] / 1e9:.3f} GB whole) "
        f"+ the whole ones ({(wb['whole'] - wb['split_whole']) / 1e9:.6f} GB); torch peak a "
        f"rank {[round(x['peak_allocated'] / 2**30, 2) for x in ranks]} GiB")
    log(f"33 logits vs the whole run, max abs over ranks: forward (4 prompts of {TP_PLENS}) "
        f"{errs['forward']:.4g}, prefill last {errs['prefill']:.4g}, {TP_STEPS} teacher-forced "
        f"decode steps {errs['steps']:.4g} (by step "
        f"{[round(max(x['err']['steps_by_step'][s] for x in ranks), 4) for s in range(TP_STEPS)]}"
        f"); the whole run's max |logit| {scale}, bounds (TP_REL = {TP_REL:g} of it) "
        f"{bounds}; argmax equal wherever the top-2 margin exceeds twice the bound")
    log(f"33 launches a rank: row 11 {want_flash} (all wgmma, 16 q / 2 KV heads of 128 a "
        f"rank), row 4 peer {want_puts} (= {n_fwd} forwards x ({1 + 2 * TP_LAYERS} all-reduces"
        f" x {TP_RANKS - 1 + gather} puts + 1 all-gather x {gather}), row 7 peer 0 (the "
        f"gather is the ring of row 4 puts); host barriers a rank {ranks[0]['barriers']}")
    log(f"33 host ms ({card}), all ranks' samples after each one's first: forward "
        f"(make_prefill_step) {spread(fwd)}, Model.prefill {spread(pre)}, decode step "
        f"{spread(steps)}; whole: decode step {median(want['step_ms'][1:]):.3f}")
    ar = [x["ar_ms"] for x in ranks]
    ps = [x["psum_ms"] for x in ranks]
    log(f"33 all-reduce at the decode shape ({ranks[0]['ar_bytes']} B f32 a rank, {card}): "
        f"ring {spread(ar)}, {ranks[0]['ar_rounds']:g} rounds (host barriers) a call; "
        f"ProcMesh.psum on the same bytes {spread(ps)}, {ranks[0]['psum_rounds']:g} round; "
        f"ring vs psum max abs {max(x['ar_vs_psum'] for x in ranks):.3g}")
    put = ranks[0]["put"]
    log(f"33 row 4 peer put at the all-reduce's chunk ({put['bytes'] // 2} B, rank 0 alone): "
        f"kernel {put['ms'] * 1e3:.1f} us, plain copy_ {put['plain_ms'] * 1e3:.1f} us, bound "
        f"{put['bound_ms'] * 1e3:.2f} us (bytes)")
    wall = time.perf_counter() - t0
    log(f"33: ranks' run {run_s:.1f} s (init {max(x['init_s'] for x in ranks):.1f} s), phase "
        f"{wall:.1f} s")
    return {"card": card, "row4_launches": sum(x["launches"]["put_shift"] for x in ranks),
            "row11_launches": sum(x["launches"]["flash"] for x in ranks),
            "row7_launches": sum(x["launches"]["ring_all_gather"] for x in ranks),
            "put": put, "reduced": {"n_layers": [80, TP_LAYERS]},
            "err": errs, "bounds": bounds, "max_logit": scale,
            "weights_gb_rank": wb["rank"] / 1e9,
            "weights_gb_whole": whole_bytes / 1e9,
            "peak_gib": [x["peak_allocated"] / 2**30 for x in ranks],
            "whole_peak_gib": whole_peak / 2**30,
            "forward_ms": fwd, "prefill_ms": pre, "step_ms": steps,
            "whole_step_ms": want["step_ms"], "whole_forward_ms": want["forward_ms"],
            "whole_prefill_ms": want["prefill_ms"], "whole_flash": whole_flash,
            "ar_ms": ar, "psum_ms": ps, "ar_rounds": ranks[0]["ar_rounds"],
            "psum_rounds": ranks[0]["psum_rounds"], "ar_bytes": ranks[0]["ar_bytes"],
            "barriers": ranks[0]["barriers"], "puts_per_rank": want_puts,
            "run_s": run_s, "wall_s": wall}


def tp_procs_only() -> int:
    """``python3 chip_smoke.py --tp-procs``: phase 33 alone, on the package
    beside this file (the kernels build first).  Prints the kernels line of
    rows 4 (peer) and 11 with this phase's launches and times (row 7's peer
    launches, none, among the numbers), then the result line."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    tp = tp_serve_phases(torch, H100.hbm_bandwidth)
    # row 11 at a rank's attention shape: 16 q / 2 KV heads, the longest prompt
    cfg = tp_config(get_config)
    g = torch.Generator(device="cuda").manual_seed(TP_SEED)
    S = max(TP_PLENS)
    q, k, v = (torch.randn(1, h // TP_RANKS, S, cfg.hd, generator=g, device="cuda")
               .to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    err = float((fops.flash_attention(q, k, v).float() - fref.attention_ref(q, k, v).float())
                .abs().max())
    if err > BF16_TOL:
        raise AssertionError(f"flash_attention at a rank's shape: {err:.3g} from plain")
    flash = time_flash(torch, F, fops, fref, q, k, v, H100.hbm_bandwidth)
    put = tp.pop("put")
    rows = [{"name": "put_shift_peer", "route": KERNELS["put_shift_peer"][0],
             "source": KERNELS["put_shift_peer"][1], "replaces": KERNELS["put_shift_peer"][2],
             "launches": tp.pop("row4_launches"), "max_abs_err": 0.0, "ms": put["ms"],
             "plain_ms": put["plain_ms"], "bound_ms": put["bound_ms"], "bound_by": "bytes",
             "library_ms": put["plain_ms"]},
            {"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1], "replaces": KERNELS["flash_attention"][2],
             "launches": tp.pop("row11_launches"), "max_abs_err": err,
             **{key: flash[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}}]
    log(f"tp procs phase numbers: {json.dumps(tp)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# -------------- phase 34: the train step split over {"data": 2, "model": 2}
def tt_config(get_config):
    import dataclasses

    return dataclasses.replace(get_config(TT_ARCH), n_layers=TT_LAYERS)


def tt_batches(torch, cfg) -> list:
    """The TT_STEPS global batches of the synthetic pipeline (the same on
    every process: it draws on the host)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline

    B, S = TRAIN_BATCH
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=TT_SEED),
                                  device="cuda")
    return [pipe.batch_at(i) for i in range(TT_STEPS)]


def tt_mu_per_grad(grad_norm: float) -> float:
    """Step 1's first moment over its gradient: AdamW from zero moments
    keeps (1 - b1) x the clipped gradient, clipped at the step's norm."""
    from repro_torch.train.optimizer import AdamWConfig

    opt = AdamWConfig(**TRAIN_OPT)
    return (1 - opt.b1) * min(1.0, opt.clip_norm / max(grad_norm, 1e-9))


def tt_puts(cfg) -> int:
    """Row 4 peer puts of one split train step a rank, from the schedule at
    tp = dp = 2 (`core.collectives`): a ring all-reduce over two ranks is 1
    reduce-scatter put and 2 all-gather puts (both directions of its one
    step), the vocabulary all-gather 2, an FSDP gather 1 (one direction)
    and its reduce-scatter 1.  Forward: the embedding's gather and
    all-reduce, each layer's 6 gathered leaves (wq, wk, wv, wo, w_in,
    w_out) and 2 all-reduces, the LM head's gather and vocabulary gather.
    The remat recomputation stops at a layer's last saved tensor: its 6
    gathers again and the attention's all-reduce.  Backward: 2 entry
    all-reduces and 6 reduce-scatters a layer, the LM head's entry and two
    reduce-scatters.  Then the data sum (one all-reduce) and the global
    norm (one all-reduce over the 4 ranks: 3 + 2 x 2 puts)."""
    ar, vocab, fg, rs = 3, 2, 1, 1
    leaves = 6 if cfg.mlp_type == "gelu" else 7
    layer = (leaves * fg + 2 * ar) + (leaves * fg + ar) + (2 * ar + leaves * rs)
    tok = 2 * fg + ar + vocab + ar + 2 * rs
    return tok + cfg.n_layers * layer + ar + 3 + 2 * 2


def tt_ulp(torch, w):
    """One bf16 ulp at each element's magnitude (the least subnormal's at 0)."""
    _, e = torch.frexp(w.float())
    return torch.where(w != 0, torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8),
                       torch.full_like(w, 2.0 ** -133, dtype=torch.float32))


def tt_rel(torch, a, want) -> float:
    """||a - want|| / ||want|| in f32, `want` moved to a's device."""
    want = want.to(a.device).float()
    return float((a.float() - want).norm() / want.norm().clamp_min(1e-30))


def tt_whole(torch, cfg, model, batches: list) -> dict:
    """The TT_STEPS steps whole in this process (backend "cuda"): losses,
    grad norms, lrs, host ms, flash launches a step, the peak; step 1's
    gradient (bf16) and the params after it, moved to the host (the
    ranks' processes map them from shared memory).  First the witness:
    step 1's gradient at the same params in f32, each bf16 run's distance
    from which says how far bf16 alone moves a leaf's gradient."""
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import layers as L
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_map
    from repro_torch.train.train_step import StepConfig, loss_and_grads, make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = keyed_params(torch, cfg, TT_SEED)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "loss": [], "grad_norm": [], "lr": [], "ms": [],
           "flash": [], "wgmma": [],
           "bytes": sum(v.nbytes for v in flat_leaves(params).values())}
    # the witness: step 1's gradient at the same params in f32 (backend "torch")
    t = time.perf_counter()
    p32 = tree_map(lambda v: v.float(), params)
    _, _, g32 = loss_and_grads(model, p32, batches[0], remat=True)
    del p32
    out["grads32"] = {k: v.cpu() for k, v in flatten(g32)}
    del g32
    out["witness_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), StepConfig(remat=True))
    before = fops.launches, fops.launches_by_variant["wgmma"]
    L.set_attention_backend("cuda")
    try:
        for i, batch in enumerate(batches):
            f0, w0 = fops.launches, fops.launches_by_variant["wgmma"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t) * 1e3)
            out["flash"].append(fops.launches - f0)
            out["wgmma"].append(fops.launches_by_variant["wgmma"] - w0)
            for k in ("loss", "grad_norm", "lr"):
                out[k].append(float(met[k]))
            if i == 0:
                c = tt_mu_per_grad(out["grad_norm"][0])
                g = {k: (v / c).to(torch.bfloat16) for k, v in flatten(opt.mu)}
                out["rel32"] = {k: tt_rel(torch, v, out["grads32"][k]) for k, v in g.items()}
                out["grads"] = {k: v.cpu() for k, v in g.items()}
                out["params"] = {k: v.cpu() for k, v in flatten(params)}
                del g
    finally:
        L.set_attention_backend("torch")
    # the comparison run's launches are not the path's
    fops.launches, fops.launches_by_variant["wgmma"] = before
    torch.cuda.synchronize()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["finite"] = all(bool(torch.isfinite(v).all()) for v in flat_leaves(params).values())
    return out


def tt_rank(mesh, ref: dict, hbm: float) -> dict:
    """Phase 34 in one rank's process of ProcMesh({"data": 2, "model": 2}):
    its 2-D blocks of the keyed weights, ZeRO-1 moments, TT_STEPS calls of
    `make_train_step` under `make_policy` (the launch counts zeroed before
    the steps and read after each), step 1's gradient and params held to
    the whole run's blocks, every block's digest after every step; then a
    profiled step and row 4's peer put at an FSDP gather's block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref as rma_ref
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import NamedSharding
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, make_train_step

    t0 = time.perf_counter()
    cfg = tt_config(get_config)
    model = build_model(cfg)
    policy = make_policy(mesh, cfg, SHAPES["train_4k"])
    torch.cuda.reset_peak_memory_stats()
    params = keyed_params(torch, cfg, TT_SEED, policy)
    opt = init_opt_state(params)
    specs = policy.flat_specs(model.init_shapes())
    batches = tt_batches(torch, cfg)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT), StepConfig(remat=True), policy)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "coords": mesh.coords, "init_s": time.perf_counter() - t0,
           "want_bytes": tp_bytes(torch, cfg, policy), "loss": [], "grad_norm": [], "lr": [],
           "ms": [], "rounds": [], "flash": [], "wgmma": [], "puts": [], "digests": [],
           "blocks": {p: NamedSharding(mesh, sp).index(mesh.coords, ref["shapes"][p])
                      for p, sp in specs.items()}}
    out["blocks"] = {p: [(s.start, s.stop) for s in v] for p, v in out["blocks"].items()}
    # the leaves whose block another rank holds too: a spec that leaves a grid axis out
    shared = {p for p, sp in specs.items()
              if not set(mesh.axis_names) <= {a for e in sp if e for a in
                                               (e if isinstance(e, tuple) else (e,))}}
    L.set_attention_backend("cuda")
    fops.launches = 0
    fops.launches_by_variant = {k: 0 for k in fops.launches_by_variant}
    zero_rma_launches(rma_ops)
    try:
        with OpCounter() as c:
            for i, batch in enumerate(batches):
                f0, w0, p0 = fops.launches, fops.launches_by_variant["wgmma"], c.puts
                torch.cuda.synchronize()
                mesh.barrier()
                b0, t = mesh.barriers, time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t) * 1e3)
                out["rounds"].append(mesh.barriers - b0)
                out["flash"].append(fops.launches - f0)
                out["wgmma"].append(fops.launches_by_variant["wgmma"] - w0)
                out["puts"].append(c.puts - p0)
                for k in ("loss", "grad_norm", "lr"):
                    out[k].append(float(met[k]))
                trees = {"params": params, "mu": opt.mu, "nu": opt.nu}
                out["digests"].append({f"{k}/{p}": digest(torch, v) for k, t in trees.items()
                                       for p, v in flatten(t) if p in shared})
                if i == 0:
                    out.update(tt_step1(torch, mesh, specs, params, opt.mu, ref,
                                        out["grad_norm"][0], out["lr"][0]))
        out["launches"] = {"flash": fops.launches, "wgmma": fops.launches_by_variant["wgmma"],
                           **rma_ops.launches}
        out["bytes"] = {k: sum(v.nbytes for v in flat_leaves(t).values())
                        for k, t in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}
        out["peak_allocated"] = torch.cuda.max_memory_allocated()
        # one more step under the profiler (its launches are not the path's)
        mesh.barrier()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step(params, opt, batches[-1])
            torch.cuda.synchronize()
            out["profiled_ms"] = (time.perf_counter() - t) * 1e3
        out["busy_ms"] = sum(self_us(e) for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    finally:
        L.set_attention_backend("torch")
    del params, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    D, F = cfg.d_model, cfg.d_ff
    out["put"] = pp_put_row(torch, mesh, rma_ops, rma_ref, D // 2 * F // 2 // 2, hbm,
                            axis="data", phase=34)
    out["s"] = time.perf_counter() - t0
    return out


def tt_step1(torch, mesh, specs: dict, params, mu, ref: dict, grad_norm: float,
             lr: float) -> dict:
    """Step 1 held to the whole run's, on this rank's blocks: every leaf's
    gradient's relative L2 distance, and the params' distance in units of
    its bound with the count of elements past it.  From one bf16 start,
    Adam's first step moves an element by lr x (g / (|g| + eps) + wd p):
    the two runs' f32 results differ by at most 2 lr, and each is rounded
    to bf16 by at most half an ulp of itself, so the bound is 2 lr plus
    one bf16 ulp at the larger of the two elements."""
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.parallel.sharding import NamedSharding

    rel, rel32, over, worst = {}, {}, 0, 0.0
    c = tt_mu_per_grad(grad_norm)
    for path, m in flatten(mu):
        g, at = m / c, NamedSharding(mesh, specs[path])
        rel[path] = tt_rel(torch, g.to(torch.bfloat16), at.local(ref["grads"][path]))
        rel32[path] = tt_rel(torch, g.to(torch.bfloat16), at.local(ref["grads32"][path]))
        del g
    for path, p in flatten(params):
        want = NamedSharding(mesh, specs[path]).local(ref["params"][path]).to(p.device)
        err = (p.float() - want.float()).abs() / (
            2 * lr + tt_ulp(torch, torch.maximum(p.abs(), want.abs())))
        over += int((err > 1).sum())
        worst = max(worst, float(err.max()))
        del err
    return {"grad_rel": rel, "grad_rel32": rel32, "param_over": over, "param_worst": worst}


def tt_train_phases(torch, hbm: float) -> dict:
    """Phase 34: starcoder2-15b at full width, 4 of 40 layers, trained over
    ProcMesh({"data": 2, "model": 2}) in 4 processes on the card under
    `make_policy`, against one process running the same 3 steps whole
    (run first; what the ranks compare against goes to the host, the
    card is freed).  Returns the phase's numbers and the kernel rows'
    launches."""
    from repro_torch import procmesh
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    card = card_line()
    cfg = tt_config(get_config)
    log(f"phase 34: {TT_ARCH} at full width, {TT_LAYERS} of 40 layers (reduced: depth only), "
        f"trained over ProcMesh({TT_GRID}) under make_policy (fsdp=True) in {TT_RANKS} "
        f"processes sharing one card ({card}); no link is crossed")
    model = build_model(cfg)
    batches = tt_batches(torch, cfg)
    want = tt_whole(torch, cfg, model, batches)
    ref = {"grads": want.pop("grads"), "params": want.pop("params"),
           "grads32": want.pop("grads32"),
           "shapes": {p: tuple(v.shape) for p, v in flatten(model.init_shapes())}}
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"34 whole run in this process ({card}): {want['bytes'] / 1e9:.3f} GB of weights "
        f"(keyed init {want['init_s']:.1f} s), peak {want['peak'] / 2**30:.2f} GiB, flash "
        f"{want['flash']} a step; losses {want['loss']}, grad norms {want['grad_norm']}, lr "
        f"{want['lr']}; ms a step {[round(t, 1) for t in want['ms']]}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left allocated here")
    t1 = time.perf_counter()
    ranks = procmesh.run(tt_rank, TT_RANKS, device="cuda", args=(ref, hbm), axes=TT_GRID,
                         timeout=TT_TIMEOUT)
    run_s = time.perf_counter() - t1
    del ref
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()

    want_puts = tt_puts(cfg)
    want_flash = 2 * TT_LAYERS
    bad = []                    # every check's failure, raised after the logs
    if not want["finite"] or want["flash"] != [want_flash] * TT_STEPS or \
            want["wgmma"] != want["flash"]:
        bad.append(f"whole run: finite {want['finite']}, flash {want['flash']} (wgmma "
                   f"{want['wgmma']}), want {want_flash} a step")
    for res in ranks:
        r, wb, lc = res["rank"], res["want_bytes"], res["launches"]
        if wb["whole"] != want["bytes"]:
            bad.append(f"the whole model is {want['bytes']} bytes, the specs say {wb['whole']}")
        if res["bytes"] != {"params": wb["rank"], "mu": 2 * wb["rank"], "nu": 2 * wb["rank"]}:
            bad.append(f"rank {r}: bytes {res['bytes']}, its blocks' {wb}")
        loss = [abs(a - b) for a, b in zip(res["loss"], want["loss"])]
        if max(loss) > TRAIN_LOSS_TOL or not all(math.isfinite(x) for x in res["loss"]):
            bad.append(f"rank {r}: losses {res['loss']} vs the whole run's {want['loss']}")
        gn = abs(res["grad_norm"][0] - want["grad_norm"][0]) / want["grad_norm"][0]
        over = {k: v for k, v in res["grad_rel"].items() if v > TRAIN_GRAD_REL}
        if over or gn > TRAIN_GRAD_REL:
            bad.append(f"rank {r}: step 1 gradient blocks past {TRAIN_GRAD_REL:g} relative L2: "
                       f"{over}; grad norm {res['grad_norm'][0]} vs {want['grad_norm'][0]}")
        if res["param_over"] or res["lr"][0] != want["lr"][0]:
            bad.append(f"rank {r}: {res['param_over']} param elements past 2 lr + 1 ulp after "
                       f"step 1 (worst {res['param_worst']:.3g} of it), lr {res['lr'][0]} vs "
                       f"{want['lr'][0]}")
        if res["flash"] != [want_flash] * TT_STEPS or res["wgmma"] != res["flash"]:
            bad.append(f"rank {r}: flash launches a step {res['flash']} (wgmma "
                       f"{res['wgmma']}), want {want_flash}, all wgmma")
        if res["puts"] != [want_puts] * TT_STEPS or lc["put_shift"] != want_puts * TT_STEPS \
                or any(lc[k] for k in lc if k not in ("flash", "wgmma", "put_shift")):
            bad.append(f"rank {r}: puts a step {res['puts']}, rma launches {lc}, want "
                       f"{want_puts} row 4 peer puts a step and nothing else")
    for s in range(TT_STEPS):
        held: dict = {}
        for res in ranks:
            for key, d in res["digests"][s].items():
                block = tuple(map(tuple, res["blocks"][key.split("/", 1)[1]]))
                held.setdefault((key, block), set()).add(d)
        split = [k for k, v in held.items() if len(v) > 1]
        if split:
            bad.append(f"step {s + 1}: ranks holding one block differ: {split[:6]}")
    if sorted(x["coords"] for x in ranks) != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        bad.append(f"coords {[x['coords'] for x in ranks]}")
    shared = sum(1 for k in ranks[0]["digests"][0]
                 if sum(1 for x in ranks if x["digests"][0][k] == ranks[0]["digests"][0][k]) > 1)
    wb = ranks[0]["want_bytes"]
    ms = [t for x in ranks for t in x["ms"][1:]]
    rounds = [x["rounds"] for x in ranks]
    busy = [x["busy_ms"] / x["profiled_ms"] for x in ranks]
    grad_rel = max(max(x["grad_rel"].values()) for x in ranks)
    by_leaf = {k: [round(max(x[f][k] for x in ranks), 4) for f in ("grad_rel", "grad_rel32")]
               + [round(want["rel32"][k], 4)] for k in ranks[0]["grad_rel"]}
    log(f"34 split over {TT_RANKS} processes ({card}): each rank {wb['rank'] / 1e9:.3f} GB of "
        f"weights + {2 * wb['rank'] / 1e9:.3f} GB a moment = its 2-D blocks by the fitted "
        f"specs; torch peak a rank {[round(x['peak_allocated'] / 2**30, 2) for x in ranks]} "
        f"GiB; init {max(x['init_s'] for x in ranks):.1f} s")
    log(f"34 vs the whole run: losses {[x['loss'] for x in ranks]} (max abs diff "
        f"{max(abs(a - b) for x in ranks for a, b in zip(x['loss'], want['loss'])):.3g}, "
        f"bound {TRAIN_LOSS_TOL:g}); step 1 grad norm {[x['grad_norm'][0] for x in ranks]} "
        f"vs {want['grad_norm'][0]}; worst leaf's gradient relative L2 {grad_rel:.4g} (bound "
        f"{TRAIN_GRAD_REL:g}); params after step 1 at most "
        f"{max(x['param_worst'] for x in ranks):.3g} of 2 lr + 1 ulp; {shared} leaves held "
        f"by several ranks, the same bits after every step")
    log(f"34 step 1's gradient by leaf, relative L2 [split vs whole, split vs f32, whole vs "
        f"f32] (max over ranks; the f32 witness {want['witness_s']:.1f} s): {by_leaf}")
    log(f"34 launches a rank a step: row 11 {want_flash} (all wgmma: "
        f"{cfg.n_heads // 2} q / {cfg.n_kv_heads // 2} KV heads of {cfg.hd}, 2 rows), row 4 "
        f"peer {want_puts} (tt_puts); nothing else")
    log(f"34 host ms a step ({card}), all ranks' steps after their first: {spread(ms)} "
        f"(first steps {[round(x['ms'][0], 1) for x in ranks]}); whole: "
        f"{[round(t, 1) for t in want['ms']]}; fenced rounds (host barriers) a step by rank "
        f"{rounds}; a profiled step's device busy share by rank "
        f"{[round(b, 4) for b in busy]} (sum {sum(busy):.3f}, the card's share if the contexts "
        f"never overlap)")
    if bad:
        raise AssertionError("34: " + "; ".join(bad))
    put = ranks[0]["put"]
    log(f"34 row 4 peer put at an FSDP gather's block ({put['bytes'] // 2} B, rank 0 alone): "
        f"kernel {put['ms'] * 1e3:.1f} us, plain copy_ {put['plain_ms'] * 1e3:.1f} us, bound "
        f"{put['bound_ms'] * 1e3:.2f} us (bytes)")
    wall = time.perf_counter() - t0
    log(f"34: ranks' run {run_s:.1f} s, phase {wall:.1f} s")
    return {"card": card, "row4_launches": sum(x["launches"]["put_shift"] for x in ranks),
            "row11_launches": sum(x["launches"]["flash"] for x in ranks), "put": put,
            "reduced": {"n_layers": [40, TT_LAYERS]}, "puts_per_step": want_puts,
            "loss": [x["loss"] for x in ranks], "whole_loss": want["loss"],
            "grad_norm": [x["grad_norm"] for x in ranks], "whole_grad_norm": want["grad_norm"],
            "grad_rel": grad_rel, "param_worst": max(x["param_worst"] for x in ranks),
            "weights_gb_rank": wb["rank"] / 1e9, "weights_gb_whole": want["bytes"] / 1e9,
            "peak_gib": [x["peak_allocated"] / 2**30 for x in ranks],
            "whole_peak_gib": want["peak"] / 2**30, "ms": [x["ms"] for x in ranks],
            "whole_ms": want["ms"], "rounds": rounds, "busy": busy,
            "profiled_ms": [x["profiled_ms"] for x in ranks], "run_s": run_s, "wall_s": wall}


def tt_procs_only() -> int:
    """``python3 chip_smoke.py --tp-train-procs``: phase 34 alone, on the
    package beside this file (the kernels build first).  Prints the kernels
    line of rows 4 (peer) and 11 with this phase's launches and times,
    then the result line."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    tt = tt_train_phases(torch, H100.hbm_bandwidth)
    # row 11 at a rank's attention shape: 24 q / 2 KV heads, its 2 rows
    cfg = tt_config(get_config)
    g = torch.Generator(device="cuda").manual_seed(TT_SEED)
    rows, S = TRAIN_BATCH[0] // TT_GRID["data"], TRAIN_BATCH[1]
    q, k, v = (torch.randn(rows, h // TT_GRID["model"], S, cfg.hd, generator=g, device="cuda")
               .to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    err = float((fops.flash_attention(q, k, v).float() - fref.attention_ref(q, k, v).float())
                .abs().max())
    if err > BF16_TOL:
        raise AssertionError(f"flash_attention at a rank's shape: {err:.3g} from plain")
    flash = time_flash(torch, F, fops, fref, q, k, v, H100.hbm_bandwidth)
    put = tt.pop("put")
    rows = [{"name": "put_shift_peer", "route": KERNELS["put_shift_peer"][0],
             "source": KERNELS["put_shift_peer"][1], "replaces": KERNELS["put_shift_peer"][2],
             "launches": tt.pop("row4_launches"), "max_abs_err": 0.0, "ms": put["ms"],
             "plain_ms": put["plain_ms"], "bound_ms": put["bound_ms"], "bound_by": "bytes",
             "library_ms": put["plain_ms"]},
            {"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1], "replaces": KERNELS["flash_attention"][2],
             "launches": tt.pop("row11_launches"), "max_abs_err": err,
             **{key: flash[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}}]
    log(f"tp train procs phase numbers: {json.dumps(tt)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------ phase 35: a KV cache split on its sequence over the model axis
def kv_config(get_config, layers=None):
    import dataclasses

    cfg = get_config(KV_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def kv_rows(policy, n: int) -> slice:
    """The rows of a global batch of `n` that this rank serves: its data
    coordinate's block (all of them without a data axis)."""
    if policy is None or "data" not in policy.mesh.shape:
        return slice(0, n)
    d, k = policy.mesh.coords[0], n // policy.mesh.shape["data"]
    return slice(d * k, (d + 1) * k)


def kv_serve(torch, model, params, prompts: list, max_seq: int, chunk: int, policy,
             tokens=None, fwd: bool = True) -> dict:
    """Phase 35's main path under `policy` (None: whole) for the rows it
    serves: make_prefill_step on each prompt's first KV_FWD tokens (the
    flash kernel; `fwd`), a cache of every prompt made under the policy,
    each prompt prefilled alone into its row in `chunk`-token chunks
    (the first from an empty row, the rest over the cache), then KV_STEPS
    make_serve_step steps over the rows, greedy or teacher-forced on
    `tokens` [KV_STEPS, rows].  Logits, tokens fed, host ms and fenced
    rounds (host barriers) a step."""
    from repro_torch.parallel.sharding import use_policy
    from repro_torch.train.train_step import make_prefill_step, make_serve_step

    mesh = None if policy is None else policy.mesh

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    rows = kv_rows(policy, len(prompts))
    mine = prompts[rows]
    pre, serve = make_prefill_step(model, policy), make_serve_step(model, policy)
    fwd_out, fwd_ms = [], []
    for p in (mine if fwd else []):
        lg, ms = timed(lambda: pre(params, {"tokens": p[None, :KV_FWD]}))
        fwd_out.append(lg[0])
        fwd_ms.append(ms)
    with use_policy(policy):
        cache = model.init_cache(len(prompts), max_seq, device="cuda")
    last, pre_ms = [], []
    for b, p in enumerate(mine):
        row = {**cache, "kv": {k: v[:, b:b + 1] for k, v in cache["kv"].items()},
               "len": torch.zeros((), dtype=torch.int32, device="cuda")}

        def chunks():
            for at in range(0, len(p), chunk):
                lg, new = model.prefill(params, p[None, at:at + chunk], row)
                row["len"] = new["len"]
            return lg

        with torch.no_grad(), use_policy(policy):
            lg, ms = timed(chunks)
        last.append(lg[0])
        pre_ms.append(ms)
    cache["len"] = torch.tensor([len(p) for p in mine], dtype=torch.int32, device="cuda")
    tok = torch.stack(last).argmax(-1)
    fed, steps, step_ms, rounds = [], [], [], []
    for s in range(KV_STEPS):
        if tokens is not None:
            tok = tokens[s, rows]
        fed.append(tok)
        b0 = 0 if mesh is None else mesh.barriers
        (lg, cache), ms = timed(lambda: serve(params, tok, cache))
        rounds.append(0 if mesh is None else mesh.barriers - b0)
        steps.append(lg)
        step_ms.append(ms)
        tok = lg.argmax(-1)
    return {"forward": fwd_out, "prefill": torch.stack(last), "steps": torch.stack(steps),
            "tokens": torch.stack(fed), "forward_ms": fwd_ms, "prefill_ms": pre_ms,
            "step_ms": step_ms, "rounds": rounds, "cache": cache}


def kv_schedule(cfg, tp: int, dp: int, fsdp: bool, kv_split: bool) -> dict:
    """A rank's (puts, all-to-alls) of each call of the path: a ring
    all-reduce over tp is tp - 1 + 2 ceil((tp - 1) / 2) puts, an
    all-gather 2 ceil((tp - 1) / 2), an FSDP gather over two data ranks
    one (one direction), an all-to-all one collective.  The forward: the
    embedding's all-reduce, 2 a layer, the vocabulary's all-gather (and
    under FSDP 7 leaves a layer and the 2 of ``tok``).  A prefill chunk
    from an empty row adds the K/V rows' gather a layer where ``wk`` is
    split; a chunk over the cache and a decode step add q's gather and
    the partials' all-to-all a layer."""
    ag = 2 * -(-(tp - 1) // 2)
    ar = tp - 1 + ag
    fg = int(fsdp and dp > 1)
    forward = 2 * fg + ar + cfg.n_layers * (7 * fg + 2 * ar) + ag
    first = forward + cfg.n_layers * ag * kv_split
    return {"forward": (forward, 0), "first": (first, 0),
            "over": (first + cfg.n_layers * ag, cfg.n_layers)}


def kv_rank(mesh, ref: dict, part: int, hbm: float) -> dict:
    """Phase 35 in one rank's process: its blocks of the keyed weights
    under the reference's `make_policy` (part 1: chatglm3-6b whole over
    {"model": 4} for decode_32k; part 2: its first KV_GRID_LAYERS layers
    over KV_GRID for long_500k), the main path teacher-forced on the whole
    run's tokens with its launch counts zeroed before and read after, the
    logits held to the whole run's, the cache's bytes and layer 0's block;
    part 1 then row 4's peer put at the partials' all-to-all block."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref as rma_ref
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cfg = kv_config(get_config, None if part == 1 else KV_GRID_LAYERS)
    model = build_model(cfg)
    policy = make_policy(mesh, cfg, SHAPES["decode_32k" if part == 1 else "long_500k"])
    torch.cuda.reset_peak_memory_stats()
    params = keyed_params(torch, cfg, KV_SEED, policy)
    torch.cuda.synchronize()
    rows = kv_rows(policy, len(ref["prompts"]))
    out = {"rank": mesh.rank, "model_rank": policy.model_rank, "rows": [rows.start, rows.stop],
           "init_s": time.perf_counter() - t0, "kv_seq_shard": policy.kv_seq_shard,
           "fsdp": policy.gathers_data,
           "bytes": sum(v.nbytes for v in flat_leaves(params).values()),
           "want_bytes": tp_bytes(torch, cfg, policy)}
    L.set_attention_backend("cuda")
    fops.launches = 0
    fops.launches_by_variant = {k: 0 for k in fops.launches_by_variant}
    zero_rma_launches(rma_ops)
    b0 = mesh.barriers
    try:
        with OpCounter() as c:
            run = kv_serve(torch, model, params, ref["prompts"], ref["max_seq"], ref["chunk"],
                           policy, ref["tokens"], fwd=part == 1)
        torch.cuda.synchronize()
    finally:
        L.set_attention_backend("torch")
    out["launches"] = {"flash": fops.launches, "wgmma": fops.launches_by_variant["wgmma"],
                       **rma_ops.launches}
    out["puts"], out["colls"], out["barriers"] = c.puts, c.colls, mesh.barriers - b0
    out["err"] = tp_check(torch, run, {"forward": ref["forward"][rows],
                                       "prefill": ref["prefill"][rows],
                                       "steps": ref["steps"][:, rows]})
    out["tokens_equal"] = bool(torch.equal(run["tokens"], ref["tokens"][:, rows]))
    for k in ("forward_ms", "prefill_ms", "step_ms", "rounds"):
        out[k] = run[k]
    cache = run.pop("cache")
    out["blocks"] = cache.get("kv_seq_blocks", 1)
    out["cache_bytes"] = sum(v.nbytes for v in cache["kv"].values())
    out["cache_shape"] = list(cache["kv"]["k"].shape)
    # layer 0's block against the whole run's same rows and positions
    n = cache["kv"]["k"].shape[2]
    lo = policy.model_rank * n if out["blocks"] > 1 else 0
    out["layer0_diff"] = sum(int((cache["kv"][k][0] != ref["layer0"][k][rows, lo:lo + n])
                                 .sum()) for k in ("k", "v"))
    del run, cache
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    if part == 1:
        # row 4 at the partials' all-to-all block of a decode step
        block = len(ref["prompts"]) * (cfg.n_heads // KV_RANKS) * (cfg.hd + 2)
        out["put"] = pp_put_row(torch, mesh, rma_ops, rma_ref, block, hbm, axis="model",
                                phase=35)
    out["s"] = time.perf_counter() - t0
    return out


def kv_whole(torch, cfg, prompts: list, max_seq: int, chunk: int, fwd: bool) -> tuple:
    """The whole run in this process (backend "cuda"): keyed weights, the
    path, then the weights freed.  What the ranks are held to (its
    logits, greedy tokens and layer 0's K/V rows, on the card for them)
    and its numbers."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = keyed_params(torch, cfg, KV_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    whole_bytes = sum(v.nbytes for v in flat_leaves(params).values())
    L.set_attention_backend("cuda")
    before = fops.launches
    try:
        want = kv_serve(torch, model, params, prompts, max_seq, chunk, None, fwd=fwd)
    finally:
        L.set_attention_backend("torch")
    flash = fops.launches - before
    fops.launches = before          # the comparison run's launches are not the path's
    torch.cuda.synchronize()
    cache = want.pop("cache")
    nums = {"init_s": init_s, "weights_gb": whole_bytes / 1e9, "flash": flash,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "cache_bytes": sum(v.nbytes for v in cache["kv"].values()),
            "forward_ms": want["forward_ms"], "prefill_ms": want["prefill_ms"],
            "step_ms": want["step_ms"], "margin": float(tp_margin(torch, want["steps"]).min())}
    ref = {"prompts": prompts, "max_seq": max_seq, "chunk": chunk, "tokens": want["tokens"],
           "forward": want["forward"], "prefill": want["prefill"], "steps": want["steps"],
           "layer0": {k: v[0].clone() for k, v in cache["kv"].items()}}
    del params, cache, want
    gc.collect()
    torch.cuda.empty_cache()
    return ref, nums


def kv_part(torch, part: int, hbm: float, card: str, full: bool = False) -> dict:
    """One part of phase 35: the whole run here, then KV_RANKS processes
    on the card; every check; returns the part's numbers.  Part 1 at
    KV_32K's decode_32k length where `full`, else at KV_MAX_SEQ."""
    from repro_torch import procmesh
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    layers = None if part == 1 else KV_GRID_LAYERS
    cfg = kv_config(get_config, layers)
    max_seq, plens, chunk = (KV_32K if full else (KV_MAX_SEQ, KV_PLENS, KV_CHUNK)) \
        if part == 1 else (KV_GRID_SEQ, KV_GRID_PLENS, KV_CHUNK)
    grid = {"model": KV_RANKS} if part == 1 else KV_GRID
    g = torch.Generator(device="cuda").manual_seed(KV_SEED + part)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g, device="cuda")
               for n in plens]
    ref, whole = kv_whole(torch, cfg, prompts, max_seq, chunk, fwd=part == 1)
    t1 = time.perf_counter()
    ranks = procmesh.run(kv_rank, KV_RANKS, device="cuda", args=(ref, part, hbm), axes=grid,
                         timeout=KV_TIMEOUT)
    run_s = time.perf_counter() - t1
    bounds = tp_bounds(ref)
    del ref
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()

    tp, dp = grid["model"], grid.get("data", 1)
    sched = kv_schedule(cfg, tp, dp, True, cfg.n_kv_heads % tp == 0)
    n_rows = len(plens) // dp
    n_chunks = sum(-(-n // chunk) for n in plens[:n_rows])   # the same on every rank
    n_fwd = n_rows if part == 1 else 0
    want_puts = (n_fwd * sched["forward"][0] + n_rows * sched["first"][0]
                 + (n_chunks - n_rows + KV_STEPS) * sched["over"][0])
    want_colls = (n_chunks - n_rows + KV_STEPS) * sched["over"][1]
    want_flash = n_fwd * cfg.n_layers
    for res in ranks:
        r, e, lc, wb = res["rank"], res["err"], res["launches"], res["want_bytes"]
        if res["bytes"] != wb["rank"]:
            raise AssertionError(f"35.{part} rank {r}: {res['bytes']} weight bytes, its "
                                 f"blocks' {wb}")
        over = [k for k in bounds if e[k] > bounds[k]]
        if over or e["argmax_flips_beyond_bound"] or not res["tokens_equal"]:
            raise AssertionError(f"35.{part} rank {r}: logits {e} vs the whole run (bounds "
                                 f"{bounds}), tokens fed equal {res['tokens_equal']}")
        if (not res["kv_seq_shard"] or res["blocks"] != tp
                or res["cache_bytes"] * tp * dp != whole["cache_bytes"]):
            raise AssertionError(f"35.{part} rank {r}: kv_seq_shard {res['kv_seq_shard']}, "
                                 f"{res['blocks']} sequence blocks, cache {res['cache_bytes']} "
                                 f"B of the whole {whole['cache_bytes']}")
        if part == 1 and res["layer0_diff"]:
            raise AssertionError(f"35.1 rank {r}: layer 0's cache block differs from the "
                                 f"whole run's in {res['layer0_diff']} entries")
        if (lc["flash"], lc["wgmma"]) != (want_flash, want_flash):
            raise AssertionError(f"35.{part} rank {r}: flash launches {lc['flash']} (wgmma "
                                 f"{lc['wgmma']}), want {want_flash}, all wgmma")
        if (res["puts"], res["colls"]) != (want_puts, want_colls) or lc["put_shift"] != \
                want_puts + tp * want_colls or any(
                    lc[k] for k in lc if k not in ("flash", "wgmma", "put_shift")):
            raise AssertionError(f"35.{part} rank {r}: rma launches {lc}, puts {res['puts']}, "
                                 f"all-to-alls {res['colls']}, want {want_puts} puts and "
                                 f"{want_colls} all-to-alls of {tp} row 4 peer puts")
    if sorted((x["rows"][0], x["model_rank"]) for x in ranks) != sorted(
            (d * n_rows, m) for d in range(dp) for m in range(tp)):
        raise AssertionError(f"35.{part}: ranks' rows and model ranks "
                             f"{[(x['rows'], x['model_rank']) for x in ranks]}")
    steps = [t for x in ranks for t in x["step_ms"][1:]]
    pre = [t for x in ranks for t in x["prefill_ms"]]
    rounds = sorted({n for x in ranks for n in x["rounds"][1:]})
    errs = {k: max(x["err"][k] for x in ranks) for k in bounds}
    wb = ranks[0]["want_bytes"]
    name = f"{cfg.name} ({cfg.n_layers} layers)"
    log(f"35.{part} whole run in this process ({card}): {name}, {whole['weights_gb']:.3f} GB "
        f"of weights (keyed init {whole['init_s']:.1f} s), cache {whole['cache_bytes']} B "
        f"({len(plens)} rows x {max_seq}), peak {whole['peak_gib']:.2f} GiB, "
        f"{whole['flash']} flash launches; ms: forward {[round(t, 1) for t in whole['forward_ms']]}"
        f", prefill {[round(t, 1) for t in whole['prefill_ms']]} (prompts {list(plens)}, "
        f"chunks of {chunk}), decode step {spread(whole['step_ms'][1:])}; smallest top-2 "
        f"margin of a step {whole['margin']:.4f}")
    log(f"35.{part} split over {KV_RANKS} processes as {grid} ({card}): each rank "
        f"{wb['rank'] / 1e9:.3f} GB of weights, cache {ranks[0]['cache_bytes']} B = 1/{tp * dp} "
        f"of the whole ({ranks[0]['cache_shape']} a leaf, {ranks[0]['blocks']} sequence blocks"
        f"), layer 0's block vs the whole run's: {[x['layer0_diff'] for x in ranks]} entries "
        f"differ; torch peak a rank {[round(x['peak_allocated'] / 2**30, 2) for x in ranks]} GiB")
    log(f"35.{part} logits vs the whole run, max abs over ranks {errs}, bounds (TP_REL = "
        f"{TP_REL:g} of the whole run's max |logit|) {bounds}; argmax equal wherever the "
        f"top-2 margin exceeds twice the bound")
    log(f"35.{part} launches a rank: row 11 {want_flash} (all wgmma), row 4 peer "
        f"{want_puts + tp * want_colls} (= {want_puts} ring puts + {want_colls} all-to-alls x "
        f"{tp}); fenced rounds (host barriers) a decode step {rounds}, a rank in all "
        f"{ranks[0]['barriers']}")
    log(f"35.{part} host ms ({card}), all ranks' samples: prefill of a prompt {spread(pre)} "
        f"(whole {[round(t, 1) for t in whole['prefill_ms']]}), decode step after each one's "
        f"first {spread(steps)} (whole {spread(whole['step_ms'][1:])})")
    wall = time.perf_counter() - t0
    log(f"35.{part}: ranks' run {run_s:.1f} s (init {max(x['init_s'] for x in ranks):.1f} s), "
        f"part {wall:.1f} s")
    return {"row4_launches": sum(x["launches"]["put_shift"] for x in ranks),
            "row11_launches": sum(x["launches"]["flash"] for x in ranks),
            "put": ranks[0].get("put"), "layers": cfg.n_layers, "max_seq": max_seq,
            "prompts": list(plens), "err": errs, "bounds": bounds,
            "cache_bytes_rank": ranks[0]["cache_bytes"], "cache_bytes_whole": whole["cache_bytes"],
            "layer0_diff": [x["layer0_diff"] for x in ranks],
            "weights_gb_rank": wb["rank"] / 1e9, "weights_gb_whole": whole["weights_gb"],
            "peak_gib": [x["peak_allocated"] / 2**30 for x in ranks],
            "whole_peak_gib": whole["peak_gib"], "prefill_ms": pre, "step_ms": steps,
            "whole_prefill_ms": whole["prefill_ms"], "whole_step_ms": whole["step_ms"],
            "whole_forward_ms": whole["forward_ms"],
            "forward_ms": [t for x in ranks for t in x["forward_ms"]],
            "rounds_per_step": rounds, "puts_per_rank": want_puts,
            "all_to_alls_per_rank": want_colls, "run_s": run_s, "wall_s": wall}


def kv_seq_phases(torch, hbm: float, full: bool = False) -> dict:
    """Phase 35: chatglm3-6b at its published widths and depth served over
    ProcMesh({"model": 4}) with its KV cache split on the sequence (part
    1; at decode_32k's length where `full`), then its first KV_GRID_LAYERS
    layers over KV_GRID (part 2), each against one process running the
    same keyed weights whole.  Returns both parts' numbers and the kernel
    rows' launches."""
    t0 = time.perf_counter()
    card = card_line()
    log(f"phase 35: {KV_ARCH} at full width, part 1 all 28 layers over ProcMesh({{'model': "
        f"{KV_RANKS}}}) under make_policy(decode_32k) (2 KV heads < 4: the cache's sequence "
        f"over model), max_seq {KV_32K[0] if full else KV_MAX_SEQ}"
        f"{'' if full else ' (reduced from 32,768)'}; part 2 {KV_GRID_LAYERS} of 28 layers "
        f"(reduced: depth) over {KV_GRID} under make_policy(long_500k), max_seq "
        f"{KV_GRID_SEQ}; {KV_RANKS} processes sharing one card ({card})")
    one = kv_part(torch, 1, hbm, card, full)
    two = kv_part(torch, 2, hbm, card)
    wall = time.perf_counter() - t0
    log(f"35: phase {wall:.1f} s")
    return {"card": card, "row4_launches": one.pop("row4_launches") + two.pop("row4_launches"),
            "row11_launches": one.pop("row11_launches") + two.pop("row11_launches"),
            "put": one.pop("put"), "part1": one, "part2": {k: v for k, v in two.items()
                                                          if k != "put"},
            "wall_s": wall}


def kv_seq_only() -> int:
    """``python3 chip_smoke.py --kv-seq-procs [--decode-32k]``: phase 35
    alone, on the package beside this file (the kernels build first); with
    ``--decode-32k`` part 1 at decode_32k's 32,768 positions (KV_32K).
    Prints the kernels line of rows 4 (peer) and 11 with this phase's
    launches and times (row 4 at the partials' all-to-all block, row 11 at
    a rank's attention shape in part 1), then the result line."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    kv = kv_seq_phases(torch, H100.hbm_bandwidth, full="--decode-32k" in sys.argv[2:])
    # row 11 at a rank's attention shape in part 1: 8 q heads, each with its
    # K/V head selected from the 2 whole ones, the forward's KV_FWD tokens
    cfg = kv_config(get_config)
    g = torch.Generator(device="cuda").manual_seed(KV_SEED)
    q, k, v = (torch.randn(1, cfg.n_heads // KV_RANKS, KV_FWD, cfg.hd, generator=g,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    err = float((fops.flash_attention(q, k, v).float() - fref.attention_ref(q, k, v).float())
                .abs().max())
    if err > BF16_TOL:
        raise AssertionError(f"flash_attention at a rank's shape: {err:.3g} from plain")
    flash = time_flash(torch, F, fops, fref, q, k, v, H100.hbm_bandwidth)
    put = kv.pop("put")
    rows = [{"name": "put_shift_peer", "route": KERNELS["put_shift_peer"][0],
             "source": KERNELS["put_shift_peer"][1], "replaces": KERNELS["put_shift_peer"][2],
             "launches": kv.pop("row4_launches"), "max_abs_err": 0.0, "ms": put["ms"],
             "plain_ms": put["plain_ms"], "bound_ms": put["bound_ms"], "bound_by": "bytes",
             "library_ms": put["plain_ms"]},
            {"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1], "replaces": KERNELS["flash_attention"][2],
             "launches": kv.pop("row11_launches"), "max_abs_err": err,
             **{key: flash[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}}]
    log(f"kv seq procs phase numbers: {json.dumps(kv)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------ phase 36: the MoE layer split over the model axis
def ms_config(get_config, part: int):
    import dataclasses

    return dataclasses.replace(get_config(MS_ARCHS[part - 1]), n_layers=MS_LAYERS[part - 1])


class SlotTap(RouteTap):
    """A RouteTap that also keeps each dispatch as the MoE layer used it
    (`models.moe.Routing`: the choices, forced or the router's own, their
    slots and overflow flags), in the order the layers route."""

    used = None

    def _route(self, params, xt, top_k, capacity_factor=1.25):
        r = super()._route(params, xt, top_k, capacity_factor)
        if self.used is not None:
            self.used.append(r)
        return r

    def record(self, fn, force=None):
        """(fn()'s result, the router's choices as a `Chosen`, the
        dispatches used)."""
        self.used = []
        try:
            out, chosen = super().record(fn, force)
        finally:
            used, self.used = self.used, None
        return out, chosen, used


def ms_serve(torch, model, params, ins: dict, part: int, policy, tap, rows: slice,
             tokens=None, forces=None) -> dict:
    """Phase 36's main path under `policy` for the batch's `rows`: part 1
    make_prefill_step on each prompt alone, each prefilled alone into its
    row of one cache made under the policy; part 2 make_prefill_step on the
    rows' MS_GRID_FWD tokens (given the global row count) and one
    Model.prefill of their first MS_GRID_PROMPT into the cache; then
    MS_STEPS make_serve_step steps, greedy or teacher-forced on `tokens`
    [MS_STEPS, batch].  Every call goes through `tap` (`forces[i]`: the
    i-th call's choices); its logits, host ms and fenced rounds (host
    barriers) a call."""
    from repro_torch.parallel.sharding import use_policy
    from repro_torch.train.train_step import make_prefill_step, make_serve_step

    mesh = policy.mesh if policy is not None and policy.splits_model else None
    n = ins["n_rows"]
    pre, serve = make_prefill_step(model, policy), make_serve_step(model, policy)
    calls = []

    def call(kind: str, fn):
        force = None if forces is None else forces[len(calls)]
        torch.cuda.synchronize()
        b0 = 0 if mesh is None else mesh.barriers
        t = time.perf_counter()
        out, chosen, used = tap.record(fn, force)
        torch.cuda.synchronize()
        calls.append({"kind": kind, "ms": (time.perf_counter() - t) * 1e3, "chosen": chosen,
                      "used": used, "rounds": 0 if mesh is None else mesh.barriers - b0})
        return out

    if part == 1:
        prompts = [p.to("cuda") for p in ins["prompts"]]
        fwd = [call("forward", lambda: pre(params, {"tokens": p[None]}))[0] for p in prompts]
        with use_policy(policy):
            cache = model.init_cache(n, max(MS_PLENS) + MS_STEPS, device="cuda")
        last = []
        for b, p in enumerate(prompts):
            row = {"kv": {k: v[:, b:b + 1] for k, v in cache["kv"].items()},
                   "len": torch.zeros((), dtype=torch.int32, device="cuda")}
            with torch.no_grad(), use_policy(policy):
                last.append(call("prefill", lambda: model.prefill(params, p[None], row))[0][0])
        last = torch.stack(last)
        cache["len"] = torch.tensor(MS_PLENS, dtype=torch.int32, device="cuda")
    else:
        toks = ins["batch"][rows].to("cuda")
        fwd = [call("forward", lambda: pre(params, {"tokens": toks}, rows=n))]
        with use_policy(policy):
            cache = model.init_cache(n, MS_GRID_PROMPT + MS_STEPS, device="cuda")
        with torch.no_grad(), use_policy(policy):
            last, cache = call("prefill", lambda: model.prefill(
                params, toks[:, :MS_GRID_PROMPT], cache))
    tok = last.argmax(-1)
    fed, steps = [], []
    for s in range(MS_STEPS):
        if tokens is not None:
            tok = tokens[s, rows]
        fed.append(tok)
        lg, cache = call("step", lambda: serve(params, tok, cache))
        steps.append(lg)
        tok = lg.argmax(-1)
    return {"forward": fwd, "prefill": last, "steps": torch.stack(steps),
            "tokens": torch.stack(fed), "calls": calls}


def ms_schedule(cfg, tp: int, dp: int, fsdp: bool) -> int:
    """A rank's row 4 peer puts a call of the path (forward, prefill or
    decode step alike: the caches split by heads): the embedding's ring
    all-reduce, the attention's and the MoE layer's ONE (the experts' and
    the shared expert's partials summed together) a layer, the
    vocabulary's all-gather; a ring all-reduce over tp is tp - 1 +
    2 ceil((tp - 1) / 2) puts, an all-gather 2 ceil((tp - 1) / 2); under
    FSDP over two data ranks one put a gathered leaf (one direction): the
    2 of ``tok`` and a layer's wq / wk / wv / wo, router, the experts' 3
    and the shared expert's 3."""
    ag = 2 * -(-(tp - 1) // 2)
    ar = tp - 1 + ag
    leaves = 8 + 3 * bool(cfg.moe_shared_ff)
    fg = int(fsdp and dp > 1)
    return 2 * fg + ar + cfg.n_layers * (fg * leaves + 2 * ar) + ag


def ms_rank(mesh, ins: dict, part: int, hbm: float) -> dict:
    """Phase 36 in one rank's process: its blocks of the keyed weights under
    the reference's `make_policy`, the main path (greedy) through a
    SlotTap with its launch counts zeroed before and read after; digests
    of every dispatch (choices, slots, overflow flags) and of the logits,
    each call's drops; a model rank 0 writes its logits into the shared
    buffers and returns its routing (the whole run is forced to it); part
    1's rank 0 then times row 4's peer put at the MoE all-reduce's block."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.rma import OpCounter
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref as rma_ref
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod

    t0 = time.perf_counter()
    cfg = ms_config(get_config, part)
    model = build_model(cfg)
    policy = make_policy(mesh, cfg, SHAPES["decode_32k"])
    torch.cuda.reset_peak_memory_stats()
    params = keyed_params(torch, cfg, MS_SEED + part, policy)
    torch.cuda.synchronize()
    rows = kv_rows(policy, ins["n_rows"])
    out = {"rank": mesh.rank, "model_rank": policy.model_rank, "rows": [rows.start, rows.stop],
           "init_s": time.perf_counter() - t0, "fsdp": policy.gathers_data,
           "bytes": sum(v.nbytes for v in flat_leaves(params).values()),
           "want_bytes": tp_bytes(torch, cfg, policy)}
    L.set_attention_backend("cuda")
    fops.launches = 0
    fops.launches_by_variant = {k: 0 for k in fops.launches_by_variant}
    zero_rma_launches(rma_ops)
    b0 = mesh.barriers
    try:
        with OpCounter() as c, SlotTap(moe_mod) as tap:
            run = ms_serve(torch, model, params, ins, part, policy, tap, rows)
        torch.cuda.synchronize()
    finally:
        L.set_attention_backend("torch")
    out["launches"] = {"flash": fops.launches, "wgmma": fops.launches_by_variant["wgmma"],
                       **rma_ops.launches}
    out["puts"], out["colls"], out["barriers"] = c.puts, c.colls, mesh.barriers - b0
    calls = run.pop("calls")
    out["routes"] = [[(digest(torch, r.expert_idx), digest(torch, r.slot), digest(torch, r.ok))
                      for r in x["used"]] for x in calls]
    out["drops"] = [[(r.ok.numel(), int((~r.ok).sum())) for r in x["used"]] for x in calls]
    out["logits"] = [digest(torch, t) for t in (*run["forward"], run["prefill"], run["steps"])]
    out["tokens"] = run["tokens"].cpu()
    out["capacity"] = sorted({r.capacity for x in calls for r in x["used"]})
    for kind in ("forward", "prefill", "step"):
        out[f"{kind}_ms"] = [x["ms"] for x in calls if x["kind"] == kind]
    out["rounds"] = [x["rounds"] for x in calls if x["kind"] == "step"]
    if policy.model_rank == 0:
        bufs = ins["bufs"]
        for buf, lg in zip(bufs["forward"], run["forward"]):
            buf[rows if part == 2 else slice(None)].copy_(lg)
        bufs["prefill"][rows].copy_(run["prefill"])
        bufs["steps"][:, rows].copy_(run["steps"])
        out["choices"] = [[r.expert_idx.cpu() for r in x["used"]] for x in calls]
        out["chosen"] = [None if x["chosen"] is None else tuple(t.cpu() for t in x["chosen"])
                         for x in calls]
    del run, calls
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    if part == 1:
        # row 4 at the MoE all-reduce's reduce-scatter block of a decode step
        # (the f32 partial [4 rows, 1, d_model] over 4 ranks)
        out["put"] = pp_put_row(torch, mesh, rma_ops, rma_ref,
                                ins["n_rows"] * cfg.d_model // MS_RANKS, hbm, axis="model",
                                phase=36)
    out["s"] = time.perf_counter() - t0
    return out


def ms_part(torch, part: int, hbm: float, card: str) -> dict:
    """One part of phase 36: the ranks first (their logits into host shared
    memory, their routing returned), then the whole run here dispatched
    to their experts and teacher-forced on their tokens; every check;
    returns the part's numbers."""
    from repro_torch import procmesh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.dryrun import make_policy
    from repro_torch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_mod

    t0 = time.perf_counter()
    cfg = ms_config(get_config, part)
    grid = {"model": MS_RANKS} if part == 1 else MS_GRID
    tp, dp = grid["model"], grid.get("data", 1)
    V = cfg.vocab_size
    g = torch.Generator().manual_seed(MS_SEED + part)

    def shared(*shape):
        return torch.empty(shape, dtype=torch.bfloat16).share_memory_()

    if part == 1:
        ins = {"n_rows": len(MS_PLENS),
               "prompts": [torch.randint(0, V, (n,), generator=g) for n in MS_PLENS]}
        fwd_bufs = [shared(n, V) for n in MS_PLENS]
    else:
        ins = {"n_rows": MS_GRID_ROWS,
               "batch": torch.randint(0, V, (MS_GRID_ROWS, MS_GRID_FWD), generator=g)}
        fwd_bufs = [shared(MS_GRID_ROWS, MS_GRID_FWD, V)]
    n = ins["n_rows"]
    ins["bufs"] = {"forward": fwd_bufs, "prefill": shared(n, V),
                   "steps": shared(MS_STEPS, n, V)}
    ranks = procmesh.run(ms_rank, MS_RANKS, device="cuda", args=(ins, part, hbm), axes=grid,
                         timeout=MS_TIMEOUT)
    run_s = time.perf_counter() - t0
    bad = []                    # every check's failure, raised after the logs
    lead = {x["rows"][0]: x for x in ranks if x["model_rank"] == 0}   # by first row
    if sorted((x["rows"][0], x["model_rank"]) for x in ranks) != sorted(
            (d * (n // dp), m) for d in range(dp) for m in range(tp)):
        bad.append(f"ranks' rows and model ranks {[(x['rows'], x['model_rank']) for x in ranks]}")
    # routing, logits and tokens bit-equal across the model ranks of a row block
    for x in ranks:
        ref = lead[x["rows"][0]]
        if x["routes"] != ref["routes"]:
            diff = sum(a != b for ca, cb in zip(x["routes"], ref["routes"]) for a, b in zip(ca, cb))
            bad.append(f"rank {x['rank']}: {diff} dispatches differ from its row block's model "
                       "rank 0's")
        if x["logits"] != ref["logits"] or not torch.equal(x["tokens"], ref["tokens"]):
            bad.append(f"rank {x['rank']}: logits or tokens differ from model rank 0's")
    blocks = [lead[k] for k in sorted(lead)]
    n_calls = len(blocks[0]["routes"])
    tokens = torch.cat([x["tokens"] for x in blocks], dim=1)

    # the whole run: the same keyed weights, forced to the split's experts
    # (route calls ordered layer by layer, a data block's group after another's)
    def whole_order(per_block: list) -> list:
        per = len(per_block[0]) // cfg.n_layers
        return [t for layer in range(cfg.n_layers) for x in per_block
                for t in x[layer * per:(layer + 1) * per]]

    forces = [[t.to("cuda") for t in whole_order([x["choices"][i] for x in blocks])]
              for i in range(n_calls)]
    split_routes = [whole_order([x["routes"][i] for x in blocks]) for i in range(n_calls)]
    split_drops = [sum(k for _, k in whole_order([x["drops"][i] for x in blocks]))
                   for i in range(n_calls)]
    items = [sum(m for m, _ in whole_order([x["drops"][i] for x in blocks]))
             for i in range(n_calls)]
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = keyed_params(torch, cfg, MS_SEED + part)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    whole_bytes = sum(v.nbytes for v in flat_leaves(params).values())
    stacked = None if part == 1 else make_policy(Mesh(MS_GRID, device="cuda"), cfg,
                                                 SHAPES["decode_32k"])
    L.set_attention_backend("cuda")
    before = fops.launches
    try:
        with SlotTap(moe_mod) as tap:
            want = ms_serve(torch, model, params, ins, part, stacked, tap, slice(0, n),
                            tokens=tokens.to("cuda"), forces=forces)
    finally:
        L.set_attention_backend("torch")
    whole_flash = fops.launches - before
    fops.launches = before          # the comparison run's launches are not the path's
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    calls = want.pop("calls")
    flips, err_router, gap = 0, 0.0, 0.0
    for i, x in enumerate(calls):
        used = [(digest(torch, r.expert_idx), digest(torch, r.slot), digest(torch, r.ok))
                for r in x["used"]]
        if used != split_routes[i]:
            bad.append(f"call {i}: the forced whole run's dispatch (choices, slots, overflow "
                       "flags) differs from the split's")
        dropped = sum(int((~r.ok).sum()) for r in x["used"])
        if dropped != split_drops[i]:
            bad.append(f"call {i}: whole run drops {dropped} items, the split {split_drops[i]}")
        parts = whole_order([[Chosen(*(t[j:j + 1] for t in b["chosen"][i]))
                              for j in range(b["chosen"][i][0].shape[0])] for b in blocks])
        ref = Chosen(*(torch.cat(ts).to("cuda") for ts in zip(*parts)))
        own = Chosen(x["chosen"].idx, x["chosen"].logits, x["chosen"].probs)
        try:
            rc = route_check(torch, f"36.{part} call {i}", ref, own)
        except AssertionError as e:
            bad.append(str(e))
            continue
        flips, gap = flips + rc["flips"], max(gap, rc["gap"])
        err_router = max(err_router, rc["err"])
    got = {"forward": [b.to("cuda") for b in ins["bufs"]["forward"]],
           "prefill": ins["bufs"]["prefill"].to("cuda"),
           "steps": ins["bufs"]["steps"].to("cuda")}
    e = tp_check(torch, got, want)
    bounds = tp_bounds(want)
    scale = {k: v / TP_REL for k, v in bounds.items()}
    margin = float(tp_margin(torch, want["steps"]).min())
    whole_ms = {kind: [x["ms"] for x in calls if x["kind"] == kind]
                for kind in ("forward", "prefill", "step")}
    del got, want, calls, forces
    gc.collect()
    torch.cuda.empty_cache()
    over = [k for k in bounds if e[k] > bounds[k]]
    if over or e["argmax_flips_beyond_bound"]:
        bad.append(f"logits {e} vs the whole run (bounds {bounds})")

    n_fwd = len(MS_PLENS) if part == 1 else 1      # forwards, and prefills
    want_puts = (2 * n_fwd + MS_STEPS) * ms_schedule(cfg, tp, dp, True)
    want_flash = n_fwd * cfg.n_layers
    for x in ranks:
        r, lc, wb = x["rank"], x["launches"], x["want_bytes"]
        if x["bytes"] != wb["rank"]:
            bad.append(f"rank {r}: {x['bytes']} weight bytes, its blocks' {wb}")
        if wb["whole"] != whole_bytes:
            bad.append(f"the whole model is {whole_bytes} bytes, the specs say {wb['whole']}")
        if (lc["flash"], lc["wgmma"]) != (want_flash, want_flash):
            bad.append(f"rank {r}: flash launches {lc['flash']} (wgmma {lc['wgmma']}), want "
                       f"{want_flash}, all wgmma")
        if (x["puts"], x["colls"]) != (want_puts, 0) or lc["put_shift"] != want_puts or any(
                lc[k] for k in lc if k not in ("flash", "wgmma", "put_shift")):
            bad.append(f"rank {r}: rma launches {lc}, puts {x['puts']}, all-to-alls "
                       f"{x['colls']}, want {want_puts} row 4 peer puts and nothing else")
    x0 = ranks[0]
    wb = x0["want_bytes"]
    steps = [t for x in ranks for t in x["step_ms"][1:]]
    pre = [t for x in ranks for t in x["prefill_ms"]]
    fwd = [t for x in ranks for t in x["forward_ms"]]
    rounds = sorted({k for x in ranks for k in x["rounds"][1:]})
    drop_frac = [d / m for d, m in zip(split_drops, items)]
    name = f"{cfg.name} ({cfg.n_layers} of 48 layers)"
    log(f"36.{part} split over {MS_RANKS} processes as {grid} ({card}): {name}, each rank "
        f"{wb['rank'] / 1e9:.3f} GB of weights = the split leaves' 1/{tp * (dp if x0['fsdp'] else 1)}"
        f" ({wb['split_whole'] / 1e9:.3f} GB whole) + the whole ones "
        f"({(wb['whole'] - wb['split_whole']) / 1e9:.6f} GB); init {max(x['init_s'] for x in ranks):.1f} s, "
        f"torch peak a rank {[round(x['peak_allocated'] / 2**30, 2) for x in ranks]} GiB; "
        f"capacity a group {x0['capacity']}")
    log(f"36.{part} whole run in this process ({card}): {whole_bytes / 1e9:.3f} GB of weights "
        f"(keyed init {init_s:.1f} s), peak {whole_peak / 2**30:.2f} GiB, {whole_flash} flash "
        f"launches, dispatched to the split's experts: its own routers would pick otherwise "
        f"in {flips} of its choices, each a near-tie (largest probability gap {gap:.3g}); "
        f"router logits differ by at most {err_router:.3g}")
    log(f"36.{part} routing: every rank's choices, slots and overflow flags bit-equal to its "
        f"row block's model rank 0's in all {n_calls} calls; drop fraction by call (split = "
        f"forced whole) {[round(f, 5) for f in drop_frac]}")
    log(f"36.{part} logits vs the whole run, max abs over the split {e}, bounds (TP_REL = "
        f"{TP_REL:g} of the whole run's max |logit| {scale}) {bounds}; smallest top-2 margin "
        f"of a step {margin:.4f}")
    log(f"36.{part} launches a rank: row 11 {want_flash} (all wgmma), row 4 peer {want_puts} "
        f"(= {2 * n_fwd + MS_STEPS} calls x {ms_schedule(cfg, tp, dp, True)}); fenced "
        f"rounds (host barriers) a decode step {rounds}, a rank in all {x0['barriers']}")
    log(f"36.{part} host ms ({card}), all ranks' samples: forward {spread(fwd)}, prefill "
        f"{spread(pre)}, decode step after each one's first {spread(steps)}; whole: forward "
        f"{[round(t, 1) for t in whole_ms['forward']]}, prefill "
        f"{[round(t, 1) for t in whole_ms['prefill']]}, decode step "
        f"{spread(whole_ms['step'][1:])}")
    wall = time.perf_counter() - t0
    log(f"36.{part}: ranks' run {run_s:.1f} s, part {wall:.1f} s")
    if bad:
        raise AssertionError(f"36.{part}: " + "; ".join(bad))
    return {"row4_launches": sum(x["launches"]["put_shift"] for x in ranks),
            "row11_launches": sum(x["launches"]["flash"] for x in ranks),
            "put": x0.get("put"), "layers": cfg.n_layers, "grid": grid,
            "err": {k: e[k] for k in bounds}, "bounds": bounds, "max_logit": scale,
            "route_flips": flips, "route_gap": gap, "drop_fraction": drop_frac,
            "capacity": x0["capacity"], "weights_gb_rank": wb["rank"] / 1e9,
            "weights_gb_whole": whole_bytes / 1e9,
            "peak_gib": [x["peak_allocated"] / 2**30 for x in ranks],
            "whole_peak_gib": whole_peak / 2**30, "forward_ms": fwd, "prefill_ms": pre,
            "step_ms": steps, "whole_ms": whole_ms, "rounds_per_step": rounds,
            "puts_per_rank": want_puts, "run_s": run_s, "wall_s": wall}


def moe_split_phases(torch, hbm: float) -> dict:
    """Phase 36: qwen3-moe-30b-a3b at full width, 8 of 48 layers, over
    ProcMesh({"model": 4}) (part 1), then moonshot-v1-16b-a3b, 4 of 48
    layers, over {"data": 2, "model": 2} (part 2), each against one process
    running the same keyed weights whole.  Returns both parts' numbers and
    the kernel rows' launches."""
    t0 = time.perf_counter()
    card = card_line()
    log(f"phase 36: the MoE layer split over model (tensor-parallel experts); part 1 "
        f"{MS_ARCHS[0]} at full width, {MS_LAYERS[0]} of 48 layers (reduced: depth only) over "
        f"ProcMesh({{'model': {MS_RANKS}}}); part 2 {MS_ARCHS[1]} at full width, {MS_LAYERS[1]} "
        f"of 48 layers (reduced: depth only) over {MS_GRID}, both under make_policy "
        f"(decode_32k); {MS_RANKS} processes sharing one card ({card})")
    one = ms_part(torch, 1, hbm, card)
    two = ms_part(torch, 2, hbm, card)
    wall = time.perf_counter() - t0
    log(f"36: phase {wall:.1f} s")
    return {"card": card, "row4_launches": one.pop("row4_launches") + two.pop("row4_launches"),
            "row11_launches": one.pop("row11_launches") + two.pop("row11_launches"),
            "put": one.pop("put"), "part1": one,
            "part2": {k: v for k, v in two.items() if k != "put"}, "wall_s": wall}


def moe_split_only() -> int:
    """``python3 chip_smoke.py --moe-procs``: phase 36 alone, on the package
    beside this file (the kernels build first).  Prints the kernels line
    of rows 4 (peer, at the MoE all-reduce's block) and 11 (at a part 1
    rank's attention shape [1, 8, 2048, 128]) with this phase's launches
    and times, then the result line."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products, as in main()
    log(card_line())
    build_all(common)
    ms = moe_split_phases(torch, H100.hbm_bandwidth)
    # row 11 at a part 1 rank's attention shape: 8 q heads, its one KV head
    # selected for each, the longest prompt
    cfg = ms_config(get_config, 1)
    g = torch.Generator(device="cuda").manual_seed(MS_SEED)
    q, k, v = (torch.randn(1, cfg.n_heads // MS_RANKS, max(MS_PLENS), cfg.hd, generator=g,
                           device="cuda").to(torch.bfloat16) for _ in range(3))
    err = float((fops.flash_attention(q, k, v).float() - fref.attention_ref(q, k, v).float())
                .abs().max())
    if err > BF16_TOL:
        raise AssertionError(f"flash_attention at a rank's shape: {err:.3g} from plain")
    flash = time_flash(torch, F, fops, fref, q, k, v, H100.hbm_bandwidth)
    put = ms.pop("put")
    rows = [{"name": "put_shift_peer", "route": KERNELS["put_shift_peer"][0],
             "source": KERNELS["put_shift_peer"][1], "replaces": KERNELS["put_shift_peer"][2],
             "launches": ms.pop("row4_launches"), "max_abs_err": 0.0, "ms": put["ms"],
             "plain_ms": put["plain_ms"], "bound_ms": put["bound_ms"], "bound_by": "bytes",
             "library_ms": put["plain_ms"]},
            {"name": "flash_attention", "route": KERNELS["flash_attention"][0],
             "source": KERNELS["flash_attention"][1], "replaces": KERNELS["flash_attention"][2],
             "launches": ms.pop("row11_launches"), "max_abs_err": err,
             **{key: flash[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}}]
    log(f"moe procs phase numbers: {json.dumps(ms)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


MODES = {"--gather-shift": gather_shift_only, "--queue-push": queue_push_only,
         "--pool": pool_only, "--apps": apps_only, "--zoo": zoo_only,
         "--parallel": parallel_only, "--conformance": conformance_only,
         "--tools": tools_only, "--procs": procs_only,
         "--disagg-procs": disagg_procs_only, "--apps-procs": apps_procs_only,
         "--parallel-procs": parallel_procs_only, "--drift": drift_only,
         "--tp-procs": tp_procs_only, "--tp-train-procs": tt_procs_only,
         "--kv-seq-procs": kv_seq_only, "--moe-procs": moe_split_only}

if __name__ == "__main__":
    sys.exit(MODES[sys.argv[1]]() if sys.argv[1:] else main())
