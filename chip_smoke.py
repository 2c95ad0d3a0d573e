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
     masked row, Sq=4 causal): max abs error <= 1e-4 (f32; the order of
     the sums differs);
  5. timings with CUDA events at the main-path inputs: kernel, plain
     version, F.scaled_dot_product_attention over pre-gathered K/V (a
     yardstick the port never calls) and the bound (bytes read at the
     H100 model's HBM rate, 3.35 TB/s, or f32 flops at 67 TFLOP/s,
     whichever is larger);
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
     the PyTorch op's launch latency, the event latency, the copy_ rate.

Each path is driven with the kernel launch counts set to 0 just before it
and read just after.

The second-to-last line is one JSON object of per-kernel numbers; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TOL = 1e-4                      # kernel vs plain, f32, different sum order
SOURCES = ("paged_attention", "rma")      # csrc/<name>.cu, one nvcc each
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
}
FULL = dict(n_prefill=2, d_model=128, vocab=32000, page_tokens=16,
            block_tokens=2048, pool_pages=8192, queue_capacity=64,
            max_recv_per_step=16, n_lanes=2, novel_slots=128)
N_FUSED, N_GATHER, N_INLINE = 256, 64, 64
N_PREFIX_GROUPS = 4             # requests share one of 4 half-length prefixes
MILC_P, MILC_LOCAL = 131072, (8, 4, 4, 4, 6)   # ranks; T_local, X, Y, Z, reals
MILC_STEPS, MILC_TOL = 5, 1e-5  # the example's own tolerance
AR_P, AR_MIB, AR_TOL = 8, 25, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_all(common) -> None:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        for name, path in zip(SOURCES, ex.map(common.build, SOURCES)):
            log(f"built {name}: {path.name}")
            for line in common.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
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


def serve(disagg, cfg, n: int, seed: int) -> tuple:
    """Run n requests to completion and check them; returns (engine, seconds)."""
    import numpy as np
    import torch

    eng = disagg.DisaggEngine(4, cfg, seed=seed, device="cuda")
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
        raise AssertionError(f"{cfg.attend if cfg.paged else 'inline'}: "
                             f"{len(res)}/{n} results, tokens differ for {bad[:8]}")
    if eng.retries != 0:
        raise AssertionError(f"retries {eng.retries} != 0")
    if not eng.flow_stats()["conservation_ok"]:
        raise AssertionError("credit conservation violated")
    ms = eng.msg_stats
    want = (8, 3) if cfg.paged else (6, 2)
    got = (ms["raw_msgs_per_step"], ms["wire_msgs_per_step"])
    if got != want:
        raise AssertionError(f"raw -> wire per step {got}, want {want}")
    if cfg.paged:
        ps = eng.paged_stats()
        if not ps["pool_conservation_ok"] or ps["prefix_hits"] == 0:
            raise AssertionError(f"paged stats: {ps}")
        if (eng.lane_sends[cfg.n_prefill:].sum(axis=1) == 0).any():
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
    """Masked pages, a fully masked row, Sq=4 causal, at hd=128, pt=16."""
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
        f"{valid_pages} valid pages; kernel {kernel_ms * 1e3:.1f} us, plain "
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
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    torch.cuda.empty_cache()
    kernels += rma_phases(torch)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
        + f"; a csrc kernel's ctypes launch {lat_kernel:.6g} s")
    return out


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
    from repro_torch.kernels.rma import ops as rma_ops
    from repro_torch.kernels.rma import ref
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
    rows = time_rma(torch, rma_ops, ref, Mesh, launches, errs, H100.hbm_bandwidth)
    log("model constants, measured vs spec: " + ", ".join(
        f"{k} {v:.4g}/{getattr(H100, k):.4g}" for k, v in consts.items()))
    model = PerfModel(HardwareSpec(**consts))
    log(f"model on these constants: aggregation crossover "
        f"{model.aggregation_crossover_bytes():.0f} B (spec: "
        f"{plan_mod.DEFAULT_MODEL.aggregation_crossover_bytes():.0f} B), "
        f"choose_sync(2, {MILC_P}) {epoch_mod.choose_sync(2, MILC_P, model)}")
    return rows

if __name__ == "__main__":
    sys.exit(main())
