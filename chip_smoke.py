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
     yardstick the port never calls) and the bound (bytes read at
     3.35 TB/s or f32 flops at 67 TFLOP/s, whichever is larger).

The second-to-last line is one JSON object of per-kernel numbers; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TOL = 1e-4                      # kernel vs plain, f32, different sum order
KERNELS = {
    # name -> (route, source, TPU kernel it replaces)
    "paged_attention": ("cuda", "src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:99"),
}
FULL = dict(n_prefill=2, d_model=128, vocab=32000, page_tokens=16,
            block_tokens=2048, pool_pages=8192, queue_capacity=64,
            max_recv_per_step=16, n_lanes=2, novel_slots=128)
N_FUSED, N_GATHER, N_INLINE = 256, 64, 64
N_PREFIX_GROUPS = 4             # requests share one of 4 half-length prefixes


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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        for name, path in zip(KERNELS, ex.map(common.build, KERNELS)):
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
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
