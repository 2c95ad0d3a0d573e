"""The fused ring matmul's plain versions against the JAX reference, and
`allgather_matmul_plan` against its closed form.

The reference's `ring_matmul` runs its Pallas kernel in interpret mode on 4
forced host devices in a child process (this file's own ``__main__``
branch), at the shapes and dtypes of `tests/subtests/ring_matmul_sub.py`;
both packages get the same numpy inputs.  The port's ring schedule (what
`ops.ring_matmul` computes on CPU tensors, every rank's copy) and its oracle
are held to the reference's output within the subtest's own bounds: 1e-3
abs in f32, 0.15 abs in bf16 (both packages multiply exact products in
f32; the sums run in other orders).  Every rank's copy equals rank 0's in
the ring schedule's own arithmetic only up to the order of its sums, so
the copies are held to the oracle within the same bounds.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perfmodel import DEFAULT_MODEL, H100  # noqa: E402
from repro_torch.kernels.ring_matmul import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402
from repro_torch.parallel.overlap import CollectiveStrategist  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
N_RANKS = 4
# (K, m, N, dtype): the subtest's three cases
CASES = [(256, 16, 128, "float32"), (128, 8, 128, "float32"), (512, 32, 256, "bfloat16")]
TOL = {"float32": 1e-3, "bfloat16": 0.15}


def _inputs(K, m, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, m)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.kernels.ring_matmul.ops import ring_matmul

    mesh = jax.make_mesh((N_RANKS,), ("x",))
    out = {}
    for i, (K, m, N, dt) in enumerate(CASES):
        x_t, w = _inputs(K, m, N, i)
        y = ring_matmul(jnp.asarray(x_t, dt), jnp.asarray(w, dt), mesh, "x")
        out[f"y/{i}"] = np.asarray(y, np.float32)
    np.savez(d / "out.npz", **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_matmul_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _port_inputs(i):
    K, m, N, dt = CASES[i]
    x_t, w = _inputs(K, m, N, i)
    dtype = getattr(torch, dt)
    return (torch.from_numpy(x_t).to(dtype),
            torch.from_numpy(w).to(dtype).reshape(N_RANKS, K // N_RANKS, N))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_schedule_matches_reference(reference, i):
    x_t, w = _port_inputs(i)
    mesh = Mesh(N_RANKS, device="cpu")
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    assert ranks.shape == (N_RANKS, x_t.shape[1], w.shape[2])
    assert ranks.dtype == torch.float32
    want = reference[f"y/{i}"]
    tol = TOL[CASES[i][3]]
    for r in range(N_RANKS):
        err = np.abs(ranks[r].numpy() - want).max()
        assert err < tol, (r, err)
    assert torch.equal(ops.ring_matmul(x_t, w, mesh), ranks[0])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_oracle_matches_reference(reference, i):
    x_t, w = _port_inputs(i)
    mesh = Mesh(N_RANKS, device="cpu")
    got = ref.ring_matmul_ref(x_t, w, mesh)
    assert np.abs(got.numpy() - reference[f"y/{i}"]).max() < TOL[CASES[i][3]]
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    assert (ranks - got).abs().max() < TOL[CASES[i][3]]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_schedule_every_rank_count(n):
    """Rank r sums its shards in the order r, r-1, ...; all equal the oracle."""
    g = torch.Generator().manual_seed(n)
    ks, m, N = 5, 7, 9
    x_t = torch.randn(n * ks, m, generator=g, dtype=torch.float64)
    w = torch.randn(n, ks, N, generator=g, dtype=torch.float64)
    mesh = Mesh(n, device="cpu")
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    want = x_t.T @ w.reshape(n * ks, N)
    assert torch.allclose(ranks, want.float().expand(n, m, N), atol=1e-5)


def test_ops_checks_its_inputs():
    mesh = Mesh(4, device="cpu")
    with pytest.raises(ValueError):
        ops.ring_matmul(torch.zeros(10, 3), torch.zeros(4, 2, 5), mesh)
    with pytest.raises(MeshError):
        ops.ring_matmul(torch.zeros(8, 3), torch.zeros(2, 4, 5), mesh)
    with pytest.raises(ValueError):
        ops.ring_matmul(torch.zeros(8, 3, 1), torch.zeros(4, 2, 5), mesh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 9, 16])
@pytest.mark.parametrize("m", [16, 12])
def test_variant_rule(dtype, n, m):
    """"wgmma" iff bf16, 1 <= n <= 8 and both views pass the TMA's rules (m =
    12: x_t's rows are 24 bytes apart); everything else is "simt"."""
    x_t, w = torch.zeros(n * 4, m, dtype=dtype), torch.zeros(n, 4, 24, dtype=dtype)
    want = "wgmma" if dtype == torch.bfloat16 and n <= 8 and m == 16 else "simt"
    assert ops.variant(dtype, n, x_t, w) == want


def test_variant_rule_reads_the_kernel_views():
    """A non-contiguous x_t is judged as the contiguous copy the wrapper
    hands over; an x_t whose data starts 8 bytes into its storage is not."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16).T         # [64, 8] with strides (1, 64)
    w = torch.zeros(4, 16, 32, dtype=torch.bfloat16)
    assert ops.variant(torch.bfloat16, 4, x, w) == "wgmma"
    base = torch.zeros(64 * 16 + 4, dtype=torch.bfloat16)
    assert ops.variant(torch.bfloat16, 4, base[:64 * 16].view(64, 16), w) == "wgmma"
    assert ops.variant(torch.bfloat16, 4, base[4:].view(64, 16), w) == "simt"


# (shape [shards, rows, cols], strides in elements, base offset in bytes, itemsize, problem)
TMA_CASES = [
    ((4, 240, 8192), (240 * 8192, 8192, 1), 0, 2, None),        # x_t, the up projection
    ((4, 640, 960), (640 * 960, 960, 1), 32, 2, None),          # w, the down projection
    ((4, 37, 8192), (37 * 8192, 8192, 1), 16, 2, None),         # K/n = 37
    ((1, 1, 300), (7, 3, 1), 0, 2, None),                       # length-1 dims: strides unread
    ((1, 37, 16), (5, 16, 1), 0, 2, None),
    ((4, 1, 8), (8, 3, 1), 0, 2, None),
    ((4, 240, 300), (240 * 300, 300, 1), 0, 2, "dim 1"),        # rows 600 bytes apart
    ((4, 1, 300), (300, 300, 1), 0, 2, "dim 0"),                # shards 600 bytes apart
    ((2, 64, 64), (64 * 64 + 4, 64, 1), 0, 2, "dim 0"),
    ((2, 64, 64), (0, 64, 1), 0, 2, "dim 0"),                   # a broadcast shard dim
    ((2, 64, 64), (64 * 64, 64, 1), 2, 2, "16-byte aligned"),
    ((2, 64, 64), (64 * 64, 64, 1), 8, 2, "16-byte aligned"),
    ((2, 64, 64), (64 * 64 * 2, 128, 2), 0, 2, "not contiguous"),
    ((2, 64, 4), (256, 4, 1), 0, 4, None),                      # 16-byte f32 rows
]


@pytest.mark.parametrize("shape,strides,offset,itemsize,problem", TMA_CASES)
def test_tma_preconditions(shape, strides, offset, itemsize, problem):
    """The "wgmma" variant's TMA checker, fed shapes, strides and offsets: a
    16-byte aligned base, contiguous columns, and every other stride of a
    dim longer than 1 a positive multiple of 16 bytes."""
    got = ops.tma_problem(shape, strides, 0x7F0000000000 + offset, itemsize)
    if problem is None:
        assert got is None
    else:
        assert got is not None and problem in got, got


@pytest.mark.parametrize("shape,want", [
    ((4, 240, 8192), (240 * 8192, 8192)),
    ((1, 37, 16), (37 * 16, 16)),
    ((1, 1, 300), (304, 304)),          # neither stride is read: valid stand-ins
    ((4, 1, 16), (16, 16)),
    ((3, 1, 300), (300, 304)),          # the shard stride is read, the row stride not
])
def test_map_strides_of_length_one_dims_are_valid(shape, want):
    got = ops.map_strides(shape)
    assert got == want
    assert all(st > 0 and st % 8 == 0 for st, n in zip(got, shape[:2]) if n == 1)


@pytest.mark.parametrize("n,ks,N", [(4, 240, 2560), (4, 640, 960), (1, 960, 2560), (8, 120, 2560),
                                    (4, 37, 2560), (8, 45, 136), (2, 1, 8), (1, 16, 64),
                                    (4, 4096, 2560), (2, 3000, 128), (1, 100000, 512),
                                    (3, 37, 200), (5, 53, 520), (6, 45, 2560), (7, 37, 264),
                                    (6, 160, 960)])
def test_plan_fits_and_keeps_the_ring_moving(n, ks, N):
    """The shared-memory plan: within the block's budget, every shard row
    covered, two slots of each ring, and (n > 1) a slot to spare beyond a
    step's chunks, without which the ring of n blocks could not move."""
    p = ops.plan(n, ks, N)
    assert p.smem <= ops.SMEM_BYTES
    assert p.bn in (128, 256) and (p.bn == 128 or N >= 512)
    assert p.kc in ops.CHUNK_ROWS and p.stages >= 2 and p.slots >= 2
    assert p.rounds * p.nkr * p.kc >= ks > (p.rounds - 1) * p.nkr * p.kc   # no empty round
    if n > 1:
        assert p.slots > p.nkr
    if (n, ks) in ((4, 240), (4, 640)):           # the training run's projections: one round
        assert p.rounds == 1 and p.nkr * p.kc == ks and p.slots >= p.nkr + 2
        assert p.bn == (256 if ks == 240 else 128)   # the down projection's ring fills 128 wide


@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("kc", ops.CHUNK_ROWS)
@pytest.mark.parametrize("stages", [2, 4])
def test_room_is_the_most_slots_that_fit(bn, kc, stages):
    """`_room` is read off `Plan.smem`: its slots fit the budget, one more
    does not."""
    room = ops._room(bn, kc, stages)
    assert ops.Plan(bn, kc, stages, room, 1, 1).smem <= ops.SMEM_BYTES
    assert ops.Plan(bn, kc, stages, room + 1, 1, 1).smem > ops.SMEM_BYTES


def test_main_entry_takes_no_variant_override():
    """The override is for comparisons through `ring_matmul_ranks`; the
    main path's entry always takes the variant the rule names."""
    import inspect
    assert list(inspect.signature(ops.ring_matmul).parameters) == ["x_t", "w", "mesh"]
    x_t, w = _port_inputs(1)
    with pytest.raises(TypeError):
        ops.ring_matmul(x_t, w, Mesh(N_RANKS, device="cpu"), variant="simt")


def test_cpu_tensors_never_reach_the_card_path(monkeypatch):
    """On CPU tensors the wrapper computes the plain ring schedule without
    consulting the variant rule, the plan or the kernel."""
    def boom(*a, **k):
        raise AssertionError("card-only path consulted for a CPU tensor")
    for name in ("variant", "plan", "_RING", "_launch", "tma_problem"):
        monkeypatch.setattr(ops, name, boom)
    before, by_kind = ops.launches, dict(ops.launches_by_variant)
    x_t, w = _port_inputs(2)
    mesh = Mesh(N_RANKS, device="cpu")
    for kind in (None, "wgmma", "simt"):
        got = ops.ring_matmul_ranks(x_t, w, mesh, variant=kind)
        assert torch.equal(got, ref.ring_schedule_ref(x_t, w, mesh))
    assert ops.launches == before and ops.launches_by_variant == by_kind


def test_variant_names_are_checked():
    x_t, w = _port_inputs(1)
    with pytest.raises(ValueError, match="variant"):
        ops.ring_matmul_ranks(x_t, w, Mesh(N_RANKS, device="cpu"), variant="tensor")


@pytest.mark.parametrize("m,k,n,shards,want", [
    (8192, 960, 2560, 4, "unfused"),             # SmolLM's MLP up projection, FSDP 4
    (8192, 2560, 960, 4, "unfused"),             # its down projection
    (16, 960, 2560, 4, "fused_ring"),            # a 16-token call: both arms host-bound
    (1, 1024, 1024, 8, "unfused"),               # m = 1: the "simt" variant, a launch a step
])
def test_allgather_matmul_plan_closed_form(m, k, n, shards, want):
    """Fuse iff the ring kernel's price is below the all-gather + GEMM's,
    both from the H100 model's measured constants, each arm the larger of
    its host and its device time: "wgmma" = max(the call, 2 shards m k n /
    product rate + ceil(m / 128) (shards - 1) k n 2 bytes / forward rate);
    "simt" = max(the call + shards - 1 launches, flops / simt rate);
    unfused = max(its calls, (1 + shards) k n 2 bytes / all-gather rate +
    max(flops / GEMM rate, its bytes / HBM rate))."""
    flops = 2 * shards * m * k * n
    if m % 8 == 0 and n % 8 == 0 and shards <= 8:
        fused = max(H100.ring_call_latency, flops / H100.ring_product_flops
                    + -(-m // 128) * (shards - 1) * k * n * 2 / H100.ring_forward_bandwidth)
    else:
        fused = max(H100.ring_call_latency + (shards - 1) * H100.launch_latency,
                    flops / H100.ring_simt_flops)
    mm_bytes = (m * k + shards * k * n + shards * m * n) * 2
    unfused = max(H100.unfused_call_latency,
                  (1 + shards) * k * n * 2 / H100.all_gather_bandwidth
                  + max(flops / H100.gemm_flops_bf16, mm_bytes / H100.hbm_bandwidth))
    closed = "fused_ring" if fused < unfused else "unfused"
    assert closed == want
    assert CollectiveStrategist().allgather_matmul_plan(m, k, n, shards) == want
    assert CollectiveStrategist(DEFAULT_MODEL).allgather_matmul_plan(
        m, k, n, shards, dtype_bytes=2) == want
    assert DEFAULT_MODEL.p_ring_matmul(m, k, n, shards) == pytest.approx(fused, rel=1e-12)
    assert DEFAULT_MODEL.p_allgather_matmul(m, k, n, shards) == pytest.approx(unfused, rel=1e-12)


@pytest.mark.parametrize("m,k,n", [(8192, 960, 2560), (8192, 2560, 960)])
def test_allgather_matmul_plan_prices_t1_from_the_card(m, k, n):
    """At T1's projections (x_t [k, 8192] over 4 ranks) the fused arm is the
    one-copy products plus the ring's forward, which the card measured
    slower than the all-gather + library GEMM: the forward alone exceeds
    the gather's copy by far, and both arms price the same products."""
    model, shards = DEFAULT_MODEL, 4
    flops = 2 * shards * m * k * n
    forwarded = (m // 128) * (shards - 1) * k * n * 2     # 64 tiles of m, 3 hops each
    gathered = (1 + shards) * k * n * 2                    # W read once, 4 copies written
    assert model.ring_variant(m, n, shards) == "wgmma"
    assert forwarded / gathered == pytest.approx(64 * 3 / 5)
    assert forwarded / H100.ring_forward_bandwidth > 10 * gathered / H100.all_gather_bandwidth
    fused, unfused = model.p_ring_matmul(m, k, n, shards), model.p_allgather_matmul(m, k, n, shards)
    assert fused > unfused > flops / H100.gemm_flops_bf16
    assert CollectiveStrategist().allgather_matmul_plan(m, k, n, shards) == "unfused"


@pytest.mark.parametrize("m", [8, 16, 128])
def test_allgather_matmul_plan_fuses_a_few_tokens_against_a_large_weight(m):
    """x [m, 16384] against W [16384, 16384] (512 MB bf16) over 8 ranks: the
    all-gather writes 8 copies of W, the ring forwards it 7 times for one
    tile of m: the fused arm wins while m fits one tile, and 8 tiles of m
    (1024 tokens) forward W 56 times."""
    model, k, n, shards = DEFAULT_MODEL, 16384, 16384, 8
    assert model.ring_variant(m, n, shards) == "wgmma"
    assert CollectiveStrategist().allgather_matmul_plan(m, k, n, shards) == "fused_ring"
    assert CollectiveStrategist().allgather_matmul_plan(1024, k, n, shards) == "unfused"


@pytest.mark.parametrize("m,k,n,shards,dtype_bytes", [
    (16, 960, 2560, 16, 2),          # more ranks than a cluster holds: "simt"
    (4, 1024, 1024, 8, 2),           # a 4-token call: x_t's rows are not 16 bytes
    (12, 960, 2560, 4, 2),           # m not whole 16-byte rows: "simt"
])
def test_small_calls_the_fused_kernel_cannot_take_in_one_launch_stay_unfused(
        m, k, n, shards, dtype_bytes):
    model = DEFAULT_MODEL
    assert model.ring_variant(m, n, shards, dtype_bytes) == "simt"
    assert model.p_ring_matmul(m, k, n, shards, dtype_bytes) >= (
        H100.ring_call_latency + (shards - 1) * H100.launch_latency)
    assert CollectiveStrategist().allgather_matmul_plan(m, k, n, shards, dtype_bytes) == "unfused"


@pytest.mark.parametrize("m,K,N,shards,dtype", [
    (16, 960, 2560, 4, torch.bfloat16), (8, 96, 64, 8, torch.bfloat16),
    (12, 960, 2560, 4, torch.bfloat16), (16, 96, 36, 4, torch.bfloat16),
    (16, 144, 64, 9, torch.bfloat16), (16, 96, 64, 4, torch.float32),
    (1, 64, 64, 1, torch.bfloat16), (128, 64, 256, 1, torch.bfloat16),
])
def test_the_models_variant_rule_is_the_kernels(m, K, N, shards, dtype):
    """`PerfModel.ring_variant` prices the variant `ops.variant` launches:
    on contiguous tensors, from the shapes alone, the two agree."""
    from repro_torch.core.perfmodel import RING_MAX_RANKS, RING_TILE

    assert (RING_MAX_RANKS, RING_TILE) == (ops.MAX_RANKS, ops.TILE)
    x_t = torch.zeros(K, m, dtype=dtype)
    w = torch.zeros(shards, K // shards, N, dtype=dtype)
    assert DEFAULT_MODEL.ring_variant(m, N, shards, dtype.itemsize) == ops.variant(
        dtype, shards, x_t, w)


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
