"""The fused ring matmul's CUDA kernel against its plain versions on the
card: every rank's copy against the oracle (all-gather + one f32 matmul)
within 1e-4 of max |Y| (bf16 products are exact in f32, only the order of
the sums differs; f32 products round alike), at SmolLM's MLP projections
and at the edge cases the smoke runs (n = 1, n = 8, f32, K/n not a multiple
of a chunk, m = 16, ragged m and N, an m whose rows the TMA refuses), at
clusters of 3, 5, 6 and 7 blocks (sizes that are not powers of two), each
through the variant `ops.variant` names, and the launch count (one a call
for "wgmma", one a ring step for "simt").  These tests carry the `cuda`
marker and skip where no card is present; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring_matmul_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ring_matmul import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

REL = 1e-4
# (n, K, m, N, dtype)
CASES = [
    (4, 960, 8192, 2560, torch.bfloat16),     # SmolLM's MLP up projection, FSDP 4
    (4, 2560, 8192, 960, torch.bfloat16),     # its down projection
    (1, 960, 512, 640, torch.bfloat16),
    (8, 960, 1024, 2560, torch.bfloat16),
    (4, 960, 1024, 960, torch.float32),
    (4, 4 * 37, 300, 200, torch.bfloat16),    # K/n = 37, m = 300: rows the TMA refuses
    (3, 3 * 50, 16, 130, torch.float32),
    (4, 960, 16, 2560, torch.bfloat16),       # m = 16
    (2, 2 * 37, 264, 200, torch.bfloat16),    # K/n = 37, ragged m and N, through "wgmma"
    (8, 8 * 45, 136, 136, torch.bfloat16),    # K/n = 45, ragged m and N, through "wgmma"
    (2, 2 * 3000, 256, 128, torch.bfloat16),  # a shard too tall for the ring: in rounds
    # clusters of every other size the rule admits, K/n ragged, m and N ragged
    (3, 3 * 37, 264, 200, torch.bfloat16),
    (5, 5 * 53, 136, 520, torch.bfloat16),
    (6, 6 * 45, 392, 2560, torch.bfloat16),
    (7, 7 * 37, 136, 264, torch.bfloat16),
    (6, 6 * 160, 1024, 960, torch.bfloat16),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _inputs(n, K, m, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_t = torch.randn(K, m, generator=g, device="cuda").to(dtype)
    w = torch.randn(n, K // n, N, generator=g, device="cuda").to(dtype)
    return x_t, w


def _held_to_oracle(ranks, x_t, w, mesh):
    want = ref.ring_matmul_ref(x_t, w, mesh)
    tol = REL * float(want.abs().max())
    n, m, N = w.shape[0], x_t.shape[1], w.shape[2]
    assert ranks.shape == (n, m, N) and ranks.dtype == torch.float32
    assert torch.isfinite(ranks).all()
    for r in range(n):
        err = float((ranks[r] - want).abs().max())
        assert err <= tol, (r, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,m,N,dtype", CASES)
def test_kernel_matches_plain(card, n, K, m, N, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x_t, w = _inputs(n, K, m, N, dtype, seed=K + m + N)
    mesh = Mesh(n, device="cuda")
    kind = ops.variant(dtype, n, x_t, w)
    if dtype == torch.bfloat16 and n <= ops.MAX_RANKS and m % 8 == 0:
        assert kind == "wgmma"
    before, by_kind = ops.launches, dict(ops.launches_by_variant)
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    torch.cuda.synchronize()
    calls = 1 if kind == "wgmma" else n
    assert ops.launches - before == calls
    assert ops.launches_by_variant[kind] - by_kind[kind] == calls
    _held_to_oracle(ranks, x_t, w, mesh)
    assert torch.equal(ops.ring_matmul(x_t, w, mesh), ops.ring_matmul_ranks(x_t, w, mesh)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,m,N", [(4, 960, 1024, 2560), (4, 2560, 512, 960), (2, 74, 264, 200),
                                    (3, 111, 264, 200), (7, 259, 136, 520)])
def test_variants_agree(card, n, K, m, N):
    """"wgmma" and "simt" on the same bf16 inputs: both within the oracle's
    bound, and within twice that of each other."""
    x_t, w = _inputs(n, K, m, N, torch.bfloat16, seed=n + K)
    mesh = Mesh(n, device="cuda")
    a = ops.ring_matmul_ranks(x_t, w, mesh, variant="wgmma")
    b = ops.ring_matmul_ranks(x_t, w, mesh, variant="simt")
    _held_to_oracle(a, x_t, w, mesh)
    _held_to_oracle(b, x_t, w, mesh)
    assert float((a - b).abs().max()) <= 2 * REL * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,m,N", [(4, 960, 8192, 2560), (4, 2560, 8192, 960), (8, 360, 136, 136),
                                    (3, 111, 264, 200), (5, 265, 136, 520), (6, 270, 392, 2560),
                                    (7, 259, 136, 264)])
def test_wgmma_repeats_bit_equal(card, n, K, m, N):
    """Three calls on the same inputs give the same bits: the cluster's
    handshake leaves no race, and the sums run in one fixed order."""
    x_t, w = _inputs(n, K, m, N, torch.bfloat16, seed=7)
    mesh = Mesh(n, device="cuda")
    assert ops.variant(torch.bfloat16, n, x_t, w) == "wgmma"
    first = ops.ring_matmul_ranks(x_t, w, mesh)
    for _ in range(2):
        assert torch.equal(ops.ring_matmul_ranks(x_t, w, mesh), first)


@pytest.mark.cuda
def test_kernel_matches_the_cpu_ring_schedule(card):
    """The CPU ring schedule and the kernel agree on the card's inputs."""
    x_t, w = _inputs(4, 256, 64, 96, torch.bfloat16, seed=1)
    mesh_gpu, mesh_cpu = Mesh(4, device="cuda"), Mesh(4, device="cpu")
    got = ops.ring_matmul_ranks(x_t, w, mesh_gpu).cpu()
    want = ref.ring_schedule_ref(x_t.cpu(), w.cpu(), mesh_cpu)
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.cuda
def test_kernel_refuses_mixed_dtypes(card):
    x_t, w = _inputs(2, 64, 8, 8, torch.bfloat16, seed=2)
    with pytest.raises(TypeError):
        ops.ring_matmul(x_t.float(), w, Mesh(2, device="cuda"))


@pytest.mark.cuda
def test_wgmma_never_gives_way(card):
    """A "wgmma" call its inputs do not fit raises; nothing falls back."""
    x_t, w = _inputs(2, 64, 300, 64, torch.bfloat16, seed=3)
    mesh = Mesh(2, device="cuda")
    before = ops.launches
    with pytest.raises(ValueError, match="16 bytes"):
        ops.ring_matmul_ranks(x_t, w, mesh, variant="wgmma")
    with pytest.raises(ValueError, match="bf16"):
        ops.ring_matmul_ranks(x_t[:, :256].float(), w.float(), mesh, variant="wgmma")
    assert ops.launches == before
