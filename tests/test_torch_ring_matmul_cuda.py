"""The fused ring matmul's CUDA kernel against its plain versions on the
card: every rank's copy against the oracle (all-gather + one f32 matmul)
within 1e-4 of max |Y| (bf16 products are exact in f32, only the order of
the sums differs; f32 products round alike), at SmolLM's MLP projections
and at the edge cases the smoke runs (n = 1, n = 8, f32, K/n not a multiple
of the 32-row tile, m = 16, ragged m and N), and the launch count (one a
ring step).  These tests carry the `cuda` marker and skip where no card is
present; the file imports no JAX:

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
    (4, 4 * 37, 300, 200, torch.bfloat16),    # K/n = 37: ragged k tile, ragged m and N
    (3, 3 * 50, 16, 130, torch.float32),
    (4, 960, 16, 2560, torch.bfloat16),       # m = 16
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,m,N,dtype", CASES)
def test_kernel_matches_plain(card, n, K, m, N, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x_t, w = _inputs(n, K, m, N, dtype, seed=K + m + N)
    mesh = Mesh(n, device="cuda")
    before = ops.launches
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    torch.cuda.synchronize()
    assert ops.launches - before == n
    want = ref.ring_matmul_ref(x_t, w, mesh)
    tol = REL * float(want.abs().max())
    assert ranks.shape == (n, m, N) and ranks.dtype == torch.float32
    assert torch.isfinite(ranks).all()
    for r in range(n):
        err = float((ranks[r] - want).abs().max())
        assert err <= tol, (r, err, tol)
    assert torch.equal(ops.ring_matmul(x_t, w, mesh), ops.ring_matmul_ranks(x_t, w, mesh)[0])


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
