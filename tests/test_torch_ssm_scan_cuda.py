"""The selective-scan CUDA kernel against its plain PyTorch version on the
card: at Jamba's mixer shape (d 8192, N 16), at the reference test's three
shapes in bf16 (`tests/test_kernels.py:110-115`), and at edge cases (S = 1,
S = 1000 and d = 200, which no block divides, a non-zero h0, N = 8 and 5,
and `h_last` itself), and the gradients through the kernel.  f32 within
1e-4 of the output's largest magnitude (the sum over N is a butterfly here
and an einsum there); bf16 within 5e-2, the reference test's tolerance.  These tests carry the `cuda` marker and skip
where no card is present; the file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm_scan_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402

# (B, S, d, N, dtype, seeded)
CASES = [
    (1, 1024, 8192, 16, torch.float32, True),     # Jamba's mixer, a 1024-token prompt
    (2, 64, 32, 8, torch.bfloat16, False),        # the reference test's shapes, bf16
    (1, 128, 64, 16, torch.bfloat16, False),
    (1, 256, 128, 16, torch.bfloat16, False),
    (3, 1, 64, 16, torch.float32, True),          # one step
    (2, 1000, 200, 16, torch.float32, True),      # S and d divisible by no block
    (1, 33, 24, 5, torch.float32, True),          # N below its lane group
    (2, 77, 40, 32, torch.bfloat16, True),
]
F32_REL, BF16_TOL = 1e-4, 5e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _inputs(B, S, d, N, dtype, seeded, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    decay = (0.5 + 0.5 * torch.rand(B, S, d, N, generator=g, device="cuda")).to(dtype)
    drive = (0.1 * torch.randn(B, S, d, N, generator=g, device="cuda")).to(dtype)
    c = torch.randn(B, S, N, generator=g, device="cuda")
    h0 = torch.randn(B, d, N, generator=g, device="cuda") if seeded else None
    return decay, drive, c, h0


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _scale(want):
    """The output's largest magnitude: a tolerance relative to it (the tiny
    floor only keeps an all-zero output from asking for an exact zero)."""
    return max(float(want.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,N,dtype,seeded", CASES)
def test_kernel_matches_plain(card, B, S, d, N, dtype, seeded):
    decay, drive, c, h0 = _inputs(B, S, d, N, dtype, seeded, seed=S + d + N)
    before = ops.launches
    y, h_last = ops.selective_scan(decay, drive, c, h0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert y.dtype == dtype and y.shape == (B, S, d)
    assert h_last.dtype == torch.float32 and h_last.shape == (B, d, N)
    want_y, want_h = ref.ssm_scan_ref(decay, drive, c, h0)
    assert torch.isfinite(y).all() and torch.isfinite(h_last).all()
    if dtype == torch.float32:
        assert _err(y, want_y) <= F32_REL * _scale(want_y)
    else:
        assert _err(y, want_y) <= BF16_TOL
    assert _err(h_last, want_h) <= F32_REL * _scale(want_h)


@pytest.mark.cuda
def test_reference_call_ignores_its_blocks(card):
    decay, drive, c, _ = _inputs(1, 96, 48, 16, torch.float32, False, seed=3)
    a = ops.ssm_scan(decay, drive, c, block_d=16, block_t=32)
    b = ops.ssm_scan(decay, drive, c)
    assert torch.equal(a, b)
    assert torch.equal(a, ops.selective_scan(decay, drive, c)[0])


@pytest.mark.cuda
def test_chunked_scan_equals_one_scan(card):
    """Two scans chained through h_last equal one scan over both halves:
    the chunked prefill's contract."""
    decay, drive, c, h0 = _inputs(2, 300, 64, 16, torch.float32, True, seed=4)
    y, h = ops.selective_scan(decay, drive, c, h0)
    y1, h1 = ops.selective_scan(decay[:, :123], drive[:, :123], c[:, :123], h0)
    y2, h2 = ops.selective_scan(decay[:, 123:], drive[:, 123:], c[:, 123:], h1)
    assert _err(torch.cat([y1, y2], 1), y) <= 1e-5 * _scale(y)
    assert _err(h2, h) <= 1e-5 * _scale(h)


@pytest.mark.cuda
def test_gradients_pass_through_the_kernel(card):
    """A forward through the kernel keeps the autograd graph: its gradients
    equal the plain version's."""
    decay, drive, c, h0 = _inputs(2, 200, 64, 16, torch.float32, True, seed=6)
    grads = []
    for fn in (ops.selective_scan, ref.ssm_scan_ref):
        ins = [t.clone().requires_grad_(True) for t in (decay, drive, c, h0)]
        before = ops.launches
        y, h = fn(*ins)
        assert ops.launches == before + (fn is ops.selective_scan)
        (y.sum() + (h * h).sum()).backward()
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert _err(got, want) <= 1e-5 * _scale(want)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(card):
    decay, drive, c, _ = _inputs(1, 4, 8, 40, torch.float32, False, seed=5)
    with pytest.raises(ValueError, match="N <= 32"):
        ops.selective_scan(decay, drive, c)
    d16 = torch.zeros(1, 4, 8, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ops.selective_scan(d16, d16, torch.zeros(1, 4, 16, device="cuda"))
