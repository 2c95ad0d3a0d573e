"""The paged-gather CUDA kernel, and `rmem.pages.gather_shift` through it,
against their plain PyTorch versions on the card: bit-equal.  These tests
carry the `cuda` marker and skip where no card is present; the file imports
no JAX, so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_gather_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_gather import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmem import pages  # noqa: E402

# (p, n_pages, page shape, k, dtype): 16-byte rows, rows of odd words,
# int32 words, p = 1, and a serving-pool page [pt, 2, hd]
CASES = [(4, 10, (32,), 7, torch.float32), (3, 9, (5,), 6, torch.float32),
         (4, 6, (8,), 5, torch.int32), (1, 5, (4,), 3, torch.float32),
         (4, 12, (4, 2, 32), 9, torch.float32)]
SHIFTS = [0, 1, -1, 3, 17]       # 17 >= p for every case above


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _inputs(p, n_pages, ps, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (p, n_pages) + ps
    if dtype == torch.int32:
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device="cuda",
                          dtype=torch.int32)
    else:
        x = torch.randn(shape, generator=g, device="cuda")
    ids = torch.randint(0, n_pages, (p, k), generator=g, device="cuda",
                        dtype=torch.int32)
    ids[0, 0] = -1                         # a hole: clamps to row 0
    ids[-1, -1] = n_pages + 4              # past the pool: clamps to the last
    return x, ids


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("p,n_pages,ps,k,dtype", CASES)
def test_kernel_is_bit_equal_to_plain(card, p, n_pages, ps, k, dtype, shift):
    x, ids = _inputs(p, n_pages, ps, k, dtype, seed=shift + 7)
    mesh = Mesh(p, "x", device="cuda")
    before = ops.launches
    out = ops.paged_gather(x, ids, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(out, ref.paged_gather_ref(x, ids, shift, mesh))
    masked = pages.gather_shift(mesh, x, ids, shift)
    assert ops.launches == before + 2
    assert not masked[0, 0].any()
    assert torch.equal(masked[0, 1:], out[0, 1:])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    x, ids = _inputs(4, 10, (32,), 7, torch.float32, seed=0)
    mesh = Mesh(4, "x", device="cuda")
    with pytest.raises(TypeError):
        ops.paged_gather(x.half(), ids, 1, mesh)
    with pytest.raises(TypeError):
        ops.paged_gather(x, ids.long(), 1, mesh)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_gather(x[:, :, :16], ids, 1, mesh)
    with pytest.raises(ValueError, match="several devices"):
        ops.paged_gather(x, ids.cpu(), 1, mesh)
