"""The paged-gather CUDA kernel, and `rmem.pages.gather_shift` through it
(the kernel's hole mode), against their plain PyTorch versions on the card:
bit-equal.  These tests
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


# hole mode at the smoke's edge cases: (p, n_pages, page shape, k, dtype, ids)
# with ids "all holes", "no hole", "mixed" (holes and ids past the pool)
HOLE_CASES = [(4, 10, (32,), 7, torch.float32), (3, 9, (7,), 6, torch.float32),
              (3, 9, (3,), 6, torch.float32), (4, 6, (8,), 5, torch.int32),
              (1, 5, (4,), 3, torch.float32), (4, 12, (16, 2, 128), 9, torch.float32)]
HOLE_IDS = ["all holes", "no hole", "mixed"]


def _hole_ids(kind, p, n_pages, k, g):
    if kind == "all holes":
        return torch.full((p, k), -1, device="cuda", dtype=torch.int32)
    ids = torch.randint(0, n_pages, (p, k), generator=g, device="cuda", dtype=torch.int32)
    if kind == "mixed":
        ids[0, ::2] = -1
        ids[-1, 0] = -7
        ids[-1, -1] = n_pages + 9
        ids[0, -1] = n_pages
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("kind", HOLE_IDS)
@pytest.mark.parametrize("shift", [0, -1, 1, 17])
@pytest.mark.parametrize("p,n_pages,ps,k,dtype", HOLE_CASES)
def test_hole_mode_is_bit_equal_to_plain(card, p, n_pages, ps, k, dtype, shift, kind):
    x, _ = _inputs(p, n_pages, ps, k, dtype, seed=shift + 31)
    g = torch.Generator(device="cuda").manual_seed(shift + 41)
    ids = _hole_ids(kind, p, n_pages, k, g)
    mesh = Mesh(p, "x", device="cuda")
    want = ref.paged_gather_holes_ref(x, ids, shift, mesh)
    before = ops.launches
    got = ops.paged_gather(x, ids, shift, mesh, holes=True)
    clamp = ops.paged_gather(x, ids, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches == before + 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(clamp.view(torch.int32),
                       ref.paged_gather_ref(x, ids, shift, mesh).view(torch.int32))
    assert torch.equal(pages.gather_shift(mesh, x, ids, shift).view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
def test_a_pool_past_two_to_the_31_words(card, holes):
    """A pool of 2 x 8200 rows of 128 Ki words (8.6 GB): row offsets pass
    2**31 words, so every address is 64-bit; rows of 512 KiB."""
    p, n_pages, w, k = 2, 8200, 1 << 17, 6
    x = torch.empty(p, n_pages, w, device="cuda")
    x[:, :8].normal_()
    x[:, -8:].normal_()
    ids = torch.tensor([[8199, -1, 3, 8192, 9000, 0], [-5, 8195, 8198, 1, 8200, 7]],
                       device="cuda", dtype=torch.int32)
    mesh = Mesh(p, "x", device="cuda")
    plain = ref.paged_gather_holes_ref if holes else ref.paged_gather_ref
    for shift in (0, 1):
        want = plain(x, ids, shift, mesh)
        got = ops.paged_gather(x, ids, shift, mesh, holes=holes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shift
    del x
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_three_calls_bit_equal_one_launch_each(card):
    x, ids = _inputs(4, 64, (16, 2, 128), 48, torch.float32, seed=5)
    ids[1, ::3] = -1
    mesh = Mesh(4, "x", device="cuda")
    for holes in (False, True):
        before = ops.launches
        outs = [ops.paged_gather(x, ids, 1, mesh, holes=holes) for _ in range(3)]
        torch.cuda.synchronize()
        assert ops.launches == before + 3
        assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
def test_launches_on_the_callers_stream(card, holes):
    """Launched on a side stream right after work queued there that makes
    its ids: the kernel must run on that stream, after the work."""
    from repro_torch.kernels import common

    x, ids = _inputs(4, 64, (16, 2, 128), 48, torch.float32, seed=6)
    mesh = Mesh(4, "x", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(4096, 4096, generator=g, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert common.current_stream(torch.cuda.current_device()) == side.cuda_stream
        b = a
        for _ in range(8):
            b = b @ a * 1e-3                       # milliseconds of work on `side`
        late = ids + (b[0, 0] * 0).to(torch.int32)  # the ids, made after it
        out = pages.gather_shift(mesh, x, late, 1) if holes else \
            ops.paged_gather(x, late, 1, mesh)
    side.synchronize()
    plain = ref.paged_gather_holes_ref if holes else ref.paged_gather_ref
    assert torch.equal(out, plain(x, ids, 1, mesh))
