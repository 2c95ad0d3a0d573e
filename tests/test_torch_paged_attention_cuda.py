"""The paged-attention CUDA kernels (pool-local and cross-rank) against
their plain PyTorch versions, on the card.  These tests carry the `cuda` marker and skip where no card is
present; the file imports no JAX, so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

TOL = 1e-4          # f32: the kernel sums in another order than the plain version


def _inputs(Sq: int, hd: int, pt: int, seed: int):
    """3 rows over 9 pages of a 40-page pool: row 0 has two masked pages,
    row 2 is fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, Sq, hd)).astype(np.float32)
    kv = rng.standard_normal((40, pt, 2, hd)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 9)).astype(np.int32)
    ids[0, 2] = ids[0, 5] = -1
    ids[2, :] = -1
    return tuple(torch.from_numpy(a).cuda() for a in (q, kv, ids))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,hd,pt", [(1, 32, 4), (4, 32, 4), (1, 128, 16), (4, 128, 16)])
def test_kernel_matches_plain(card, Sq, hd, pt, causal):
    q, kv, ids = _inputs(Sq, hd, pt, seed=Sq + hd + causal)
    before = ops.launches
    out = ops.paged_attention(q, kv, ids, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ref.paged_attention_ref(q, kv, ids, causal=causal)
    assert float((out - plain).abs().max()) <= TOL
    assert float(out[2].abs().max()) == 0.0       # fully masked row -> zeros


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    q, kv, ids = _inputs(1, 32, 4, seed=0)
    with pytest.raises(TypeError):
        ops.paged_attention(q.half(), kv.half(), ids)
    with pytest.raises(TypeError):
        ops.paged_attention(q, kv, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q, kv.transpose(0, 1).contiguous().transpose(0, 1), ids)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.paged_attention(q[..., :16].contiguous(), kv[..., :16].contiguous(), ids)


def _shift_inputs(p: int, Sq: int, hd: int, pt: int, seed: int):
    """p ranks of 12-page pools, 6 ids a rank: rank 0 has two masked pages
    and an id past its pool, the last rank is fully masked (when p > 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((p, Sq, hd)).astype(np.float32)
    kv = rng.standard_normal((p, 12, pt, 2, hd)).astype(np.float32)
    ids = rng.integers(0, 12, (p, 6)).astype(np.int32)
    ids[0, 1] = ids[0, 4] = -1
    ids[0, 2] = 12 + 3
    if p > 1:
        ids[-1, :] = -1
    return tuple(torch.from_numpy(a).cuda() for a in (q, kv, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, -1, 9])
@pytest.mark.parametrize("p,Sq,hd,pt,causal", [
    (4, 1, 128, 16, False), (4, 4, 128, 16, True), (3, 4, 32, 4, False),
    (1, 4, 64, 8, True)])
def test_shift_kernel_matches_plain(card, p, Sq, hd, pt, causal, shift):
    q, kv, ids = _shift_inputs(p, Sq, hd, pt, seed=p + Sq + shift)
    mesh = Mesh(p, "x", device="cuda")
    before = ops.shift_launches
    out = ops.paged_attention_shift(q, kv, ids, shift, mesh, causal=causal)
    torch.cuda.synchronize()
    assert ops.shift_launches == before + 1
    plain = ref.paged_attention_shift_ref(q, kv, ids, shift, mesh, causal=causal)
    assert float((out - plain).abs().max()) <= TOL
    if p > 1:
        assert float(out[-1].abs().max()) == 0.0   # fully masked rank -> zeros
    # unit scale, as the serving path calls it
    out1 = ops.paged_attention_shift(q, kv, ids, shift, mesh, scale=1.0)
    plain1 = ref.paged_attention_shift_ref(q, kv, ids, shift, mesh, scale=1.0)
    assert float((out1 - plain1).abs().max()) <= TOL


@pytest.mark.cuda
def test_shift_kernel_refuses_what_it_does_not_take(card):
    q, kv, ids = _shift_inputs(4, 1, 32, 4, seed=0)
    mesh = Mesh(4, "x", device="cuda")
    with pytest.raises(TypeError):
        ops.paged_attention_shift(q, kv, ids.long(), 1, mesh)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention_shift(q, kv.transpose(0, 1).contiguous().transpose(0, 1),
                                  ids, 1, mesh)
    with pytest.raises(ValueError, match="kv_pages"):
        ops.paged_attention_shift(q, kv.reshape(4, 12, -1, 32), ids, 1, mesh)


# ---- the split page walk: many splits a row, merged in the same launch

def _split_inputs(m: int, Sq: int, hd: int, pt: int, k: int, seed: int,
                  valid_rows=None, n_pages: int = 600):
    """m rows over k pages of an n_pages pool.  Rows outside `valid_rows`
    (all rows if None) are fully masked; a valid row has a few masked
    pages, one id past the pool, and entries 8-15 masked (two whole splits
    at 4 pages a split)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, Sq, hd)).astype(np.float32)
    kv = rng.standard_normal((n_pages, pt, 2, hd)).astype(np.float32)
    ids = np.full((m, k), -1, np.int32)
    for i in (range(m) if valid_rows is None else valid_rows):
        ids[i] = rng.integers(0, n_pages, k)
        ids[i, rng.integers(0, k, max(1, k // 10))] = -1
        ids[i, 8:16] = -1
        ids[i, min(3, k - 1)] = n_pages + 5
    return tuple(torch.from_numpy(a).cuda() for a in (q, kv, ids))


def _check(q, kv, ids, causal=False, scale=None, min_splits=2):
    assert ops.plan(q.shape[0], q.shape[1], ids.shape[1], kv.shape[1],
                    q.shape[2]).splits >= min_splits
    before = ops.launches
    out = ops.paged_attention(q, kv, ids, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    plain = ref.paged_attention_ref(q, kv, ids, causal=causal, scale=scale)
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= TOL
    return out


@pytest.mark.cuda
def test_split_main_path_two_valid_rows(card):
    """The decode path's shapes: q [64, 1, 128], k = 128 pages of 16
    tokens, 2 valid rows, unit scale; every masked row comes out 0."""
    q, kv, ids = _split_inputs(64, 1, 128, 16, 128, seed=5, valid_rows=(33, 50),
                               n_pages=2048)
    assert ops.plan(64, 1, 128, 16, 128).splits >= 32
    out = _check(q, kv, ids, scale=1.0)
    masked = [i for i in range(64) if i not in (33, 50)]
    assert float(out[masked].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("pt", [4, 16])
@pytest.mark.parametrize("Sq,causal", [(1, False), (4, False), (4, True), (8, True)])
def test_split_ragged_masked_and_causal(card, Sq, causal, pt):
    """k = 130 leaves a ragged last split; entries 8-15 are whole masked
    splits at pt 16; at Sq 4 and 8 the causal horizon falls inside the last
    split (at pt 4 and Sq 8 its last page lies past the horizon of the
    first four positions)."""
    q, kv, ids = _split_inputs(3, Sq, 128, pt, 130, seed=Sq + pt + causal)
    pl = ops.plan(3, Sq, 130, pt, 128)
    assert 130 % pl.pages != 0
    _check(q, kv, ids, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 96, 256, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_split_head_dims(card, hd, causal):
    q, kv, ids = _split_inputs(2, 4 if causal else 1, hd, 16, 128, seed=hd,
                               n_pages=300)
    _check(q, kv, ids, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("pt", [4, 64])
def test_split_page_sizes(card, pt):
    q, kv, ids = _split_inputs(3, 1, 128, pt, 128, seed=pt, n_pages=300)
    _check(q, kv, ids)


@pytest.mark.cuda
def test_split_unaligned_pool(card):
    """A pool view 4 bytes off a 16-byte boundary takes the scalar loads."""
    q, kv, ids = _split_inputs(3, 1, 128, 16, 128, seed=8, n_pages=300)
    flat = torch.empty(kv.numel() + 1, device="cuda")
    flat[1:] = kv.reshape(-1)
    shifted = flat[1:].view(kv.shape)
    assert shifted.data_ptr() % 16 != 0
    _check(q, shifted, ids)


@pytest.mark.cuda
def test_split_three_calls_bit_equal(card):
    q, kv, ids = _split_inputs(8, 4, 128, 16, 128, seed=9, valid_rows=(1, 2, 6),
                               n_pages=400)
    outs = [ops.paged_attention(q, kv, ids, causal=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_split_two_streams_at_once(card):
    """Two launches in flight on two streams, each with its own tickets,
    give what each gives alone."""
    a = _split_inputs(64, 1, 128, 16, 128, seed=10, valid_rows=(0, 17, 40), n_pages=1024)
    b = _split_inputs(64, 1, 128, 16, 128, seed=11, valid_rows=(3, 33, 63), n_pages=1024)
    want = [ops.paged_attention(*x, scale=1.0) for x in (a, b)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(20):
        for s, x, g in zip(streams, (a, b), got):
            with torch.cuda.stream(s):
                g.append(ops.paged_attention(*x, scale=1.0))
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert all(torch.equal(w, o) for o in g)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, -1, 9])
@pytest.mark.parametrize("Sq,causal", [(1, False), (4, True)])
def test_split_shift_one_valid_rank(card, shift, Sq, causal):
    """The shift form at p = 4, k = 128: only rank 2 has pages."""
    p, hd, pt, n_pages = 4, 128, 16, 256
    rng = np.random.default_rng(20 + shift)
    q = torch.from_numpy(rng.standard_normal((p, Sq, hd)).astype(np.float32)).cuda()
    kv = torch.from_numpy(rng.standard_normal((p, n_pages, pt, 2, hd)).astype(np.float32)).cuda()
    ids = np.full((p, 128), -1, np.int32)
    ids[2] = rng.integers(0, n_pages, 128)
    ids[2, 20:28] = -1
    ids[2, 5] = n_pages + 1
    ids = torch.from_numpy(ids).cuda()
    mesh = Mesh(p, "x", device="cuda")
    assert ops.plan(p, Sq, 128, pt, hd).splits >= 32
    before = ops.shift_launches
    out = ops.paged_attention_shift(q, kv, ids, shift, mesh, scale=1.0, causal=causal)
    torch.cuda.synchronize()
    assert ops.shift_launches == before + 1
    plain = ref.paged_attention_shift_ref(q, kv, ids, shift, mesh, scale=1.0, causal=causal)
    assert float((out - plain).abs().max()) <= TOL
    assert float(out[[0, 1, 3]].abs().max()) == 0.0
