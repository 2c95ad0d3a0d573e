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
