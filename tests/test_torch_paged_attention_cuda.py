"""The paged-attention CUDA kernel against its plain PyTorch version, on
the card.  These tests carry the `cuda` marker and skip where no card is
present; the file imports no JAX, so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

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
