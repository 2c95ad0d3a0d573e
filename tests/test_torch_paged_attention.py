"""Paged attention in the PyTorch port against the JAX reference.

The port's wrapper, given CPU tensors, computes the plain PyTorch version;
it is held to the reference's Pallas kernel (interpret mode) and to the
reference's jnp oracle on the same numpy inputs, at atol = rtol = 1e-5
(f32; only the order of the sums differs).  The CUDA kernel itself runs
only on a card: its tests are in `test_torch_paged_attention_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import paged_attention_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402

M, HD, PT, K, N_PAGES = 3, 32, 4, 5, 12
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(Sq: int, seed: int = 0):
    """m=3 rows over k=5 pages of a 12-page pool: row 0 has two masked
    pages, row 1 one, row 2 is fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((M, Sq, HD)).astype(np.float32)
    kv = rng.standard_normal((N_PAGES, PT, 2, HD)).astype(np.float32)
    ids = rng.integers(0, N_PAGES, (M, K)).astype(np.int32)
    ids[0, 1] = ids[0, 3] = -1
    ids[1, 4] = -1
    ids[2, :] = -1
    return q, kv, ids


def _port(q, kv, ids, **kw):
    return ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kv),
                               torch.from_numpy(ids), **kw).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq", [1, 4])
def test_plain_matches_pallas_and_oracle(Sq, causal):
    q, kv, ids = _inputs(Sq, seed=Sq + 10 * causal)
    out = _port(q, kv, ids, causal=causal)
    pallas = np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(ids), causal=causal,
        interpret=True))
    oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv),
                                jnp.asarray(ids), causal=causal))
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    assert np.all(out[2] == 0.0)                  # fully masked row -> zeros
    # the mask is live: unmasking changes rows 0 and 1
    unmasked = _port(q, kv, np.abs(ids), causal=causal)
    assert np.abs(unmasked[:2] - out[:2]).max() > 1e-3


def test_serving_call_unit_scale():
    """The decoder's call: Sq=1, scale=1.0, non-causal."""
    q, kv, ids = _inputs(1, seed=3)
    out = _port(q, kv, ids, scale=1.0)
    oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv),
                                jnp.asarray(ids), scale=1.0))
    np.testing.assert_allclose(out, oracle, **TOL)


def test_ids_past_the_pool_clamp_like_the_reference():
    q, kv, ids = _inputs(1, seed=4)
    ids[1, 0] = N_PAGES + 7
    out = _port(q, kv, ids)
    oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(ids)))
    np.testing.assert_allclose(out, oracle, **TOL)


def test_cpu_path_counts_no_launch():
    q, kv, ids = _inputs(1)
    before = ops.launches
    _port(q, kv, ids)
    assert ops.launches == before


def test_wrapper_refuses_mixed_and_foreign_devices():
    q, kv, ids = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(ValueError, match="several devices"):
        ops.paged_attention(q, kv.to("meta"), ids)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paged_attention(q.to("meta"), kv.to("meta"), ids.to("meta"))


def test_build_targets_hopper_and_keys_by_source():
    flags = " ".join(common.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    lib = common.library_path("paged_attention")
    assert lib.parent == common.BUILD_DIR
    assert lib.name.startswith("libpaged_attention-") and lib.suffix == ".so"
    assert (common.CSRC / "paged_attention.cu").exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(common.KernelBuildError, match="nvcc not found"):
        common.nvcc_path()
