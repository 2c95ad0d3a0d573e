"""Paged attention in the PyTorch port against the JAX reference.

The port's wrappers, given CPU tensors, compute the plain PyTorch versions;
each is held to the reference's Pallas kernel (interpret mode) and to the
reference's jnp oracle on the same numpy inputs, at atol = rtol = 1e-5
(f32; only the order of the sums differs).  The pool-local kernel runs in
this process; the cross-rank `paged_attention_shift` needs a 4-device mesh,
so this file's own ``__main__`` branch runs the reference's
`paged_attention_shift_pallas` (through its `ops`) and
`paged_attention_shift_ref` (inside `shard_map`) in one child process with
forced host devices.  At shift p + 1 the Pallas kernel is not run: its
requester index ``(me - shift + n) % n`` is negative for shift > n and the
interpret run never returns, so that case is held to the oracle alone.
The CUDA kernels themselves run only on a card: their tests are in
`test_torch_paged_attention_cuda.py`.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import paged_attention_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
M, HD, PT, K, N_PAGES = 3, 32, 4, 5, 12
TOL = dict(atol=1e-5, rtol=1e-5)
P_RANKS = 4
# cross-rank cases: (Sq, causal, shift, scale); the Pallas kernel runs
# all but the shift past p (see the module docstring)
SHIFT_CASES = [(1, False, 1, 1.0), (4, True, -1, None), (4, False, 0, None),
               (4, True, P_RANKS + 1, None)]


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


# ------------------------------------------------- cross-rank (4 ranks)
def _shift_inputs(Sq: int, seed: int):
    """Rank 0 has two masked pages, rank 1 one and an id past its pool,
    rank 2 is fully masked (its rows must come out zero)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P_RANKS, Sq, HD)).astype(np.float32)
    kv = rng.standard_normal((P_RANKS, N_PAGES, PT, 2, HD)).astype(np.float32)
    ids = rng.integers(0, N_PAGES, (P_RANKS, K)).astype(np.int32)
    ids[0, 1] = ids[0, 3] = -1
    ids[1, 4], ids[1, 0] = -1, N_PAGES + 2
    ids[2, :] = -1
    return q, kv, ids


def _shift_child(d: pathlib.Path) -> None:
    import functools

    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.kernels.paged_attention import ops as jops
    from repro.kernels.paged_attention.ref import paged_attention_shift_ref

    mesh = jax.make_mesh((P_RANKS,), ("x",))
    out = {}
    for i, (Sq, causal, shift, scale) in enumerate(SHIFT_CASES):
        q, kv, ids = (jnp.asarray(a) for a in _shift_inputs(Sq, seed=i))
        fn = functools.partial(paged_attention_shift_ref, shift=shift, axis="x",
                               scale=scale, causal=causal)
        out[f"oracle_{i}"] = np.asarray(jax.jit(shard_map(
            lambda qq, b, ii: fn(qq[0], b[0], ii[0])[None], mesh=mesh,
            in_specs=(P("x", None, None), P("x", None, None, None, None),
                      P("x", None)),
            out_specs=P("x", None, None), check_vma=False))(q, kv, ids))
        if abs(shift) < P_RANKS:
            out[f"pallas_{i}"] = np.asarray(jops.paged_attention_shift(
                q, kv, ids, shift, mesh, "x", scale=scale, causal=causal,
                interpret=True))
    np.savez(d / "out.npz", **out)


@pytest.fixture(scope="module")
def shift_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("paged_attention_shift_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={P_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", range(len(SHIFT_CASES)))
def test_shift_plain_matches_pallas_and_oracle(shift_reference, case):
    Sq, causal, shift, scale = SHIFT_CASES[case]
    q, kv, ids = _shift_inputs(Sq, seed=case)
    mesh = Mesh(P_RANKS, "x", device="cpu")
    before = ops.shift_launches
    out = ops.paged_attention_shift(torch.from_numpy(q), torch.from_numpy(kv),
                                    torch.from_numpy(ids), shift, mesh,
                                    scale=scale, causal=causal).numpy()
    assert ops.shift_launches == before            # the CPU path launches nothing
    np.testing.assert_allclose(out, shift_reference[f"oracle_{case}"], **TOL)
    if f"pallas_{case}" in shift_reference:
        np.testing.assert_allclose(out, shift_reference[f"pallas_{case}"], **TOL)
    assert np.all(out[2] == 0.0)                   # fully masked rank -> zeros
    # the pages come from rank r + shift: the own pool gives other rows
    if shift % P_RANKS:
        own = ops.paged_attention_shift(torch.from_numpy(q), torch.from_numpy(kv),
                                        torch.from_numpy(ids), 0, mesh,
                                        scale=scale, causal=causal).numpy()
        assert np.abs(own[:2] - out[:2]).max() > 1e-3


def test_shift_equals_pool_local_kernel_on_the_owner_pool():
    """Rank r over pool r + shift equals the pool-local kernel given that
    pool; shift 0 reads the rank's own pool."""
    q, kv, ids = _shift_inputs(4, seed=7)
    mesh = Mesh(P_RANKS, "x", device="cpu")
    for shift in (0, 1, -1, 2 * P_RANKS + 3):
        out = ops.paged_attention_shift(torch.from_numpy(q), torch.from_numpy(kv),
                                        torch.from_numpy(ids), shift, mesh, causal=True)
        for r in range(P_RANKS):
            owner = torch.from_numpy(kv[(r + shift) % P_RANKS])
            want = ops.paged_attention(torch.from_numpy(q[r:r + 1]), owner,
                                       torch.from_numpy(ids[r:r + 1]), causal=True)
            torch.testing.assert_close(out[r:r + 1], want, atol=1e-6, rtol=1e-6)


def test_shift_wrapper_checks_its_ranks():
    q, kv, ids = (torch.from_numpy(a) for a in _shift_inputs(1, seed=0))
    mesh = Mesh(P_RANKS, "x", device="cpu")
    with pytest.raises(Exception, match="leading rank dim"):
        ops.paged_attention_shift(q[:3], kv, ids, 1, mesh)
    with pytest.raises(ValueError, match="several devices"):
        ops.paged_attention_shift(q, kv.to("meta"), ids, 1, mesh)


if __name__ == "__main__":
    _shift_child(pathlib.Path(sys.argv[1]))
