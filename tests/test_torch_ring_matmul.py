"""The fused ring matmul's plain versions against the JAX reference, and
`allgather_matmul_plan` against its closed form.

The reference's `ring_matmul` runs its Pallas kernel in interpret mode on 4
forced host devices in a child process (this file's own ``__main__``
branch), at the shapes and dtypes of `tests/subtests/ring_matmul_sub.py`;
both packages get the same numpy inputs.  The port's ring schedule (what
`ops.ring_matmul` computes on CPU tensors, every rank's copy) and its oracle
are held to the reference's output within the subtest's own bounds: 1e-3
abs in f32, 0.15 abs in bf16 (both packages multiply exact products in
f32; the sums run in other orders).  Every rank's copy equals rank 0's in
the ring schedule's own arithmetic only up to the order of its sums, so
the copies are held to the oracle within the same bounds.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.perfmodel import DEFAULT_MODEL, H100  # noqa: E402
from repro_torch.kernels.ring_matmul import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402
from repro_torch.parallel.overlap import CollectiveStrategist  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
N_RANKS = 4
# (K, m, N, dtype): the subtest's three cases
CASES = [(256, 16, 128, "float32"), (128, 8, 128, "float32"), (512, 32, 256, "bfloat16")]
TOL = {"float32": 1e-3, "bfloat16": 0.15}


def _inputs(K, m, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, m)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.kernels.ring_matmul.ops import ring_matmul

    mesh = jax.make_mesh((N_RANKS,), ("x",))
    out = {}
    for i, (K, m, N, dt) in enumerate(CASES):
        x_t, w = _inputs(K, m, N, i)
        y = ring_matmul(jnp.asarray(x_t, dt), jnp.asarray(w, dt), mesh, "x")
        out[f"y/{i}"] = np.asarray(y, np.float32)
    np.savez(d / "out.npz", **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_matmul_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _port_inputs(i):
    K, m, N, dt = CASES[i]
    x_t, w = _inputs(K, m, N, i)
    dtype = getattr(torch, dt)
    return (torch.from_numpy(x_t).to(dtype),
            torch.from_numpy(w).to(dtype).reshape(N_RANKS, K // N_RANKS, N))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_schedule_matches_reference(reference, i):
    x_t, w = _port_inputs(i)
    mesh = Mesh(N_RANKS, device="cpu")
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    assert ranks.shape == (N_RANKS, x_t.shape[1], w.shape[2])
    assert ranks.dtype == torch.float32
    want = reference[f"y/{i}"]
    tol = TOL[CASES[i][3]]
    for r in range(N_RANKS):
        err = np.abs(ranks[r].numpy() - want).max()
        assert err < tol, (r, err)
    assert torch.equal(ops.ring_matmul(x_t, w, mesh), ranks[0])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_oracle_matches_reference(reference, i):
    x_t, w = _port_inputs(i)
    mesh = Mesh(N_RANKS, device="cpu")
    got = ref.ring_matmul_ref(x_t, w, mesh)
    assert np.abs(got.numpy() - reference[f"y/{i}"]).max() < TOL[CASES[i][3]]
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    assert (ranks - got).abs().max() < TOL[CASES[i][3]]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_schedule_every_rank_count(n):
    """Rank r sums its shards in the order r, r-1, ...; all equal the oracle."""
    g = torch.Generator().manual_seed(n)
    ks, m, N = 5, 7, 9
    x_t = torch.randn(n * ks, m, generator=g, dtype=torch.float64)
    w = torch.randn(n, ks, N, generator=g, dtype=torch.float64)
    mesh = Mesh(n, device="cpu")
    ranks = ops.ring_matmul_ranks(x_t, w, mesh)
    want = x_t.T @ w.reshape(n * ks, N)
    assert torch.allclose(ranks, want.float().expand(n, m, N), atol=1e-5)


def test_ops_checks_its_inputs():
    mesh = Mesh(4, device="cpu")
    with pytest.raises(ValueError):
        ops.ring_matmul(torch.zeros(10, 3), torch.zeros(4, 2, 5), mesh)
    with pytest.raises(MeshError):
        ops.ring_matmul(torch.zeros(8, 3), torch.zeros(2, 4, 5), mesh)
    with pytest.raises(ValueError):
        ops.ring_matmul(torch.zeros(8, 3, 1), torch.zeros(4, 2, 5), mesh)


@pytest.mark.parametrize("m,k,n,shards,want", [
    (8192, 960, 2560, 4, "fused_ring"),          # SmolLM's MLP up projection, FSDP 4
    (8192, 2560, 960, 4, "fused_ring"),          # its down projection
    (16, 960, 2560, 4, "unfused"),               # a 16-token call: the put is not hidden
    (1, 1024, 1024, 8, "unfused"),
])
def test_allgather_matmul_plan_closed_form(m, k, n, shards, want):
    """Fuse iff 2 m (k/shards) n / peak_bf16 >= (launch + 2 * shard bytes /
    copy rate) / 2, with the H100 model's constants."""
    shard_bytes = k * n * 2 / shards
    t_put = H100.launch_latency + 2 * shard_bytes / H100.copy_bandwidth
    t_mm = 2 * m * (k / shards) * n / 989e12
    closed = "fused_ring" if t_mm >= 0.5 * t_put else "unfused"
    assert closed == want
    assert CollectiveStrategist().allgather_matmul_plan(m, k, n, shards) == want
    assert CollectiveStrategist(DEFAULT_MODEL).allgather_matmul_plan(
        m, k, n, shards, dtype_bytes=2) == want
    assert H100.peak_flops_bf16 == 989e12


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
