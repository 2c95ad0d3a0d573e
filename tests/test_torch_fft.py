"""The 3-D FFT of the PyTorch port (`repro_torch.apps.fft`) against the
JAX reference's pencil transform and against numpy.

The reference's pencil FFT lives inside `examples/fft3d.py`'s `main()`, so
this file's own ``__main__`` branch runs a copy of its body (lines 50-62)
under its own `shard_map` on 4 forced host devices at N = 16 and 32, and
saves the spectra and the `OpCounter` ledgers.  `fft3d` and `fft3d_slabs`
run on the same numpy grids on the stacked rank axis (``device="cpu"``):
each within 1e-5 of the spectrum's max abs of the reference's and of
`numpy.fft.fftn` in complex128, `fft3d`'s ledger equal to the pencil's.
(`benchmarks/bench_fft.py`'s two bodies keep only the first source's block
and transform axis 1 last, so they are no 3-D FFT and are not held here;
ROADMAP §3.)
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro_torch.apps import fft as tfft  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, SIZES, TOL = 4, (16, 32), 1e-5


def _grid(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((n, n, n))
            + 1j * rng.standard_normal((n, n, n))).astype(np.complex64)


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    from repro.core import collectives
    from repro.core.rma import OpCounter as JOpCounter

    mesh = jax.make_mesh((NP,), ("x",))
    out, snaps = {}, {}
    for N in SIZES:
        n = NP

        def pencil(v, N=N, n=n):          # examples/fft3d.py:50-62
            v = jnp.fft.fftn(v, axes=(1, 2))
            blk = v.reshape(v.shape[0], n, N // n, N)
            blk = blk.transpose(1, 0, 2, 3)
            blk = collectives.all_to_all(blk, "x")
            xs = blk.reshape(n * v.shape[0], N // n, N)
            xs = jnp.fft.fft(xs, axis=0)
            blk = xs.reshape(n, v.shape[0], N // n, N)
            blk = collectives.all_to_all(blk, "x")
            out = blk.transpose(1, 0, 2, 3).reshape(v.shape[0], N, N)
            return out

        f = jax.jit(shard_map(pencil, mesh=mesh, in_specs=P("x", None, None),
                              out_specs=P("x", None, None), check_vma=False))
        with JOpCounter() as c:
            out[f"n{N}"] = np.asarray(f(jnp.asarray(_grid(N))))
        snaps[f"n{N}"] = c.snapshot()
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("fft")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


def _stacked(g: np.ndarray, p: int) -> torch.Tensor:
    n = g.shape[0]
    return torch.from_numpy(g.reshape(p, n // p, n, n).copy())


def _close(got: torch.Tensor, want: np.ndarray) -> float:
    want = want.reshape(got.shape)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


# ================================================================ tests
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fn", ["fft3d", "fft3d_slabs"])
def test_fft_matches_reference_pencil_and_numpy(fn, n, jax_ref):
    ref_out, ref_snaps = jax_ref
    g = _grid(n)
    m = Mesh(NP, "x", device="cpu")
    with OpCounter() as c:
        got = getattr(tfft, fn)(_stacked(g, NP), m)
    assert got.shape == (NP, n // NP, n, n) and got.dtype == torch.complex64
    assert _close(got, ref_out[f"n{n}"]) < TOL
    assert _close(got, np.fft.fftn(g.astype(np.complex128))) < TOL
    # the pencil: two all-to-alls; the plane schedule: one a plane and one back
    want = ref_snaps[f"n{n}"] if fn == "fft3d" else dict(
        ref_snaps[f"n{n}"], colls=n // NP + 1, raw_msgs=n // NP + 1,
        coalesced_msgs=n // NP + 1, by_axis={"x": {"colls": n // NP + 1}})
    assert c.snapshot() == want


@pytest.mark.parametrize("fn", ["fft3d", "fft3d_slabs"])
def test_fft_on_one_rank(fn):
    g = _grid(8, seed=1)
    got = getattr(tfft, fn)(_stacked(g, 1), Mesh(1, "x", device="cpu"))
    assert _close(got, np.fft.fftn(g.astype(np.complex128))) < TOL


def test_fft_reference_is_the_global_transform():
    g = _grid(16, seed=2)
    got = tfft.fft3d_reference(_stacked(g, NP))
    assert got.shape == (NP, 16 // NP, 16, 16)
    assert _close(got, np.fft.fftn(g.astype(np.complex128))) < TOL


@pytest.mark.parametrize("fn", ["fft3d", "fft3d_slabs"])
def test_fft_grid_the_ranks_do_not_split_raises(fn):
    m = Mesh(3, "x", device="cpu")
    with pytest.raises(MeshError):                     # N = 8 over p = 3
        getattr(tfft, fn)(torch.zeros(3, 2, 8, 8, dtype=torch.complex64), m)
    with pytest.raises(MeshError):                     # not [p, N/p, N, N]
        getattr(tfft, fn)(torch.zeros(3, 2, 6, 5, dtype=torch.complex64), m)
    with pytest.raises(MeshError):
        getattr(tfft, fn)(torch.zeros(4, 2, 6, 6, dtype=torch.complex64), m)


def test_fft_flops_is_the_benchmark_count():
    for n in (64, 512):                                # benchmarks/bench_fft.py:57
        assert tfft.fft_flops(n) == 5 * n**3 * np.log2(n**3)
    assert tfft.fft_flops(512) == pytest.approx(1.8119e10, rel=1e-4)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
