"""Cross-rank paged gather in the PyTorch port against the JAX reference.

The port's `kernels.paged_gather.ops.paged_gather`, given CPU tensors,
computes the plain PyTorch version; it must equal, bit for bit, the
reference's Pallas kernel in interpret mode (through the reference's
`kernels/paged_gather/ops.py`) and its jnp oracle `paged_gather_ref`, on 4
forced host devices, at shifts 0, 1, -1 and p + 1, with ids of -1 and past
the pool, for f32 and int32 pages.  At p + 1 the Pallas kernel is not run:
its requester index ``(me - shift + n) % n`` is negative for shift > n
(rank 0 asks device -1) and the interpret run never returns, so that shift
is held to the oracle alone.  `rmem.pages.gather_shift` (its mask of
negative ids) and `rmem.pages.gather_pages` (the rendezvous pull, with its
message counts) are held to the reference's functions inside `shard_map`.

The reference needs a 4-device mesh, so this file's own ``__main__`` branch
runs it in one child process and saves its outputs; the CUDA kernel runs
only on a card (`test_torch_paged_gather_cuda.py`).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.paged_gather import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmem import pages as tpg  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
P_RANKS, N_PAGES, K, W = 4, 6, 5, 12
SHIFTS = (0, 1, -1, P_RANKS + 1)
PALLAS_SHIFTS = (0, 1, -1)          # the Pallas kernel's shifts (see above)
DTYPES = ("float32", "int32")
PT, D, M, PPB = 2, 3, 3, 4          # gather_pages: pages [PT, 2, D], [M, PPB] entries


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    ids = rng.integers(0, N_PAGES, (P_RANKS, K)).astype(np.int32)
    ids[0, 1] = ids[2, 4] = -1                  # holes
    ids[1, 0] = N_PAGES + 3                     # past the pool: clamps
    ids[3, :] = -1                              # a rank that wants nothing
    entries = np.stack([rng.integers(0, P_RANKS, (P_RANKS, M, PPB)),
                        rng.integers(0, N_PAGES, (P_RANKS, M, PPB))], -1).astype(np.int32)
    entries[0, 0, 1] = (-1, 2)                  # no owner
    entries[1, 2, 0] = (P_RANKS, 1)             # owner past the mesh
    entries[2, 1, 3] = (1, N_PAGES)             # page past the pool
    entries[3, 0, 2] = (2, -1)                  # negative page
    out = {
        "float32": rng.standard_normal((P_RANKS, N_PAGES, W)).astype(np.float32),
        "int32": rng.integers(-2**31, 2**31 - 1, (P_RANKS, N_PAGES, W)).astype(np.int32),
        "ids": ids,
        "pool": rng.standard_normal((P_RANKS, N_PAGES, PT, 2, D)).astype(np.float32),
        "entries": entries,
        "valid": np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [0, 0, 1]], bool),
    }
    # gather_shift's hole mode at its edges: every id a hole, no hole, ids
    # past the pool (clamped, never zeroed)
    out["ids_all_holes"] = np.full((P_RANKS, K), -1, np.int32)
    out["ids_no_holes"] = rng.integers(0, N_PAGES, (P_RANKS, K)).astype(np.int32)
    past = rng.integers(0, N_PAGES, (P_RANKS, K)).astype(np.int32)
    past[:, 0] = N_PAGES
    past[2, 3] = N_PAGES + 100
    out["ids_past"] = past
    return out


HOLE_CASES = ("ids_all_holes", "ids_no_holes", "ids_past")


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.rma import OpCounter as JaxCounter
    from repro.kernels.paged_gather import ops as jops
    from repro.kernels.paged_gather import ref as jref
    from repro.rmem import pages as jpg

    inp = np.load(d / "in.npz")
    mesh = jax.make_mesh((P_RANKS,), ("x",))
    ids = jnp.asarray(inp["ids"])
    out = {}

    def spmd(fn, *args, specs):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=specs, out_specs=specs[0],
            check_vma=False))(*args))

    p3, p2 = P("x", None, None), P("x", None)
    for dt in DTYPES:
        pages = jnp.asarray(inp[dt])
        for s in PALLAS_SHIFTS:
            out[f"pallas_{dt}_{s}"] = np.asarray(
                jops.paged_gather(pages, ids, s, mesh, "x", interpret=True))
        for s in SHIFTS:
            out[f"oracle_{dt}_{s}"] = spmd(
                lambda b, i, s=s: jref.paged_gather_ref(b[0], i[0], s, "x")[None],
                pages, ids, specs=(p3, p2))
    pool = jnp.asarray(inp["pool"])
    p5 = P("x", None, None, None, None)
    for s in SHIFTS:
        out[f"gather_shift_{s}"] = spmd(
            lambda b, i, s=s: jpg.gather_shift(b[0], i[0], s, "x")[None],
            pool, ids, specs=(p5, p2))
        for case in HOLE_CASES:
            out[f"gather_shift_{case}_{s}"] = spmd(
                lambda b, i, s=s: jpg.gather_shift(b[0], i[0], s, "x")[None],
                pool, jnp.asarray(inp[case]), specs=(p5, p2))
    with JaxCounter() as c:
        out["gather_pages"] = np.asarray(jax.jit(shard_map(
            lambda b, e, v: jpg.gather_pages("x", b[0], e[0], v[0])[None],
            mesh=mesh, in_specs=(p5, P("x", None, None, None), p2),
            out_specs=P("x", None, None, None, None, None), check_vma=False))(
                pool, jnp.asarray(inp["entries"]), jnp.asarray(inp["valid"])))
    out["gather_pages_counts"] = np.array([c.raw_msgs, c.coalesced_msgs, c.gets])
    out["gather_pages_bytes"] = np.array([pl["bytes_wire"] for pl in c.plans])
    np.savez(d / "out.npz", **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("paged_gather_ref")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={P_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


MESH = Mesh(P_RANKS, "x", device="cpu")


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_pallas_and_oracle(reference, dtype, shift):
    inp = _inputs()
    before = ops.launches
    got = ops.paged_gather(torch.from_numpy(inp[dtype]), torch.from_numpy(inp["ids"]),
                           shift, MESH).numpy()
    assert ops.launches == before                  # the CPU path launches nothing
    if shift in PALLAS_SHIFTS:
        np.testing.assert_array_equal(got, reference[f"pallas_{dtype}_{shift}"])
    np.testing.assert_array_equal(got, reference[f"oracle_{dtype}_{shift}"])
    # the clamp is live: the id past the pool reads the last row, -1 row 0
    src = (1 + shift) % P_RANKS
    np.testing.assert_array_equal(got[1, 0], inp[dtype][src, N_PAGES - 1])
    np.testing.assert_array_equal(got[0, 1], inp[dtype][shift % P_RANKS, 0])


@pytest.mark.parametrize("shift", SHIFTS)
def test_gather_shift_masks_holes_like_the_reference(reference, shift):
    inp = _inputs()
    got = tpg.gather_shift(MESH, torch.from_numpy(inp["pool"]),
                           torch.from_numpy(inp["ids"]), shift).numpy()
    np.testing.assert_array_equal(got, reference[f"gather_shift_{shift}"])
    assert not got[3].any() and not got[0, 1].any()      # holes are zeros
    assert got[2, 0].any()


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", HOLE_CASES)
def test_gather_shift_hole_mode_edges_match_the_reference(reference, case, shift):
    """The plain hole mode (`gather_shift`, and `paged_gather(holes=True)`,
    which it calls) equals the reference's gather_shift bit for bit when
    every id is a hole, when none is, and when ids pass the pool."""
    inp = _inputs()
    pool, ids = torch.from_numpy(inp["pool"]), torch.from_numpy(inp[case])
    before = ops.launches
    got = tpg.gather_shift(MESH, pool, ids, shift)
    assert ops.launches == before
    np.testing.assert_array_equal(got.numpy(), reference[f"gather_shift_{case}_{shift}"])
    assert torch.equal(got, ops.paged_gather(pool, ids, shift, MESH, holes=True))
    if case == "ids_all_holes":
        assert not got.any() and not torch.signbit(got).any()       # +0.0 words
    else:
        assert torch.equal(got, ref.paged_gather_ref(pool, ids, shift, MESH))


def test_gather_pages_matches_reference(reference):
    inp = _inputs()
    with OpCounter() as c:
        got = tpg.gather_pages(MESH, torch.from_numpy(inp["pool"]),
                               torch.from_numpy(inp["entries"]),
                               torch.from_numpy(inp["valid"])).numpy()
    np.testing.assert_array_equal(got, reference["gather_pages"])
    assert got.shape == (P_RANKS, M, PPB, PT, 2, D)
    assert not got[~inp["valid"]].any() and not got[0, 0, 1].any()
    # the pull is two fused gets: the id lists out, the packed replies back
    assert [c.raw_msgs, c.coalesced_msgs, c.gets] == list(reference["gather_pages_counts"])
    assert [pl["bytes_wire"] for pl in c.plans] == list(reference["gather_pages_bytes"])
    assert (c.raw_msgs, c.coalesced_msgs, c.gets) == (2, 2, 2)


def test_gather_pages_equals_gather_shift_per_owner():
    """The pull and the kernel's gather read the same rows: for every shift,
    the pulled pages whose owner is rank r + shift equal gather_shift's."""
    inp = _inputs()
    pool = torch.from_numpy(inp["pool"])
    entries = torch.from_numpy(inp["entries"])
    valid = torch.from_numpy(inp["valid"])
    block = tpg.gather_pages(MESH, pool, entries, valid).reshape(P_RANKS, M * PPB, PT, 2, D)
    owner = entries[..., 0].reshape(P_RANKS, -1)
    page = entries[..., 1].reshape(P_RANKS, -1)
    want = valid.repeat_interleave(PPB, 1) & (page >= 0) & (page < N_PAGES)
    me = torch.arange(P_RANKS)[:, None]
    combined = torch.zeros_like(block)
    for s in range(P_RANKS):
        hit = want & (owner == (me + s) % P_RANKS)
        ids = torch.where(hit, page, torch.full_like(page, -1)).to(torch.int32)
        combined += tpg.gather_shift(MESH, pool, ids, s)
    assert torch.equal(combined, block)


def test_wrapper_refuses_what_it_does_not_take():
    inp = _inputs()
    pages, ids = torch.from_numpy(inp["float32"]), torch.from_numpy(inp["ids"])
    with pytest.raises(ValueError, match="several devices"):
        ops.paged_gather(pages, ids.to("meta"), 1, MESH)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.paged_gather(pages.to("meta"), ids.to("meta"), 1, MESH)
    with pytest.raises(ValueError, match="\\[p, k\\]"):
        ops.paged_gather(pages, ids[:, :, None], 1, MESH)
    with pytest.raises(Exception, match="leading rank dim"):
        ops.paged_gather(pages[:3], ids[:3], 1, MESH)


def test_build_targets_hopper_and_keys_by_source():
    lib = common.library_path("paged_gather")
    assert lib.parent == common.BUILD_DIR and lib.name.startswith("libpaged_gather-")
    assert (common.CSRC / "paged_gather.cu").exists()
    assert "paged_gather_shift" in (common.CSRC / "paged_gather.cu").read_text()


def test_plain_version_is_the_two_message_gather():
    """The plain version is the reference's two shifts: ids to the owner,
    the packed rows back, on any mesh size (p = 1 included)."""
    one = Mesh(1, "x", device="cpu")
    pages = torch.arange(12, dtype=torch.float32).reshape(1, 4, 3)
    ids = torch.tensor([[3, -1, 9, 0]], dtype=torch.int32)
    got = ref.paged_gather_ref(pages, ids, 7, one)
    assert torch.equal(got, pages[0][torch.tensor([3, 0, 3, 0])][None])


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
