"""The rank axis over processes (`repro_torch.procmesh.ProcMesh`, one rank
a process) against the JAX reference and against the stacked `Mesh`.

Four CPU processes are spawned once for the whole file (gloo over a
`FileStore` in a temporary directory, shared-memory windows, the peer
forms' plain versions); every rank runs the same cases on its own block
and returns its outputs and its `OpCounter` / `PlanStats` / `SyncStats`
ledgers.  The reference runs the same cases under `shard_map` on 4 forced
host devices, and the Pallas rma kernels in interpret mode, in one child
process started beside the ranks (this file's ``__main__`` branch, so the
test process and the ranks never import JAX); the stacked `Mesh(4)` runs
them in the test process.  Tolerances: copies, single adds and the MILC
step are bit-equal to the stacked run (the same sums in the same order);
against the reference the ring reductions are held to rel 1e-6 and the
MILC step to abs 1e-5 (its own tolerance), the rest bit-equal.  Ledgers are
per rank and equal to both, with the reference's traced loop bodies
unrolled as in `tests/test_torch_rma.py`.  A rank that raises or hangs
fails `run` (and the test) at the timeout, never the suite.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402
from repro_torch.apps import milc as tmilc  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.core import epoch as tepoch  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import rma as trma  # noqa: E402
from repro_torch.core import window as twin  # noqa: E402
from repro_torch.core.perfmodel import DEFAULT_MODEL, H100  # noqa: E402
from repro_torch.kernels.rma import ops as tops  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP = 4                  # ranks: processes here, forced host devices in the reference
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the test
PERM_REV = [(i, NP - 1 - i) for i in range(NP)]
PERM_PART = [(0, 2), (1, 3), (3, 0)]             # rank 1 gets zeros
BACKEND_NAMES = {"xla": "torch", "pallas": "cuda"}
REL_REDUCE = 1e-6       # ring reductions vs the reference: f32 in the ring's order
ABS_MILC = 1e-5
# the reference counts a traced `fori_loop` body once; the port every step
LOOP_TRIPS = {
    "ring_all_gather_bidir": [NP // 2],
    "ring_all_gather_uni": [NP - 1],
    "ring_reduce_scatter": [NP - 1],
    "all_reduce_divisible": [NP - 1, NP // 2],
    "all_reduce_ragged": [NP - 1, NP // 2],
}
KERNEL_CASES = [("put_shift", 1), ("put_shift", -1), ("get_shift", 1), ("get_shift", 3),
                ("accumulate_shift", 1), ("accumulate_shift", -1), ("ring_all_gather", 0)]


def _inputs() -> dict:
    rng = np.random.default_rng(29)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {
        "x": f(NP, 3, 5), "y": f(NP, 3, 5), "acc": f(NP, 3, 5), "c": f(NP, 2, 3),
        "xi": rng.integers(-2**31, 2**31, (NP, 4), dtype=np.int64).astype(np.int32),
        "a2a": f(NP, NP, 2), "a2at": f(NP, NP * 2, 3), "tgt": f(NP), "fx": f(NP),
        "ring": f(NP, 4, 6), "rs": f(NP, NP, 3), "ar4": f(NP, NP, 5), "ar7": f(NP, 7, 5),
        "halo": f(NP, 4, 2), "halo3": f(NP, 3, 4, 2), "lat": f(NP, 2, 4, 4, 4, 6),
        "kx": np.arange(NP * 8 * 128, dtype=np.float32).reshape(NP, 8, 128) * 0.5 - 17.0,
        "kacc": f(NP, 8, 128),
    }


# ================================================================ cases
# name -> (input names, port fn (cap, mesh, *tensors)).  The same function
# runs on the stacked Mesh(4) (inputs [4, ...]) and on each rank's
# ProcMesh (its rows [1, ...]); `cap` takes the ledgers read in the case.
def _port_cases():
    def access(family):
        def fn(cap, m, x, y, acc, tgt, fx):
            kw = {"group": [0, 1]} if family == "pscw" else {}
            ep = tplan.AccessEpoch(m, family=family, **kw)
            x = ep.open(x)
            hs = [ep.put_shift(x, 1), ep.get_shift(y, 2), ep.accumulate_shift(x, acc, 1),
                  ep.put_shift(y, 1), ep.put_perm(x, PERM_REV), ep.fetch_and_op(fx, tgt)]
            x = ep.close(x, aggregate=True)
            cap["plan"] = ep.plan_stats.snapshot()
            cap["sync"] = ep.sync.stats.snapshot()
            outs = [x]
            for h in hs:
                r = h.result()
                outs.extend(r if isinstance(r, tuple) else (r,))
            return tuple(outs)
        return ("x", "y", "acc", "tgt", "fx"), fn

    def milc(cap, m, v):
        seen = []
        real = tepoch.PSCWEpoch.__init__

        def tap(self, *a, **kw):
            real(self, *a, **kw)
            seen.append(self)

        tepoch.PSCWEpoch.__init__ = tap
        try:
            out = tmilc.stencil_step(v, m)
        finally:
            tepoch.PSCWEpoch.__init__ = real
        cap["sync"] = seen[0].stats.snapshot()
        return out

    return {
        "rank": ((), lambda cap, m: trma.rank(m)),
        "put_shift+1": (("x",), lambda cap, m, x: trma.put_shift(x, 1, m)),
        "put_shift-1": (("x",), lambda cap, m, x: trma.put_shift(x, -1, m)),
        "put_shift+3": (("xi",), lambda cap, m, x: trma.put_shift(x, 3, m)),
        "get_shift+1": (("c",), lambda cap, m, x: trma.get_shift(x, 1, m)),
        "get_shift-3": (("xi",), lambda cap, m, x: trma.get_shift(x, -3, m)),
        "get_index": (("x",), lambda cap, m, x: trma.get_index(x, 2, m)),
        "put_perm_partial": (("xi",), lambda cap, m, x: trma.put_perm(x, PERM_PART, m)),
        "accumulate_shift": (("x", "acc"), lambda cap, m, x, a: trma.accumulate_shift(x, a, 1, m)),
        "accumulate_shift_max": (("x", "acc"), lambda cap, m, x, a: trma.accumulate_shift(
            x, a, -2, m, op=torch.maximum)),
        "put_all_to_all": (("a2a",), lambda cap, m, x: trma.put_all_to_all(x, m)),
        "put_all_to_all_tiled": (("a2at",), lambda cap, m, x: trma.put_all_to_all(
            x, m, tiled=True)),
        "broadcast": (("x",), lambda cap, m, x: tcoll.broadcast(x, 3, m)),
        "epoch_fence": access("fence"),
        "epoch_pscw": access("pscw"),
        "epoch_lock": access("lock"),
        "ring_all_gather_bidir": (("ring",), lambda cap, m, x: tcoll.ring_all_gather(x, m)),
        "ring_all_gather_uni": (("ring",), lambda cap, m, x: tcoll.ring_all_gather(
            x, m, bidirectional=False)),
        "ring_reduce_scatter": (("rs",), lambda cap, m, x: tcoll.ring_reduce_scatter(x, m)),
        "all_reduce_divisible": (("ar4",), lambda cap, m, x: tcoll.all_reduce(x, m)),
        "all_reduce_ragged": (("ar7",), lambda cap, m, x: tcoll.all_reduce(x, m)),
        "halo_exchange_1d": (("halo",), lambda cap, m, x: tcoll.halo_exchange_1d(x, 1, m, dim=0)),
        "halo_exchange_1d_dim1": (("halo3",), lambda cap, m, x: tcoll.halo_exchange_1d(
            x, 2, m, dim=1)),
        "milc_step": (("lat",), milc),
    }


CASE_NAMES = list(_port_cases())


def _run_case(name: str, m, tensors: dict):
    from repro_torch.core.rma import OpCounter

    names, fn = _port_cases()[name]
    cap: dict = {}
    with OpCounter() as c:
        res = fn(cap, m, *[tensors[n] for n in names])
    res = res if isinstance(res, tuple) else (res,)
    return [r.numpy() for r in res], {"ops": c.snapshot(), "plans": c.plans, **cap}


def _rank_main(mesh, inputs: dict) -> dict:
    """Every case on this rank's rows, the peer ops' plain versions at the
    Pallas kernels' inputs, and a window written through `Window.peer`."""
    r = mesh.rank
    rows = {k: torch.from_numpy(v[r:r + 1].copy()) for k, v in inputs.items()}
    out = {"cases": {}, "syncs": {}}
    for name in CASE_NAMES:
        before = mesh.barriers, mesh.tokens
        out["cases"][name] = _run_case(name, mesh, rows)
        out["syncs"][name] = (mesh.barriers - before[0], mesh.tokens - before[1])
    before = dict(tops.launches)
    kern = {}
    for name, s in KERNEL_CASES:
        if name == "accumulate_shift":
            got = tops.accumulate_shift(rows["kx"], rows["kacc"], s, mesh)
        elif name == "ring_all_gather":
            got = tops.ring_all_gather(rows["kx"], mesh)
        else:
            got = getattr(tops, name)(rows["kx"], s, mesh)
        kern[f"{name}{s}"] = got.numpy()
    out["kernels"], out["launched"] = kern, tops.launches != before
    win, buf = twin.win_allocate(mesh, (2, 3), torch.int32)
    win.peer(r + 1).fill_(r)                    # a store into the right neighbour's block
    mesh.fence()
    out["window"] = (buf.clone().numpy(), win.block_shape(), win.global_shape())
    twin.win_free(win)
    out["axis_index"] = mesh.axis_index().tolist()
    return out


def _card_rank(mesh) -> dict:
    """Each peer kernel against its plain version on the card, this rank's
    launches counted: shifts 0, 1, -1, >= p; 16-byte rows, 21-word rows,
    int32, a block that is not contiguous."""
    from repro_torch.kernels.rma import ref

    g = torch.Generator(device=mesh.device).manual_seed(mesh.rank)
    xs = [torch.randn(1, 6, 32, device=mesh.device, generator=g),
          torch.randn(1, 3, 7, device=mesh.device, generator=g),
          torch.randint(-2**31, 2**31 - 1, (1, 8), device=mesh.device, generator=g,
                        dtype=torch.int32),
          torch.randn(1, 4, 8, device=mesh.device, generator=g)[:, :, :3]]
    before, same = dict(tops.launches), True
    for x in xs:
        for s in (0, 1, -1, mesh.p + 1):
            same &= torch.equal(tops.put_shift(x, s, mesh), ref.put_shift_ref(x, s, mesh))
            same &= torch.equal(tops.get_shift(x, s, mesh), ref.get_shift_ref(x, s, mesh))
            if x.dtype == torch.float32:
                acc = torch.randn(x.shape, device=mesh.device, generator=g)
                same &= torch.equal(tops.accumulate_shift(x, acc, s, mesh),
                                    ref.accumulate_shift_ref(x, acc, s, mesh))
        same &= torch.equal(tops.ring_all_gather(x, mesh), ref.ring_all_gather_ref(x, mesh))
    return {"same": bool(same), "launched": {k: tops.launches[k] - before[k] for k in before}}


def _raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one refuses")
    mesh.barrier()          # the others wait for it


def _hangs(mesh):
    if mesh.rank == 0:
        time.sleep(600)
    return mesh.rank


# ================================================================ JAX child
def _jax_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import collectives as jc
    from repro.core import rma as jr
    from repro.core.epoch import PSCWEpoch
    from repro.core.plan import AccessEpoch
    from repro.core.rma import OpCounter
    from repro.kernels.rma import ops as jops

    def access(family):
        def fn(cap, x, y, acc, tgt, fx):
            kw = {"p": NP} if family == "fence" else {"group": [0, 1]} if family == "pscw" else {}
            ep = AccessEpoch("x", family=family, **kw)
            x = ep.open(x)
            hs = [ep.put_shift(x, 1), ep.get_shift(y, 2), ep.accumulate_shift(x, acc, 1),
                  ep.put_shift(y, 1), ep.put_perm(x, PERM_REV), ep.fetch_and_op(fx, tgt)]
            x = ep.close(x, aggregate=True)
            cap["plan"] = ep.plan_stats.snapshot()
            cap["sync"] = ep.sync.stats.snapshot()
            outs = [x]
            for h in hs:
                r = h.result()
                outs.extend(r if isinstance(r, tuple) else (r,))
            return tuple(outs)
        return fn

    def milc(cap, v):
        ep = PSCWEpoch("x", group=[0, 1])
        v = ep.post(v)
        padded = jc.halo_exchange_1d(v, 1, "x", dim=0)
        v2 = ep.complete(v)
        cap["sync"] = ep.stats.snapshot()
        acc = padded[2:] + padded[:-2]
        for dim in (1, 2, 3):
            acc = acc + jnp.roll(v2, 1, axis=dim) + jnp.roll(v2, -1, axis=dim)
        return acc - 8.0 * v2

    cases = {
        "rank": lambda cap: jr.rank("x"),
        "put_shift+1": lambda cap, x: jr.put_shift(x, 1, "x"),
        "put_shift-1": lambda cap, x: jr.put_shift(x, -1, "x"),
        "put_shift+3": lambda cap, x: jr.put_shift(x, 3, "x"),
        "get_shift+1": lambda cap, x: jr.get_shift(x, 1, "x"),
        "get_shift-3": lambda cap, x: jr.get_shift(x, -3, "x"),
        "get_index": lambda cap, x: jr.get_index(x, 2, "x"),
        "put_perm_partial": lambda cap, x: jr.put_perm(x, PERM_PART, "x"),
        "accumulate_shift": lambda cap, x, a: jr.accumulate_shift(x, a, 1, "x"),
        "accumulate_shift_max": lambda cap, x, a: jr.accumulate_shift(x, a, -2, "x",
                                                                      op=jnp.maximum),
        "put_all_to_all": lambda cap, x: jr.put_all_to_all(x, "x"),
        "put_all_to_all_tiled": lambda cap, x: jr.put_all_to_all(x, "x", tiled=True),
        "broadcast": lambda cap, x: jc.broadcast(x, 3, "x"),
        "epoch_fence": access("fence"),
        "epoch_pscw": access("pscw"),
        "epoch_lock": access("lock"),
        "ring_all_gather_bidir": lambda cap, x: jc.ring_all_gather(x, "x"),
        "ring_all_gather_uni": lambda cap, x: jc.ring_all_gather(x, "x", bidirectional=False),
        "ring_reduce_scatter": lambda cap, x: jc.ring_reduce_scatter(x, "x"),
        "all_reduce_divisible": lambda cap, x: jc.all_reduce(x, "x"),
        "all_reduce_ragged": lambda cap, x: jc.all_reduce(x, "x"),
        "halo_exchange_1d": lambda cap, x: jc.halo_exchange_1d(x, 1, "x", dim=0),
        "halo_exchange_1d_dim1": lambda cap, x: jc.halo_exchange_1d(x, 2, "x", dim=1),
        "milc_step": milc,
    }
    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NP,), ("x",))
    out, snaps = {}, {}
    for name, fn in cases.items():
        names = _port_cases()[name][0]
        cap: dict = {}

        def body(*blocks, fn=fn, cap=cap):
            res = fn(cap, *[b[0] for b in blocks])
            res = res if isinstance(res, tuple) else (res,)
            return tuple(jnp.asarray(r)[None] for r in res)

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(P("x") for _ in names),
                              out_specs=P("x"), check_vma=False))
        with OpCounter() as c:
            res = f(*[jnp.asarray(inp[n]) for n in names])
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        snaps[name] = {"ops": c.snapshot(), "plans": c.plans, **cap}

    x = jnp.asarray(inp["kx"].reshape(NP * 8, 128))
    acc = jnp.asarray(inp["kacc"].reshape(NP * 8, 128))
    for name, s in KERNEL_CASES:
        if name == "accumulate_shift":
            y = jops.accumulate_shift(x, acc, s, mesh, "x", interpret=True)
        elif name == "ring_all_gather":
            y = jops.ring_all_gather(x, mesh, "x", interpret=True)
        else:
            y = getattr(jops, name)(x, s, mesh, "x", interpret=True)
        out[f"kernel/{name}{s}"] = np.asarray(y)
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """(the reference's outputs and ledgers, every rank's results): the JAX
    child and the four ranks run side by side."""
    d = tmp_path_factory.mktemp("procmesh")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "jax", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(inputs,), axis="x",
                             timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    ref = dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())
    return ref, ranks


@pytest.fixture(scope="module")
def stacked(inputs):
    """Every case on the stacked Mesh(4) in this process."""
    m = Mesh(NP, "x", device="cpu")
    full = {k: torch.from_numpy(v.copy()) for k, v in inputs.items()}
    return {name: _run_case(name, m, full) for name in CASE_NAMES}


# ================================================================ helpers
def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 and a.dtype.kind == "f" else a


def _unrolled(ref: dict, trips: list) -> dict:
    """The reference's ledgers with each traced loop body counted once per
    step the port runs (every plan of these cases records puts only)."""
    assert len(ref["plans"]) == len(trips)
    plans = [pl for pl, n in zip(ref["plans"], trips) for _ in range(n)]
    puts = sum(pl["raw"] for pl in plans)
    wire = sum(pl["coalesced"] for pl in plans)
    ops = {"puts": puts, "gets": 0, "accs": 0, "colls": 0, "raw_msgs": puts,
           "coalesced_msgs": wire, "by_axis": {"x": {"puts": puts}}}
    return {"ops": ops, "plans": plans}


def _torch_names(snap: dict) -> dict:
    snap = dict(snap)
    snap["backends"] = {BACKEND_NAMES[k]: v for k, v in snap["backends"].items()}
    return snap


# ================================================================ tests
@pytest.mark.parametrize("name", CASE_NAMES)
def test_each_rank_matches_the_reference(name, runs):
    (ref_out, ref_snaps), ranks = runs
    ref = ref_snaps[name]
    if name in LOOP_TRIPS:
        ref = {**ref, **_unrolled(ref, LOOP_TRIPS[name])}
    for r, res in enumerate(ranks):
        got, snap = res["cases"][name]
        assert f"{name}/{len(got)}" not in ref_out, "the port returned fewer outputs"
        for i, g in enumerate(got):
            w = ref_out[f"{name}/{i}"][r:r + 1]
            assert g.shape == w.shape, (r, i, g.shape, w.shape)
            if name == "milc_step":
                np.testing.assert_allclose(g, w, rtol=0, atol=ABS_MILC)
            elif name.startswith(("ring_reduce_scatter", "all_reduce")):
                np.testing.assert_allclose(g, w, rtol=REL_REDUCE,
                                           atol=REL_REDUCE * np.abs(w).max())
            else:
                np.testing.assert_array_equal(_bits(g), _bits(w.astype(g.dtype)),
                                              err_msg=f"rank {r} output {i}")
        if name.startswith("epoch_"):
            # packing: the reference's TPU model against the port's H100 model
            # (aggregate=True forces it in both); bytes and counts per rank
            assert snap["plan"] == _torch_names(ref["plan"]), r
        assert snap["ops"] == ref["ops"], r
        assert snap["plans"] == ref["plans"], r
        if "sync" in ref:
            assert snap["sync"] == ref["sync"], r


@pytest.mark.parametrize("name", CASE_NAMES)
def test_each_rank_is_its_row_of_the_stacked_run(name, runs, stacked):
    """Bit for bit, ledgers included: the same ops in the same order, each
    rank's row of the stacked Mesh(4)'s results."""
    _, ranks = runs
    want, want_snap = stacked[name]
    for r, res in enumerate(ranks):
        got, snap = res["cases"][name]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(_bits(g), _bits(w[r:r + 1]), err_msg=f"rank {r} out {i}")
        assert snap == want_snap, r


@pytest.mark.parametrize("name,shift", KERNEL_CASES)
def test_peer_plain_versions_match_pallas(name, shift, runs):
    """The peer forms' plain versions (what a CPU ProcMesh takes) against the
    Pallas kernels in interpret mode: each rank's block, bit-equal."""
    (ref_out, _), ranks = runs
    want = ref_out[f"kernel/{name}{shift}"]
    for r, res in enumerate(ranks):
        got = res["kernels"][f"{name}{shift}"]
        assert not res["launched"]                  # CPU tensors never launch
        if name == "ring_all_gather":
            assert got.shape == (1, NP, 8, 128)
            np.testing.assert_array_equal(_bits(got[0]), _bits(want.reshape(NP, 8, 128)))
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want.reshape(NP, 8, 128)[r:r + 1]))


def test_window_stores_reach_the_peer_after_a_fence(runs):
    _, ranks = runs
    for r, res in enumerate(ranks):
        buf, block, glob = res["window"]
        assert (buf == (r - 1) % NP).all() and buf.shape == (1, 2, 3)
        assert tuple(block) == (1, 2, 3) and tuple(glob) == (NP, 2, 3)
        assert res["axis_index"] == [r]


def test_epochs_synchronise_by_their_own_messages(runs):
    """Host barriers and sent tokens a rank, by case: an eager op fences
    (one barrier a round); a plan flushed in an epoch stores its puts with
    no fence, so the fence epoch takes its two fences plus one for the
    PERM_REV group, PSCW (k = 2) four tokens plus the fences of its groups
    outside the ring neighbours (shift -2, PERM_REV), and the MILC step
    four tokens and no barrier."""
    _, ranks = runs
    want = {"milc_step": (0, 4), "epoch_pscw": (2, 4), "epoch_fence": (3, 0),
            "epoch_lock": (3, 0), "halo_exchange_1d": (2, 0), "put_shift+1": (1, 0)}
    for res in ranks:
        assert {k: res["syncs"][k] for k in want} == want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_peer_kernels_equal_their_plain_versions_on_the_card(card):
    for res in procmesh.run(_card_rank, 3, timeout=TIMEOUT):
        assert res["same"]
        # each kernel where it is launched: the put kernel also exposes a
        # get's block and stores an accumulate's slot; a gather hops p - 1 times
        assert res["launched"] == {"put_shift": 16 + 16 + 12, "get_shift": 16,
                                   "accumulate_shift": 12, "ring_all_gather": 4 * 2}


def test_a_rank_that_raises_is_reported_with_its_rank():
    t0 = time.monotonic()
    with pytest.raises(procmesh.ProcMeshError, match=r"(?s)rank 1 raised.*rank one refuses"):
        procmesh.run(_raises, 2, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 60


def test_a_hanging_rank_is_cut_at_the_timeout():
    import multiprocessing

    t0 = time.monotonic()
    with pytest.raises(procmesh.ProcMeshError, match=r"ranks \[0(, 1)?\] not done after 8.0 s"):
        procmesh.run(_hangs, 2, device="cpu", timeout=8.0)
    assert time.monotonic() - t0 < 45
    assert not [c for c in multiprocessing.active_children() if "Spawn" in c.name]


def test_a_one_rank_mesh_runs_in_this_process():
    m = procmesh.ProcMesh(1, 0, device="cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    for s in (0, 1, -1, 5):
        assert torch.equal(tops.put_shift(x, s, m), x)
        assert torch.equal(tops.get_shift(x, s, m), x)
        assert torch.equal(tops.accumulate_shift(x, x, s, m), 2 * x)
    assert torch.equal(tops.ring_all_gather(x, m), x[None])
    assert torch.equal(tcoll.all_reduce(x, m), x)
    workdir = m.workdir
    m.close()
    assert m.workdir is None and not os.path.exists(workdir)   # every segment's file gone


def test_the_mesh_surface_refuses_what_the_stacked_mesh_refuses():
    m = procmesh.ProcMesh(4, 2, "t", device="cpu")
    assert (m.p, m.ranks, m.local_ranks, m.axis) == (4, 4, 1, "t")
    assert Mesh(4, "t", device="cpu").local_ranks == 4
    with pytest.raises(MeshError, match="rank block"):
        m.shift(torch.ones(4, 3), 1)
    with pytest.raises(MeshError, match="no axis"):
        m.along("x")
    with pytest.raises(MeshError, match="lattice must be"):
        tmilc.stencil_step(torch.ones(4, 2, 4, 4, 4, 6), m)
    # a grid: row-major ranks, one unit rank dim an axis, one-axis views
    g = procmesh.ProcMesh({"pod": 2, "data": 3}, 4, device="cpu")
    assert (g.shape, g.axis_names, g.p, g.ranks, g.coords) == (
        {"pod": 2, "data": 3}, ("pod", "data"), 6, 6, (1, 1))
    assert g.rank_dims == (1, 1) and g.dim("data") == 1
    data, pod = g.along("data"), g.along("pod")
    assert (data.p, data.rank, data.ranks, data.members) == (3, 1, 6, (3, 4, 5))
    assert (pod.p, pod.rank, pod.ranks, pod.members) == (2, 1, 6, (1, 4))
    with pytest.raises(MeshError, match="along"):
        g.shift(torch.ones(1, 1, 3), 1)
    with pytest.raises(MeshError, match="6 ranks over 4 processes"):
        procmesh.run(_hangs, 4, device="cpu", axes={"pod": 2, "data": 3})
    with pytest.raises(MeshError, match="outside"):
        procmesh.ProcMesh({"pod": 2, "data": 3}, 6, device="cpu")
    with pytest.raises(MeshError):
        procmesh.run(_hangs, 2, device="meta")
    with pytest.raises(procmesh.ProcMeshError, match="shared workdir"):
        m.allocate(16)                  # several ranks, no run to share a directory


def test_the_milc_example_runs_one_rank_a_process(capsys):
    from repro_torch.examples import milc_stencil

    out = milc_stencil.main(["--procs", "2", "--device", "cpu"])
    assert out["max_err"] == 0.0 and out["sync"] == "fence"
    assert "2 processes, max err by rank: [0.0, 0.0]" in capsys.readouterr().out


def test_pscw_partners_are_the_rings_nearest_neighbours():
    assert procmesh.neighbour_offsets(2) == [1, -1]
    assert procmesh.neighbour_offsets(3) == [1, -1, 2]
    assert procmesh.neighbour_offsets(0) == []


def test_a_crossing_is_priced_on_the_link_across_cards_and_in_hbm_on_one():
    """The H100 spec's NVLink rate (data sheet, 450 GB/s each way) prices a
    crossing between ranks on different cards; ranks on one card cross
    HBM.  The choices stay the card's (the put kernel, PSCW only from
    p = 128 at k = 2): both arms of each cross the same link."""
    assert H100.link_bandwidth == 450e9
    one = procmesh.ProcMesh(4, 0, device="cpu", devices=["cuda:0"] * 4)
    four = procmesh.ProcMesh(4, 0, device="cpu", devices=[f"cuda:{r}" for r in range(4)])
    assert not one.crosses_link and four.crosses_link
    n = 6 << 20
    assert DEFAULT_MODEL.p_crossing(n, link=four.crosses_link) == n / 450e9
    assert DEFAULT_MODEL.p_crossing(n, link=one.crosses_link) == 2 * n / H100.hbm_bandwidth
    assert DEFAULT_MODEL.p_crossing(n, link=True) > DEFAULT_MODEL.p_crossing(n)
    for nbytes in (8.0, 1 << 20, 192 << 20):
        assert tplan.choose_backend(DEFAULT_MODEL, nbytes, True) == "cuda"
        assert tplan.choose_backend(DEFAULT_MODEL, nbytes, False) == "torch"
    assert tepoch.choose_sync(2, 64) == "fence"
    assert tepoch.choose_sync(2, 128) == "pscw"


if __name__ == "__main__":
    {"jax": _jax_child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
