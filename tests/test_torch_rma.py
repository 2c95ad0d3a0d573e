"""The one-sided RMA layer of the PyTorch port against the JAX reference on
the same numpy inputs: eager ops, mixed plans, access epochs, the RMA
collectives, the MILC stencil step and the four `kernels/rma` plain
versions.

The reference needs an 8-device mesh (4 for the Pallas kernels), which the
main test process must not have, so this file's own ``__main__`` branch
runs the JAX side in a child process with forced host devices and writes
every output and every ledger snapshot; the tests run the port on the same
inputs with ``device="cpu"`` and compare.  Tolerances: copies and single
adds are bit-equal; the ring reductions are held to rel 1e-6 and the MILC
step to abs 1e-5 (the example's own tolerance).  Ledgers (`OpCounter`,
`PlanStats`, `SyncStats`) must be equal, with the reference's backend names
"xla"/"pallas" read as the port's "torch"/"cuda".
"""

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro_torch.apps import milc as tmilc  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.core import epoch as tepoch  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import rma as trma  # noqa: E402
from repro_torch.kernels.rma import ops as tops  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP = 8                  # ranks of the eager/plan/epoch/collective cases
NK = 4                  # ranks of the Pallas kernel cases (interpret mode)
PERM_REV = [(i, NP - 1 - i) for i in range(NP)]
PERM_PART = [(0, 2), (1, 5), (3, 3), (6, 0)]      # ranks 1, 4, 6, 7 get zeros
BACKEND_NAMES = {"xla": "torch", "pallas": "cuda"}
REL_REDUCE = 1e-6       # ring reductions: f32, the ring's order on both sides
ABS_MILC = 1e-5
# The reference counts ops while tracing, and a `fori_loop` body is traced
# once; the port runs (and counts) every step.  Per case: how many times
# each of the reference's recorded plans runs in the port's loops.
LOOP_TRIPS = {
    "ring_all_gather_bidir": [NP // 2],                 # max(steps_f, steps_b)
    "ring_all_gather_uni": [NP - 1],
    "ring_reduce_scatter": [NP - 1],
    "all_reduce_divisible": [NP - 1, NP // 2],          # reduce-scatter, all-gather
    "all_reduce_ragged": [NP - 1, NP // 2],
}


def _inputs() -> dict:
    rng = np.random.default_rng(12)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {
        "x": f(NP, 3, 5), "y": f(NP, 3, 5), "acc": f(NP, 3, 5), "c": f(NP, 2, 3),
        "xi": rng.integers(-2**31, 2**31, (NP, 4), dtype=np.int64).astype(np.int32),
        "hb": rng.integers(-64, 64, (NP, 6)).astype(np.float32),   # exact in bf16
        "src": rng.integers(0, NP, NP).astype(np.int32),
        "slots": rng.integers(-1000, 1000, (NP, 3, 4)).astype(np.int32),
        "sacc": rng.integers(-1000, 1000, (NP, 4)).astype(np.int32),
        "a2a": f(NP, NP, 2), "a2at": f(NP, NP * 2, 3),
        "tgt": f(NP), "fx": f(NP),
        "ring": f(NP, 4, 6), "rs": f(NP, NP, 3), "ar8": f(NP, NP, 5),
        "ar7": f(NP, 7, 5), "halo": f(NP, 4, 2), "halo3": f(NP, 3, 4, 2),
        "lat": f(NP, 2, 4, 4, 4, 6),
        "kx": np.arange(NK * 8 * 128, dtype=np.float32).reshape(NK, 8, 128) * 0.5 - 17.0,
        "kacc": f(NK, 8, 128),
    }


# ================================================================ cases
# name -> (input names, jax fn over one rank's blocks, port fn over stacked
# tensors and a Mesh).  A jax fn gets `cap`, a dict for ledgers it reads at
# trace time (plan stats, sync stats).
def _jax_cases():
    from repro.core import collectives as jc
    from repro.core import rma as jr
    from repro.core.epoch import FenceEpoch, PSCWEpoch, SharedLockEpoch, flush, flush_local
    from repro.core.plan import AccessEpoch, RmaPlan

    def mixed(agg):
        def fn(cap, x, y, acc, c, xi, hb, tgt, fx):
            pl = RmaPlan("x")
            hs = [pl.put_shift(x, 1), pl.put_shift(y, 1), pl.get_shift(c, -1),
                  pl.accumulate_shift(x, acc, 1), pl.put_shift(xi, 2),
                  pl.put_shift(hb.astype(jnp.bfloat16), 2), pl.put_perm(y, PERM_PART),
                  pl.fetch_and_op(fx, tgt), pl.all_gather(xi), pl.all_gather(hb, kind="accs")]
            cap["plan"] = pl.flush(aggregate=agg).snapshot()
            outs = []
            for h in hs:
                r = h.result()
                outs.extend(r if isinstance(r, tuple) else (r,))
            return tuple(o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in outs)
        return fn

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

    def scopes(cap, x, y):
        from repro.core.epoch import SyncStats

        with SyncStats() as s:
            fe = FenceEpoch("x", NP)
            x = fe.open(x)
            pl = fe.begin_plan()
            h = pl.put_shift(y, 3)
            x = fe.close(x)
            ps = PSCWEpoch("x", group=[0, 1, 2])
            x = ps.complete(ps.start(ps.wait(ps.post(x))))
            lk = SharedLockEpoch("x")
            lp = lk.begin_plan()
            h2 = lp.get_shift(x, 1)
            x = lk.unlock(lk.lock(x))
            x = flush_local(flush(x))
        cap["sync"] = {"outer": s.snapshot(), "fence": fe.stats.snapshot(),
                       "pscw": ps.stats.snapshot(), "lock": lk.stats.snapshot()}
        return x, h.result(), h2.result()

    def milc(cap, v):
        ep = PSCWEpoch("x", group=[0, 1])
        v = ep.post(v)
        padded = jc.halo_exchange_1d(v, 1, "x", dim=0)
        v2 = ep.complete(v)
        cap["sync"] = ep.stats.snapshot()
        acc = padded[2:] + padded[:-2]
        for d in (1, 2, 3):
            acc = acc + jnp.roll(v2, 1, axis=d) + jnp.roll(v2, -1, axis=d)
        return acc - 8.0 * v2

    return {
        "rank": ((), lambda cap: jr.rank("x")),
        "put_shift+1": (("x",), lambda cap, x: jr.put_shift(x, 1, "x")),
        "put_shift-1": (("x",), lambda cap, x: jr.put_shift(x, -1, "x")),
        "put_shift+11": (("xi",), lambda cap, x: jr.put_shift(x, 11, "x")),
        "put_shift0": (("x",), lambda cap, x: jr.put_shift(x, 0, "x")),
        "put_perm_rev": (("x",), lambda cap, x: jr.put_perm(x, PERM_REV, "x")),
        "put_perm_partial": (("xi",), lambda cap, x: jr.put_perm(x, PERM_PART, "x")),
        "get_shift+1": (("c",), lambda cap, x: jr.get_shift(x, 1, "x")),
        "get_shift-3": (("xi",), lambda cap, x: jr.get_shift(x, -3, "x")),
        "get_index": (("x",), lambda cap, x: jr.get_index(x, 2, "x")),
        "get_gather": (("x", "src"), lambda cap, x, s: jr.get_gather(
            x, jnp.asarray(_inputs()["src"]), "x")),
        "accumulate_shift": (("x", "acc"), lambda cap, x, a: jr.accumulate_shift(x, a, 1, "x")),
        "accumulate_shift_max": (("x", "acc"), lambda cap, x, a: jr.accumulate_shift(
            x, a, -2, "x", op=jnp.maximum)),
        "accumulate_perm": (("x", "acc"), lambda cap, x, a: jr.accumulate_perm(x, a, PERM_PART, "x")),
        "accumulate_slots": (("slots", "sacc"), lambda cap, s, a: jr.accumulate_slots(s, a)),
        "accumulate_slots_max": (("slots", "sacc"), lambda cap, s, a: jr.accumulate_slots(
            s, a, op=jnp.maximum)),
        "fetch_and_op": (("fx", "tgt"), lambda cap, x, t: jr.fetch_and_op(x, t, "x")),
        "put_all_to_all": (("a2a",), lambda cap, x: jr.put_all_to_all(x, "x")),
        "put_all_to_all_tiled": (("a2at",), lambda cap, x: jr.put_all_to_all(x, "x", tiled=True)),
        "put_bcast": (("x",), lambda cap, x: jr.put_bcast(x, 3, "x")),
        "plan_aggregate_true": (("x", "y", "acc", "c", "xi", "hb", "tgt", "fx"), mixed(True)),
        "plan_aggregate_false": (("x", "y", "acc", "c", "xi", "hb", "tgt", "fx"), mixed(False)),
        "plan_aggregate_none": (("x", "y", "acc", "c", "xi", "hb", "tgt", "fx"), mixed(None)),
        "epoch_fence": (("x", "y", "acc", "tgt", "fx"), access("fence")),
        "epoch_pscw": (("x", "y", "acc", "tgt", "fx"), access("pscw")),
        "epoch_lock": (("x", "y", "acc", "tgt", "fx"), access("lock")),
        "epoch_scopes": (("x", "y"), scopes),
        "ring_all_gather_bidir": (("ring",), lambda cap, x: jc.ring_all_gather(x, "x")),
        "ring_all_gather_uni": (("ring",), lambda cap, x: jc.ring_all_gather(
            x, "x", bidirectional=False)),
        "ring_reduce_scatter": (("rs",), lambda cap, x: jc.ring_reduce_scatter(x, "x")),
        "all_reduce_divisible": (("ar8",), lambda cap, x: jc.all_reduce(x, "x")),
        "all_reduce_ragged": (("ar7",), lambda cap, x: jc.all_reduce(x, "x")),
        "halo_exchange_1d": (("halo",), lambda cap, x: jc.halo_exchange_1d(x, 1, "x", dim=0)),
        "halo_exchange_1d_dim1": (("halo3",), lambda cap, x: jc.halo_exchange_1d(x, 2, "x", dim=1)),
        "halo_exchange_nd": (("halo3",), lambda cap, x: jc.halo_exchange_nd(x, {"x": 1}, {"x": 0})),
        "all_to_all": (("a2a",), lambda cap, x: jc.all_to_all(x, "x")),
        "broadcast": (("x",), lambda cap, x: jc.broadcast(x, 5, "x")),
        "milc_step": (("lat",), milc),
    }


def _port_cases():
    def mixed(agg):
        def fn(cap, m, x, y, acc, c, xi, hb, tgt, fx):
            pl = tplan.RmaPlan(m)
            hs = [pl.put_shift(x, 1), pl.put_shift(y, 1), pl.get_shift(c, -1),
                  pl.accumulate_shift(x, acc, 1), pl.put_shift(xi, 2),
                  pl.put_shift(hb.to(torch.bfloat16), 2), pl.put_perm(y, PERM_PART),
                  pl.fetch_and_op(fx, tgt), pl.all_gather(xi), pl.all_gather(hb, kind="accs")]
            cap["plan"] = pl.flush(aggregate=agg).snapshot()
            outs = []
            for h in hs:
                r = h.result()
                outs.extend(r if isinstance(r, tuple) else (r,))
            return tuple(o.float() if o.dtype == torch.bfloat16 else o for o in outs)
        return fn

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
        return fn

    def scopes(cap, m, x, y):
        with tepoch.SyncStats() as s:
            fe = tepoch.FenceEpoch(m)
            x = fe.open(x)
            pl = fe.begin_plan()
            h = pl.put_shift(y, 3)
            x = fe.close(x)
            ps = tepoch.PSCWEpoch(m, group=[0, 1, 2])
            x = ps.complete(ps.start(ps.wait(ps.post(x))))
            lk = tepoch.SharedLockEpoch(m)
            lp = lk.begin_plan()
            h2 = lp.get_shift(x, 1)
            x = lk.unlock(lk.lock(x))
            x = tepoch.flush_local(tepoch.flush(x))
        cap["sync"] = {"outer": s.snapshot(), "fence": fe.stats.snapshot(),
                       "pscw": ps.stats.snapshot(), "lock": lk.stats.snapshot()}
        return x, h.result(), h2.result()

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
        "rank": lambda cap, m: trma.rank(m),
        "put_shift+1": lambda cap, m, x: trma.put_shift(x, 1, m),
        "put_shift-1": lambda cap, m, x: trma.put_shift(x, -1, m),
        "put_shift+11": lambda cap, m, x: trma.put_shift(x, 11, m),
        "put_shift0": lambda cap, m, x: trma.put_shift(x, 0, m),
        "put_perm_rev": lambda cap, m, x: trma.put_perm(x, PERM_REV, m),
        "put_perm_partial": lambda cap, m, x: trma.put_perm(x, PERM_PART, m),
        "get_shift+1": lambda cap, m, x: trma.get_shift(x, 1, m),
        "get_shift-3": lambda cap, m, x: trma.get_shift(x, -3, m),
        "get_index": lambda cap, m, x: trma.get_index(x, 2, m),
        "get_gather": lambda cap, m, x, s: trma.get_gather(x, s, m),
        "accumulate_shift": lambda cap, m, x, a: trma.accumulate_shift(x, a, 1, m),
        "accumulate_shift_max": lambda cap, m, x, a: trma.accumulate_shift(
            x, a, -2, m, op=torch.maximum),
        "accumulate_perm": lambda cap, m, x, a: trma.accumulate_perm(x, a, PERM_PART, m),
        "accumulate_slots": lambda cap, m, s, a: trma.accumulate_slots(s, a),
        "accumulate_slots_max": lambda cap, m, s, a: trma.accumulate_slots(s, a, op=torch.maximum),
        "fetch_and_op": lambda cap, m, x, t: trma.fetch_and_op(x, t, m),
        "put_all_to_all": lambda cap, m, x: trma.put_all_to_all(x, m),
        "put_all_to_all_tiled": lambda cap, m, x: trma.put_all_to_all(x, m, tiled=True),
        "put_bcast": lambda cap, m, x: trma.put_bcast(x, 3, m),
        "plan_aggregate_true": mixed(True),
        "plan_aggregate_false": mixed(False),
        "plan_aggregate_none": mixed(None),
        "epoch_fence": access("fence"),
        "epoch_pscw": access("pscw"),
        "epoch_lock": access("lock"),
        "epoch_scopes": scopes,
        "ring_all_gather_bidir": lambda cap, m, x: tcoll.ring_all_gather(x, m),
        "ring_all_gather_uni": lambda cap, m, x: tcoll.ring_all_gather(x, m, bidirectional=False),
        "ring_reduce_scatter": lambda cap, m, x: tcoll.ring_reduce_scatter(x, m),
        "all_reduce_divisible": lambda cap, m, x: tcoll.all_reduce(x, m),
        "all_reduce_ragged": lambda cap, m, x: tcoll.all_reduce(x, m),
        "halo_exchange_1d": lambda cap, m, x: tcoll.halo_exchange_1d(x, 1, m, dim=0),
        "halo_exchange_1d_dim1": lambda cap, m, x: tcoll.halo_exchange_1d(x, 2, m, dim=1),
        "halo_exchange_nd": lambda cap, m, x: tcoll.halo_exchange_nd(x, {"x": 1}, {"x": 0}, m),
        "all_to_all": lambda cap, m, x: tcoll.all_to_all(x, m),
        "broadcast": lambda cap, m, x: tcoll.broadcast(x, 5, m),
        "milc_step": milc,
    }


CASE_NAMES = list(_port_cases())
KERNEL_CASES = [("put_shift", 1), ("put_shift", -1), ("get_shift", 1), ("get_shift", 3),
                ("accumulate_shift", 1), ("accumulate_shift", -1), ("ring_all_gather", 0)]


# ================================================================ JAX child
def _ops_child(d: pathlib.Path) -> None:
    from repro.core.rma import OpCounter

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NP,), ("x",))
    out, snaps = {}, {}
    for name, (names, fn) in _jax_cases().items():
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
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


def _kernels_child(d: pathlib.Path) -> None:
    from repro.kernels.rma import ops as jops

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NK,), ("x",))
    x = jnp.asarray(inp["kx"].reshape(NK * 8, 128))
    acc = jnp.asarray(inp["kacc"].reshape(NK * 8, 128))
    out = {}
    for name, s in KERNEL_CASES:
        if name == "put_shift":
            y = jops.put_shift(x, s, mesh, "x", interpret=True)
        elif name == "get_shift":
            y = jops.get_shift(x, s, mesh, "x", interpret=True)
        elif name == "accumulate_shift":
            y = jops.accumulate_shift(x, acc, s, mesh, "x", interpret=True)
        else:
            y = jops.ring_all_gather(x, mesh, "x", interpret=True)
        out[f"{name}{s}"] = np.asarray(y)
    np.savez(d / "out.npz", **out)


def _run_jax_child(case: str, workdir: pathlib.Path, devices: int) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, case, str(workdir)],
                          capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ops(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("rma_ops")
    np.savez(d / "in.npz", **inputs)
    _run_jax_child("ops", d, NP)
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


@pytest.fixture(scope="module")
def jax_kernels(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("rma_kernels")
    np.savez(d / "in.npz", **inputs)
    _run_jax_child("kernels", d, NK)
    return dict(np.load(d / "out.npz"))


# ================================================================ helpers
def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 and a.dtype.kind == "f" else a


def _torch_names(snap: dict) -> dict:
    """A reference PlanStats snapshot with the port's backend names."""
    snap = dict(snap)
    snap["backends"] = {BACKEND_NAMES[k]: v for k, v in snap["backends"].items()}
    return snap


def _unrolled(ref: dict, trips: list) -> dict:
    """The reference's ledgers with each traced loop body counted once per
    step the port runs (every plan of these cases records puts only)."""
    assert len(ref["plans"]) == len(trips)
    plans = [pl for pl, n in zip(ref["plans"], trips) for _ in range(n)]
    puts = sum(pl["raw"] for pl in plans)
    wire = sum(pl["coalesced"] for pl in plans)
    ops = {"puts": puts, "gets": 0, "accs": 0, "colls": 0, "raw_msgs": puts,
           "coalesced_msgs": wire, "by_axis": {"x": {"puts": puts}}}
    assert ref["ops"]["puts"] == ref["ops"]["raw_msgs"] == sum(pl["raw"] for pl in ref["plans"])
    return {"ops": ops, "plans": plans}


def _run_port(name: str, inputs: dict):
    from repro_torch.core.rma import OpCounter

    fn = _port_cases()[name]
    names = _jax_cases()[name][0]
    cap: dict = {}
    m = Mesh(NP, "x", device="cpu")
    with OpCounter() as c:
        res = fn(cap, m, *[torch.from_numpy(inputs[n].copy()) for n in names])
    res = res if isinstance(res, tuple) else (res,)
    return [r.numpy() for r in res], {"ops": c.snapshot(), "plans": c.plans, **cap}


# ================================================================ tests
@pytest.mark.parametrize("name", CASE_NAMES)
def test_port_matches_reference(name, inputs, jax_ops):
    ref_out, ref_snaps = jax_ops
    got, snap = _run_port(name, inputs)
    want = [ref_out[f"{name}/{i}"] for i in range(len(got))]
    assert f"{name}/{len(got)}" not in ref_out, "the port returned fewer outputs"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if name == "milc_step":
            np.testing.assert_allclose(g, w, rtol=0, atol=ABS_MILC)
        elif name.startswith(("ring_reduce_scatter", "all_reduce")):
            np.testing.assert_allclose(g, w, rtol=REL_REDUCE, atol=REL_REDUCE * np.abs(w).max())
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w.astype(g.dtype)), err_msg=f"output {i}")

    ref = ref_snaps[name]
    if name == "plan_aggregate_none":
        # the reference packs by its TPU model; the port by the H100 model,
        # which never packs on one card: hold the port to its own model
        model = tperf.DEFAULT_MODEL
        ps = snap["plan"]
        assert model.aggregation_crossover_bytes() == 8.0
        assert ps["packed_groups"] == 0 and ps["coalesced_msgs"] == ps["raw_msgs"] == 10
        assert ps["groups"] == ref["plan"]["groups"] and ps["bytes_logical"] == ref["plan"]["bytes_logical"]
        assert snap["ops"]["raw_msgs"] == ref["ops"]["raw_msgs"]
        for k in ("puts", "gets", "accs", "colls", "by_axis"):
            assert snap["ops"][k] == ref["ops"][k], k
        return
    if name in LOOP_TRIPS:
        ref = {**ref, **_unrolled(ref, LOOP_TRIPS[name])}
    assert snap["ops"] == ref["ops"]
    assert snap["plans"] == ref["plans"]
    if "plan" in ref:
        assert snap["plan"] == _torch_names(ref["plan"])
    if "sync" in ref:
        assert snap["sync"] == ref["sync"]


@pytest.mark.parametrize("name,shift", KERNEL_CASES)
def test_kernel_plain_versions_match_pallas(name, shift, inputs, jax_kernels):
    """The plain versions (what a CPU tensor takes) against the Pallas
    kernels in interpret mode: bit-equal."""
    m = Mesh(NK, "x", device="cpu")
    x = torch.from_numpy(inputs["kx"].copy())
    acc = torch.from_numpy(inputs["kacc"].copy())
    before = dict(tops.launches)
    if name == "accumulate_shift":
        got = tops.accumulate_shift(x, acc, shift, m)
    elif name == "ring_all_gather":
        got = tops.ring_all_gather(x, m)
    else:
        got = getattr(tops, name)(x, shift, m)
    assert tops.launches == before          # CPU tensors never launch
    want = jax_kernels[f"{name}{shift}"]
    if name == "ring_all_gather":
        assert got.shape == (NK, NK, 8, 128)
        for receiver in range(NK):
            np.testing.assert_array_equal(_bits(got[receiver].numpy()), _bits(want))
    else:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.reshape(NK, 8, 128)))


# ------------------------------------------------------- port-only behaviour
def test_ppermute_returns_a_new_tensor_with_zeros_where_nothing_lands():
    m = Mesh(4, "x", device="cpu")
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = m.ppermute(x, [(0, 1), (2, 3)])
    assert torch.equal(out, torch.tensor([[0, 0], [0, 1], [0, 0], [4, 5]], dtype=torch.float32))
    for s in (0, 1, -1, 6):
        y = m.shift(x, s)
        assert torch.equal(y, torch.roll(x, s, 0))
        assert y.data_ptr() != x.data_ptr()
    view = x.t().contiguous().t()            # a strided [4, 2] view
    assert torch.equal(m.shift(view, 1), torch.roll(x, 1, 0))


def test_flush_defaults_follow_the_model_and_validate_the_backend():
    m = Mesh(4, "x", device="cpu")
    x = torch.ones(4, 3)
    pl = tplan.RmaPlan(m)
    pl.put_shift(x, 1)
    pl.put_shift(x, 1)
    stats = pl.flush()                       # aggregate=None, backend="auto"
    assert (stats.raw, stats.coalesced, stats.packed_groups) == (2, 2, 0)
    assert stats.backends == {"torch": 2}    # CPU payloads never take the kernel
    pl = tplan.RmaPlan(m)
    pl.put_shift(x, 1)
    with pytest.raises(tplan.PlanError, match="unknown backend"):
        pl.flush(backend="pallas")


def test_forced_cuda_backend_on_cpu_tensors_takes_the_plain_version():
    m = Mesh(4, "x", device="cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    pl = tplan.RmaPlan(m)
    h1 = pl.put_shift(x, 1)
    h2 = pl.get_shift(x, 1)
    h3 = pl.put_perm(x, [(0, 2)])
    before = dict(tops.launches)
    stats = pl.flush(backend="cuda")
    # the two shift groups go to the kernel's wrapper; the perm, which the
    # kernel cannot carry, through the mesh, and is counted so
    assert stats.backends == {"cuda": 2, "torch": 1} and tops.launches == before
    assert torch.equal(h1.result(), torch.roll(x, 1, 0))
    assert torch.equal(h2.result(), torch.roll(x, -1, 0))
    assert torch.equal(h3.result()[2], x[0])


@pytest.mark.parametrize("sig,shifts,pack,backend,eligible,want", [
    ("ppermute", (1, 1), False, "auto", True, "cuda"),
    ("ppermute", (1, 1), True, "auto", True, "torch"),       # packed words
    ("ppermute", (1,), False, "auto", False, "torch"),       # CPU or 64-bit payload
    ("ppermute", (1, None), False, "auto", True, "torch"),   # a perm shares the group
    ("ppermute", (1, 1), True, "cuda", False, "cuda"),       # forced
    ("ppermute", (None,), False, "cuda", True, "torch"),     # not a shift
    ("all_to_all", (None,), False, "cuda", True, "torch"),
    ("ppermute", (1,), False, "torch", True, "torch"),
])
def test_route_takes_the_kernel_for_every_eligible_shift_group(
        monkeypatch, sig, shifts, pack, backend, eligible, want):
    monkeypatch.setattr(tplan, "_cuda_eligible", lambda x: eligible)
    ops = [SimpleNamespace(shift=s, payload=None) for s in shifts]
    assert tplan._route((sig,), ops, pack, backend) == want


def test_cuda_eligible_needs_32_bit_words_on_the_card():
    assert not tplan._cuda_eligible(torch.ones(4, 3))            # on the CPU
    assert not tplan._cuda_eligible(torch.ones(4, 3, dtype=torch.float64))


def test_kernel_rows_read_a_rank_strided_halo_in_place():
    lat = torch.zeros(4, 8, 3, 2)
    halo = lat[:, -1:]                        # [4, 1, 3, 2] at rank stride 48
    xs, row, stride = tops._rows(halo)
    assert (xs.data_ptr(), row, stride) == (halo.data_ptr(), 6, 48)
    inner = lat[:, :, :1]                     # a rank's block is not contiguous
    xs, row, stride = tops._rows(inner)
    assert xs.is_contiguous() and (row, stride) == (16, 16)
    assert torch.equal(xs, inner)
    one = lat[:1, 2:3]                        # p = 1: the stride is the row
    assert tops._rows(one)[1:] == (6, 6)


def test_h100_model_decisions():
    model = tperf.DEFAULT_MODEL
    # k = 2 neighbours: PSCW's 2k + 2 messages beat a fence's ceil(log2 p)
    # stages from p = 128 on
    assert tepoch.choose_sync(2, 64) == "fence"
    assert tepoch.choose_sync(2, 128) == "pscw"
    assert tepoch.choose_sync(2, 131072) == "pscw"
    # one launch a message either way, plus the pack and decode passes
    for n in (2, 16, 256):
        for s in (8.0, 4096.0, 2.0**24):
            assert model.select_aggregation(n, s) == "direct"
    assert model.p_get(1e6) == model.p_put(1e6)
    assert model.p_accumulate(1e6) > model.p_put(1e6)
    assert model.all_reduce(8e6, 8) > model.ring_all_gather(1e6, 8) > 0


def test_halo_exchange_nd_refuses_an_axis_the_mesh_lacks():
    m = Mesh(2, "t", device="cpu")
    with pytest.raises(MeshError):
        tcoll.halo_exchange_nd(torch.ones(2, 3), {"z": 1}, {"z": 0}, m)


def test_epoch_misuse_raises_as_in_the_reference():
    m = Mesh(2, "x", device="cpu")
    x = torch.ones(2, 3)
    ep = tplan.AccessEpoch(m, family="fence")
    ep.close(ep.open(x))
    with pytest.raises(tplan.PlanError, match="already closed"):
        ep.put_shift(x, 1)
    fe = tepoch.FenceEpoch(m)
    with pytest.raises(tplan.PlanError, match="double fence"):
        fe.close(x)
    fe.open(x)
    with pytest.raises(tplan.PlanError, match="already open"):
        fe.open(x)
    fe.begin_plan().put_shift(x, 1)
    with pytest.raises(tplan.PlanError, match="unflushed"):
        fe.begin_plan()
    with pytest.raises(tplan.PlanError, match="unknown epoch family"):
        tplan.AccessEpoch(m, family="bogus")


def test_milc_step_counts_two_puts_and_refuses_a_bad_lattice():
    from repro_torch.core.rma import OpCounter

    m = Mesh(4, "t", device="cpu")
    lat = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 2, 4, 4, 4, 6)).astype(np.float32))
    with OpCounter() as c:
        out = tmilc.stencil_step(lat, m)
    assert (c.puts, c.raw_msgs, c.coalesced_msgs) == (2, 2, 2)
    assert torch.equal(out, tmilc.stencil_reference(lat))
    with pytest.raises(MeshError):
        tmilc.stencil_step(lat[0], m)


def test_flush_tags_trace_events_with_the_causal_scopes():
    from repro_torch.obs import causal, trace

    with trace.Tracer() as tr:
        with causal.request_scope(7), causal.epoch_scope([5, 3]):
            tepoch.flush(None)
            tepoch.flush_local(None)
        assert causal.current_rid() is None and causal.current_epoch_rids() == ()
    ev = [e for e in tr.events if e["name"].startswith("sync.")]
    assert [e["args"] for e in ev] == [{"rid": 7, "wait": 0, "rids": (3, 5)}] * 2


if __name__ == "__main__":
    {"ops": _ops_child, "kernels": _kernels_child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
