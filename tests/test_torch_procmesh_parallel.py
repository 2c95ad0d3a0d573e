"""The parallel layer with one rank a process: a grid `ProcMesh` of named
axes (`repro_torch.procmesh`, ``{"pod": 2, "data": 2}``) against the
stacked grid `Mesh` and against the JAX reference.

Four CPU processes are spawned once for the whole file (gloo over a
`FileStore`, shared-memory windows, the peer forms' plain versions), each
holding its own ``[1, 1, ...]`` blocks.  Every rank runs, on its blocks:
each collective over a named axis of `tests/test_torch_parallel.py`'s grid
cases, the peer forms of rows 4-7 on each one-axis view (`along`), the
bucketed gradient sync on a SMOKE model's gradients, three int8
error-feedback rounds on its own gradients, the GPipe pipeline with one
stage a process (the same four ranks as a ``pod`` axis of 4, `regrid`),
the elastic restore onto the survivors' ``{"data": 2, "model": 2}`` grid
(its own block of every leaf) and the ring matmul's plain version over
one axis of 4 and over a grid's ``model`` axis.  Each rank is held bit
for bit to its row of the same calls on the stacked grid `Mesh` in the
test process, its `OpCounter` / `SyncStats` ledgers equal.  One JAX child
(this file's ``__main__`` branch) runs the reference on 4 forced host
devices with a ``jax.sharding.Mesh`` (2, 2) ``("pod", "data")`` (Auto
axes), XLA paths only: the collectives, the gradient sync and the
pipeline, held at rel 1e-6 for the ring reductions and bit-equal for the
rest.  A rank that raises or hangs fails `run` (and the tests) at the
timeout, never the suite.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager, flatten  # noqa: E402
from repro_torch.core import collectives as tc  # noqa: E402
from repro_torch.core.epoch import SyncStats  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.ft import elastic as telastic  # noqa: E402
from repro_torch.kernels.ring_matmul import ops as rops  # noqa: E402
from repro_torch.kernels.rma import ops as tops  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402
from repro_torch.parallel import compression as tcomp  # noqa: E402
from repro_torch.parallel import overlap as tov  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, PODS, PER_POD = 4, 2, 2
GRID = {"pod": PODS, "data": PER_POD}
ELASTIC = {"data": 2, "model": 2}        # 4 survivors, prefer_model 2
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
REL_REDUCE = 1e-6       # ring reductions vs the reference: f32 in the ring's order
BUCKET = 4096           # bytes: the SMOKE gradients fall into several buckets
STAGES, N_MICRO, MB, DW = NP, 5, 3, 8
RING_K, RING_M, RING_N = 16, 6, 5
SMOKE_ARCH, SMOKE_BATCH = "smollm-360m", (NP, 12)

# collective cases over the (pod 2, data 2) grid: (input, the reference's
# call on a rank's block); every traced loop body of the reference runs
# once at 2 ranks an axis, so its ledgers need no unrolling here
COLL = {
    "hier": ("x", "lambda x: jc.hierarchical_all_reduce(x, 'data', 'pod')"),
    "ag_data": ("x", "lambda x: jc.ring_all_gather(x, 'data')"),
    "ag_pod": ("x", "lambda x: jc.ring_all_gather(x, 'pod')"),
    "rs_data": ("rs", "lambda x: jc.ring_reduce_scatter(x, 'data')"),
    "rs_pod": ("rs", "lambda x: jc.ring_reduce_scatter(x, 'pod')"),
    "ar_data": ("ar", "lambda x: jc.all_reduce(x, 'data')"),
    "ar_pod": ("ar", "lambda x: jc.all_reduce(x, 'pod')"),
    "halo": ("halo", "lambda x: jc.halo_exchange_nd(x, {'data': 1, 'pod': 2}, "
                     "{'data': 0, 'pod': 1})"),
}
REDUCTIONS = ("hier", "rs_data", "rs_pod", "ar_data", "ar_pod")
PEER_CASES = [(op, axis) for axis in ("data", "pod")
              for op in ("put_shift", "get_shift", "accumulate_shift", "ring_all_gather")]


def _inputs() -> dict:
    rng = np.random.default_rng(32)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {
        "x": f(PODS, PER_POD, 3, 5), "rs": f(PODS, PER_POD, 2, 5),
        "ar": f(PODS, PER_POD, 7, 3), "halo": f(PODS, PER_POD, 4, 6),
        "acc": f(PODS, PER_POD, 3, 5),
        # powers of two: every stage's product is exact, in any order of sums
        "pipe_w": rng.choice(np.float32([0.5, -0.5, 2.0, -2.0, 0.25]), (STAGES, MB, DW)),
        "pipe_x": f(N_MICRO, MB, DW),
        "ring_x": f(RING_K, RING_M), "ring_w": f(RING_K, RING_N),
    }


def _smoke_grads() -> dict:
    """Each rank's f32 gradients of its own row of a SMOKE batch, stacked as
    the grid's global view [pod, data, ...], flattened by path."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.train_step import loss_and_grads

    model = build_model(get_config(SMOKE_ARCH, smoke=True))
    params = model.init(3, device="cpu")
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, model.cfg.vocab_size, SMOKE_BATCH, generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    rows = [dict(flatten(loss_and_grads(model, params,
                                        {k: v[r:r + 1] for k, v in batch.items()})[2]))
            for r in range(NP)]
    return {k: torch.stack([row[k].float() for row in rows]).reshape(
        (PODS, PER_POD) + tuple(rows[0][k].shape)).numpy() for k in rows[0]}


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _elastic_tree() -> dict:
    return {"w_in": torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32),
            "attn": {"wq": torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)},
            "norm": torch.linspace(-1, 1, 7).to(torch.bfloat16)}


def _like(tree):
    return {k: _like(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _stage(w, v):
    return v * w[0] + 1.0


# ================================================================ the port
def _port_coll(name: str, x: torch.Tensor, m) -> torch.Tensor:
    return {
        "hier": lambda: tc.hierarchical_all_reduce(x, m, "data", "pod"),
        "ag_data": lambda: tc.ring_all_gather(x, m, axis="data"),
        "ag_pod": lambda: tc.ring_all_gather(x, m, axis="pod"),
        "rs_data": lambda: tc.ring_reduce_scatter(x, m, axis="data"),
        "rs_pod": lambda: tc.ring_reduce_scatter(x, m, axis="pod"),
        "ar_data": lambda: tc.all_reduce(x, m, axis="data"),
        "ar_pod": lambda: tc.all_reduce(x, m, axis="pod"),
        "halo": lambda: tc.halo_exchange_nd(x, {"data": 1, "pod": 2},
                                            {"data": 0, "pod": 1}, m),
    }[name]()


def _peer(op: str, axis: str, m, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Row `op`'s ops surface over one named axis of the grid: the axis
    moved first, the other rank dim riding along as payload."""
    sub, xf, af = m.along(axis), m.front(x, axis), m.front(acc, axis)
    if op == "put_shift":
        return m.back(tops.put_shift(xf, 1, sub), axis)
    if op == "get_shift":
        return m.back(tops.get_shift(xf, -1, sub), axis)
    if op == "accumulate_shift":
        return m.back(tops.accumulate_shift(xf, af, 1, sub), axis)
    return tops.ring_all_gather(xf, sub)          # [ranks of the axis held, p, ...]


def _ledgered(fn):
    st = SyncStats()
    with OpCounter() as c:
        out = fn(st)
    return out, {"ops": c.snapshot(), "plans": c.plans, "flushes": st.flush_msgs}


def _np(t: torch.Tensor) -> np.ndarray:
    """t's values, a bf16 tensor as its 16-bit patterns."""
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _leaves(tree) -> dict:
    return {k: _np(v) for k, v in flatten(tree)}


def _compress(grads: dict) -> list:
    """Three int8 error-feedback rounds of one rank's gradient tree."""
    g = _tree({k: torch.from_numpy(v) for k, v in grads.items()})
    state, out = tcomp.init_compression_state(g), []
    for _ in range(3):
        dec, state, met = tcomp.compress_decompress(g, state)
        out.append((_leaves(dec), _leaves(state.residual), met))
    return out


def _run_all(m, rows: dict, grads: dict, ckpt: str, pod, elastic, ring: tuple) -> dict:
    """Every case on `m` (the stacked grid Mesh, or this rank's grid
    ProcMesh) given its blocks `rows` and `grads`; `pod`, `elastic` and
    `ring` are the other meshes over the same ranks."""
    out: dict = {"coll": {}, "peer": {}}
    for name, (arg, _) in COLL.items():
        got, led = _ledgered(lambda st: _port_coll(name, rows[arg], m))
        out["coll"][name] = (got.numpy(), led)
    for op, axis in PEER_CASES:
        out["peer"][f"{op}/{axis}"] = _peer(op, axis, m, rows["x"], rows["acc"]).numpy()
    g = _tree({k: torch.from_numpy(v) for k, v in grads.items()})
    synced, led = _ledgered(lambda st: tov.overlapped_grad_sync(g, m, bucket_bytes=BUCKET,
                                                                stats=st))
    out["sync"] = (_leaves(synced), led, tov.bucket_grads(g, BUCKET, m))
    cfg = tpipe.PipelineConfig(STAGES, N_MICRO)
    out["pipe"] = _ledgered(lambda st: tpipe.pipeline_forward(
        _stage, rows["pipe_w"], rows["pipe_x"], cfg, pod).numpy())
    tree, extra, emesh, pol = telastic.elastic_restore(
        CheckpointManager(ckpt), _like(_elastic_tree()), NP, 2, device="cpu",
        mesh=None if isinstance(m, Mesh) else elastic)
    sh = dict(flatten(pol.tree_shardings(_like(_elastic_tree()))))
    out["elastic"] = (_leaves(tree), extra, emesh.shape,
                      {k: tuple(s.spec) for k, s in sh.items()})
    out["ring"] = [rops.ring_matmul_ranks(rows["ring_x"], w, rm).numpy() for w, rm in ring]
    return out


def _rank_main(mesh, inputs: dict, grads: dict, ckpt: str) -> dict:
    """This rank's blocks through every case; its coordinates and views."""
    r, (i, j) = mesh.rank, mesh.coords
    rows = {k: torch.from_numpy(inputs[k][i:i + 1, j:j + 1].copy())
            for k in ("x", "rs", "ar", "halo", "acc")}
    rows["pipe_w"] = torch.from_numpy(inputs["pipe_w"][r:r + 1].copy())    # its stage alone
    rows["pipe_x"] = torch.from_numpy(inputs["pipe_x"])
    rows["ring_x"] = torch.from_numpy(inputs["ring_x"])
    w = torch.from_numpy(inputs["ring_w"])
    elastic = mesh.regrid(ELASTIC)
    e, mo = elastic.coords
    ring = [(w.reshape(NP, -1, RING_N)[r:r + 1], mesh.regrid({"model": NP})),
            (w.reshape(2, -1, RING_N)[mo:mo + 1], elastic.along("model"))]
    mine = {k: v[i:i + 1, j:j + 1] for k, v in grads.items()}
    out = _run_all(mesh, rows, mine, ckpt, mesh.regrid({"pod": STAGES}), elastic, ring)
    out["comp"] = _compress(mine)
    out["views"] = {"coords": mesh.coords, "elastic": elastic.coords,
                    "data": (mesh.along("data").p, mesh.along("data").rank,
                             mesh.along("data").members),
                    "pod": (mesh.along("pod").p, mesh.along("pod").rank,
                            mesh.along("pod").members)}
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import collectives as jc
    from repro.core.epoch import SyncStats as JSync
    from repro.core.rma import OpCounter as JOps
    from repro.parallel import overlap as jov
    from repro.parallel import pipeline as jpipe

    inp = dict(np.load(d / "in.npz"))
    grads = dict(np.load(d / "grads.npz"))
    out, meta = {}, {"coll": {}}
    devs = np.asarray(jax.devices()[:NP])
    grid = jax.sharding.Mesh(devs.reshape(PODS, PER_POD), ("pod", "data"))
    for name, (arg, src) in COLL.items():
        fn = eval(src, {"jc": jc})
        x = jnp.asarray(inp[arg])
        lead = P("pod", "data", *([None] * (x.ndim - 2)))
        f = jax.jit(shard_map(lambda b, fn=fn: fn(b[0, 0])[None, None], mesh=grid,
                              in_specs=(lead,), out_specs=P("pod", "data"),
                              check_vma=False))
        with JOps() as c:
            res = f(x)
        out[f"coll/{name}"] = np.asarray(res)
        meta["coll"][name] = {"ops": c.snapshot(), "plans": c.plans}

    # the gradient sync: rank r's block is rows [r * n, (r + 1) * n) of dim 0
    g = {k: jnp.asarray(v.reshape((NP * v.shape[2],) + v.shape[3:])) for k, v in grads.items()}
    tree = _tree(g)
    specs = jax.tree.map(lambda a: P(("pod", "data"), *([None] * (a.ndim - 1))), tree)
    st = JSync()
    f = jax.jit(shard_map(
        functools.partial(jov.overlapped_grad_sync, inner_axis="data", outer_axis="pod",
                          bucket_bytes=BUCKET, stats=st),
        mesh=grid, in_specs=(specs,), out_specs=specs, check_vma=False))
    with JOps() as c:
        res = f(tree)
    for k, v in flatten_np(res).items():
        out[f"sync/{k}"] = np.asarray(v)
    meta["sync"] = {"flushes": st.flush_msgs, "ops": c.snapshot(), "plans": c.plans}

    cfg = jpipe.PipelineConfig(n_stages=STAGES, n_micro=N_MICRO, axis="pod")
    pmesh = jax.sharding.Mesh(devs, ("pod",))
    f = jax.jit(shard_map(
        functools.partial(jpipe.pipeline_forward, lambda w, v: v * w[0] + 1.0, cfg=cfg),
        mesh=pmesh, in_specs=(P("pod", None, None), P(None, None, None)),
        out_specs=P(None, None, None), check_vma=False))
    out["pipe"] = np.asarray(f(jnp.asarray(inp["pipe_w"]), jnp.asarray(inp["pipe_x"])))
    np.savez(d / "out.npz", **out)
    (d / "meta.json").write_text(json.dumps(meta))


def flatten_np(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flatten_np(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs and ledgers, every rank's results, the
    stacked grid Mesh's results): the JAX child and the four ranks run
    side by side, then the stacked run in this process."""
    d = tmp_path_factory.mktemp("procmesh_parallel")
    inputs, grads = _inputs(), _smoke_grads()
    np.savez(d / "in.npz", **inputs)
    np.savez(d / "grads.npz", **grads)
    ckpt = str(d / "ckpt")
    CheckpointManager(ckpt).save(9, _elastic_tree(), extra={"step": 9}, blocking=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "child", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(inputs, grads, ckpt),
                             axes=GRID, timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    ref = dict(np.load(d / "out.npz")), json.loads((d / "meta.json").read_text())

    m = Mesh(GRID, device="cpu")
    rows = {k: torch.from_numpy(v) for k, v in inputs.items()}
    w = rows["ring_w"]
    ring = [(w.reshape(NP, -1, RING_N), Mesh({"model": NP}, device="cpu")),
            (w.reshape(2, -1, RING_N), Mesh({"model": 2}, device="cpu"))]
    stacked = _run_all(m, rows, grads, ckpt, Mesh({"pod": STAGES}, device="cpu"), None, ring)
    stacked["comp"] = [_compress({k: _row(v, r) for k, v in grads.items()}) for r in range(NP)]
    return ref, ranks, stacked


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.itemsize == 4 and a.dtype.kind == "f":
        return a.view(np.uint32)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind == "f" else a


def _same(got, want, what) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=str(what))


def _row(a: np.ndarray, r: int) -> np.ndarray:
    i, j = divmod(r, PER_POD)
    return a[i:i + 1, j:j + 1]


def _unrolled(ref: dict) -> dict:
    """The reference's ledger as the port counts it: every plan of these
    cases records puts only, once a step (a traced loop body runs once at
    two ranks an axis)."""
    plans = ref["plans"]
    puts = sum(pl["raw"] for pl in plans)
    by_axis: dict = {}
    for pl in plans:
        per = by_axis.setdefault(pl["axis"], {"puts": 0})
        per["puts"] += pl["raw"]
    return {"ops": {"puts": puts, "gets": 0, "accs": 0, "colls": 0, "raw_msgs": puts,
                    "coalesced_msgs": sum(pl["coalesced"] for pl in plans),
                    "by_axis": by_axis}, "plans": plans}


# ================================================================ tests
def test_each_rank_has_its_grid_coordinates_and_views(runs):
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        i, j = divmod(r, PER_POD)
        v = res["views"]
        assert v["coords"] == (i, j) and v["elastic"] == (i, j)
        assert v["data"] == (PER_POD, j, (i * PER_POD, i * PER_POD + 1))
        assert v["pod"] == (PODS, i, (j, PER_POD + j))


@pytest.mark.parametrize("name", list(COLL))
def test_collective_over_a_named_axis_is_the_stacked_row(name, runs):
    _, ranks, stacked = runs
    want, want_led = stacked["coll"][name]
    for r, res in enumerate(ranks):
        got, led = res["coll"][name]
        _same(got, _row(want, r), (name, r))
        assert led == want_led, r


@pytest.mark.parametrize("name", list(COLL))
def test_collective_over_a_named_axis_matches_the_reference(name, runs):
    (out, meta), ranks, _ = runs
    want = out[f"coll/{name}"]
    exp = _unrolled(meta["coll"][name])
    for r, res in enumerate(ranks):
        got, led = res["coll"][name]
        w = _row(want, r)
        if name in REDUCTIONS:
            np.testing.assert_allclose(got, w, rtol=REL_REDUCE,
                                       atol=REL_REDUCE * np.abs(w).max())
        else:
            _same(got, w, (name, r))
        assert (led["ops"], led["plans"]) == (exp["ops"], exp["plans"]), r


@pytest.mark.parametrize("op,axis", PEER_CASES)
def test_peer_forms_over_a_sub_axis_are_the_stacked_row(op, axis, runs):
    """Rows 4-7's ops surfaces over one axis of the grid: each rank's block
    is its row of the stacked run on the same axis (bit-equal)."""
    _, ranks, stacked = runs
    want = stacked["peer"][f"{op}/{axis}"]
    for r, res in enumerate(ranks):
        got = res["peer"][f"{op}/{axis}"]
        if op == "ring_all_gather":       # [the axis's ranks held, p, other rank dim, ...]
            i, j = divmod(r, PER_POD)
            q, o = (j, i) if axis == "data" else (i, j)
            _same(got, want[q:q + 1, :, o:o + 1], (op, axis, r))
        else:
            _same(got, _row(want, r), (op, axis, r))


def test_grad_sync_is_the_stacked_row_with_equal_ledgers(runs):
    _, ranks, stacked = runs
    want, want_led, want_buckets = stacked["sync"]
    assert want_led["flushes"] == len(want_buckets) > 2
    for r, res in enumerate(ranks):
        got, led, buckets = res["sync"]
        assert buckets == want_buckets, r
        assert led == want_led, r
        for k, v in got.items():
            _same(v, _row(want[k], r), (k, r))


def test_grad_sync_matches_the_reference(runs):
    (out, meta), ranks, _ = runs
    ref = meta["sync"]
    exp = _unrolled(ref)
    for r, res in enumerate(ranks):
        got, led, _ = res["sync"]
        assert led["flushes"] == ref["flushes"]
        assert (led["ops"], led["plans"]) == (exp["ops"], exp["plans"]), r
        for k, v in got.items():
            w = out[f"sync/{k}"]
            w = w.reshape((NP, -1) + w.shape[1:])[r]
            np.testing.assert_allclose(v[0, 0], w, rtol=REL_REDUCE,
                                       atol=REL_REDUCE * np.abs(w).max())


def test_compression_of_a_ranks_own_grads_is_the_stacked_row(runs):
    """The int8 round trip acts on one rank's [1, 1, ...] blocks as on its
    row of the stacked view: outputs, residuals and metrics bit-equal."""
    _, ranks, stacked = runs
    for r, res in enumerate(ranks):
        assert len(res["comp"]) == 3
        for (dec, resid, met), (wdec, wresid, wmet) in zip(res["comp"], stacked["comp"][r]):
            assert met == wmet
            for k in dec:
                _same(dec[k], wdec[k], (k, r))
                _same(resid[k], wresid[k], (k, r))


def test_pipeline_with_one_stage_a_process(runs):
    (out, _), ranks, stacked = runs
    want, want_led = stacked["pipe"]
    for r, res in enumerate(ranks):
        got, led = res["pipe"]
        _same(got, want[r:r + 1], r)                 # its row of the stacked run
        _same(got[0], out["pipe"], r)                # the reference's, bit for bit
        assert led == want_led, r
    assert want_led["ops"]["puts"] == N_MICRO + STAGES - 1


def test_elastic_restore_gives_each_rank_its_blocks(runs):
    _, ranks, stacked = runs
    full, extra, shape, specs = stacked["elastic"]
    assert extra == {"step": 9} and shape == ELASTIC
    assert specs["w_in"] == ("data", "model") and specs["attn/wq"] == ("data", "model", None)
    m = Mesh(ELASTIC, device="cpu")
    seen: dict = {}
    for r, res in enumerate(ranks):
        got, gextra, gshape, gspecs = res["elastic"]
        assert (gextra, gshape, gspecs) == (extra, shape, specs)
        for k, v in got.items():
            sh = tsh.NamedSharding(m, tsh.P(*specs[k]))
            block = sh.blocks(torch.from_numpy(full[k]))[divmod(r, 2)]
            _same(v, block.numpy(), (k, r))
            seen.setdefault(k, []).append(sh.index(divmod(r, 2), full[k].shape))
    for k, idx in seen.items():                      # the four blocks tile every leaf
        tiled = np.zeros(full[k].shape, np.int32)
        for ix in idx:
            tiled[ix] += 1
        assert (tiled == (1 if any(specs[k]) else NP)).all(), k


def test_ring_matmul_over_processes_is_the_stacked_row(runs):
    """The plain version (`ring_schedule_ref`) over one axis of 4 processes
    and over a grid's model axis, each rank's copy its stacked row."""
    _, ranks, stacked = runs
    want4, want2 = stacked["ring"]
    for r, res in enumerate(ranks):
        got4, got2 = res["ring"]
        _same(got4, want4[r:r + 1], r)
        _same(got2, want2[r % 2:r % 2 + 1], r)
        full = np.asarray(torch.from_numpy(_inputs()["ring_x"]).T.double()
                          @ torch.from_numpy(_inputs()["ring_w"]).double())
        np.testing.assert_allclose(got4[0], full, rtol=1e-5, atol=1e-5)


def _card_rank(mesh) -> dict:
    """On the card: the hierarchical all-reduce of this rank's block
    against its row of the stacked grid run, and the ring matmul over the
    four ranks as one axis against its plain version; launches counted."""
    from repro_torch.kernels.ring_matmul import ref as rref

    dev, (i, j), r = mesh.device, mesh.coords, mesh.rank
    full = torch.randn(PODS, PER_POD, 1000, 3, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5))
    want = tc.hierarchical_all_reduce(full, Mesh(GRID, device=dev), "data", "pod")
    before = dict(tops.launches)
    got = tc.hierarchical_all_reduce(full[i:i + 1, j:j + 1].clone(), mesh, "data", "pod")
    torch.cuda.synchronize()
    puts = tops.launches["put_shift"] - before["put_shift"]
    g = torch.Generator(device=dev).manual_seed(6)
    xt = torch.randn(64, 48, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 32, device=dev, generator=g).to(torch.bfloat16)
    ring = mesh.regrid({"model": NP})
    shard = w.reshape(NP, 16, 32)[r:r + 1].contiguous()
    n0 = rops.launches_by_variant["wgmma"]
    y = rops.ring_matmul_ranks(xt, shard, ring)
    torch.cuda.synchronize()
    plain = rref.ring_schedule_ref(xt, shard, ring)
    return {"same": bool(torch.equal(got, want[i:i + 1, j:j + 1])), "puts": puts,
            "wgmma": rops.launches_by_variant["wgmma"] - n0,
            "rel": float((y - plain).abs().max() / plain.abs().max())}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_the_grid_runs_on_the_card(card):
    """Four processes on the card: the peer kernels reach a sub-axis's
    ranks through its own pointer table (3 row 4 launches a leaf of the
    hierarchical all-reduce), and the ring matmul over processes launches
    row 13 once a hop."""
    for res in procmesh.run(_card_rank, NP, axes=GRID, timeout=TIMEOUT):
        assert res["same"] and res["puts"] == 3 and res["wgmma"] == NP
        assert res["rel"] <= 1e-4


def test_a_grid_procmesh_refuses_what_the_stacked_grid_refuses():
    g = procmesh.ProcMesh(GRID, 3, device="cpu")
    with pytest.raises(MeshError, match="needs axis="):
        tc.all_reduce(torch.ones(1, 1, 4), g)
    with pytest.raises(MeshError, match="along"):
        g.all_gather(torch.ones(1, 1, 4))
    with pytest.raises(MeshError, match="leading rank dims"):
        g.psum(torch.ones(2, 2, 4), "pod")
    with pytest.raises(MeshError, match="a grid"):
        g.regrid({"data": 3})
    with pytest.raises(MeshError, match="stacked mesh holds every block"):
        tsh.NamedSharding(Mesh(ELASTIC, device="cpu"), tsh.P("data")).local(torch.ones(4))
    with pytest.raises(MeshError, match="make the grid"):
        telastic.elastic_restore(None, {}, NP, 2, device="cpu", mesh=g)
    with pytest.raises(procmesh.ProcMeshError, match="closed with the group"):
        g.along("pod").close()


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
