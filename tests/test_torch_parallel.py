"""The parallel layer of the PyTorch port against the JAX reference: a second
rank axis, the hierarchical gradient sync, int8 error feedback, the GPipe
pipeline, sharding policies and the elastic restore.

This file's own ``__main__`` branch runs the reference on 8 forced host
devices at the sizes of `tests/subtests/gradsync_sub.py`,
`pipeline_sub.py` and `elastic_sub.py`, on numpy inputs the parent writes,
and saves every result; the port runs the same inputs on the stacked rank
axis (``device="cpu"``).  Held to the reference:

  * `core.collectives` over each named axis of a (pod 2, data 4) grid —
    `hierarchical_all_reduce`, `ring_all_gather`, `ring_reduce_scatter`,
    `all_reduce` and `halo_exchange_nd` — values within 1e-5 (f32 sums in
    ring order), `OpCounter` ledgers equal once the reference's traced loop
    bodies are counted once a step the port runs (`LOOP_TRIPS`);
  * `parallel.overlap.overlapped_grad_sync` at ``bucket_bytes=64``
    (rtol and atol 1e-5), its `bucket_grads` lists, its `SyncStats` flush
    count and ledger; ``compress_outer=True`` equals ``False`` in both
    packages (the reference never applies it, ROADMAP §3);
  * `parallel.compression.compress_decompress`, three error-feedback rounds:
    outputs, residuals and metrics bit-equal (both round half to even and
    divide by the same f32 scale), `topk_sparsify` on distinct magnitudes
    exactly (ties break otherwise in `torch.topk`);
  * `parallel.pipeline.pipeline_forward` at S 4, n_micro 6 within 1e-6;
  * `ft.elastic.elastic_restore` 8 -> 4 devices from the reference's own
    checkpoint: values bit-equal, mesh {"data": 2, "model": 2}, every block
    equal to the reference's `addressable_shards` at its grid coordinate;
    `plan_mesh` cases;
  * `ShardingPolicy.tree_specs` of the SMOKE dense, moe, hybrid and xlstm
    configs on (data 2, model 4) and (pod 2, data 2, model 2), equal as
    tuples; `fit_spec` trimming; `KeyError` on an unknown logical name;
  * `models.moe.moe_ffn` under a policy at B = 4 (4 dispatch groups) and
    B = 6 (halved to 2), capacity per group (1e-5; aux / z / drop 1e-6),
    and a qwen3-moe SMOKE forward under a policy (logits 1e-3, f32);
  * `PerfModel.select_allreduce` at one pod: "flat_ring" in both.

Port-only: the policy paths against the no-policy ones (bit-equal), the
pipeline against the sequential stages (bit-equal), the plan hooks, a
placement that does not tile refused, and the example programs.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import CheckpointManager, flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import collectives as tc  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.epoch import SyncStats  # noqa: E402
from repro_torch.core.perfmodel import DEFAULT_MODEL  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.ft import elastic as telastic  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.parallel import compression as tcomp  # noqa: E402
from repro_torch.parallel import overlap as tov  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NDEV, PODS, PER_POD = 8, 2, 4
GRID = {"pod": PODS, "data": PER_POD}
SPEC_ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "xlstm-1.3b")
SPEC_MESHES = {"dm": {"data": 2, "model": 4}, "pdm": {"pod": 2, "data": 2, "model": 2}}
MOE = dict(S=32, D=16, E=4, k=2, ff=24, cf=0.5)   # E 4, k 2: a group's expert overflows
MOE_B = (4, 6)
FWD_ARCH, FWD_B, FWD_S = "qwen3-moe-30b-a3b", 4, 16
STAGES, N_MICRO, MB, DW = 4, 6, 3, 8

# collective cases over the (pod 2, data 4) grid: (input, the reference's
# call on a rank's block).  The reference counts ops while tracing, and a
# `fori_loop` body is traced once; the port runs (and counts) every step:
# LOOP_TRIPS gives, per recorded plan, how many times the port runs it.
COLL = {
    "hier": ("x", "lambda x: jc.hierarchical_all_reduce(x, 'data', 'pod')"),
    "ag_data": ("x", "lambda x: jc.ring_all_gather(x, 'data')"),
    "ag_pod": ("x", "lambda x: jc.ring_all_gather(x, 'pod')"),
    "rs_data": ("rs4", "lambda x: jc.ring_reduce_scatter(x, 'data')"),
    "rs_pod": ("rs2", "lambda x: jc.ring_reduce_scatter(x, 'pod')"),
    "ar_data": ("ar", "lambda x: jc.all_reduce(x, 'data')"),
    "ar_pod": ("ar", "lambda x: jc.all_reduce(x, 'pod')"),
    "halo": ("halo", "lambda x: jc.halo_exchange_nd(x, {'data': 1, 'pod': 2}, "
                     "{'data': 0, 'pod': 1})"),
}
LOOP_TRIPS = {
    "hier": [PER_POD - 1, PER_POD // 2],      # reduce-scatter, then all-gather
    "ag_data": [PER_POD // 2],                # max(steps_f, steps_b)
    "ag_pod": [1],
    "rs_data": [PER_POD - 1],
    "rs_pod": [PODS - 1],
    "ar_data": [PER_POD - 1, PER_POD // 2],
    "ar_pod": [PODS - 1, 1],
    "halo": [1, 1],                           # two epochs, no loop
}
FIT_CASES = [  # (spec, shape, mesh)
    ((("pod", "data"), "model"), (2, 6), "pdm"),
    ((("pod", "data"), "model"), (8, 4), "pdm"),
    ((("pod", "data"), None), (6, 3), "pdm"),
    (("model", "data"), (5, 4), "dm"),
    (("data", "model", None), (4, 12, 7), "dm"),
    ((None, ("data", "model")), (3, 16), "dm"),
    ((None, ("data", "model")), (3, 4), "dm"),
]


def _inputs() -> dict:
    rng = np.random.default_rng(26)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    mags = (rng.permutation(300) + 1).astype(np.float32) / 7.0
    return {
        "x": f(PODS, PER_POD, 3, 5), "rs4": f(PODS, PER_POD, PER_POD, 5),
        "rs2": f(PODS, PER_POD, PODS, 5), "ar": f(PODS, PER_POD, 7, 3),
        "halo": f(PODS, PER_POD, 4, 6),
        "g_w1": f(NDEV * 4, 8), "g_b": f(NDEV * 2, 3),
        "c_w": f(512) * 1e-2, "c_m": f(64, 8),
        "topk": mags * np.where(rng.random(300) < 0.5, -1, 1).astype(np.float32),
        "pipe_w": f(STAGES, DW, DW) * 0.5, "pipe_x": f(N_MICRO, MB, DW),
        **{f"moe_x{b}": f(b, MOE["S"], MOE["D"]) for b in MOE_B},
    }


def _grads(inp: dict) -> dict:
    return {"w1": inp["g_w1"], "w2": {"b": inp["g_b"]}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------------- reference (child)
def _child(d: pathlib.Path) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.ckpt.checkpoint import CheckpointManager as JCkpt
    from repro.compat import shard_map
    from repro.configs import get_config as jget
    from repro.core import collectives as jc
    from repro.core.epoch import SyncStats as JSync
    from repro.core.rma import OpCounter as JOps
    from repro.ft.elastic import elastic_restore, plan_mesh
    from repro.models import build_model as jbuild
    from repro.models import moe as jmoe
    from repro.parallel import compression as jcomp
    from repro.parallel import overlap as jov
    from repro.parallel import pipeline as jpipe
    from repro.parallel import sharding as jsh

    inp = dict(np.load(d / "in.npz"))
    out, meta = {}, {"coll": {}, "specs": {}}
    devs = jax.devices()
    grid = jax.make_mesh((PODS, PER_POD), ("pod", "data"))
    # policies constrain shardings: their meshes' axes are Auto ones
    meshes = {"dm": jax.sharding.Mesh(np.asarray(devs).reshape(2, 4), ("data", "model")),
              "pdm": jax.sharding.Mesh(np.asarray(devs).reshape(2, 2, 2),
                                       ("pod", "data", "model"))}

    # ---- collectives over each named axis, ledgers kept from the trace
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

    # ---- the gradient sync (gradsync_sub.py's sizes), both compress modes
    grads = jax.tree.map(jnp.asarray, _grads(inp))
    specs = jax.tree.map(lambda g: P(("pod", "data"), None), grads)
    for comp in (False, True):
        st = JSync()
        f = jax.jit(shard_map(
            functools.partial(jov.overlapped_grad_sync, inner_axis="data", outer_axis="pod",
                              bucket_bytes=64, compress_outer=comp, stats=st),
            mesh=grid, in_specs=(specs,), out_specs=specs, check_vma=False))
        with JOps() as c:
            res = f(grads)
        for k, v in _flat(res).items():
            out[f"sync{int(comp)}/{k}"] = np.asarray(v)
        meta[f"sync{int(comp)}"] = {"flushes": st.flush_msgs, "ops": c.snapshot(),
                                    "plans": c.plans}
    local = jax.tree.map(lambda g: np.asarray(g)[: g.shape[0] // NDEV], grads)
    meta["buckets_global"] = jov.bucket_grads(grads, bucket_bytes=64)
    meta["buckets_local"] = jov.bucket_grads(local, bucket_bytes=64)
    meta["buckets_local_big"] = jov.bucket_grads(local, bucket_bytes=200)

    # ---- compression: three error-feedback rounds, top-k
    g = {"w": jnp.asarray(inp["c_w"]), "v": {"m": jnp.asarray(inp["c_m"])}}
    state = jcomp.init_compression_state(g)
    for r in range(3):
        comp, state, met = jcomp.compress_decompress(g, state)
        for k, v in _flat(comp).items():
            out[f"comp{r}/{k}"] = np.asarray(v)
        for k, v in _flat(state.residual).items():
            out[f"resid{r}/{k}"] = np.asarray(v)
        meta[f"comp_metrics{r}"] = {k: int(v) for k, v in met.items()}
    vals, idx = jcomp.topk_sparsify(jnp.asarray(inp["topk"]), frac=0.05)
    out["topk_vals"], out["topk_idx"] = np.asarray(vals), np.asarray(idx)

    # ---- pipeline (pipeline_sub.py's sizes) on 4 of the 8 devices
    cfg = jpipe.PipelineConfig(n_stages=STAGES, n_micro=N_MICRO, axis="pod")
    pmesh = jax.make_mesh((STAGES,), ("pod",), devices=devs[:STAGES])
    f = jax.jit(shard_map(
        functools.partial(jpipe.pipeline_forward, lambda w, v: jnp.tanh(v @ w[0]), cfg=cfg),
        mesh=pmesh, in_specs=(P("pod", None, None), P(None, None, None)),
        out_specs=P(None, None, None), check_vma=False))
    out["pipe"] = np.asarray(f(jnp.asarray(inp["pipe_w"]), jnp.asarray(inp["pipe_x"])))
    meta["bubble"] = cfg.bubble_fraction

    # ---- elastic restore 8 -> 4 (elastic_sub.py's tree), the checkpoint kept
    from jax.sharding import NamedSharding
    mesh_a = jax.make_mesh((2, 4), ("data", "model"))
    tree = {"w_in": jax.device_put(jnp.arange(64 * 32, dtype=jnp.float32).reshape(64, 32),
                                   NamedSharding(mesh_a, P("data", "model"))),
            "norm": jnp.ones((7,), jnp.bfloat16)}
    ckpt = JCkpt(str(d / "ckpt"))
    ckpt.save(5, tree, extra={"step": 5}, blocking=True)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    restored, extra, mesh_b, _ = elastic_restore(ckpt, like, n_surviving_devices=4,
                                                 prefer_model=2)
    meta["elastic"] = {"extra": extra, "mesh": dict(mesh_b.shape)}
    out["elastic/w_in"] = np.asarray(restored["w_in"])
    out["elastic/norm"] = np.asarray(restored["norm"].astype(jnp.float32))
    for sh in restored["w_in"].addressable_shards:
        i, j = (int(v) for v in np.argwhere(mesh_b.devices == sh.device)[0])
        out[f"elastic/block/{i}_{j}"] = np.asarray(sh.data)
    meta["plan_mesh"] = {f"{n}_{m}": [plan_mesh(n, m).data, plan_mesh(n, m).model]
                         for n in range(1, 10) for m in (1, 2, 4, 8)}

    # ---- sharding specs
    for arch in SPEC_ARCHS:
        shapes = jax.eval_shape(jbuild(jget(arch, smoke=True)).init, jax.random.PRNGKey(0))
        for mname, mesh in meshes.items():
            specs = jsh.ShardingPolicy(mesh=mesh).tree_specs(shapes)
            flat, _ = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))
            meta["specs"][f"{arch}/{mname}"] = {
                "/".join(jsh._key_str(k) for k in path): _spec_json(s) for path, s in flat}
    meta["fit"] = [_spec_json(jsh.fit_spec(P(*spec), shape, meshes[m]))
                   for spec, shape, m in FIT_CASES]
    try:
        jsh.ShardingPolicy(mesh=meshes["dm"]).act_spec("act_nonsense")
        meta["unknown_raises"] = False
    except KeyError:
        meta["unknown_raises"] = True

    # ---- MoE under a policy, and a SMOKE forward under a policy
    pol = jsh.ShardingPolicy(mesh=meshes["pdm"])
    mp = jmoe.init_moe(jax.random.PRNGKey(3), MOE["D"], MOE["E"], MOE["ff"], "swiglu", 0,
                       jnp.float32)
    for k, v in _flat(mp).items():
        out[f"moe_param/{k}"] = np.asarray(v)
    for b in MOE_B:
        for tag, p_ in (("pol", pol), ("none", None)):
            def run(x, p_=p_):
                with jsh.use_policy(p_):
                    return jmoe.moe_ffn(mp, x, MOE["k"], MOE["cf"], "swiglu")
            y, met = jax.jit(run)(jnp.asarray(inp[f"moe_x{b}"]))
            out[f"moe/{b}/{tag}/y"] = np.asarray(y)
            for n_, v in zip(("aux", "z", "drop"), met):
                out[f"moe/{b}/{tag}/{n_}"] = np.asarray(v)
    fwd_p = dict(np.load(d / "fwd_params.npz"))
    model = jbuild(jget(FWD_ARCH, smoke=True))
    params = jax.tree.map(jnp.asarray, _tree(fwd_p))
    toks = jnp.asarray(np.load(d / "fwd_tokens.npy"))

    def fwd(p, t):
        with jsh.use_policy(pol):
            return model.forward_logits(p, {"tokens": t})
    res = jax.jit(fwd)(params, toks)
    out["fwd/logits"], out["fwd/aux"] = np.asarray(res.logits), np.asarray(res.aux_loss)
    np.savez(d / "out.npz", **out)
    (d / "meta.json").write_text(json.dumps(meta))


def _fwd_model():
    cfg = get_config(FWD_ARCH, smoke=True)
    model = build_model(cfg)
    params = model.init(7, device="cpu")
    params = {k: v for k, v in flatten(params)}
    return cfg, model, {k: v.float() for k, v in params.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    np.savez(d / "in.npz", **_inputs())
    cfg, _, flat = _fwd_model()
    np.savez(d / "fwd_params.npz", **{k: v.numpy() for k, v in flat.items()})
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (FWD_B, FWD_S)).astype(np.int32)
    np.save(d / "fwd_tokens.npy", toks)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NDEV}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return d, dict(np.load(d / "out.npz")), json.loads((d / "meta.json").read_text())


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _grid() -> Mesh:
    return Mesh(GRID, device="cpu")


# ============================================================ the mesh
def test_named_axes_mesh():
    m = _grid()
    assert (m.p, m.axis, m.ranks, m.axis_names) == (8, ("pod", "data"), 8, ("pod", "data"))
    sub = m.along("data")
    assert (sub.p, sub.axis, sub.ranks) == (4, "data", 8)
    x = torch.arange(2 * 4 * 3.).reshape(2, 4, 3)
    assert torch.equal(m.back(m.front(x, "data"), "data"), x)
    s = m.psum(x, "pod")
    assert torch.equal(s, x.sum(0, keepdim=True).expand_as(x))
    assert m.front(s, "data").is_contiguous() == m.front(x, "data").is_contiguous()
    one = Mesh(4, "x", device="cpu")                     # the one-axis form stays
    assert (one.p, one.axis, one.ranks, one.along("x")) == (4, "x", 4, one)
    with pytest.raises(MeshError, match="along"):
        m.shift(x, 1)
    with pytest.raises(MeshError):
        m.along("model")


# ====================================================== collectives
def _unrolled(ref_meta: dict, trips: list) -> dict:
    """The reference's ledgers with each traced loop body counted once per
    step the port runs (every plan of these cases records puts only)."""
    plans = [pl for pl, n in zip(ref_meta["plans"], trips) for _ in range(n)]
    assert len(ref_meta["plans"]) == len(trips)
    puts = sum(pl["raw"] for pl in plans)
    wire = sum(pl["coalesced"] for pl in plans)
    by_axis: dict = {}
    for pl in plans:
        per = by_axis.setdefault(pl["axis"], {"puts": 0})
        per["puts"] += pl["raw"]
    ops = {"puts": puts, "gets": 0, "accs": 0, "colls": 0, "raw_msgs": puts,
           "coalesced_msgs": wire, "by_axis": by_axis}
    return {"ops": ops, "plans": plans}


def _port_coll(name: str, x: torch.Tensor, m: Mesh) -> torch.Tensor:
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


@pytest.mark.parametrize("name", list(COLL))
def test_collective_over_named_axis_matches_reference(name, ref, inputs):
    _, out, meta = ref
    m = _grid()
    with OpCounter() as c:
        got = _port_coll(name, _t(inputs[COLL[name][0]]), m)
    want = out[f"coll/{name}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exp = _unrolled(meta["coll"][name], LOOP_TRIPS[name])
    assert c.snapshot() == exp["ops"]
    assert c.plans == exp["plans"]


def test_hierarchical_all_reduce_is_the_sum():
    x = torch.randn(2, 4, 5, 7, generator=torch.Generator().manual_seed(1))
    got = tc.hierarchical_all_reduce(x, _grid(), "data", "pod")
    torch.testing.assert_close(got, x.sum((0, 1), keepdim=True).expand_as(x),
                               rtol=1e-6, atol=1e-5)


# ====================================================== the grad sync
def _port_grads(inputs) -> dict:
    return {"w1": _t(inputs["g_w1"]).reshape(PODS, PER_POD, 4, 8),
            "w2": {"b": _t(inputs["g_b"]).reshape(PODS, PER_POD, 2, 3)}}


@pytest.mark.parametrize("compress", [False, True])
def test_overlapped_grad_sync_matches_reference(compress, ref, inputs):
    _, out, meta = ref
    st = SyncStats()
    with OpCounter() as c:
        got = tov.overlapped_grad_sync(_port_grads(inputs), _grid(), bucket_bytes=64,
                                       compress_outer=compress, stats=st)
    want = {k: v for k, v in out.items() if k.startswith(f"sync{int(compress)}/")}
    for key, leaf in _flat(got).items():
        np.testing.assert_allclose(leaf.reshape(-1, leaf.shape[-1]).numpy(),
                                   want[f"sync{int(compress)}/{key}"], rtol=1e-5, atol=1e-5)
    r = meta[f"sync{int(compress)}"]
    assert st.flush_msgs == r["flushes"] == 2
    # two leaves, each the reduce-scatter body (3 steps) and all-gather body (2)
    exp = _unrolled({"plans": r["plans"]}, [PER_POD - 1, PER_POD // 2] * 2)
    assert c.snapshot() == exp["ops"]
    assert c.plans == exp["plans"]


def test_compress_outer_is_not_applied_in_either_package(ref, inputs):
    _, out, _ = ref
    for k in ("w1", "w2/b"):
        np.testing.assert_array_equal(out[f"sync0/{k}"], out[f"sync1/{k}"])
    a = tov.overlapped_grad_sync(_port_grads(inputs), _grid(), bucket_bytes=64)
    b = tov.overlapped_grad_sync(_port_grads(inputs), _grid(), bucket_bytes=64,
                                 compress_outer=True)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_bucket_grads_matches_reference(ref, inputs):
    _, _, meta = ref
    g = _port_grads(inputs)
    assert tov.bucket_grads(g, 64, _grid()) == meta["buckets_local"]
    assert tov.bucket_grads(g, 200, _grid()) == meta["buckets_local_big"]
    flat = {"w1": _t(inputs["g_w1"]), "w2": {"b": _t(inputs["g_b"])}}
    assert tov.bucket_grads(flat, 64) == meta["buckets_global"]
    assert sorted(i for b in tov.bucket_grads(g, 64, _grid()) for i in b) == [0, 1]


def test_grad_sync_without_an_outer_axis_is_one_ring():
    m = Mesh({"data": 4}, device="cpu")
    g = {"a": torch.randn(4, 6, generator=torch.Generator().manual_seed(2))}
    got = tov.overlapped_grad_sync(g, m, outer_axis=None)
    torch.testing.assert_close(got["a"], g["a"].sum(0, keepdim=True).expand(4, 6))


# ====================================================== compression
def test_compress_decompress_matches_reference(ref, inputs):
    _, out, meta = ref
    g = {"w": _t(inputs["c_w"]), "v": {"m": _t(inputs["c_m"])}}
    state = tcomp.init_compression_state(g)
    for r in range(3):
        comp, state, met = tcomp.compress_decompress(g, state)
        assert met == meta[f"comp_metrics{r}"]
        for k, v in _flat(comp).items():
            np.testing.assert_array_equal(v.numpy(), out[f"comp{r}/{k}"])
        for k, v in _flat(state.residual).items():
            np.testing.assert_array_equal(v.numpy(), out[f"resid{r}/{k}"])


def test_compression_error_feedback_converges(inputs):
    """gradsync_sub.py's check: the mean of 40 compressed rounds is within
    5 % of the true gradient."""
    g = {"w": _t(inputs["c_w"])}
    state = tcomp.init_compression_state(g)
    acc = torch.zeros(512)
    for _ in range(40):
        comp, state, _ = tcomp.compress_decompress(g, state)
        acc = acc + comp["w"]
    err = float((acc / 40 - g["w"]).abs().max() / g["w"].abs().max())
    assert err < 0.05, err


def test_topk_sparsify_matches_reference(ref, inputs):
    _, out, _ = ref
    vals, idx = tcomp.topk_sparsify(_t(inputs["topk"]), frac=0.05)
    np.testing.assert_array_equal(idx.numpy(), out["topk_idx"])
    np.testing.assert_array_equal(vals.numpy(), out["topk_vals"])


# ====================================================== the pipeline
def _stage(w, v):
    return torch.tanh(v @ w[0])


def test_pipeline_forward_matches_reference(ref, inputs):
    _, out, meta = ref
    cfg = tpipe.PipelineConfig(STAGES, N_MICRO)
    got = tpipe.pipeline_forward(_stage, _t(inputs["pipe_w"]), _t(inputs["pipe_x"]), cfg,
                                 Mesh(STAGES, "pod", device="cpu"))
    assert got.shape == (STAGES, N_MICRO, MB, DW)
    for s in range(STAGES):                           # every stage holds the result
        np.testing.assert_allclose(got[s].numpy(), out["pipe"], rtol=1e-6, atol=1e-6)
    assert cfg.bubble_fraction == meta["bubble"]


def test_pipeline_is_the_stages_in_sequence(inputs):
    """Bit-equal to each microbatch through the stages one after another:
    the schedule only moves activations, and a put is a copy."""
    w, x = _t(inputs["pipe_w"]), _t(inputs["pipe_x"])
    cfg = tpipe.PipelineConfig(STAGES, N_MICRO)
    with OpCounter() as c:
        got = tpipe.pipeline_forward(_stage, w, x, cfg, Mesh(STAGES, "pod", device="cpu"))
    for mb in range(N_MICRO):
        h = x[mb]
        for s in range(STAGES):
            h = _stage(w[s:s + 1], h)
        assert torch.equal(got[0, mb], h)
    assert c.puts == N_MICRO + STAGES - 1 and c.colls == 1
    with pytest.raises(MeshError):
        tpipe.pipeline_forward(_stage, w, x, cfg, Mesh(2, "pod", device="cpu"))


# ====================================================== elasticity
def test_elastic_restore_matches_reference(ref):
    d, out, meta = ref
    like = {"w_in": torch.empty(64, 32, device="meta"),
            "norm": torch.empty(7, dtype=torch.bfloat16, device="meta")}
    tree, extra, mesh, pol = telastic.elastic_restore(CheckpointManager(str(d / "ckpt")), like,
                                                      n_surviving_devices=4, prefer_model=2,
                                                      device="cpu")
    assert extra == meta["elastic"]["extra"] == {"step": 5}
    assert mesh.shape == meta["elastic"]["mesh"] == {"data": 2, "model": 2}
    assert tree["w_in"].device.type == "cpu" and tree["norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["w_in"].numpy(), out["elastic/w_in"])
    np.testing.assert_array_equal(tree["norm"].float().numpy(), out["elastic/norm"])
    sh = pol.tree_shardings(like)["w_in"]
    assert sh.spec == ("data", "model")
    blocks = sh.blocks(tree["w_in"])
    assert len(blocks) == 4
    for (i, j), blk in blocks.items():
        np.testing.assert_array_equal(blk.numpy(), out[f"elastic/block/{i}_{j}"])


def test_plan_mesh_matches_reference(ref):
    _, _, meta = ref
    for key, want in meta["plan_mesh"].items():
        n, m = (int(v) for v in key.split("_"))
        plan = telastic.plan_mesh(n, m)
        assert [plan.data, plan.model] == want, key


def test_restore_refuses_a_placement_that_does_not_tile(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w_in": torch.zeros(6, 4)}
    mgr.save(1, tree, blocking=True)
    mesh = Mesh({"data": 4, "model": 1}, device="cpu")
    bad = {"w_in": tsh.NamedSharding(mesh, tsh.P("data", None))}
    with pytest.raises(ValueError, match="tile"):
        mgr.restore(tree, shardings=bad)
    good = {"w_in": tsh.NamedSharding(mesh, tsh.P(None, "data"))}
    back, _ = mgr.restore(tree, shardings=good)
    assert torch.equal(back["w_in"], tree["w_in"])


# ====================================================== sharding specs
@pytest.mark.parametrize("mname", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_tree_specs_match_reference(arch, mname, ref):
    _, _, meta = ref
    params = build_model(get_config(arch, smoke=True)).init(0, device="cpu")
    pol = tsh.ShardingPolicy(Mesh(SPEC_MESHES[mname], device="cpu"))
    got = {path: _spec_json(s) for path, s in _spec_items(pol.tree_specs(params))}
    assert got == meta["specs"][f"{arch}/{mname}"]


def _spec_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def test_fit_spec_matches_reference(ref):
    _, _, meta = ref
    got = [_spec_json(tsh.fit_spec(tsh.P(*spec), shape,
                                   Mesh(SPEC_MESHES[m], device="cpu")))
           for spec, shape, m in FIT_CASES]
    assert got == meta["fit"]


def test_unknown_logical_name_raises_under_a_policy(ref):
    _, _, meta = ref
    assert meta["unknown_raises"]
    x = torch.ones(2, 3)
    assert tsh.shard(x, "act_nonsense") is x                # no policy: a no-op
    with tsh.use_policy(tsh.ShardingPolicy(Mesh(SPEC_MESHES["dm"], device="cpu"))):
        assert tsh.shard(x, "act_btd") is x
        with pytest.raises(KeyError):
            tsh.shard(x, "act_nonsense")
    assert tsh.current_policy() is None


# ====================================================== MoE and forward under a policy
def _moe_params(out) -> dict:
    return _tree({k[len("moe_param/"):]: _t(v) for k, v in out.items()
                  if k.startswith("moe_param/")})


@pytest.mark.parametrize("b", MOE_B)
def test_moe_under_a_policy_matches_reference(b, ref, inputs):
    _, out, _ = ref
    params = _moe_params(out)
    pol = tsh.ShardingPolicy(Mesh(SPEC_MESHES["pdm"], device="cpu"))
    x = _t(inputs[f"moe_x{b}"])
    for tag, p in (("pol", pol), ("none", None)):
        with tsh.use_policy(p):
            assert tmoe._n_groups(b) == ({4: 4, 6: 2}[b] if p else 1)
            y, met = tmoe.moe_ffn(params, x, MOE["k"], MOE["cf"], "swiglu")
        np.testing.assert_allclose(y.numpy(), out[f"moe/{b}/{tag}/y"], rtol=1e-5, atol=1e-5)
        for n, v in zip(("aux", "z", "drop"), met):
            np.testing.assert_allclose(float(v), out[f"moe/{b}/{tag}/{n}"], rtol=1e-6,
                                       atol=1e-6)
    # capacity is per group: the policy changes which tokens drop
    assert np.abs(out[f"moe/{b}/pol/y"] - out[f"moe/{b}/none/y"]).max() > 0.1


@pytest.mark.parametrize("b", MOE_B)
def test_moe_groups_are_separate_calls(b, ref, inputs):
    """Under a policy, bit-equal to one no-policy call a dispatch group."""
    _, out, _ = ref
    params = _moe_params(out)
    x = _t(inputs[f"moe_x{b}"])
    with tsh.use_policy(tsh.ShardingPolicy(Mesh(SPEC_MESHES["pdm"], device="cpu"))):
        y, _ = tmoe.moe_ffn(params, x, MOE["k"], MOE["cf"], "swiglu")
        g = tmoe._n_groups(b)
    parts = [tmoe.moe_ffn(params, xg, MOE["k"], MOE["cf"], "swiglu")[0]
             for xg in x.chunk(g)]
    assert torch.equal(y, torch.cat(parts))


def test_smoke_forward_under_a_policy_matches_reference(ref):
    d, out, _ = ref
    cfg, model, flat = _fwd_model()
    params = params_from_jax(_tree({k: v.numpy() for k, v in flat.items()}), device="cpu",
                             dtype=torch.float32)
    toks = torch.from_numpy(np.load(d / "fwd_tokens.npy"))
    pol = tsh.ShardingPolicy(Mesh(SPEC_MESHES["pdm"], device="cpu"))
    with torch.no_grad(), tsh.use_policy(pol):
        res = model.forward_logits(params, {"tokens": toks})
    np.testing.assert_allclose(res.logits.numpy(), out["fwd/logits"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(res.aux_loss), out["fwd/aux"], rtol=1e-5, atol=1e-6)


def test_policy_steps_equal_no_policy_for_a_dense_model():
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                              make_train_step)

    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    pol = tsh.ShardingPolicy(Mesh({"data": 4}, device="cpu"))
    a = make_prefill_step(model)(params, batch)
    assert torch.equal(a, make_prefill_step(model, pol)(params, batch))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    s0 = make_train_step(model, opt)(params, init_opt_state(params), batch)
    s1 = make_train_step(model, opt, policy=pol)(params, init_opt_state(params), batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(s0[0]), tree_leaves(s1[0])))
    la, _ = make_serve_step(model)(params, toks[:, 0], model.init_cache(4, 32, device="cpu"))
    lb, _ = make_serve_step(model, pol)(params, toks[:, 0],
                                        model.init_cache(4, 32, device="cpu"))
    assert torch.equal(la, lb)


# ====================================================== the models and plan hooks
def test_select_allreduce():
    from repro.core.perfmodel import DEFAULT_MODEL as JMODEL

    for nbytes in (1e3, 1e6, 1e8, 1e10):
        for per_pod in (2, 4, 8):
            assert DEFAULT_MODEL.select_allreduce(nbytes, 1, per_pod) == "flat_ring"
            assert JMODEL.select_allreduce(nbytes, 1, per_pod) == "flat_ring"
    # on one card the split saves launches: it wins at small payloads, and
    # once the flat ring wins it keeps winning as the payload grows
    for pods, per_pod in ((2, 2), (2, 4), (4, 2), (4, 4)):
        picks = [DEFAULT_MODEL.select_allreduce(2.0 ** e, pods, per_pod) for e in range(10, 36)]
        assert picks[0] == "hierarchical", (pods, per_pod)
        if "flat_ring" in picks:
            assert set(picks[picks.index("flat_ring"):]) == {"flat_ring"}, (pods, per_pod)
    # at (pod 2, data 2) the split's extra pass over the payload outweighs its
    # launches past a few hundred MB
    assert DEFAULT_MODEL.select_allreduce(2.0 ** 35, 2, 2) == "flat_ring"
    st = tov.CollectiveStrategist()
    assert st.allreduce_plan(1e3, 2, 2) == "hierarchical"
    assert st.backend_plan(1e3, False) == "torch" and st.backend_plan(1e3, True) == "cuda"


def test_plan_hooks():
    m = Mesh(4, "x", device="cpu")
    plan = tplan.RmaPlan(m)
    x = torch.arange(8.).reshape(4, 2)
    h = plan.put_shift(x, 1)
    assert plan.pending == 1 and not h.resolved
    plan.flush()
    assert plan.pending == 0 and h.resolved
    assert tplan.choose_backend(DEFAULT_MODEL, 1e9, False) == "torch"
    assert tplan.choose_backend(DEFAULT_MODEL, 4.0, True) == "cuda"

    class Forced(tov.CollectiveStrategist):
        calls: list = []

        def aggregation_plan(self, n, msg_bytes):
            self.calls.append(("pack", n))
            return "pack"

        def backend_plan(self, nbytes, shift_eligible=True):
            self.calls.append(("backend", shift_eligible))
            return "torch"

    s = Forced()
    plan = tplan.RmaPlan(m, strategist=s)
    a, b = plan.put_shift(x, 1), plan.put_shift(x + 1, 1)
    stats = plan.flush()
    assert s.calls == [("pack", 2), ("backend", False)]      # packed: not the kernel's
    assert stats.packed_groups == 1 and stats.backends == {"torch": 1}
    assert torch.equal(a.result(), x.roll(1, 0)) and torch.equal(b.result(), (x + 1).roll(1, 0))


def test_examples_run_on_the_cpu(tmp_path):
    from repro_torch.examples import quickstart, train_e2e

    toks = quickstart.main(["--device", "cpu", "--steps", "3", "--new", "4"])
    assert len(toks) == 4
    hist = train_e2e.main(["--device", "cpu", "--width", "64", "--layers", "2", "--steps", "8",
                           "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 8 and hist[-1]["loss"] < hist[0]["loss"]
    assert CheckpointManager(str(tmp_path)).list_steps() == [4, 6, 8]


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
