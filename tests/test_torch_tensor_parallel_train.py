"""The train step split over a `ProcMesh` grid ``{"data": 2, "model": 2}``
against the JAX reference's jitted step under the same `ShardingPolicy`.

Four CPU processes are spawned once for the whole file (`procmesh.run`
with the grid: gloo over a `FileStore`, windows as shared files, the peer
forms' plain versions).  For each case every rank takes its blocks of the
same seeded numpy params and AdamW moments (`params_from_jax` /
`opt_state_from_jax` with ``policy=``), built by the port's `make_policy`
(the reference's rule: ``fsdp=True``), and the global batch, of which
`make_train_step` takes the rank's rows; it runs `step_grads` and one
train step.  The cases, in f32, on qwen1.5-110b SMOKE over the grid:

  * ``fsdp``: 2-D blocks, FSDP over ``data`` x TP over ``model``;
  * ``tp_only``: the same policy with ``fsdp=False`` (ROADMAP 12c.1 alone);
  * ``mixed_tied``: 6 q heads and 3 KV heads with tied embeddings and
    FSDP: ``wk`` / ``wv`` split over ``data`` only, ``bk`` / ``bv`` whole;
  * ``micro``: ``fsdp`` with two microbatches;

and on chatglm3-6b SMOKE over the four ranks as ``{"model": 4}``:

  * ``glm_tp4``: 2 KV heads under 4 ranks, so `make_policy` sets
    ``kv_seq_shard`` (a train step has no cache): one q head a rank,
    ``wk`` / ``wv`` / ``bk`` / ``bv`` whole on every rank;

and the moe family (tensor-parallel experts, the router whole):

  * ``moe_fsdp``: qwen3-moe SMOKE over the grid with FSDP at a global
    batch of 4: the reference's G = 2 dispatch groups, one a rank's rows;
  * ``moe_micro``: the same with two microbatches, each global rows [i B
    / 2, (i + 1) B / 2) as the reference cuts them (its reference is its
    `value_and_grad` over those microbatches, averaged as its train step
    accumulates them: an MoE loss is not linear in the rows);
  * ``moe_shared_tp4``: moonshot SMOKE (a shared expert) over ``{"model":
    4}``, every rank on the whole batch;
  * ``moe_drops``: ``moe_fsdp`` at 48 tokens a row with the router biased
    toward expert 0, so that capacity drops items.

One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs ``jax.jit(make_train_step(model, AdamWConfig(...), StepConfig(n),
policy))`` and ``jax.value_and_grad`` of the reference's remat loss under
the reference's `make_policy` over ``Mesh(devices.reshape(2, 2), ("data",
"model"))`` (Auto axes; ``(1, 4)`` for ``glm_tp4``, whose FSDP specs name a
``data`` axis of one), every input placed by its fitted spec, with the
dtype-keeping `grad_cast_bf16` of `tests/test_torch_training.py` swapped
in; it writes its results, its fitted specs, and `make_policy`'s answers
for every arch x shape on a few mesh shapes.  Held, at the train-step
parity tolerances of `tests/test_torch_training.py`: every rank's loss
(1e-4), grad norm (1e-4 relative) and its gradient, moment and updated
param blocks, each the reference's leaf cut by the reference's spec at the
rank's coordinate (1e-4 of the leaf's max; params 1e-5 where |g| > 1e-4 of
the max, else 2 lr); ranks holding one block hold it bit for bit; the
step's collectives are the one-sided ring's puts, every
`torch.distributed` collective made to raise while it runs.  The MoE
cases also hold each step's aux and z losses to the reference's (a
`jax.debug.callback` in a wrapped `repro.models.moe.moe_ffn` keeps its
drop fractions), the router to the same bits on every model rank, and
the routing (`models.moe.route` tapped in the ranks) to the same bits on
every rank of a data coordinate, in the forward and the recomputation.
In this process: a remat body recomputes under the forward's policy, and
a bf16 embedding's gradient sums an id's repeats in f32.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402
from repro_torch.ckpt.checkpoint import flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.launch.dryrun import make_policy  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe as X  # noqa: E402
from repro_torch.models.registry import build_model, params_from_jax  # noqa: E402
from repro_torch.parallel.sharding import ShardingPolicy  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, opt_state_from_jax, tree_map  # noqa: E402
from repro_torch.train.train_step import (StepConfig, loss_and_grads,  # noqa: E402
                                          make_train_step, step_grads)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, GRID = 4, {"data": 2, "model": 2}
ARCH, GLM = "qwen1.5-110b", "chatglm3-6b"
QWEN, MOON = "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"
B, S, STEP0 = 4, 8, 3                   # the global batch; the moments' step count


class Case(NamedTuple):
    over: dict              # overrides of the SMOKE config
    fsdp: bool
    n: int                  # microbatches
    arch: str
    axes: dict              # the ranks' grid
    seed: int
    seq: int = S
    bias: bool = False      # the router biased toward expert 0 (capacity drops)


CASES = {
    "fsdp": Case({}, True, 1, ARCH, GRID, 0),
    "tp_only": Case({}, False, 1, ARCH, GRID, 4),
    "mixed_tied": Case({"n_heads": 6, "n_kv_heads": 3, "tie_embeddings": True}, True, 1, ARCH,
                       GRID, 3),
    "micro": Case({}, True, 2, ARCH, GRID, 2),
    "glm_tp4": Case({}, True, 1, GLM, {"model": 4}, 1),
    "moe_fsdp": Case({}, True, 1, QWEN, GRID, 5),
    "moe_micro": Case({}, True, 2, QWEN, GRID, 6),
    "moe_shared_tp4": Case({}, True, 1, MOON, {"model": 4}, 7),
    "moe_drops": Case({}, True, 1, QWEN, GRID, 8, seq=48, bias=True),
}
MOE_CASES = sorted(n for n, c in CASES.items() if c.arch in (QWEN, MOON))
AUX_TOL = 1e-4
STEP_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
LOSS_TOL, GRAD_REL, PARAM_TOL = 1e-4, 1e-4, 1e-5
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
CHILD_TIMEOUT = 240.0   # s: the JAX child
POLICY_MESHES = ({"data": 2, "model": 2}, {"data": 16, "model": 16},
                 {"pod": 2, "data": 16, "model": 16}, {"data": 4, "model": 1})
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single")


def _cfg(name: str, get=get_config):
    return dataclasses.replace(get(CASES[name].arch, smoke=True), **CASES[name].over)


def _grid(name: str) -> dict:
    """The case's mesh axes as the reference sees them: a ``data`` axis of
    one where the ranks' grid has none."""
    axes = CASES[name].axes
    return axes if "data" in axes else {"data": 1, **axes}


def _policy(mesh, name: str) -> ShardingPolicy:
    pol = make_policy(mesh, _cfg(name), SHAPES["train_4k"])
    return dataclasses.replace(pol, fsdp=CASES[name].fsdp)


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _inputs(name: str) -> dict:
    """Seeded f32 params (norm scales near 1, the rest at 1/sqrt(D)), first
    and second moments (nu positive) and a global batch of the case's
    length.  With `bias` every embedding row gains the unit vector u and
    the router's expert 0 the column 2u, so that every token's router
    prefers it and capacity drops items."""
    c = CASES[name]
    cfg = _cfg(name)
    rng = np.random.default_rng(c.seed)
    params, mu, nu = {}, {}, {}
    for path, leaf in flatten(build_model(cfg).init_shapes()):
        shape = tuple(leaf.shape)
        if path.endswith("scale"):
            params[path] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            params[path] = rng.standard_normal(shape) / np.sqrt(cfg.d_model)
        mu[path] = 1e-2 * rng.standard_normal(shape)
        nu[path] = 1e-4 * rng.random(shape)
    if c.bias:
        u = np.full(cfg.d_model, cfg.d_model ** -0.5)
        params["tok/embed"] = params["tok/embed"] + u
        params["blocks/moe/router"][..., 0] = 2 * u
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    toks = rng.integers(0, cfg.vocab_size, (2, B, c.seq)).astype(np.int32)
    return {"params": f32(params), "mu": f32(mu), "nu": f32(nu),
            "batch": {"tokens": toks[0], "labels": toks[1]}}


def _refusing(fn):
    """fn() with every torch.distributed collective raising while it runs
    (the bootstrap's barrier is the fence, and stays)."""
    dist = torch.distributed
    saved = {n: getattr(dist, n) for n in DIST_COLLECTIVES if hasattr(dist, n)}

    def refuse(*a, **kw):
        raise AssertionError("a torch.distributed collective on the split step's path")

    for n in saved:
        setattr(dist, n, refuse)
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


class _RouteLog:
    """`models.moe.route` kept while it runs: each call's choices, slots
    and overflow flags, in the order the layers route (forward, then the
    remat recomputation)."""

    def __enter__(self):
        self.real, self.calls = X.route, []

        def route(*a, **kw):
            r = self.real(*a, **kw)
            self.calls.append(tuple(t.numpy().copy() for t in (r.expert_idx, r.slot, r.ok)))
            return r

        X.route = route
        return self

    def __exit__(self, *exc):
        X.route = self.real


# ================================================================ the ranks
def _rank_main(mesh, cases: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coords": mesh.coords}
    for name, ins in cases.items():
        n, axes = CASES[name].n, CASES[name].axes
        model = build_model(_cfg(name))
        m = mesh if axes == GRID else mesh.regrid(axes)
        pol = _policy(m, name)
        params = params_from_jax(_tree(ins["params"]), "cpu", torch.float32, policy=pol)
        state = opt_state_from_jax(STEP0, _tree(ins["mu"]), _tree(ins["nu"]), "cpu",
                                   policy=pol)
        batch = {k: torch.from_numpy(v) for k, v in ins["batch"].items()}
        step_cfg = StepConfig(n_microbatches=n)
        step = make_train_step(model, AdamWConfig(**STEP_CFG), step_cfg, pol)
        with OpCounter() as c_grads, _RouteLog() as routes:
            loss, gmet, grads = _refusing(lambda: step_grads(model, params, batch, step_cfg,
                                                             pol))
        with OpCounter() as c_step:
            p2, st2, met = _refusing(lambda: step(params, state, batch))
        flat = lambda t: {k: v.numpy() for k, v in flatten(t)}  # noqa: E731
        out[name] = {"loss": float(loss), "step_loss": float(met["loss"]),
                     "aux": [float(gmet["aux"]), float(met["aux"])],
                     "z": [float(gmet["z"]), float(met["z"])], "routes": routes.calls,
                     "grad_norm": float(met["grad_norm"]), "lr": float(met["lr"]),
                     "step": int(st2.step), "grads": flat(grads), "params": flat(p2),
                     "mu": flat(st2.mu), "nu": flat(st2.nu), "start": flat(params),
                     "puts_grads": c_grads.puts, "puts_step": c_step.puts,
                     "at": {a: dict(zip(axes, m.coords)).get(a, 0) for a in _grid(name)}}
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    devices = jax.devices()[:NP]         # the backend starts with 4 devices, before
    from repro.configs import SHAPES as JSHAPES  # noqa: E402  repro.launch.dryrun sets
    from repro.configs import get_config as jget  # its own XLA_FLAGS on import
    from repro.launch import dryrun as jdry
    from repro.models import layers as JL
    from repro.models import moe as jmoe
    from repro.models import transformer as JT
    from repro.models.registry import build_model as jbuild
    from repro.parallel import sharding as jsh
    from repro.train import optimizer as jopt
    from repro.train.train_step import StepConfig as JStep, make_train_step as jmake

    # f32 models: a cotangent rounded to bf16, in the cotangent's own dtype
    @jax.custom_vjp
    def grad_cast_keep_dtype(x):
        return x

    grad_cast_keep_dtype.defvjp(
        lambda x: (x, None), lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    JL.grad_cast_bf16 = grad_cast_keep_dtype

    # each MoE layer's drop fraction, in the order the layers run
    drops: list = []
    real_moe = jmoe.moe_ffn

    def tapped(*a, **kw):
        y, met = real_moe(*a, **kw)
        jax.debug.callback(lambda v: drops.append(float(v)), met.drop_fraction)
        return y, met

    jmoe.moe_ffn = tapped

    def taken() -> list:
        jax.effects_barrier()
        got = list(drops)
        drops.clear()
        return got

    is_spec = lambda s: isinstance(s, PartitionSpec)  # noqa: E731
    out, specs, dropped = {}, {}, {}
    for name, (_, fsdp, n, *_) in CASES.items():
        grid = _grid(name)
        mesh = jax.sharding.Mesh(np.asarray(devices).reshape(tuple(grid.values())), tuple(grid))
        cfg = _cfg(name, jget)
        model = jbuild(cfg)
        pol = dataclasses.replace(jdry.make_policy(mesh, cfg, JSHAPES["train_4k"]), fsdp=fsdp)
        ins = {k: _tree(dict(np.load(d / f"{name}_{k}.npz"))) for k in ("params", "mu", "nu")}
        batch = dict(np.load(d / f"{name}_batch.npz"))
        pspecs = pol.tree_specs(ins["params"])

        def place(tree, spec_tree):
            return jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
                                tree, spec_tree)

        params = place(ins["params"], pspecs)
        state = jopt.OptState(jnp.int32(STEP0), place(ins["mu"], pspecs),
                              place(ins["nu"], pspecs))
        rows = NamedSharding(mesh, PartitionSpec("data", None))
        jb = {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()}

        def loss_fn(p, b, model=model, pol=pol):
            JT.set_remat(True)
            with jsh.use_policy(pol):
                res = model.loss(p, b)
            JT.set_remat(False)
            return res

        with mesh:
            vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            if n == 1:
                (loss, lmet), grads = vg(params, jb)
            else:
                # the train step's accumulation (an MoE loss is not linear in
                # the rows): global microbatches, f32 sums, averaged
                grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                loss = jnp.zeros(())
                for i in range(n):
                    mb = {k: jax.device_put(jnp.asarray(v.reshape((n, -1) + v.shape[1:])[i]),
                                            rows) for k, v in batch.items()}
                    (l, _), g = vg(params, mb)
                    grads, loss = jax.tree.map(jnp.add, grads, g), loss + l
                grads, loss = jax.tree.map(lambda g: g / n, grads), loss / n
                lmet = {"aux": jnp.zeros(()), "z": jnp.zeros(())}
            dropped[name] = taken()
            step = jax.jit(jmake(model, jopt.AdamWConfig(**STEP_CFG), JStep(n_microbatches=n),
                                 pol))
            p2, st2, met = step(params, state, jb)
            taken()
        out[f"{name}/loss"] = np.asarray(loss)
        for k in ("aux", "z"):
            out[f"{name}/{k}"] = np.asarray(lmet[k])
        for k in ("loss", "grad_norm", "lr", "aux", "z"):
            out[f"{name}/step/{k}"] = np.asarray(met[k])
        for tname, t in (("grads", grads), ("params", p2), ("mu", st2.mu), ("nu", st2.nu)):
            flat, _ = jax.tree_util.tree_flatten_with_path(t)
            for path, v in flat:
                out[f"{name}/{tname}/" + "/".join(jsh._key_str(k) for k in path)] = np.asarray(v)
        flat, _ = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=is_spec)
        specs[name] = {"/".join(jsh._key_str(k) for k in path):
                       [list(e) if isinstance(e, tuple) else e for e in spec]
                       for path, spec in flat}
    policies = {}
    for arch in ARCH_IDS:
        cfg = jget(arch)
        for shape in JSHAPES:
            for m in POLICY_MESHES:
                pol = jdry.make_policy(types.SimpleNamespace(shape=dict(m)), cfg, JSHAPES[shape])
                policies[f"{arch}/{shape}/{json.dumps(m)}"] = [pol.seq_parallel,
                                                               pol.kv_seq_shard, pol.fsdp]
    np.savez(d / "out.npz", **out)
    (d / "specs.json").write_text(json.dumps({"specs": specs, "policies": policies,
                                              "drops": dropped}))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, its specs and policies, every rank's
    results, the inputs): the JAX child and the four ranks side by side."""
    d = tmp_path_factory.mktemp("tensor_parallel_train")
    cases = {}
    for name in CASES:
        cases[name] = ins = _inputs(name)
        for k, v in ins.items():
            np.savez(d / f"{name}_{k}.npz", **v)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "child", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(cases,), axes=GRID,
                             timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=CHILD_TIMEOUT)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    meta = json.loads((d / "specs.json").read_text())
    return dict(np.load(d / "out.npz")), meta, ranks, cases


def _block(leaf: np.ndarray, spec: list, at: dict, grid: dict) -> np.ndarray:
    """The block of `leaf` that the coordinate `at` of `grid` holds under
    the reference's `spec` (one entry a dim: None, an axis or a list of
    axes)."""
    idx = []
    for d, n in enumerate(leaf.shape):
        entry = spec[d] if d < len(spec) else None
        axes = [] if entry is None else ([entry] if isinstance(entry, str) else entry)
        k, i = 1, 0
        for a in axes:
            i, k = i * grid[a] + at[a], k * grid[a]
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return leaf[tuple(idx)]


def _cut(leaf: np.ndarray, name: str, path: str, rank: dict, meta: dict) -> np.ndarray:
    """The block of the reference's `leaf` at `path` that `rank` holds in
    case `name`."""
    return _block(leaf, meta["specs"][name][path], rank[name]["at"], _grid(name))


def _held(name: str, what: str, runs) -> list:
    """[(rank's block, the reference's leaf cut to it, the whole leaf, path)]
    over every rank and leaf of `what` (grads, params, mu, nu)."""
    ref, meta, ranks, _ = runs
    out = []
    for rank in ranks:
        got = rank[name][what]
        assert set(got) == set(meta["specs"][name])
        for path, v in got.items():
            whole = ref[f"{name}/{what}/{path}"]
            want = _cut(whole, name, path, rank, meta)
            assert v.shape == want.shape, (name, what, path, v.shape, want.shape)
            out.append((v, want, whole, path))
    return out


# ================================================================ tests
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grad_norm_match_the_reference(name, runs):
    ref, _, ranks, _ = runs
    for rank in ranks:
        res = rank[name]
        assert abs(res["loss"] - float(ref[f"{name}/loss"])) <= LOSS_TOL, res["loss"]
        assert abs(res["step_loss"] - float(ref[f"{name}/step/loss"])) <= LOSS_TOL
        gn = float(ref[f"{name}/step/grad_norm"])
        assert abs(res["grad_norm"] - gn) <= GRAD_REL * gn, (res["grad_norm"], gn)
        assert abs(res["lr"] - float(ref[f"{name}/step/lr"])) <= 1e-6 * STEP_CFG["lr"]
        assert res["step"] == STEP0 + 1


@pytest.mark.parametrize("what", ["grads", "mu", "nu"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_and_moment_blocks_match_the_reference(name, what, runs):
    """Each rank's block of every leaf: `step_grads`' gradient (the
    reference's `value_and_grad` under its policy; with microbatches the
    average of its gradients over the global microbatches, as its train
    step accumulates them) and the step's moments, within 1e-4 of the
    whole leaf's max."""
    for got, want, whole, path in _held(name, what, runs):
        tol = GRAD_REL * max(float(np.abs(whole).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max())
        assert err <= tol, f"{name} {what} {path}: {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_updated_param_blocks_match_the_reference(name, runs):
    ref, meta, ranks, _ = runs
    lr = float(ref[f"{name}/step/lr"])
    grads = {}
    for rank in ranks:
        for path in rank[name]["params"]:
            g = np.abs(_cut(ref[f"{name}/grads/{path}"], name, path, rank, meta))
            gmax = np.abs(ref[f"{name}/grads/{path}"]).max()
            grads[(rank["coords"], path)] = g > GRAD_REL * gmax
    for rank in ranks:
        for path, got in rank[name]["params"].items():
            whole = ref[f"{name}/params/{path}"]
            err = np.abs(got - _cut(whole, name, path, rank, meta))
            big = grads[(rank["coords"], path)]
            assert err[big].max(initial=0.0) <= PARAM_TOL, f"{name} {path}: {err[big].max()}"
            assert err[~big].max(initial=0.0) <= 2 * lr, f"{name} {path}: {err[~big].max()}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_only_its_blocks(name, runs):
    """Params and both moments, before and after the step: the blocks the
    reference's fitted specs give the rank's coordinate (the starting ones
    bit for bit), their bytes the whole model's split leaves' 1/4, 1/2 or
    all of them; under fsdp=True over a ``data`` axis no leaf but the norm
    scales and the biases is whole on a rank."""
    _, meta, ranks, cases = runs
    whole = cases[name]["params"]
    fsdp = CASES[name].fsdp and _grid(name)["data"] > 1
    for rank in ranks:
        res = rank[name]
        want_bytes = 0
        for path, leaf in whole.items():
            want = _cut(leaf, name, path, rank, meta)
            np.testing.assert_array_equal(res["start"][path], want, err_msg=path)
            for what in ("params", "mu", "nu"):
                assert res[what][path].shape == want.shape, (what, path)
            want_bytes += want.nbytes
        for what in ("start", "params", "mu", "nu"):
            assert sum(v.nbytes for v in res[what].values()) == want_bytes
        if fsdp:
            assert all(res["start"][p].shape != whole[p].shape for p in whole
                       if not p.endswith(("scale", "bq", "bk", "bv")))
    share = 0.3 if fsdp else 0.55          # ~1/4 with FSDP, ~1/2 (or 1/4 and whole K/V) without
    assert want_bytes < share * sum(v.nbytes for v in whole.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_holding_one_block_hold_it_bit_for_bit(name, runs):
    """After the step, a leaf replicated over an axis (the norm scales
    everywhere, the biases over ``data``, everything over ``data`` without
    FSDP) is the same bits on every rank that holds its block."""
    _, meta, ranks, _ = runs
    shared = 0
    for what in ("params", "mu", "nu", "grads"):
        for path, spec in meta["specs"][name].items():
            held: dict = {}
            for rank in ranks:
                split = {a for e in spec if e for a in ([e] if isinstance(e, str) else e)}
                key = tuple(c for a, c in rank[name]["at"].items() if a in split)
                held.setdefault(key, []).append(rank[name][what][path])
            for blocks in held.values():
                for b in blocks[1:]:
                    np.testing.assert_array_equal(b, blocks[0], err_msg=f"{what} {path}")
                    shared += 1
    assert shared


def _ring(p: int) -> tuple:
    """(all-reduce, all-gather) puts of the ring over p ranks: p - 1
    reduce-scatter puts, then 2 x ceil((p - 1) / 2) all-gather puts (both
    directions a step); none over one rank."""
    ag = 2 * -(-(p - 1) // 2)
    return (p - 1 + ag if p > 1 else 0), ag


def _puts(name: str) -> dict:
    """The puts of `step_grads` and of the train step a rank, from the
    schedule (`_ring`; at tp = dp = 2 a ring all-reduce is 1 reduce-scatter
    put and 2 all-gather puts, the vocabulary all-gather 2), an FSDP gather
    over two ``data`` ranks 1 (one direction) and its reduce-scatter 1.
    Forward: the embedding's gather and all-reduce, 2 all-reduces and the
    FSDP leaves' gathers a layer, the LM head's gather and its vocabulary
    gather.  The remat recomputation stops at the layer's last saved
    tensor, so it gathers again and runs the attention's all-reduce, not
    the MLP's (an MoE layer's all-reduce likewise).  Backward: 2 entry
    all-reduces a layer (plus one a whole K/V leaf of the mixed fit; an
    MoE layer's entry carries its experts' input and its gates together,
    a shared expert enters its input once more), the LM head's entry, a
    reduce-scatter a gathered leaf.  An MoE layer gathers its router and
    its experts' (and shared expert's) three leaves; where a rank's rows
    are a data share the forward sums the layers' expert counts in one
    all-reduce over ``data`` a microbatch.  Then one all-reduce over
    ``data`` a step (none without a ``data`` axis); the train step adds
    the global norm's all-reduce over the 4 ranks."""
    cfg = _cfg(name)
    c = CASES[name]
    dp = c.axes.get("data", 1)
    ar, vocab = _ring(c.axes["model"])
    fg = rs = int(c.fsdp and dp > 1)
    mlp = ["w_in", "w_out"] + (["w_gate"] if cfg.mlp_type == "swiglu" else [])
    names = ["wq", "wk", "wv", "wo"] + mlp
    entries, counts = 2, 0
    if cfg.family == "moe":
        names += ["router"] + mlp * bool(cfg.moe_shared_ff)
        entries += bool(cfg.moe_shared_ff)
        counts = _ring(dp)[0]
    kv_whole = cfg.n_kv_heads % c.axes["model"] != 0
    kv_leaves = 4 if cfg.qkv_bias else 2
    heads = len(names)                   # every one of them split over data (D % 2 == 0)
    layer = (heads * fg + 2 * ar) + (heads * fg + ar) + (entries * ar + kv_leaves * ar *
                                                        kv_whole + heads * rs)
    tok = 2 * fg + ar + vocab + ar + 2 * rs          # embedding, LM head (tied: one leaf)
    grads = c.n * (tok + cfg.n_layers * layer + counts) + _ring(dp)[0]
    return {"grads": grads, "step": grads + _ring(NP)[0]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_the_one_sided_ring(name, runs):
    """Every rank issues exactly the schedule's puts (`_puts`), and no
    torch.distributed collective ran (`_refusing`)."""
    _, _, ranks, _ = runs
    want = _puts(name)
    for rank in ranks:
        assert rank[name]["puts_grads"] == want["grads"], (rank[name]["puts_grads"], want)
        assert rank[name]["puts_step"] == want["step"], (rank[name]["puts_step"], want)


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_aux_and_z_match_the_reference(name, runs):
    """`step_grads`' and the train step's aux and z losses on every rank:
    the global batch's (each rank's terms use the batch's expert counts,
    `models.moe.global_aux`; their mean over ``data`` is the batch's),
    within AUX_TOL of the reference's; real numbers, not zeros, with one
    microbatch, zeros with two, as the reference reports them."""
    ref, _, ranks, _ = runs
    want = {k: [float(ref[f"{name}/{k}"]), float(ref[f"{name}/step/{k}"])]
            for k in ("aux", "z")}
    for rank in ranks:
        for k in ("aux", "z"):
            got = rank[name][k]
            assert all(abs(a - b) <= AUX_TOL for a, b in zip(got, want[k])), (k, got, want[k])
            if CASES[name].n == 1:
                assert all(v > 0.1 for v in got), (k, got)
            else:
                assert got[1] == 0.0 and want[k][1] == 0.0, (k, got, want[k])


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_router_is_bit_equal_on_every_model_rank(name, runs):
    """The router is whole over ``model``: after the update its block (over
    ``data`` under FSDP), its gradient and both moments are the same bits
    on every model rank of a data coordinate, so that the next step routes
    alike on them."""
    _, _, ranks, _ = runs
    key = "blocks/moe/router"
    by_data: dict = {}
    for rank in ranks:
        by_data.setdefault(rank[name]["at"]["data"], []).append(rank[name])
    for group in by_data.values():
        assert len(group) == CASES[name].axes["model"]
        for what in ("params", "grads", "mu", "nu"):
            for res in group[1:]:
                np.testing.assert_array_equal(res[what][key], group[0][what][key],
                                              err_msg=what)
        assert not np.array_equal(group[0]["params"][key], group[0]["start"][key])


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_routing_is_equal_on_every_rank_of_a_data_coordinate(name, runs):
    """Every model rank of a data coordinate routes its tokens alike, in the
    forward and in the remat recomputation: the choices, slots and
    overflow flags of every dispatch are the same bits (F-slices of two
    experts would otherwise be summed silently); the recomputation routes
    as the forward did."""
    _, _, ranks, _ = runs
    cfg = _cfg(name)
    by_data: dict = {}
    for rank in ranks:
        by_data.setdefault(rank[name]["at"]["data"], []).append(rank[name]["routes"])
    for group in by_data.values():
        assert len(group[0]) == 2 * CASES[name].n * cfg.n_layers
        for routes in group[1:]:
            assert len(routes) == len(group[0])
            for a, b in zip(routes, group[0]):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        calls = group[0]
        for m in range(CASES[name].n):              # layer l's recomputation mirrors it
            mb = calls[2 * m * cfg.n_layers:2 * (m + 1) * cfg.n_layers]
            for fwd, again in zip(mb[:cfg.n_layers], mb[cfg.n_layers:][::-1]):
                for x, y in zip(fwd, again):
                    np.testing.assert_array_equal(x, y)


def test_moe_drops_case_drops_as_the_reference_does(runs):
    """The biased router overfills expert 0: the reference's drop fraction
    is > 0 in every layer, and the port's, from its ranks' overflow flags
    over the global batch (a data coordinate's model rank 0 each), equals
    it layer by layer."""
    _, meta, ranks, _ = runs
    name, cfg = "moe_drops", _cfg("moe_drops")
    want = meta["drops"][name][:cfg.n_layers]
    assert len(want) == cfg.n_layers and min(want) > 0, meta["drops"][name]
    lead = [r[name] for r in ranks if r[name]["at"]["model"] == 0]
    for layer, w in enumerate(want):
        oks = [res["routes"][layer][2] for res in lead]
        got = 1.0 - sum(int(o.sum()) for o in oks) / sum(o.size for o in oks)
        assert abs(got - w) <= 1e-6, (layer, got, w)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_policy_matches_the_reference(arch, shape, runs):
    """The port's `make_policy` gives the reference's options for the cell
    on each mesh shape, and keeps the mesh it was given."""
    _, meta, _, _ = runs
    cfg = get_config(arch)
    for m in POLICY_MESHES:
        mesh = procmesh.ProcMesh(m, 0, device="cpu")
        pol = make_policy(mesh, cfg, SHAPES[shape])
        want = meta["policies"][f"{arch}/{shape}/{json.dumps(m)}"]
        assert [pol.seq_parallel, pol.kv_seq_shard, pol.fsdp] == want, (m, want)
        assert pol.mesh is mesh


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_remat_recomputes_under_the_forwards_policy(arch):
    """A remat body recomputes in the backward, after `use_policy` closed:
    it must carry the forward's policy (here the MoE dispatch groups of a
    data axis of 4), so the grads equal remat off bit for bit."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = tree_map(lambda t: t.float(), model.init(0, device="cpu"))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
             for k in ("tokens", "labels")}
    pol = ShardingPolicy(Mesh({"data": 4}, device="cpu"))
    l0, _, g0 = loss_and_grads(model, params, batch, remat=False, policy=pol)
    l1, _, g1 = loss_and_grads(model, params, batch, remat=True, policy=pol)
    assert torch.equal(l0, l1)
    for (k, a), (_, b) in zip(flatten(g0), flatten(g1)):
        assert torch.equal(a, b), k


def test_embedding_gradient_sums_repeats_in_f32():
    """A bf16 table's gradient sums the repeats of an id in f32 and rounds
    once (the index backward alone adds them in bf16: a token repeated 769
    times in phase 34's batch left the embedding's gradient 10.5 % from its
    f32 witness on the card), whole and split over ``model`` alike."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(3)
    ids = torch.cat([torch.zeros(600, dtype=torch.long), torch.randint(0, 64, (424,),
                                                                     generator=g)])
    ids = ids[torch.randperm(ids.numel(), generator=g)].reshape(4, 256)
    ct = torch.randn(4, 256, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 8, generator=g).to(torch.bfloat16).requires_grad_(True)
    (got,) = torch.autograd.grad(L.embed({"embed": w}, ids), w, ct)
    want = torch.zeros(64, 8).index_put_((ids,), ct.float(), accumulate=True)
    assert torch.equal(got, want.to(torch.bfloat16))
    exact = torch.zeros(64, 8, dtype=torch.float64).index_put_((ids,), ct.double(),
                                                               accumulate=True)
    assert float((got.double() - exact).abs().max() / exact.abs().max()) <= 2 ** -8
    with torch.no_grad():                       # no gradient: the plain lookup
        assert torch.equal(L.embed({"embed": w}, ids), w[ids])


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
