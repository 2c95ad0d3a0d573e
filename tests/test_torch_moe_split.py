"""The MoE layer split over a `ProcMesh`'s ``model`` axis (tensor-parallel
experts: every rank holds every expert's block of F), against the JAX
reference's partitioned step under the same policy.

Four CPU processes are spawned once for the whole file (`procmesh.run`
with the grid ``{"data": 2, "model": 2}``, regridded to ``{"model": 4}``
where a case asks).  For each case every rank takes its blocks of the
same seeded f32 numpy params (`params_from_jax(..., policy=)`), makes its
cache with `Model.init_cache(B, MAX_SEQ)` under the policy (the global
batch) and runs `make_prefill_step` (given the global row count),
`Model.prefill` of the prompt and `STEPS` teacher-forced `make_serve_step`
steps on its rows, with `models.moe.route` tapped to keep each dispatch
group's choices, slots and overflow flags.  The cases (`CASES`):

  * ``qwen_tp2``: qwen3-moe SMOKE at tp = 2 over the grid
    (``fsdp=False``), one row a ``data`` coordinate;
  * ``moonshot_tp4``: moonshot SMOKE (a shared expert) over
    ``{"model": 4}`` under the reference's `make_policy`, every rank on the
    whole batch (its aux and z losses are then the batch's);
  * ``qwen_fsdp_b4``: qwen3-moe SMOKE over the grid under `make_policy`
    (FSDP over ``data``) at a global batch of 4: the reference forms G = 2
    groups, so a rank's 2 rows are one group, where the rank's own row
    count would make two (`models.moe._n_groups`); its router is biased
    as below, so that the groups' capacity drops other items;
  * ``qwen_drops``: qwen3-moe SMOKE at tp = 2 over the grid on a
    48-token prompt with the router biased toward expert 0, so that
    capacity drops items (the reference's drop fraction is > 0).

One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs the reference's jitted `forward_logits`, `prefill` and `decode_step`
under ``use_policy`` of its policy over a `jax.sharding.Mesh` (Auto axes:
`jax.make_mesh`'s Explicit axes make the reference's `shard_spec` raise in
`moe_ffn`), in f32, its cache placed by `launch.dryrun._cache_specs`; a
`jax.debug.callback` keeps each MoE layer's drop fraction, and it writes
the blocks its fitted specs place on each device.  Held to it: every
rank's logits (`TOL`), its MoE leaves (bit for bit the blocks at its
coordinate), each layer's drop fraction and, where a rank holds the whole
batch, the forward's aux and z losses.  Every rank of a ``data``
coordinate routes bit for bit alike.  The split step's collectives are
the one-sided ring's puts, exactly one all-reduce an MoE layer (an
`OpCounter` ledger of the exact count) with every `torch.distributed`
collective made to raise.  The dispatch group rule and the refusals run
in this process.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402
from repro_torch.ckpt.checkpoint import flatten  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.launch.dryrun import make_policy  # noqa: E402
from repro_torch.models import moe as X  # noqa: E402
from repro_torch.models.registry import build_model, params_from_jax  # noqa: E402
from repro_torch.parallel.sharding import ShardingPolicy, use_policy  # noqa: E402
from repro_torch.train.train_step import make_prefill_step, make_serve_step  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, GRID = 4, {"data": 2, "model": 2}
QWEN, MOON = "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    axes: dict              # the ranks' grid
    shape: str              # make_policy's cell ("" = ShardingPolicy(mesh, fsdp=False))
    batch: int              # the global batch
    prompt: int
    bias: bool = False      # the router biased toward expert 0


CASES = {
    "qwen_tp2": Case(QWEN, GRID, "", 2, 6),
    "moonshot_tp4": Case(MOON, {"model": 4}, "decode_32k", 2, 6),
    "qwen_fsdp_b4": Case(QWEN, GRID, "decode_32k", 4, 24, bias=True),
    "qwen_drops": Case(QWEN, GRID, "", 2, 48, bias=True),
}
STEPS, MAX_SEQ = 3, 64
# the MoE leaves (a layer) that FSDP gathers over ``data``: wq/wk/wv/wo,
# the router, the experts' three and the shared expert's three
FSDP_LEAVES = {QWEN: 8, MOON: 11}
TOL = 1e-4              # logits, f32: the split's sums against XLA's partitioned ones
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
CHILD_TIMEOUT = 240.0   # s: the JAX child
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single")


def _cfg(arch: str, get=get_config):
    return get(arch, smoke=True)


def _policy(mesh, name: str):
    c = CASES[name]
    if not c.shape:
        return ShardingPolicy(mesh, fsdp=False)
    return make_policy(mesh, _cfg(c.arch), SHAPES[c.shape])


def _np_params(name: str) -> dict:
    """Seeded f32 params: norm scales near 1, the rest at 1/sqrt(D).  With
    `bias` every embedding row gains the unit vector u and the router's
    expert 0 the column 2u, so that every token's router prefers it."""
    c = CASES[name]
    cfg = _cfg(c.arch)
    rng = np.random.default_rng(list(CASES).index(name))
    out = {}
    for path, leaf in flatten(build_model(cfg).init_shapes()):
        shape = tuple(leaf.shape)
        if path.endswith("scale"):
            out[path] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            out[path] = rng.standard_normal(shape) / np.sqrt(cfg.d_model)
        out[path] = out[path].astype(np.float32)
    if c.bias:
        u = np.full(cfg.d_model, cfg.d_model ** -0.5, np.float32)
        out["tok/embed"] += u
        out["blocks/moe/router"][..., 0] = 2 * u
    return out


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
    c = CASES[name]
    rng = np.random.default_rng(100 + list(CASES).index(name))
    v = _cfg(c.arch).vocab_size
    return {"tokens": rng.integers(0, v, (c.batch, c.prompt)).astype(np.int32),
            "steps": rng.integers(0, v, (STEPS, c.batch)).astype(np.int32)}


def _f32(cache: dict) -> dict:
    """The cache with its bf16 leaves in f32 (its other entries as they
    are), so that no rounding of a cache entry can differ."""
    return {k: (_f32(v) if isinstance(v, dict) else
                v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v)
            for k, v in cache.items()}


def _refusing(fn):
    """fn() with every torch.distributed collective raising while it runs."""
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


class _Routes:
    """`models.moe.route` tapped: each call's dispatch groups' expert
    choices, slots and overflow flags, in the order the layers route."""

    def __init__(self):
        self.real, self.got = X.route, []

    def __enter__(self):
        def route(*a, **kw):
            r = self.real(*a, **kw)
            self.got.append({"idx": r.expert_idx.numpy(), "slot": r.slot.numpy(),
                             "ok": r.ok.numpy()})
            return r

        X.route = route
        return self

    def __exit__(self, *exc):
        X.route = self.real

    def take(self) -> list:
        got, self.got = self.got, []
        return got


# ================================================================ the ranks
def _serve(model, params, toks, steps, batch: int, policy) -> dict:
    """make_prefill_step's logits (given the global row count),
    Model.prefill's last ones from an empty cache of the global batch made
    under `policy`, then the teacher-forced make_serve_step logits; each
    call's ledger and routing."""
    ledger, routes = [], []
    pre = make_prefill_step(model, policy)
    with use_policy(policy):
        cache = _f32(model.init_cache(batch, MAX_SEQ, device="cpu"))
    serve = make_serve_step(model, policy)

    def counted(fn):
        with OpCounter() as c:
            out = _refusing(fn)
        ledger.append((c.puts, c.colls))
        routes.append(tap.take())
        return out

    with _Routes() as tap:
        full = counted(lambda: pre(params, {"tokens": toks}, rows=batch))
        with torch.no_grad(), use_policy(policy):
            last, cache = counted(lambda: model.prefill(params, toks, cache))
        out = []
        for tok in steps:
            logits, cache = counted(lambda: serve(params, tok, cache))
            out.append(logits)
    with torch.no_grad(), use_policy(policy):
        met = model.forward_logits(params, {"tokens": toks}, rows=batch)
    return {"forward": full, "prefill": last, "steps": torch.stack(out), "ledger": ledger,
            "routes": routes, "rows_cached": cache["rows"],
            "aux": None if met.aux_loss is None else float(met.aux_loss),
            "z": None if met.z_loss is None else float(met.z_loss)}


def _rank_main(mesh, cases: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coords": mesh.coords}
    for name, (params_np, ins) in cases.items():
        c = CASES[name]
        m = mesh if c.axes == GRID else mesh.regrid(c.axes)
        pol = _policy(m, name)
        at = dict(zip(c.axes, m.coords))
        k = c.batch // c.axes.get("data", 1)
        rows = slice(at.get("data", 0) * k, at.get("data", 0) * k + k)
        params = params_from_jax(_tree(params_np), "cpu", torch.float32, policy=pol)
        model = build_model(_cfg(c.arch))
        toks = torch.from_numpy(ins["tokens"][rows])
        steps = torch.from_numpy(ins["steps"][:, rows])
        res = _serve(model, params, toks, steps, c.batch, pol)
        moe = {path: v.numpy() for path, v in flatten(params["blocks"]["moe"])}
        out[name] = {"at": at, "rows": [rows.start, rows.stop], **res,
                     "forward": res["forward"].numpy(), "prefill": res["prefill"].numpy(),
                     "steps": res["steps"].numpy(), "moe": moe}
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    devices = jax.devices()[:NP]         # the backend starts with 4 devices, before
    from repro.configs import SHAPES as JSHAPES  # noqa: E402  repro.launch.dryrun sets
    from repro.configs import get_config as jget  # its own XLA_FLAGS on import
    from repro.launch import dryrun as jdry
    from repro.models import moe as jmoe
    from repro.models.registry import build_model as jbuild
    from repro.parallel import sharding as jsh

    drops: list = []
    real = jmoe.moe_ffn

    def tapped(*a, **kw):
        y, met = real(*a, **kw)
        jax.debug.callback(lambda v: drops.append(float(v)), met.drop_fraction)
        return y, met

    jmoe.moe_ffn = tapped

    def taken() -> list:
        jax.effects_barrier()
        got = list(drops)
        drops.clear()
        return got

    out, meta = {}, {}
    for name, c in CASES.items():
        cfg = _cfg(c.arch, jget)
        model = jbuild(cfg)
        mesh = jax.sharding.Mesh(np.asarray(devices).reshape(tuple(c.axes.values())),
                                 tuple(c.axes))
        pol = (jsh.ShardingPolicy(mesh, fsdp=False) if not c.shape
               else jdry.make_policy(mesh, cfg, JSHAPES[c.shape]))
        params = jax.tree.map(jnp.asarray, _tree(dict(np.load(d / f"{name}_params.npz"))))
        ins = dict(np.load(d / f"{name}_in.npz"))
        toks = jnp.asarray(ins["tokens"])

        # the blocks the fitted specs place on each device, by grid coordinate
        specs = pol.tree_specs(params)
        blocks = {}
        for key in ("router", "experts/w_in", "experts/w_gate", "experts/w_out",
                    "shared/w_in", "shared/w_gate", "shared/w_out"):
            *parents, leaf = key.split("/")
            node, spec = params["blocks"]["moe"], specs["blocks"]["moe"]
            for p in parents:
                if p not in node:
                    break
                node, spec = node[p], spec[p]
            else:
                # an axis the mesh lacks is one rank: the same blocks without it
                fitted = jax.sharding.PartitionSpec(*(
                    (lambda axes: None if not axes else axes[0] if len(axes) == 1 else axes)(
                        tuple(a for a in (e if isinstance(e, tuple) else (e,))
                              if a in mesh.shape)) for e in spec[leaf]))
                arr = jax.device_put(node[leaf], NamedSharding(mesh, fitted))
                blocks[key] = {json.dumps([int(i) for i in
                                           np.argwhere(mesh.devices == sh.device)[0]]):
                               [[s.start or 0, n if s.stop is None else s.stop]
                                for s, n in zip(sh.index, arr.shape)]
                               for sh in arr.addressable_shards}
                meta[f"{name}/spec/{key}"] = [list(e) if isinstance(e, tuple) else e
                                              for e in spec[leaf]]
        meta[f"{name}/blocks"] = blocks

        def under(fn, pol=pol):
            def run(*a):
                with jsh.use_policy(pol):
                    return fn(*a)
            return jax.jit(run)

        cache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                             model.init_cache(c.batch, MAX_SEQ))
        cspecs = jax.tree.map(lambda a, s: jsh.fit_spec(s, a.shape, mesh), cache,
                              jdry._cache_specs(cache, pol, cfg))
        cache = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), cache,
                             cspecs)
        with mesh:
            fwd = under(lambda p, t: model.forward_logits(p, {"tokens": t}))(params, toks)
            out[f"{name}/forward"] = np.asarray(fwd.logits)
            out[f"{name}/aux"] = np.asarray(fwd.aux_loss)
            out[f"{name}/z"] = np.asarray(fwd.z_loss)
            meta[f"{name}/drops"] = [taken()]
            last, cache = under(model.prefill)(params, toks, cache)
            out[f"{name}/prefill"] = np.asarray(last)
            meta[f"{name}/drops"].append(taken())
            dec, steps = under(model.decode_step), []
            for tok in ins["steps"]:
                logits, cache = dec(params, jnp.asarray(tok), cache)
                steps.append(np.asarray(logits))
                meta[f"{name}/drops"].append(taken())
        out[f"{name}/steps"] = np.stack(steps)
    np.savez(d / "out.npz", **out)
    (d / "meta.json").write_text(json.dumps(meta))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, its drops and placements, every rank's
    results, the inputs by case): the JAX child and the four ranks run
    side by side."""
    d = tmp_path_factory.mktemp("moe_split")
    cases = {}
    for name in CASES:
        cases[name] = (_np_params(name), _inputs(name))
        np.savez(d / f"{name}_params.npz", **cases[name][0])
        np.savez(d / f"{name}_in.npz", **cases[name][1])
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
    return dict(np.load(d / "out.npz")), json.loads((d / "meta.json").read_text()), ranks, \
        cases


def _rows(rank: dict, name: str) -> slice:
    return slice(*rank[name]["rows"])


def _data(rank: dict, name: str) -> int:
    return rank[name]["at"].get("data", 0)


# ================================================================ tests
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("what", ["forward", "prefill", "steps"])
def test_split_moe_matches_the_reference_under_its_policy(name, what, runs):
    ref, _, ranks, _ = runs
    want = ref[f"{name}/{what}"]
    for rank in ranks:
        got = rank[name][what]
        sel = want[:, _rows(rank, name)] if what == "steps" else want[_rows(rank, name)]
        assert got.shape == sel.shape, (got.shape, sel.shape)
        assert np.isfinite(got).all()
        err = float(np.abs(got - sel).max())
        assert err <= TOL, f"{name} {what} rank {rank['coords']}: {err:.3g} > {TOL}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_of_a_data_coordinate_routes_alike(name, runs):
    """The model ranks of one data coordinate route the same tokens: their
    choices, slots and overflow flags are bit-equal in every dispatch
    group of every layer of every call (the F-slices summed over them
    would otherwise mix two experts silently).  A rank's rows form the
    reference's groups: one group a layer where the reference's G equals
    the data ranks."""
    _, _, ranks, _ = runs
    first = {}
    c = CASES[name]
    for rank in ranks:
        routes = rank[name]["routes"]
        assert len(routes) == 2 + STEPS
        for call in routes:
            assert len(call) == _cfg(c.arch).n_layers * _local_groups(name)
        ref = first.setdefault(_data(rank, name), routes)
        for got, want in zip(routes, ref):
            for g, w in zip(got, want):
                for k in ("idx", "slot", "ok"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")


def _local_groups(name: str) -> int:
    """A rank's dispatch groups a layer: the reference's G over the global
    batch (the data ranks, halved until G divides it) over the data ranks
    that split the rows (all of them where they divide the batch)."""
    c = CASES[name]
    dp = c.axes.get("data", 1)
    g = dp
    while g > 1 and c.batch % g:
        g //= 2
    return g // (dp if c.batch % dp == 0 else 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_drop_fractions_equal_the_references(name, runs):
    """Each MoE layer's drop fraction of each call, over the whole batch
    (every data coordinate's groups), equals the reference's; the
    drops case drops items."""
    _, meta, ranks, _ = runs
    c = CASES[name]
    n_layers = _cfg(c.arch).n_layers
    by_data = {_data(r, name): r[name]["routes"] for r in ranks}
    want = meta[f"{name}/drops"]
    assert len(want) == 2 + STEPS
    for i, ref_call in enumerate(want):
        assert len(ref_call) == n_layers
        got = []
        for layer in range(n_layers):
            n = k = 0
            for routes in by_data.values():
                per = len(routes[i]) // n_layers
                for grp in routes[i][layer * per:(layer + 1) * per]:
                    n, k = n + grp["ok"].size, k + int((~grp["ok"]).sum())
            got.append(k / n)
        np.testing.assert_allclose(sorted(got), sorted(ref_call), rtol=0, atol=1e-6,
                                   err_msg=f"{name} call {i}")
    if c.bias:
        assert max(want[0]) > 0 and max(want[1]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_ranks_moe_leaves_are_the_references_blocks(name, runs):
    """Every rank's router, experts and shared expert are, bit for bit, the
    blocks the reference's fitted specs place at its grid coordinate: each
    expert's F over ``model`` (the ``experts/`` rules are shadowed by the
    dense ``w_in`` / ``w_out`` ones), D over ``data`` under FSDP."""
    _, meta, ranks, cases = runs
    flat = cases[name][0]
    c = CASES[name]
    blocks = meta[f"{name}/blocks"]
    assert ("shared/w_in" in blocks) == (c.arch == MOON)
    for key in ("experts/w_in", "experts/w_out"):
        spec = meta[f"{name}/spec/{key}"]
        assert spec[3 if key.endswith("w_in") else 2] == "model", (key, spec)
    for rank in ranks:
        coord = json.dumps([rank[name]["at"][a] for a in c.axes])
        for key, by_coord in blocks.items():
            idx = tuple(slice(a, b) for a, b in by_coord[coord])
            np.testing.assert_array_equal(rank[name]["moe"][key],
                                          flat[f"blocks/moe/{key}"][idx], err_msg=key)


def test_aux_and_z_are_the_batchs_or_none(runs):
    """A rank that holds the whole batch returns the forward's aux and z
    losses equal to the reference's; a rank whose rows are a data share
    returns None for both, never its share."""
    ref, _, ranks, _ = runs
    for rank in ranks:
        for name, c in CASES.items():
            res = rank[name]
            if c.batch % c.axes.get("data", 1) == 0 and c.axes.get("data", 1) > 1:
                assert res["aux"] is None and res["z"] is None, name
                continue
            assert abs(res["aux"] - float(ref[f"{name}/aux"])) <= 1e-5, name
            assert abs(res["z"] - float(ref[f"{name}/z"])) <= 1e-4, name
        assert all(rank[n]["rows_cached"] == c.batch for n, c in CASES.items())


def _ledger(name: str) -> list:
    """(puts, colls) of each call: the forward, the prefill, each decode
    step, all alike (a head-split cache).  A ring all-reduce over tp is
    tp - 1 reduce-scatter puts and 2 x ceil((tp - 1) / 2) all-gather puts,
    an all-gather the latter, an FSDP gather over ``data`` = 2 one put.  A
    call: the embedding's all-reduce, the attention's and the MoE layer's
    (ONE for the experts and the shared expert) a layer, the vocabulary's
    all-gather, and under FSDP `FSDP_LEAVES` a layer and ``tok``'s 2."""
    c = CASES[name]
    cfg = _cfg(c.arch)
    tp = c.axes["model"]
    ag = 2 * -(-(tp - 1) // 2)
    ar = tp - 1 + ag
    fsdp = int(bool(c.shape) and c.axes.get("data", 1) > 1)
    call = 2 * fsdp + ar + cfg.n_layers * (FSDP_LEAVES[c.arch] * fsdp + 2 * ar) + ag
    return [(call, 0)] * (2 + STEPS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_one_all_reduce_a_moe_layer(name, runs):
    """Every rank issues exactly the schedule's puts (`_ledger`), and no
    torch.distributed collective ran (`_refusing`)."""
    _, _, ranks, _ = runs
    want = _ledger(name)
    for rank in ranks:
        assert [tuple(x) for x in rank[name]["ledger"]] == want, (rank[name]["ledger"], want)


# ====================================================== in this process
def _grid_policy(axes: dict, **kw):
    return ShardingPolicy(procmesh.ProcMesh(axes, 0, device="cpu"), **kw)


def test_dispatch_groups_are_the_references_over_the_global_batch():
    """Rows split over ``data``: a rank's rows are G / (data ranks) of the
    reference's groups (global B = 4 over 2: one group of 2 rows, where
    the rank's own 2 rows would make 2); rows whole on every rank (B = 3:
    2 does not divide it) take the rule of one card; no data axis needs no
    row count; a mismatched count, a missing one and a group spanning data
    blocks are refused."""
    grid = _grid_policy(GRID, fsdp=False)
    with use_policy(grid):
        assert X._n_groups(2) == 2
    assert X.dispatch_groups(grid, 2, 4) == (1, True)
    assert X.dispatch_groups(grid, 1, 2) == (1, True)
    assert X.dispatch_groups(grid, 4, 8) == (1, True)
    assert X.dispatch_groups(grid, 3, 3) == (1, False)
    assert X.dispatch_groups(grid, 3, 6) == (1, True)
    four = _grid_policy({"model": 4})
    assert X.dispatch_groups(four, 2, None) == (1, False)
    pod = _grid_policy({"pod": 2, "data": 2, "model": 2})
    assert X.dispatch_groups(pod, 2, 8) == (1, True)
    assert X.dispatch_groups(pod, 3, 6) == (1, True)        # G = 2 over pod alone
    with pytest.raises(ValueError, match="global row count"):
        X.dispatch_groups(grid, 2, None)
    with pytest.raises(ValueError, match="data blocks"):
        X.dispatch_groups(grid, 1, 4)
    odd = _grid_policy({"pod": 2, "data": 3, "model": 2})
    with pytest.raises(NotImplementedError, match="spans"):
        X.dispatch_groups(odd, 2, 4)                        # G = 1 over 2 pod blocks


def test_an_moe_layer_refuses_what_it_cannot_tell():
    """Under a split with data axes an MoE layer given no global row count
    raises rather than guess its groups; whole experts where blocks are
    due raise; a train step of an MoE model over a split is built (12c.4b),
    of a hybrid one refused (12c.5b)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = _cfg(QWEN)
    model = build_model(cfg)
    pol = _grid_policy(GRID, fsdp=False)
    params = params_from_jax(_tree(_np_params("qwen_tp2")), "cpu", torch.float32, policy=pol)
    moe = {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()})
           for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(1, 3, cfg.d_model)
    with use_policy(pol), pytest.raises(ValueError, match="global row count"):
        X.moe_ffn(moe, x, cfg.moe_top_k, d_ff=cfg.moe_d_ff)
    whole = params_from_jax(_tree(_np_params("qwen_tp2")), "cpu", torch.float32)
    wm = {k: (v[0] if isinstance(v, torch.Tensor) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in whole["blocks"]["moe"].items()}
    with use_policy(pol), pytest.raises(ValueError, match="blocks"):
        X.moe_ffn(wm, x, cfg.moe_top_k, d_ff=cfg.moe_d_ff, rows=2)
    assert callable(make_train_step(model, AdamWConfig(), policy=pol))
    with pytest.raises(NotImplementedError, match=r"12c\.5"):
        make_train_step(build_model(get_config("jamba-v0.1-52b", smoke=True)), AdamWConfig(),
                        policy=pol)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
