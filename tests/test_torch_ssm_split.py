"""The Mamba and xLSTM channel splits over a `ProcMesh`'s ``model`` axis
(the hybrid and ssm families served split), against the JAX reference's
partitioned step under the same policy.

Four CPU processes are spawned once for the whole file (`procmesh.run`
with the grid ``{"data": 2, "model": 2}``, regridded to ``{"model": 4}``
where a case asks).  For each case every rank takes its blocks of the
same seeded f32 numpy params (`params_from_jax(..., policy=)` under the
reference's `make_policy`), makes its cache with `Model.init_cache(B,
MAX_SEQ)` under the policy (the global batch; the recurrent state is the
rank's block) and runs `make_prefill_step` (given the global row count),
`Model.prefill` of the prompt in two chunks (the second seeded by the
state the first left) and `STEPS` teacher-forced `make_serve_step` steps
on its rows.  The cases (`CASES`) mirror the fits of the full-width
configs:

  * ``jamba_tp4``: Jamba SMOKE with 4 KV heads (the cache split by heads,
    as at full width) over ``{"model": 4}``: ``in_proj``'s column blocks
    are x[0:64], x[64:128], z[0:64], z[64:128] where the channels are
    [32 r, 32 r + 32), ``dt_proj`` is split on its rank R and ``A_log`` on
    N, as jamba-v0.1-52b's at tp = 4;
  * ``jamba_grid``: Jamba SMOKE over the grid (FSDP over ``data``): model
    rank 0 holds all of x, rank 1 all of z;
  * ``xlstm_tp4`` and ``xlstm_grid``: xLSTM SMOKE with 4 heads and d_model
    68, so that the sLSTM FFN's dff = 90 is 2 mod 4: at tp = 4 ``w_in``'s
    column blocks straddle gate ‖ up and ``w_out`` stays whole, at tp = 2
    model rank 0 holds the gate and rank 1 the up, ``w_out``'s rows split,
    as xlstm-1.3b's dff = 2730 fits.  Prompts stay within one mLSTM chunk
    of 64 (the reference reorders chunks beyond it, ROADMAP §3).

One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs the reference's jitted `forward_logits`, `prefill` and `decode_step`
under ``use_policy`` of its policy over a `jax.sharding.Mesh`, in f32, its
cache placed by `launch.dryrun._cache_specs` (fitted), and writes the
blocks its fitted specs place on each device of every recurrent layer's
leaf and of the final cache's state.  Held to it: every rank's logits
(`TOL`), its recurrent leaves (bit for bit the blocks at its coordinate)
and its state (the block at its coordinate, `STATE_TOL`).  The split
step's collectives are the one-sided ring's puts and all-to-alls, exactly
the schedule (`_ledger`), with every `torch.distributed` collective made
to raise.
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
from repro_torch.models.registry import build_model, params_from_jax  # noqa: E402
from repro_torch.parallel.sharding import use_policy  # noqa: E402
from repro_torch.train.train_step import make_prefill_step, make_serve_step  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, GRID = 4, {"data": 2, "model": 2}
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    axes: dict              # the ranks' grid
    prompt: int             # prefilled in two chunks of prompt / 2
    widths: tuple = ()      # the SMOKE config's fields replaced


CASES = {
    "jamba_tp4": Case(JAMBA, {"model": 4}, 12, (("n_kv_heads", 4),)),
    "jamba_grid": Case(JAMBA, GRID, 12),
    "xlstm_tp4": Case(XLSTM, {"model": 4}, 24, (("n_heads", 4), ("d_model", 68))),
    "xlstm_grid": Case(XLSTM, GRID, 24, (("n_heads", 4), ("d_model", 68))),
}
BATCH, STEPS, MAX_SEQ = 2, 3, 32
STATES = {JAMBA: ("mamba",), XLSTM: ("mlstm", "slstm")}
# logits and a state block (relative to max(1, its max |value|)), f32, against
# the reference: the split's sums against XLA's partitioned ones.  Random-weight
# xLSTM carries f32 rounding from layer to layer: the port's own unsplit f32 run
# is 1.2e-4-2.4e-4 from the reference's on these inputs (and the reference's 6e-5
# from the port's f64 run), so the xLSTM cases are held at `tests/test_torch_xlstm.py`'s
# 1e-3, and to the port's whole run in f64 within F64_REL of the max |logit|
TOL = {JAMBA: 1e-4, XLSTM: 1e-3}
F64_REL = 1e-10
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
CHILD_TIMEOUT = 240.0   # s: the JAX child
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single")


def _cfg(name: str, get=get_config):
    c = CASES[name]
    return dataclasses.replace(get(c.arch, smoke=True), **dict(c.widths))


def _policy(mesh, name: str):
    return make_policy(mesh, _cfg(name), SHAPES["decode_32k"])


def _np_params(name: str) -> dict:
    """Seeded f32 params: norm scales (and the mLSTM's ``ln``) near 1, the
    rest at 1/sqrt(D)."""
    cfg = _cfg(name)
    rng = np.random.default_rng(list(CASES).index(name))
    out = {}
    for path, leaf in flatten(build_model(cfg).init_shapes()):
        shape = tuple(leaf.shape)
        if path.endswith(("scale", "/ln")):
            out[path] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            out[path] = rng.standard_normal(shape) / np.sqrt(cfg.d_model)
        out[path] = out[path].astype(np.float32)
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
    v = _cfg(name).vocab_size
    return {"tokens": rng.integers(0, v, (BATCH, c.prompt)).astype(np.int32),
            "steps": rng.integers(0, v, (STEPS, BATCH)).astype(np.int32)}


def _as(cache: dict, dtype) -> dict:
    """The cache with its floating leaves in `dtype` (its other entries as
    they are): f32 casts the bf16 leaves, so that no rounding of a cache
    entry can differ; f64 every state leaf."""
    return {k: (_as(v, dtype) if isinstance(v, dict) else
                v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
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


# ================================================================ the ranks
def _serve(model, params, toks, steps, policy, dtype=torch.float32) -> dict:
    """make_prefill_step's logits (given the global row count), the last
    logits of each of Model.prefill's two chunks from an empty cache of the
    global batch made under `policy` (None: whole), then the teacher-forced
    make_serve_step logits; each call's ledger; the final cache."""
    ledger = []
    pre = make_prefill_step(model, policy)
    with use_policy(policy):
        cache = _as(model.init_cache(BATCH, MAX_SEQ, device="cpu"), dtype)
    serve = make_serve_step(model, policy)

    def counted(fn):
        with OpCounter() as c:
            out = _refusing(fn)
        ledger.append((c.puts, c.colls))
        return out

    full = counted(lambda: pre(params, {"tokens": toks}, rows=BATCH if policy else None))
    half = toks.shape[1] // 2
    chunks = []
    for part in (toks[:, :half], toks[:, half:]):
        with torch.no_grad(), use_policy(policy):
            last, cache = counted(lambda: model.prefill(params, part, cache))
        chunks.append(last)
    out = []
    for tok in steps:
        logits, cache = counted(lambda: serve(params, tok, cache))
        out.append(logits)
    return {"forward": full, "prefill": torch.stack(chunks), "steps": torch.stack(out),
            "ledger": ledger, "cache": cache}


def _f64(params: dict) -> dict:
    return {k: _f64(v) if isinstance(v, dict) else v.double() for k, v in params.items()}


def _rank_main(mesh, cases: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coords": mesh.coords}
    for name, (params_np, ins) in cases.items():
        c = CASES[name]
        m = mesh if c.axes == GRID else mesh.regrid(c.axes)
        pol = _policy(m, name)
        at = dict(zip(c.axes, m.coords))
        k = BATCH // c.axes.get("data", 1)
        rows = slice(at.get("data", 0) * k, at.get("data", 0) * k + k)
        params = params_from_jax(_tree(params_np), "cpu", torch.float32, policy=pol)
        model = build_model(_cfg(name))
        toks = torch.from_numpy(ins["tokens"][rows])
        steps = torch.from_numpy(ins["steps"][:, rows])
        res = _serve(model, params, toks, steps, pol)
        cache = res.pop("cache")
        f64 = {}
        if c.arch == XLSTM:
            wide = _serve(model, _f64(params), toks, steps, pol, torch.float64)
            f64 = {w: wide[w].numpy() for w in ("forward", "prefill", "steps")}
        out[name] = {"at": at, "rows": [rows.start, rows.stop], "f64": f64,
                     **{w: res[w].numpy() for w in ("forward", "prefill", "steps")},
                     "ledger": res["ledger"],
                     "leaves": {p: v.numpy() for p, v in flatten(params["periods"])},
                     "state": {f"{kind}/{k}": v.numpy() for kind in STATES[c.arch]
                               for k, v in cache[kind].items()}}
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    devices = jax.devices()[:NP]         # the backend starts with 4 devices, before
    from repro.configs import SHAPES as JSHAPES  # noqa: E402  repro.launch.dryrun sets
    from repro.configs import get_config as jget  # its own XLA_FLAGS on import
    from repro.launch import dryrun as jdry
    from repro.models.registry import build_model as jbuild
    from repro.parallel import sharding as jsh

    def coord_of(mesh, device) -> str:
        return json.dumps([int(i) for i in np.argwhere(mesh.devices == device)[0]])

    def placed(arr) -> dict:
        """{grid coordinate: [[start, stop] a dim]} of a placed array."""
        return {coord_of(arr.sharding.mesh, sh.device):
                [[s.start or 0, n if s.stop is None else s.stop]
                 for s, n in zip(sh.index, arr.shape)]
                for sh in arr.addressable_shards}

    def fitted(spec, mesh):
        # an axis the mesh lacks is one rank: the same blocks without it
        def entry(e):
            axes = tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a in mesh.shape)
            return None if not axes else axes[0] if len(axes) == 1 else axes
        return PartitionSpec(*(entry(e) for e in spec))

    out, meta = {}, {}
    for name, c in CASES.items():
        cfg = _cfg(name, jget)
        model = jbuild(cfg)
        mesh = jax.sharding.Mesh(np.asarray(devices).reshape(tuple(c.axes.values())),
                                 tuple(c.axes))
        pol = jdry.make_policy(mesh, cfg, JSHAPES["decode_32k"])
        params = jax.tree.map(jnp.asarray, _tree(dict(np.load(d / f"{name}_params.npz"))))
        ins = dict(np.load(d / f"{name}_in.npz"))
        toks = jnp.asarray(ins["tokens"])

        # the blocks the fitted specs place on each device, by grid coordinate
        flat, _ = jax.tree_util.tree_flatten_with_path(params["periods"])
        specs = jax.tree_util.tree_leaves(pol.tree_specs({"periods": params["periods"]}),
                                          is_leaf=lambda s: isinstance(s, PartitionSpec))
        meta[f"{name}/blocks"] = {
            "/".join(str(k.key) for k in path):
                placed(jax.device_put(leaf, NamedSharding(mesh, fitted(spec, mesh))))
            for (path, leaf), spec in zip(flat, specs)}

        def under(fn, pol=pol):
            def run(*a):
                with jsh.use_policy(pol):
                    return fn(*a)
            return jax.jit(run)

        cache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                             model.init_cache(BATCH, MAX_SEQ))
        cspecs = jax.tree.map(lambda a, s: jsh.fit_spec(s, a.shape, mesh), cache,
                              jdry._cache_specs(cache, pol, cfg))
        cache = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), cache,
                             cspecs)
        half = c.prompt // 2
        with mesh:
            out[f"{name}/forward"] = np.asarray(
                under(lambda p, t: model.forward_logits(p, {"tokens": t}).logits)(params, toks))
            prefill, chunks = under(model.prefill), []
            for part in (toks[:, :half], toks[:, half:]):
                last, cache = prefill(params, part, cache)
                chunks.append(np.asarray(last))
            out[f"{name}/prefill"] = np.stack(chunks)
            dec, steps = under(model.decode_step), []
            for tok in ins["steps"]:
                logits, cache = dec(params, jnp.asarray(tok), cache)
                steps.append(np.asarray(logits))
        out[f"{name}/steps"] = np.stack(steps)
        meta[f"{name}/state"] = {}
        for kind in STATES[c.arch]:
            for k, arr in cache[kind].items():
                out[f"{name}/state/{kind}/{k}"] = np.asarray(arr)
                meta[f"{name}/state"][f"{kind}/{k}"] = placed(arr)
    np.savez(d / "out.npz", **out)
    (d / "meta.json").write_text(json.dumps(meta))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, its placements, every rank's results,
    the inputs by case): the JAX child and the four ranks run side by
    side."""
    d = tmp_path_factory.mktemp("ssm_split")
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


def _coord(rank: dict, name: str) -> str:
    return json.dumps([rank[name]["at"][a] for a in CASES[name].axes])


# ================================================================ tests
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("what", ["forward", "prefill", "steps"])
def test_split_recurrence_matches_the_reference_under_its_policy(name, what, runs):
    """Every rank's logits of its rows: the cache-free forward, the last
    logits of each prefill chunk (the second seeded by the first's state)
    and each teacher-forced decode step."""
    ref, _, ranks, _ = runs
    want = ref[f"{name}/{what}"]
    for rank in ranks:
        got = rank[name][what]
        sel = want[_rows(rank, name)] if what == "forward" else want[:, _rows(rank, name)]
        assert got.shape == sel.shape, (got.shape, sel.shape)
        assert np.isfinite(got).all()
        err, tol = float(np.abs(got - sel).max()), TOL[CASES[name].arch]
        assert err <= tol, f"{name} {what} rank {rank['coords']}: {err:.3g} > {tol}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_ranks_recurrent_leaves_are_the_references_blocks(name, runs):
    """Every leaf of every rank's periods (the Mamba, mLSTM and sLSTM
    leaves, and the hybrid's attention and FFN layers) is, bit for bit, the
    block the reference's fitted specs place at its grid coordinate: no
    rank holds a whole leaf that its spec splits."""
    _, meta, ranks, cases = runs
    flat = cases[name][0]
    blocks = meta[f"{name}/blocks"]
    assert set(blocks) == set(ranks[0][name]["leaves"])
    for rank in ranks:
        coord = _coord(rank, name)
        for path, by_coord in blocks.items():
            idx = tuple(slice(a, b) for a, b in by_coord[coord])
            np.testing.assert_array_equal(rank[name]["leaves"][path],
                                          flat[f"periods/{path}"][idx], err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_ranks_state_is_the_references_block(name, runs):
    """After the prefill's two chunks and the decode steps, every rank's
    recurrent state is the block the reference's cache placement
    (`_cache_specs`, fitted) holds on the device at its coordinate: the
    Mamba channels, the mLSTM heads, the sLSTM heads' channels, the rows
    over ``data``."""
    ref, meta, ranks, _ = runs
    placed = meta[f"{name}/state"]
    assert set(placed) == set(ranks[0][name]["state"])
    for rank in ranks:
        coord = _coord(rank, name)
        for key, by_coord in placed.items():
            want = ref[f"{name}/state/{key}"][tuple(slice(a, b) for a, b in by_coord[coord])]
            got = rank[name]["state"][key]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert got.size < ref[f"{name}/state/{key}"].size, key   # a block, not the whole
            err = float(np.abs(got - want).max())
            assert err <= TOL[CASES[name].arch] * max(1.0, float(np.abs(want).max())), (key, err)


@pytest.fixture(scope="module")
def whole64(runs):
    """The port's whole run of the xLSTM cases in f64 (no policy), on one
    thread as the ranks run."""
    _, _, _, cases = runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, c in CASES.items():
            if c.arch != XLSTM:
                continue
            params_np, ins = cases[name]
            params = _f64(params_from_jax(_tree(params_np), "cpu", torch.float32))
            res = _serve(build_model(_cfg(name)), params, torch.from_numpy(ins["tokens"]),
                         torch.from_numpy(ins["steps"]), None, torch.float64)
            out[name] = {w: res[w].numpy() for w in ("forward", "prefill", "steps")}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c.arch == XLSTM))
def test_split_xlstm_is_the_whole_run_in_f64(name, runs, whole64):
    """In f64 the split's logits (forward, both prefill chunks, the steps)
    equal the port's whole run within F64_REL of the max |logit|: what
    separates the xLSTM split from the reference in f32 is rounding, not
    the split."""
    _, _, ranks, _ = runs
    for rank in ranks:
        for what, want in whole64[name].items():
            sel = want[_rows(rank, name)] if what == "forward" else want[:, _rows(rank, name)]
            got = rank[name]["f64"][what]
            assert got.shape == sel.shape
            err = float(np.abs(got - sel).max())
            assert err <= F64_REL * float(np.abs(sel).max()), (name, what, err)


def _ledger(name: str) -> list:
    """(puts, colls) of each call: the forward, both prefill chunks and each
    decode step, all alike.  A ring all-reduce over tp is tp - 1
    reduce-scatter puts and 2 x ceil((tp - 1) / 2) all-gather puts, an
    all-gather the latter, an FSDP gather over ``data`` = 2 one put, an
    all-to-all one collective.  A call: the embedding's all-reduce and the
    vocabulary's all-gather, under FSDP ``tok``'s 2 gathers, and a period's
    layers:

      * Jamba: the attention's all-reduce, each Mamba layer's in-projection
        all-gather, ``x_proj``'s and ``out_proj``'s all-reduces and one
        all-to-all (the dt partials and the A_log blocks), each MoE and MLP
        layer's all-reduce; under FSDP 15 gathers (wq / wk / wv / wo, the
        Mamba stacks' in_proj / x_proj / dt_proj / out_proj, the router and
        the experts' 3, the MLPs' 3);
      * xLSTM: each mLSTM's up-projection all-gather and ``down_proj``'s
        all-reduce; the sLSTM's h all-gather, its FFN's all-gather and,
        where ``w_out`` is split, its all-reduce; under FSDP 10 gathers
        (the mLSTM stacks' up_proj / w_i / w_f / down_proj, the sLSTM's
        w_i..w_z, w_in, w_out)."""
    c = CASES[name]
    cfg = _cfg(name)
    tp = c.axes["model"]
    ag = 2 * -(-(tp - 1) // 2)
    ar = tp - 1 + ag
    fg = int(c.axes.get("data", 1) > 1)
    if c.arch == JAMBA:
        n_p, period = cfg.n_layers // cfg.attn_period, cfg.attn_period
        per = 15 * fg + ar + (period - 1) * (ag + 2 * ar) + period * ar
        colls = n_p * (period - 1)
    else:
        n_p, period = cfg.n_layers // cfg.slstm_period, cfg.slstm_period
        w_out_split = int((4 * cfg.d_model // 3) % tp == 0)
        per = 10 * fg + (period - 1) * (ag + ar) + 2 * ag + ar * w_out_split
        colls = 0
    return [(2 * fg + ar + ag + n_p * per, colls)] * (3 + STEPS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_the_schedules(name, runs):
    """Every rank issues exactly the schedule's puts and all-to-alls
    (`_ledger`): no collective inside the sLSTM's time loop or the scan,
    and no torch.distributed collective ran (`_refusing`)."""
    _, _, ranks, _ = runs
    want = _ledger(name)
    for rank in ranks:
        assert [tuple(x) for x in rank[name]["ledger"]] == want, (rank[name]["ledger"], want)


# ====================================================== in this process
def test_the_smoke_fits_mirror_full_width():
    """The cases' SMOKE fits are full width's where the split must move an
    activation: at tp = 4 ``in_proj`` / ``up_proj`` cut x ‖ z into 4
    column blocks, ``dt_proj`` is split on R and ``A_log`` on N, the
    sLSTM's ``w_in`` is split and ``w_out`` whole; at tp = 2 ``w_out``'s
    rows split too.  Each rank's recurrent state is 1 / tp of the whole."""
    def fits(cfg, axes) -> dict:
        pol = make_policy(procmesh.ProcMesh(axes, 0, device="cpu"), cfg, SHAPES["decode_32k"])
        shapes = build_model(cfg).init_shapes()
        return {p.rsplit("/", 1)[-1] if "mix" in p else p: s
                for p, s in pol.flat_specs(shapes).items()
                if "/mix/" in p and not p.startswith("periods/mlstm")}

    for arch, small in ((JAMBA, "jamba_tp4"), (XLSTM, "xlstm_tp4")):
        for axes in ({"model": 4}, GRID):
            full = fits(get_config(arch), axes)
            smoke = fits(_cfg(small), axes)
            assert full == smoke, (arch, axes)
    tp4 = fits(get_config(JAMBA), {"model": 4})
    assert tp4["in_proj"][-1] == "model" and tp4["dt_proj"][-2] == "model"
    assert tp4["A_log"][-1] == "model"
    x4, x2 = fits(get_config(XLSTM), {"model": 4}), fits(get_config(XLSTM), GRID)
    assert x4["w_in"][-1] == "model" and x4["w_out"][-2] is None
    assert x2["w_in"][-1] == "model" and x2["w_out"][-2] == "model"
    for name in CASES:
        cfg = _cfg(name)
        pol = _policy(procmesh.ProcMesh({"model": 4}, 1, device="cpu"), name)
        with use_policy(pol):
            cache = build_model(cfg).init_cache(BATCH, MAX_SEQ, device="cpu")
        whole = build_model(cfg).init_cache(BATCH, MAX_SEQ, device="cpu")
        for kind in STATES[cfg.name.split("-smoke")[0]]:
            for k, v in cache[kind].items():
                assert v.numel() * 4 == whole[kind][k].numel(), (kind, k)
                assert v.dtype == whole[kind][k].dtype, (kind, k)
                assert bool((v == whole[kind][k].flatten()[0]).all()), (kind, k)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
