"""A KV cache split on its sequence over a `ProcMesh`'s ``model`` axis,
against the JAX reference's partitioned step under the same policy and
against the port's own whole run.

Four CPU processes are spawned once for the whole file (`procmesh.run`
with the grid ``{"data": 2, "model": 2}``, regridded to ``{"model": 4}``
where a case asks: gloo over a `FileStore`, windows as shared files, the
peer forms' plain versions).  For each case every rank takes its blocks of
the same seeded f32 numpy params (`params_from_jax(..., policy=)`), makes
its cache with `Model.init_cache(B, MAX_SEQ)` under the policy (the global
batch: the rows split over ``data``) and runs `make_prefill_step`,
`Model.prefill` of a `PROMPT`-token prompt and `STEPS` teacher-forced
`make_serve_step` steps on its rows.  The cases (`CASES`):

  * ``glm_tp4``: chatglm3-6b SMOKE (4 q heads, 2 KV heads, q/k/v biases,
    2-D RoPE) over ``{"model": 4}`` under the reference's `make_policy`
    for decode_32k: one q head a rank, ``wk`` / ``wv`` whole, the cache's
    sequence in 4 blocks;
  * ``qwen_kv_split``: qwen1.5-110b SMOKE at tp = 2 with
    ``kv_seq_shard=True`` (``fsdp=False``): the 2 KV heads split one a
    rank, each rank's new rows gathered over ``model`` before the owner
    writes them;
  * ``glm_grid``: chatglm3 SMOKE over the grid under `make_policy` for
    long_500k (FSDP over ``data``, K/V split by heads over ``model``);
  * ``glm_whole_cache``: ``glm_tp4`` at a max_seq that ``model`` does not
    divide, where the cache stays whole as in the reference.

One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs the reference's jitted `forward_logits`, `prefill` and `decode_step`
under ``use_policy`` of its `make_policy` over a `jax.sharding.Mesh` of
the case's axes, its cache placed by `launch.dryrun._cache_specs` (each
spec fitted, as its `_sharded_sds` fits them), in f32, and writes each
device's block of the placed cache.  Held to it: every rank's logits
(`TOL`), its initial cache leaf (the block of that device, bit for bit)
and its final one (`TOL`).  The split step's
collectives are the one-sided ring's and the all-to-all's puts (an
`OpCounter` ledger of the exact count) with every `torch.distributed`
collective made to raise while it runs.

Port-only, against the port's whole run computed in this process (`WTOL`,
no NaN): rows prefilled to positions in different blocks and decoded
across the block boundaries (``len`` one a row, which the reference's
engine does not keep), a chunked prefill that straddles a boundary, and
layer 0's attention of a prefill into empty rows, by the merged path (a
cache view without ``rows_empty``) and by the local one.  The partial
softmax results and their merge, and the refusals of a cache without its
marker or of other rows than the batch, run in this process too.
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
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model, params_from_jax  # noqa: E402
from repro_torch.parallel.sharding import use_policy  # noqa: E402
from repro_torch.train.train_step import make_prefill_step, make_serve_step  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, GRID = 4, {"data": 2, "model": 2}
GLM, QWEN = "chatglm3-6b", "qwen1.5-110b"


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    axes: dict          # the ranks' grid
    shape: str          # make_policy's cell
    fsdp: bool
    max_seq: int


CASES = {
    "glm_tp4": Case(GLM, {"model": 4}, "decode_32k", True, 16),
    "qwen_kv_split": Case(QWEN, GRID, "long_500k", False, 16),
    "glm_grid": Case(GLM, GRID, "long_500k", True, 16),
    "glm_whole_cache": Case(GLM, {"model": 4}, "decode_32k", True, 18),
}
B, PROMPT, STEPS = 2, 6, 4          # the global batch; prompt 6, decode to 9: crosses 8
PER_ROW, CHUNKS = (3, 9), (3, 4)    # port-only: rows at 3 and 9; chunks [0, 3), [3, 7)
TOL = 1e-4              # logits, f32: the split's sums against XLA's partitioned ones
WTOL = 1e-5             # logits, f32: the split against the port's whole run
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
CHILD_TIMEOUT = 240.0   # s: the JAX child
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single")


def _cfg(arch: str, get=get_config):
    return get(arch, smoke=True)


def _policy(mesh, name: str):
    c = CASES[name]
    return dataclasses.replace(make_policy(mesh, _cfg(c.arch), SHAPES[c.shape]), fsdp=c.fsdp)


def _np_params(arch: str) -> dict:
    """Seeded f32 params: norm scales near 1, the rest at 1/sqrt(D) (the
    biases too, so that their split is exercised)."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(sorted((GLM, QWEN)).index(arch))
    out = {}
    for path, leaf in flatten(build_model(cfg).init_shapes()):
        shape = tuple(leaf.shape)
        if path.endswith("scale"):
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


def _inputs(arch: str) -> dict:
    rng = np.random.default_rng(100 + sorted((GLM, QWEN)).index(arch))
    v = _cfg(arch).vocab_size
    return {"tokens": rng.integers(0, v, (B, max(PROMPT, sum(CHUNKS), *PER_ROW)))
            .astype(np.int32),
            "steps": rng.integers(0, v, (STEPS, B)).astype(np.int32)}


def _f32(cache: dict) -> dict:
    """The cache with its bf16 leaves in f32 (and its other entries as
    they are), so that no rounding of a cache entry can differ."""
    return {k: (_f32(v) if isinstance(v, dict) else
                v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else v)
            for k, v in cache.items()}


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


def _counted(fn, ledger: list):
    """fn(), its (puts, colls) appended to `ledger`."""
    with OpCounter() as c:
        out = _refusing(fn)
    ledger.append((c.puts, c.colls))
    return out


# ================================================================ both runs
def _serve(model, params, toks, steps, max_seq: int, policy) -> dict:
    """make_prefill_step's logits, Model.prefill's last ones from an empty
    cache of the global batch made under `policy`, then the
    teacher-forced make_serve_step logits; each call's ledger."""
    ledger: list = []
    full = _counted(lambda: make_prefill_step(model, policy)(params, {"tokens": toks}), ledger)
    with use_policy(policy):
        cache = _f32(model.init_cache(B, max_seq, device="cpu"))
    init = {k: v.clone() for k, v in cache["kv"].items()}
    with torch.no_grad(), use_policy(policy):
        last, cache = _counted(lambda: model.prefill(params, toks, cache), ledger)
    serve = make_serve_step(model, policy)
    out = []
    for tok in steps:
        logits, cache = _counted(lambda: serve(params, tok, cache), ledger)
        out.append(logits)
    return {"forward": full, "prefill": last, "steps": torch.stack(out), "ledger": ledger,
            "init": init, "cache": cache}


def _port_only(model, params, toks, steps, policy) -> dict:
    """The port-only scenarios on the glm cases' cache of 16 (4 blocks
    over model = 4), under `policy` or whole (None): rows prefilled alone
    to `PER_ROW` and decoded together; `CHUNKS` prefilled in turn (every
    position's logits, `transformer.forward`); layer 0's attention of a
    prefill of `CHUNKS[0]` seeded inputs into empty rows, by the merged
    path and by the local one."""
    cfg = model.cfg

    def fresh():
        with use_policy(policy):
            return _f32(model.init_cache(B, 16, device="cpu"))

    out = {}
    with torch.no_grad(), use_policy(policy):
        cache = fresh()
        for b, n in enumerate(PER_ROW):
            row = {**cache, "kv": {k: v[:, b:b + 1] for k, v in cache["kv"].items()},
                   "len": torch.zeros((), dtype=torch.int32)}
            model.prefill(params, toks[b:b + 1, :n], row)
        cache["len"] = torch.tensor(PER_ROW, dtype=torch.int32)
        rows = []
        for tok in steps:
            logits, cache = model.decode_step(params, tok, cache)
            rows.append(logits)
        out["per_row"] = torch.stack(rows)
        out["per_row_cache"] = {k: v.clone() for k, v in cache["kv"].items()}

        cache, at, chunks = fresh(), 0, []
        for n in CHUNKS:
            res = T.forward(params, cfg, toks[:, at:at + n], cache=cache)
            chunks.append(res.logits)
            cache, at = res.cache, at + n
        for tok in steps[:2]:
            logits, cache = model.decode_step(params, tok, cache)
            chunks.append(logits[:, None])
        out["straddle"] = torch.cat(chunks, dim=1)

        attn = {k: v[0] for k, v in params["blocks"]["attn"].items()}
        x = torch.randn(B, CHUNKS[0], cfg.d_model, generator=torch.Generator().manual_seed(7))
        pos = torch.arange(CHUNKS[0])[None].expand(B, -1)
        for what, empty in (("merged_prefill", False), ("local_prefill", True)):
            cache = fresh()
            kv = {"k": cache["kv"]["k"][0], "v": cache["kv"]["v"][0],
                  "len": torch.zeros((), dtype=torch.int32),
                  "seq_blocks": cache.get("kv_seq_blocks"), "rows_empty": empty}
            out[what], _ = L.attention(attn, x, pos, cfg.rope_style, cache=kv,
                                       heads=(cfg.n_heads, cfg.n_kv_heads))
    return out


def _rank_main(mesh, cases: dict) -> dict:
    torch.set_num_threads(1)
    out = {"coords": mesh.coords}
    for name, (params_np, ins) in cases.items():
        c = CASES[name]
        m = mesh if c.axes == GRID else mesh.regrid(c.axes)
        pol = _policy(m, name)
        at = dict(zip(c.axes, m.coords))
        rows = slice(at["data"], at["data"] + 1) if "data" in at else slice(None)
        params = params_from_jax(_tree(params_np), "cpu", torch.float32, policy=pol)
        model = build_model(_cfg(c.arch))
        toks = torch.from_numpy(ins["tokens"][rows, :PROMPT])
        steps = torch.from_numpy(ins["steps"][:, rows])
        res = _serve(model, params, toks, steps, c.max_seq, pol)
        out[name] = {"at": at, "forward": res["forward"].numpy(),
                     "prefill": res["prefill"].numpy(), "steps": res["steps"].numpy(),
                     "ledger": res["ledger"], "blocks": res["cache"].get("kv_seq_blocks", 1),
                     "init": {k: v.numpy() for k, v in res["init"].items()},
                     "cache": {k: v.numpy() for k, v in res["cache"]["kv"].items()}}
        if name == "glm_tp4":
            got = _refusing(lambda: _port_only(model, params, torch.from_numpy(ins["tokens"]),
                                               steps, pol))
            out["port_only"] = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                                    if isinstance(v, dict) else v.numpy())
                                for k, v in got.items()}
            out["port_only"]["model_rank"] = pol.model_rank
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
    from repro.models.registry import build_model as jbuild
    from repro.parallel import sharding as jsh

    out, meta = {}, {}
    for name, c in CASES.items():
        cfg = _cfg(c.arch, jget)
        model = jbuild(cfg)
        mesh = jax.sharding.Mesh(np.asarray(devices).reshape(tuple(c.axes.values())),
                                 tuple(c.axes))
        pol = dataclasses.replace(jdry.make_policy(mesh, cfg, JSHAPES[c.shape]), fsdp=c.fsdp)
        params = jax.tree.map(jnp.asarray, _tree(dict(np.load(d / f"{c.arch}_params.npz"))))
        ins = dict(np.load(d / f"{c.arch}_in.npz"))
        toks = jnp.asarray(ins["tokens"][:, :PROMPT])

        def under(fn, pol=pol):
            def run(*a):
                with jsh.use_policy(pol):
                    return fn(*a)
            return jax.jit(run)

        cache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                             model.init_cache(B, c.max_seq))
        # placed as the dry-run places it (`_sharded_sds`: each spec fitted)
        specs = jax.tree.map(lambda a, s: jsh.fit_spec(s, a.shape, mesh), cache,
                             jdry._cache_specs(cache, pol, cfg))
        cache = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), cache,
                             specs)
        shards = {}
        for sh in cache["kv"]["k"].addressable_shards:
            coord = [int(i) for i in np.argwhere(mesh.devices == sh.device)[0]]
            shards[json.dumps(coord)] = [[s.start or 0, n if s.stop is None else s.stop]
                                         for s, n in zip(sh.index, cache["kv"]["k"].shape)]
        kv_spec = specs["kv"]["k"]
        meta[name] = {"kv_spec": [list(e) if isinstance(e, tuple) else e for e in kv_spec],
                      "shards": shards, "seq_shard": pol.kv_seq_shard}
        with mesh:
            out[f"{name}/forward"] = np.asarray(
                under(lambda p, t: model.forward_logits(p, {"tokens": t}).logits)(params, toks))
            last, cache = under(model.prefill)(params, toks, cache)
            out[f"{name}/prefill"] = np.asarray(last)
            dec, steps = under(model.decode_step), []
            for tok in ins["steps"]:
                logits, cache = dec(params, jnp.asarray(tok), cache)
                steps.append(np.asarray(logits))
        out[f"{name}/steps"] = np.stack(steps)
        for k in ("k", "v"):
            out[f"{name}/cache/{k}"] = np.asarray(cache["kv"][k])
    np.savez(d / "out.npz", **out)
    (d / "meta.json").write_text(json.dumps(meta))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, its cache placements, every rank's
    results, the inputs by arch): the JAX child and the four ranks run
    side by side."""
    d = tmp_path_factory.mktemp("kv_seq_split")
    by_arch = {}
    for arch in (GLM, QWEN):
        by_arch[arch] = (_np_params(arch), _inputs(arch))
        np.savez(d / f"{arch}_params.npz", **by_arch[arch][0])
        np.savez(d / f"{arch}_in.npz", **by_arch[arch][1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "child", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cases = {name: by_arch[c.arch] for name, c in CASES.items()}
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(cases,), axes=GRID,
                             timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=CHILD_TIMEOUT)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "meta.json").read_text()), ranks, \
        by_arch


@pytest.fixture(scope="module")
def whole(runs):
    """The port's whole run of the glm cases' inputs and params (no
    policy): the reference serve and the port-only scenarios.  It runs on
    one thread, as the ranks do (`_rank_main`): at another thread count
    the CPU's matmuls sum in another order, and layer 0's block would not
    be bit-equal."""
    _, _, _, by_arch = runs
    params_np, ins = by_arch[GLM]
    model = build_model(_cfg(GLM))
    params = params_from_jax(_tree(params_np), "cpu", torch.float32)
    toks = torch.from_numpy(ins["tokens"])
    steps = torch.from_numpy(ins["steps"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _port_only(model, params, toks, steps, None)
        out["serve"] = _serve(model, params, toks[:, :PROMPT], steps, 16, None)
    finally:
        torch.set_num_threads(threads)
    return out


def _rows(rank: dict, name: str) -> slice:
    at = rank[name]["at"]
    return slice(at["data"], at["data"] + 1) if "data" in at else slice(None)


def _coord(rank: dict, name: str) -> str:
    return json.dumps([rank[name]["at"][a] for a in CASES[name].axes])


# ================================================================ tests
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("what", ["forward", "prefill", "steps"])
def test_split_step_matches_the_reference_under_its_policy(name, what, runs):
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
def test_each_ranks_cache_is_the_references_block(name, runs):
    """`init_cache` under the policy gives each rank the block that the
    reference's `_cache_specs` places on the device at its coordinate: the
    same slice of the global cache, bit for bit; after the prefill and the
    steps the block holds the reference's rows (`TOL`).  The sequence is
    split exactly where the reference splits it, and only there."""
    ref, meta, ranks, _ = runs
    c = CASES[name]
    seq_split = "model" in (meta[name]["kv_spec"][2] or [])
    assert seq_split == (c.max_seq % c.axes["model"] == 0)
    for rank in ranks:
        idx = tuple(slice(a, b) for a, b in meta[name]["shards"][_coord(rank, name)])
        res = rank[name]
        assert res["blocks"] == (c.axes["model"] if seq_split else 1)
        for k in ("k", "v"):
            want = ref[f"{name}/cache/{k}"]
            np.testing.assert_array_equal(res["init"][k], np.zeros_like(want)[idx])
            assert res["cache"][k].shape == want[idx].shape
            err = float(np.abs(res["cache"][k] - want[idx]).max())
            assert err <= TOL, f"{name} {k} rank {rank['coords']}: {err:.3g}"
        if seq_split:
            n = c.max_seq // c.axes["model"]
            assert res["init"]["k"].shape[2] == n and res["init"]["k"].shape[3] == 2


def _ledger(name: str) -> list:
    """(puts, colls) of each call: the forward, the prefill from empty rows,
    each decode step.  A ring all-reduce over tp is tp - 1 reduce-scatter
    puts and 2 x ceil((tp - 1) / 2) all-gather puts, an all-gather the
    latter, an FSDP gather over ``data`` = 2 one put (one direction), an
    all-to-all one collective.  The forward: the embedding's all-reduce, 2
    a layer, the vocabulary's all-gather, and under FSDP the 7 split
    leaves a layer and the 2 of ``tok`` gathered.  The prefill from empty
    rows attends locally: the forward's, plus the K/V rows' gather a layer
    where ``wk`` is split.  A decode step over a sequence-split cache adds
    q's gather and the partials' all-to-all a layer."""
    c = CASES[name]
    cfg = _cfg(c.arch)
    tp = c.axes["model"]
    ag = 2 * -(-(tp - 1) // 2)
    ar = tp - 1 + ag
    fsdp = int(c.fsdp and c.axes.get("data", 1) > 1)
    forward = 2 * fsdp + ar + cfg.n_layers * (7 * fsdp + 2 * ar) + ag
    seq = c.max_seq % tp == 0
    kv_split = cfg.n_kv_heads % tp == 0
    prefill = forward + cfg.n_layers * ag * kv_split
    step = prefill + cfg.n_layers * ag * seq
    return [(forward, 0), (prefill, 0)] + [(step, cfg.n_layers * seq)] * STEPS


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_one_sided_puts(name, runs):
    """Every rank issues exactly the schedule's puts and all-to-alls
    (`_ledger`), and no torch.distributed collective ran (`_refusing`)."""
    _, _, ranks, _ = runs
    want = _ledger(name)
    for rank in ranks:
        assert [tuple(x) for x in rank[name]["ledger"]] == want, (rank[name]["ledger"], want)


@pytest.mark.parametrize("what", ["per_row", "straddle", "merged_prefill", "local_prefill"])
def test_split_matches_the_whole_run(what, runs, whole):
    """Rows at positions in different blocks decoded across the
    boundaries, a chunked prefill straddling one, and layer 0's attention
    of an empty-row prefill by the merged and by the local path: within
    `WTOL` of the port's whole run, no NaN (a block where a row has no
    valid key adds nothing)."""
    _, _, ranks, _ = runs
    for rank in ranks:
        got = rank["port_only"][what]
        assert np.isfinite(got).all(), what
        err = float(np.abs(got - whole[what].numpy()).max())
        assert err <= WTOL, f"{what} rank {rank['coords']}: {err:.3g} > {WTOL}"


def test_the_split_serve_matches_the_whole_run(runs, whole):
    """glm_tp4's forward, prefill and steps within `WTOL` of the whole run,
    and each rank's cache its block of the whole run's positions: layer 0
    bit for bit (the same inputs and whole K/V weights), the rest within
    `WTOL`, in both the served cache and the per-row one."""
    _, _, ranks, _ = runs
    want = whole["serve"]
    for rank in ranks:
        res, r = rank["glm_tp4"], rank["port_only"]["model_rank"]
        for what in ("forward", "prefill", "steps"):
            assert float(np.abs(res[what] - want[what].numpy()).max()) <= WTOL, what
        for got, full in ((res["cache"], want["cache"]["kv"]),
                          (rank["port_only"]["per_row_cache"], whole["per_row_cache"])):
            for k in ("k", "v"):
                blk = full[k][:, :, 4 * r:4 * r + 4].numpy()
                np.testing.assert_array_equal(got[k][0], blk[0])
                assert float(np.abs(got[k] - blk).max()) <= WTOL


def test_merged_partials_are_the_softmax_over_the_union():
    """`blockwise_partial` over 4 disjoint blocks of keys at their absolute
    positions, merged by `merge_partials`, against `blockwise_attention`
    over all the keys (f32: the merge reorders f32 sums): rows whose keys
    lie in one block, rows with a block of no valid key, and a row that
    sees no key at all (0 in both, no NaN)."""
    g = torch.Generator().manual_seed(11)
    Bq, Sq, H, Hkv, hd, n = 3, 2, 4, 2, 8, 5
    q = torch.randn(Bq, Sq, H, hd, generator=g)
    k, v = (torch.randn(Bq, 4 * n, Hkv, hd, generator=g) for _ in range(2))
    start = torch.tensor([2, 11, 0])           # row 2 sees no key: valid length 0
    valid = torch.tensor([4, 13, 0])
    want = L.blockwise_attention(q, k, v, q_offset=start, kv_valid_len=valid, block_size=3)
    parts = torch.stack([L.blockwise_partial(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                             q_offset=start, kv_offset=i * n, block_size=3,
                                             kv_valid_len=valid) for i in range(4)])
    assert torch.isneginf(parts[:, 2, ..., -2]).all() and (parts[:, 2, ..., -1] == 0).all()
    got = L.merge_partials(parts)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6
    assert (got[2] == 0).all() and (want[2] == 0).all()


def _layer0(max_seq: int, batch: int = 1):
    """chatglm3 SMOKE's layer 0 attention params of rank 0 under the
    decode_32k policy over ``{"model": 4}``, and a cache made under it."""
    cfg = _cfg(GLM)
    pol = make_policy(procmesh.ProcMesh({"model": 4}, 0, device="cpu"), cfg,
                      SHAPES["decode_32k"])
    with use_policy(pol):
        cache = build_model(cfg).init_cache(batch, max_seq, device="cpu")
    params = params_from_jax(_tree(_np_params(GLM)), "cpu", torch.float32, policy=pol)
    return cfg, pol, {k: v[0] for k, v in params["blocks"]["attn"].items()}, cache


def _attend(cfg, pol, attn, kv: dict, batch: int = 1):
    x = torch.randn(batch, 2, cfg.d_model)
    with torch.no_grad(), use_policy(pol):
        return L.attention(attn, x, torch.arange(2)[None].expand(batch, -1), cfg.rope_style,
                           cache={**kv, "len": torch.zeros((), dtype=torch.int32)},
                           heads=(cfg.n_heads, cfg.n_kv_heads))


@pytest.mark.parametrize("max_seq", [16, 8, 18])
def test_a_block_without_its_marker_is_refused(max_seq):
    """Under a policy that splits the cache's sequence, a cache handed to
    the attention without ``seq_blocks`` is refused, whatever its length:
    a block of 4 or of 2 positions (one that tp does not divide), or a
    whole cache of 18 (model = 4 does not divide it), which `init_cache`
    marks as one block."""
    cfg, pol, attn, cache = _layer0(max_seq)
    assert cache["kv_seq_blocks"] == (1 if max_seq % 4 else 4)
    kv = {"k": cache["kv"]["k"][0], "v": cache["kv"]["v"][0]}
    with pytest.raises(ValueError, match="kv_seq_blocks"):
        _attend(cfg, pol, attn, kv)


def test_a_cache_of_other_rows_than_the_batch_is_refused():
    """Under a policy `init_cache` takes the global batch and a step the
    rank's rows: a cache whose rows are not the step's is refused."""
    cfg, pol, attn, cache = _layer0(16)
    kv = {"k": cache["kv"]["k"][0], "v": cache["kv"]["v"][0],
          "seq_blocks": cache["kv_seq_blocks"]}
    with pytest.raises(ValueError, match="global batch"):
        _attend(cfg, pol, attn, kv, batch=2)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
