"""A dense model step split over a `ProcMesh`'s ``model`` axis, against the
JAX reference's partitioned forward under the same `ShardingPolicy`.

Four CPU processes are spawned once for the whole file (`procmesh.run`
with the grid ``{"data": 2, "model": 2}``: gloo over a `FileStore`,
windows as shared files, the peer forms' plain versions).  For each case
every rank takes its blocks of the same seeded numpy params
(`models.registry.params_from_jax(..., policy=)` under
``ShardingPolicy(mesh, fsdp=False)``) and runs `make_prefill_step`
(`Model.forward_logits`), `Model.prefill` into a cache made under the
policy and `STEPS` steps of `make_serve_step`, teacher-forced on seeded
tokens.  The cases:

  * qwen1.5-110b SMOKE at tp = 2 (4 heads, 2 KV heads, q/k/v biases), each
    ``data`` coordinate on its own row of the batch;
  * the same with 8 heads and 4 KV heads at tp = 4 (the four ranks as one
    ``model`` axis, `ProcMesh.regrid`), every rank on the whole batch;
  * 6 heads and 3 KV heads at tp = 2 with tied embeddings: ``wq`` / ``bq``
    / ``wo`` split, ``wk`` / ``wv`` / ``bk`` / ``bv`` whole on every rank
    (3 does not divide by 2), the LM head the block of ``embed``.

One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs the reference's `forward_logits`, `prefill` and `decode_step` jitted
under ``use_policy(ShardingPolicy(Mesh(<tp devices>, ("model",)),
fsdp=False))`` on the same params, and writes its fitted specs.  Every
rank's logits are held to the reference's within `TOL` (f32, the K/V cache
cast to f32 in both packages so that no bf16 rounding of a cache entry
can differ); every rank's leaves are the blocks the reference's specs
give its coordinate, bit for bit; the forward's collectives are the
one-sided ring's puts (an `OpCounter` ledger of exactly the expected
count), with every `torch.distributed` collective made to raise while it
runs.  The refusals of what the split does not carry yet (and the cases
it now accepts), the train step's guard of them and `params_from_jax`'s
blocks run in this process; the backward of each of the split step's
collectives runs on two more CPU processes, against the same function
computed whole.  The train step over the grid is
`tests/test_torch_tensor_parallel_train.py`'s; a KV cache split on its
sequence, `tests/test_torch_kv_seq_split.py`'s.
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
from repro_torch.parallel.sharding import ShardingPolicy, use_policy  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,  # noqa: E402
                                          make_train_step)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, GRID = 4, {"data": 2, "model": 2}
ARCH = "qwen1.5-110b"
# name -> (overrides of the SMOKE config, tp)
CASES = {
    "qwen": ({}, 2),
    "h8_tp4": ({"n_heads": 8, "n_kv_heads": 4}, 4),
    "mixed_tied": ({"n_heads": 6, "n_kv_heads": 3, "tie_embeddings": True}, 2),
}
B, S, STEPS, MAX_SEQ = 2, 9, 4, 16
TOL = 1e-4              # logits, f32: the split's sums against XLA's partitioned ones
TIMEOUT = 120.0         # s: the pool's join; a hung rank is killed and fails the tests
CHILD_TIMEOUT = 240.0   # s: the JAX child
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single")


def _cfg(name: str, get=get_config):
    return dataclasses.replace(get(ARCH, smoke=True), **CASES[name][0])


def _np_params(name: str) -> dict:
    """Seeded f32 params of the port's structure (that of the reference):
    norm scales near 1, biases and weights at 1/sqrt(their fan-in)."""
    cfg = _cfg(name)
    rng = np.random.default_rng(sorted(CASES).index(name))
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


def _inputs(name: str) -> dict:
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    v = _cfg(name).vocab_size
    return {"tokens": rng.integers(0, v, (B, S)).astype(np.int32),
            "steps": rng.integers(0, v, (STEPS, B)).astype(np.int32)}


def _f32_cache(cache):
    return {k: (_f32_cache(v) if isinstance(v, dict) else
                v.float() if v.dtype == torch.bfloat16 else v) for k, v in cache.items()}


# ================================================================ the ranks
def _serve(model, params, ins: dict, policy) -> dict:
    """make_prefill_step's logits, Model.prefill's last ones and STEPS
    teacher-forced make_serve_step logits, under `policy`, on the rank's
    rows `ins` (the cache made for the global batch B, as `init_cache`
    takes it, holds them)."""
    toks = torch.from_numpy(ins["tokens"])
    full = make_prefill_step(model, policy)(params, {"tokens": toks})
    with use_policy(policy):
        cache = _f32_cache(model.init_cache(B, MAX_SEQ, device="cpu"))
    with torch.no_grad(), use_policy(policy):
        last, cache = model.prefill(params, toks, cache)
    serve = make_serve_step(model, policy)
    steps = []
    for tok in torch.from_numpy(ins["steps"]):
        logits, cache = serve(params, tok, cache)
        steps.append(logits)
    return {"forward": full.numpy(), "prefill": last.numpy(),
            "steps": torch.stack(steps).numpy(), "kv_heads": int(cache["kv"]["k"].shape[3])}


def _refusing(fn):
    """fn() with every torch.distributed collective raising while it runs
    (the bootstrap's barrier is the fence, and stays)."""
    dist = torch.distributed
    saved = {n: getattr(dist, n) for n in DIST_COLLECTIVES if hasattr(dist, n)}

    def refuse(*a, **kw):
        raise AssertionError("a torch.distributed collective on the split forward's path")

    for n in saved:
        setattr(dist, n, refuse)
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def _rank_main(mesh, cases: dict) -> dict:
    out = {"coords": mesh.coords}
    for name, (params_np, ins) in cases.items():
        tp = CASES[name][1]
        m = mesh if tp == GRID["model"] else mesh.regrid({"model": tp})
        policy = ShardingPolicy(m, fsdp=False)
        rows = slice(None) if tp == NP else slice(mesh.coords[0], mesh.coords[0] + 1)
        ins = {"tokens": ins["tokens"][rows], "steps": ins["steps"][:, rows]}
        params = params_from_jax(_tree(params_np), "cpu", torch.float32, policy=policy)
        with OpCounter() as c:
            res = _refusing(lambda: _serve(build_model(_cfg(name)), params, ins, policy))
        res["puts"] = c.puts
        res["model_rank"] = policy.model_rank
        res["leaves"] = {k: v.numpy() for k, v in flatten(params)}
        out[name] = res
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models.registry import build_model as jbuild
    from repro.parallel import sharding as jsh

    out, specs = {}, {}
    for name, (_, tp) in CASES.items():
        model = jbuild(_cfg(name, jget))
        params = jax.tree.map(jnp.asarray, _tree(dict(np.load(d / f"{name}_params.npz"))))
        ins = dict(np.load(d / f"{name}_in.npz"))
        pol = jsh.ShardingPolicy(jax.sharding.Mesh(np.asarray(jax.devices()[:tp]), ("model",)),
                                 fsdp=False)

        def under(fn):
            def run(*a):
                with jsh.use_policy(pol):
                    return fn(*a)
            return jax.jit(run)

        fwd = under(lambda p, t: model.forward_logits(p, {"tokens": t}).logits)
        pre = under(model.prefill)
        dec = under(model.decode_step)
        out[f"{name}/forward"] = np.asarray(fwd(params, jnp.asarray(ins["tokens"])))
        cache = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
                             model.init_cache(B, MAX_SEQ))
        last, cache = pre(params, jnp.asarray(ins["tokens"]), cache)
        out[f"{name}/prefill"] = np.asarray(last)
        steps = []
        for tok in ins["steps"]:
            logits, cache = dec(params, jnp.asarray(tok), cache)
            steps.append(np.asarray(logits))
        out[f"{name}/steps"] = np.stack(steps)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            pol.tree_specs(params), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        specs[name] = {"/".join(jsh._key_str(k) for k in path):
                       [list(e) if isinstance(e, tuple) else e for e in spec]
                       for path, spec in flat}
    np.savez(d / "out.npz", **out)
    (d / "specs.json").write_text(json.dumps(specs))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's logits, its fitted specs, every rank's results):
    the JAX child and the four ranks run side by side."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    cases = {}
    for name in CASES:
        params, ins = _np_params(name), _inputs(name)
        np.savez(d / f"{name}_params.npz", **params)
        np.savez(d / f"{name}_in.npz", **ins)
        cases[name] = (params, ins)
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
    return (dict(np.load(d / "out.npz")), json.loads((d / "specs.json").read_text()), ranks,
            cases)


def _rows(name: str, rank: dict) -> slice:
    """The batch rows a rank served: its ``data`` coordinate's at tp = 2."""
    if CASES[name][1] == NP:
        return slice(None)
    return slice(rank["coords"][0], rank["coords"][0] + 1)


def _block(leaf: np.ndarray, spec: list, at: dict, shape: dict) -> np.ndarray:
    """The block of `leaf` that the mesh coordinate `at` holds under the
    reference's `spec` (one entry a dim: None, an axis or a list of axes)."""
    idx = []
    for d, n in enumerate(leaf.shape):
        entry = spec[d] if d < len(spec) else None
        axes = [] if entry is None else ([entry] if isinstance(entry, str) else entry)
        k, i = 1, 0
        for a in axes:
            i, k = i * shape[a] + at[a], k * shape[a]
        idx.append(slice(i * (n // k), (i + 1) * (n // k)))
    return leaf[tuple(idx)]


# ================================================================ tests
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("what", ["forward", "prefill", "steps"])
def test_split_step_matches_the_reference_under_its_policy(name, what, runs):
    ref, _, ranks, _ = runs
    want = ref[f"{name}/{what}"]
    for rank in ranks:
        got = rank[name][what]
        rows = _rows(name, rank)
        sel = want[:, rows] if what == "steps" else want[rows]
        assert got.shape == sel.shape, (got.shape, sel.shape)
        err = float(np.abs(got - sel).max())
        assert err <= TOL, f"{name} {what} rank {rank['coords']}: {err:.3g} > {TOL}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_only_its_blocks(name, runs):
    """Bit for bit the blocks the reference's fitted specs give the rank's
    coordinate on its ``model`` axis; its bytes their sum, the split
    leaves' 1/tp of theirs."""
    _, specs, ranks, cases = runs
    params, tp = cases[name][0], CASES[name][1]
    split = whole = 0
    for rank in ranks:
        got = rank[name]["leaves"]
        assert set(got) == set(params)
        at = {"model": rank[name]["model_rank"]}
        nbytes = 0
        for path, leaf in params.items():
            want = _block(leaf, specs[name][path], at, {"model": tp})
            assert got[path].shape == want.shape, (path, got[path].shape, want.shape)
            np.testing.assert_array_equal(got[path], want, err_msg=path)
            nbytes += got[path].nbytes
            is_split = want.shape != leaf.shape
            split += is_split and rank is ranks[0]
            whole += (not is_split) and rank is ranks[0]
        total = sum(v.nbytes for v in params.values())
        split_bytes = sum(v.nbytes for p, v in params.items()
                          if _block(v, specs[name][p], at, {"model": tp}).shape != v.shape)
        assert nbytes == total - split_bytes + split_bytes // tp
    assert split and whole


def test_mixed_fit_splits_q_and_keeps_kv_whole(runs):
    """6 q heads split, 3 KV heads whole: the cache holds every KV head."""
    _, specs, ranks, _ = runs
    sp = specs["mixed_tied"]
    assert sp["blocks/attn/wq"][2] == "model" and sp["blocks/attn/wo"][1] == "model"
    assert sp["blocks/attn/wk"][2] is None and sp["blocks/attn/bk"][1] is None
    assert "tok/lm_head" not in sp and sp["tok/embed"][0] == "model"
    assert all(r["mixed_tied"]["kv_heads"] == 3 for r in ranks)
    assert all(r["qwen"]["kv_heads"] == 1 and r["h8_tp4"]["kv_heads"] == 1 for r in ranks)


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_the_one_sided_ring(name, runs):
    """Each forward is 1 + 2 x layers all-reduces and one all-gather, and
    nothing else moves: a ring all-reduce over p is p - 1 reduce-scatter
    puts and 2 x ceil((p - 1) / 2) all-gather puts (both directions a
    step), the all-gather alone the latter (no torch.distributed
    collective ran: `_refusing`)."""
    _, _, ranks, _ = runs
    tp = CASES[name][1]
    gather = 2 * -(-(tp - 1) // 2)
    per_forward = (1 + 2 * _cfg(name).n_layers) * (tp - 1 + gather) + gather
    for rank in ranks:
        assert rank[name]["puts"] == (2 + STEPS) * per_forward, rank[name]["puts"]


def test_params_from_jax_keeps_each_ranks_block():
    """Under a model split each rank's leaves are its blocks (here on the
    mixed case's fit); without a policy, or on a policy that splits
    nothing over processes, the whole leaves."""
    flat = _np_params("mixed_tied")
    tree = _tree(flat)
    for r in range(2):
        pol = ShardingPolicy(procmesh.ProcMesh({"model": 2}, r, device="cpu"), fsdp=False)
        got = dict(flatten(params_from_jax(tree, "cpu", torch.float32, policy=pol)))
        assert got["blocks/attn/wq"].shape[2] == 3 and got["blocks/attn/wk"].shape[2] == 3
        np.testing.assert_array_equal(got["blocks/attn/wq"].numpy(),
                                      flat["blocks/attn/wq"][:, :, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(got["blocks/attn/wo"].numpy(),
                                      flat["blocks/attn/wo"][:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(got["blocks/attn/wk"].numpy(), flat["blocks/attn/wk"])
        np.testing.assert_array_equal(got["blocks/mlp/w_out"].numpy(),
                                      flat["blocks/mlp/w_out"][:, 64 * r:64 * r + 64])
        np.testing.assert_array_equal(got["tok/embed"].numpy(),
                                      flat["tok/embed"][128 * r:128 * r + 128])
    for pol in (None, ShardingPolicy(procmesh.ProcMesh({"data": 2}, 1, device="cpu"),
                                     fsdp=False)):
        got = dict(flatten(params_from_jax(tree, "cpu", torch.float32, policy=pol)))
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _split_policy(tp=2, **kw):
    kw.setdefault("fsdp", False)
    return ShardingPolicy(procmesh.ProcMesh({"model": tp}, 0, device="cpu"), **kw)


# case -> (arch, tp, policy options, the ROADMAP item that refuses it, or
# None where the split carries it now)
REFUSALS = {
    # a KV cache split on its sequence (12c.3) is carried: accepted
    "kv_seq_shard": (ARCH, 2, {"kv_seq_shard": True}, None),
    "fewer_kv_heads_than_tp": (ARCH, 4, {}, None),
    "seq_parallel": (ARCH, 2, {"seq_parallel": True}, "12c.3b"),
    "fsdp": (ARCH, 4, {"fsdp": True}, None),
    # the moe family's experts over `model` (12c.4) are carried when serving
    "moe": ("qwen3-moe-30b-a3b", 2, {}, None),
    "hybrid": ("jamba-v0.1-52b", 2, {}, "12c.5"),
    "ssm": ("xlstm-1.3b", 2, {}, "12c.5"),
}


# what a train step over a split refuses beyond REFUSALS
TRAIN_REFUSALS = {"moe": "12c.4b"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_the_split_does_not_carry_is_refused(case):
    """What the split does not carry raises, naming its ROADMAP item; what
    it carries now is accepted: a KV cache split on its sequence, with or
    without FSDP (its cache is this rank's block of the sequence), and the
    moe family (each expert's F is this rank's block, the router whole,
    and its cache keeps the global batch for the dispatch groups)."""
    arch, tp, kw, item = REFUSALS[case]
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    pol = _split_policy(tp, **kw)
    if item is None and cfg.family == "moe":
        pol.check_model_split(cfg)
        rng = np.random.default_rng(5)
        flat = {path: rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
                for path, leaf in flatten(model.init_shapes())}
        got = dict(flatten(params_from_jax(_tree(flat), "cpu", torch.float32, policy=pol)))
        f = cfg.moe_d_ff // tp
        for leaf, idx in (("w_in", np.s_[..., :f]), ("w_gate", np.s_[..., :f]),
                          ("w_out", np.s_[:, :, :f])):
            want = flat[f"blocks/moe/experts/{leaf}"][idx]
            assert want.shape[-1 if leaf != "w_out" else 2] == f
            np.testing.assert_array_equal(got[f"blocks/moe/experts/{leaf}"].numpy(), want)
        np.testing.assert_array_equal(got["blocks/moe/router"].numpy(), flat["blocks/moe/router"])
        with use_policy(pol):
            cache = model.init_cache(2, 8, device="cpu")
        assert cache["rows"] == 2 and "kv_seq_blocks" not in cache
        return
    if item is None:
        pol.check_model_split(cfg)
        with use_policy(pol):
            cache = model.init_cache(1, 8, device="cpu")
        assert cache["kv_seq_blocks"] == tp
        assert tuple(cache["kv"]["k"].shape) == (cfg.n_layers, 1, 8 // tp, cfg.n_kv_heads,
                                                 cfg.hd)
        return
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        make_prefill_step(model, pol)({}, {"tokens": toks})
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        with use_policy(pol):
            model.init_cache(1, 8, device="cpu")


def test_train_step_under_a_model_split_raises():
    """The train step under a model split raises for what items 12c.3b,
    12c.4b (the moe family, which serves split) and 12c.5 name, at
    construction; the dense split, with or without FSDP over ``data``
    (the reference's `make_policy`), with fewer KV heads than ranks or
    ``kv_seq_shard`` (a train step has no cache), and a policy that splits
    nothing over processes build a step."""
    for case in ("seq_parallel", "moe", "hybrid", "ssm"):
        arch, tp, kw, item = REFUSALS[case]
        item = TRAIN_REFUSALS.get(case, item)
        with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
            make_train_step(build_model(get_config(arch, smoke=True)), AdamWConfig(),
                            policy=_split_policy(tp, **kw))
    model = build_model(get_config(ARCH, smoke=True))
    grid = procmesh.ProcMesh({"data": 2, "model": 2}, 0, device="cpu")
    four = procmesh.ProcMesh({"model": 4}, 0, device="cpu")
    accepted = [_split_policy(tp, **kw) for case, (_, tp, kw, item) in sorted(REFUSALS.items())
                if item is None and case not in TRAIN_REFUSALS]
    for pol in (_split_policy(), make_policy(grid, model.cfg, SHAPES["train_4k"]),
                make_policy(four, model.cfg, SHAPES["train_4k"]), *accepted,
                ShardingPolicy(procmesh.ProcMesh({"model": 1}, 0, device="cpu"))):
        assert callable(make_train_step(model, AdamWConfig(), policy=pol))


def test_a_split_with_fsdp_is_accepted():
    """fsdp=True over the grid (12c.2): the model and its cache are
    accepted, and each rank's leaves are its 2-D blocks (``data`` x
    ``model``), the norm scales and the biases as their specs say."""
    cfg = get_config(ARCH, smoke=True)
    flat = _np_params("qwen")
    for r in range(NP):
        mesh = procmesh.ProcMesh(GRID, r, device="cpu")
        pol = make_policy(mesh, cfg, SHAPES["train_4k"])
        assert pol.fsdp and pol.splits_model and pol.gathers_data
        pol.check_model_split(cfg)
        with use_policy(pol):
            assert build_model(cfg).init_cache(1, 8, device="cpu")["kv"]["k"].shape[3] == 1
        d, m = mesh.coords
        got = dict(flatten(params_from_jax(_tree(flat), "cpu", torch.float32, policy=pol)))
        np.testing.assert_array_equal(got["blocks/attn/wq"].numpy(),
                                      flat["blocks/attn/wq"][:, 32 * d:32 * d + 32,
                                                             2 * m:2 * m + 2])
        np.testing.assert_array_equal(got["blocks/mlp/w_out"].numpy(),
                                      flat["blocks/mlp/w_out"][:, 64 * m:64 * m + 64,
                                                               32 * d:32 * d + 32])
        np.testing.assert_array_equal(got["tok/lm_head"].numpy(),
                                      flat["tok/lm_head"][32 * d:32 * d + 32,
                                                          128 * m:128 * m + 128])
        np.testing.assert_array_equal(got["blocks/attn/bq"].numpy(),
                                      flat["blocks/attn/bq"][:, 2 * m:2 * m + 2])
        np.testing.assert_array_equal(got["blocks/ln1/scale"].numpy(), flat["blocks/ln1/scale"])


def _collective_grads(mesh) -> dict:
    """Each collective of the split step in a function of whole tensors,
    computed with this rank's parts and again whole: the gradients (this
    rank's parts of them) of both.  Two ranks as the ``model`` axis, then
    as ``data``."""
    g = torch.Generator().manual_seed(7)
    x, a, b, v, w, c = (torch.randn(*s, generator=g, dtype=torch.float64)
                        for s in ((3, 4), (4, 6), (6, 4), (4, 10), (3, 4), (3, 10)))
    pol = ShardingPolicy(mesh.regrid({"model": 2}), fsdp=False)
    r = pol.model_rank
    cols, rows = slice(3 * r, 3 * r + 3), slice(5 * r, 5 * r + 5)

    def split(x, a_m, b_m, v_m):
        y = pol.all_reduce(pol.enter(x) @ a_m @ b_m)               # row-parallel pair
        logits = pol.all_gather(pol.enter(x) @ v_m, dim=-1)         # vocabulary-parallel
        return (y * w).sum() + (logits * c).sum()

    def whole(x, a, b, v):
        return (x @ a @ b * w).sum() + (x @ v * c).sum()

    out = {}
    parts = [t.clone().requires_grad_(True) for t in (x, a[:, cols], b[cols], v[:, rows])]
    out["model"] = [t.numpy() for t in torch.autograd.grad(split(*parts), parts)]
    full = [t.clone().requires_grad_(True) for t in (x, a, b, v)]
    gw = torch.autograd.grad(whole(*full), full)
    out["model_want"] = [t.numpy() for t in (gw[0], gw[1][:, cols], gw[2][cols],
                                             gw[3][:, rows])]

    # FSDP: each data rank its rows of x and its block of a's rows
    data = ShardingPolicy(mesh.regrid({"data": 2, "model": 1}))
    d = data.mesh.coords[0]
    xs = torch.cat([x, w])                                       # [6, 4]: 3 rows a rank
    a_d = a[2 * d:2 * d + 2].clone().requires_grad_(True)
    loss = ((xs[3 * d:3 * d + 3] @ data.gather_data(a_d, 0)) ** 2).sum()
    out["data"] = torch.autograd.grad(loss, a_d)[0].numpy()
    a_full = a.clone().requires_grad_(True)
    out["data_want"] = torch.autograd.grad(((xs @ a_full) ** 2).sum(), a_full)[0][
        2 * d:2 * d + 2].numpy()
    return out


def test_split_collectives_differentiate_as_the_whole_function():
    """The row-parallel sum (backward the identity), the column-parallel
    entry (backward the all-reduce), the vocabulary gather (backward the
    slice) and the FSDP gather (backward the reduce-scatter), in f64 on two
    CPU processes: each rank's gradients are its parts of the whole
    function's."""
    for res in procmesh.run(_collective_grads, 2, device="cpu", timeout=TIMEOUT):
        for got, want in zip(res["model"], res["model_want"]):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(res["data"], res["data_want"], rtol=1e-12, atol=1e-12)


def test_whole_weights_under_a_split_are_refused():
    """No fallback to whole weights: a rank given the whole leaves raises."""
    cfg = _cfg("qwen")
    model = build_model(cfg)
    params = params_from_jax(_tree(_np_params("qwen")), "cpu", torch.float32)
    with pytest.raises(ValueError, match="blocks"):
        make_prefill_step(model, _split_policy())(params, {
            "tokens": torch.zeros(1, 4, dtype=torch.int32)})


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
