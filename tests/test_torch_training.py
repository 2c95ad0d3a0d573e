"""The port's training stack against the JAX reference: AdamW and its
schedule, `make_train_step` on SmolLM, qwen3-moe and jamba SMOKE configs
(one step, and microbatches on SmolLM), `grad_cast_bf16`, checkpoints
written by one package and restored by the other, the heartbeat monitor;
and the port's own training contracts (loss decreases, bitwise resume,
remat, the pipeline, the launcher).

Held, with these tolerances:

  * `lr_at`, `clip_by_global_norm` and `adamw_update` over warmup and cosine
    steps on identical f32 params and grads: 1e-6 relative to each leaf's
    largest magnitude (f32 math in both; the order of a sum differs);
  * one train step, the params cast to f32 and the reference pipeline's
    batch: loss within 1e-4; grads and the first moment within 1e-4 of each
    leaf's largest magnitude; new params within 1e-5 wherever |g| exceeds
    1e-4 of the leaf's largest, and within 2 lr elsewhere (Adam's first
    step is lr * sign(g) there, and a tiny g may take either sign);
  * remat on against off, `grad_cast_bf16`, checkpoints, the heartbeat's
    decisions: exact.

The reference's `grad_cast_bf16` hands back a bf16 cotangent for an f32
input, which `jax.grad` cannot multiply into the next f32 op (ROADMAP §3),
so the child runs its f32 models with that function replaced by one that
rounds the cotangent to bf16 and keeps its dtype, the values the reference
function gives (held here on both dtypes against the unpatched function).
The reference runs in one child process through this file's own
``__main__`` branch.
"""

import json
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.ft.heartbeat import HeartbeatConfig, HeartbeatMonitor  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig, OptState, adamw_update, clip_by_global_norm, init_opt_state, lr_at,
    opt_state_from_jax, tree_leaves, tree_map)
from repro_torch.train.train_step import (  # noqa: E402
    StepConfig, loss_and_grads, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
B, S = 2, 16                                    # the train-step batch
STEP_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
OPT_CFG = dict(lr=1e-2, warmup_steps=3, total_steps=10)
N_OPT_STEPS = 8                                 # 3 warmup + 5 cosine
LR_STEPS = list(range(13))
CLIP = 0.5
OPT_REL, LOSS_TOL, GRAD_REL, PARAM_TOL = 1e-6, 1e-4, 1e-4, 1e-5
STAT_BATCH = (256, 512, 8)                      # V, S, B of the pipeline statistics
CODECS = ("zstd", "zlib")


# --------------------------------------------------------- shared inputs
def _opt_inputs():
    """An f32 params tree and one grads tree a step, from numpy."""
    rng = np.random.default_rng(11)
    shapes = {"a": (4, 6), "b": (5,), "c": {"d": (3, 2, 2), "e": (7,)}}

    def make_tree(sh, scale):
        if isinstance(sh, dict):
            return {k: make_tree(v, scale) for k, v in sh.items()}
        return (rng.standard_normal(sh) * scale).astype(np.float32)

    params = make_tree(shapes, 1.0)
    grads = [make_tree(shapes, 0.3 * (i + 1)) for i in range(N_OPT_STEPS)]
    return params, grads


def _ckpt_inputs():
    """bf16 params (their bit patterns), f32 moments and an int32 step."""
    rng = np.random.default_rng(12)

    def bf16_bits(shape):
        f = rng.standard_normal(shape).astype(np.float32)
        return (f.view(np.uint32) >> 16).astype(np.uint16)

    params = {"tok": {"embed": bf16_bits((6, 4))}, "blocks": {"w": bf16_bits((2, 3, 4)),
                                                              "ln": bf16_bits((2, 4))}}
    mu = {"tok": {"embed": rng.standard_normal((6, 4)).astype(np.float32)},
          "blocks": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32),
                     "ln": rng.standard_normal((2, 4)).astype(np.float32)}}
    nu = {k: {kk: np.abs(vv) for kk, vv in v.items()} for k, v in mu.items()}
    return params, mu, nu, 7


def _grad_cast_inputs():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    ct = (rng.standard_normal((5, 7)) * np.pi).astype(np.float32)
    return x, ct


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


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as jckpt
    from repro.configs import get_config as jget
    from repro.data.pipeline import DataConfig as JData, SyntheticTokenPipeline as JPipe
    from repro.models import build_model as jbuild
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.train import optimizer as jopt
    from repro.train.train_step import StepConfig as JStep, make_train_step as jmake

    out = {}
    f32 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731

    # AdamW, its schedule and the clip
    params, grads = _opt_inputs()
    cfg = jopt.AdamWConfig(**OPT_CFG)
    for s in LR_STEPS:
        out[f"lr/{s}"] = jopt.lr_at(cfg, jnp.int32(s))
    clipped, norm = jopt.clip_by_global_norm(f32(grads[0]), CLIP)
    out["clip/norm"] = norm
    for k, v in _flat(clipped).items():
        out[f"clip/{k}"] = v
    p, st = f32(params), jopt.init_opt_state(f32(params))
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(cfg, p, g, s))
    for i in range(N_OPT_STEPS):
        p, st, om = upd(p, f32(grads[i]), st)
        for name, t in (("p", p), ("mu", st.mu), ("nu", st.nu)):
            for k, v in _flat(t).items():
                out[f"adamw/{i}/{name}/{k}"] = v
        out[f"adamw/{i}/gnorm"], out[f"adamw/{i}/lr"] = om["grad_norm"], om["lr"]

    # grad_cast_bf16 as the reference defines it, on f32 and bf16 cotangents
    x, ct = _grad_cast_inputs()
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        _, vjp = jax.vjp(JL.grad_cast_bf16, jnp.asarray(x, dt))
        (g,) = vjp(jnp.asarray(ct, dt))
        out[f"gc/{name}"], out[f"gc/{name}/dtype"] = g.astype(jnp.float32), np.array(str(g.dtype))

    # f32 models: a cotangent rounded to bf16, in the cotangent's own dtype
    @jax.custom_vjp
    def grad_cast_keep_dtype(x):
        return x

    grad_cast_keep_dtype.defvjp(
        lambda x: (x, None), lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    JL.grad_cast_bf16 = grad_cast_keep_dtype

    for arch in ARCHS:
        c = jget(arch, smoke=True)
        model = jbuild(c)
        params = model.init(jax.random.PRNGKey(0))
        for k, v in _flat(params).items():
            out[f"model/{arch}/params/{k}"] = v.astype(jnp.float32)
        p = f32(params)
        batch = JPipe(JData(c.vocab_size, S, B)).batch_at(0)
        out[f"model/{arch}/tokens"], out[f"model/{arch}/labels"] = (
            batch["tokens"], batch["labels"])

        def loss_fn(p, b, model=model):
            JT.set_remat(True)
            res = model.loss(p, b)
            JT.set_remat(False)
            return res

        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, _), g = vg(p, batch)
        out[f"model/{arch}/loss"] = loss
        for k, v in _flat(g).items():
            out[f"model/{arch}/grads/{k}"] = v
        runs = [("step", 1)] + ([("micro", 2)] if arch == "smollm-360m" else [])
        for name, n in runs:
            step = jax.jit(jmake(model, jopt.AdamWConfig(**STEP_CFG), JStep(n_microbatches=n)))
            p2, st2, met = step(p, jopt.init_opt_state(p), batch)
            out[f"model/{arch}/{name}/loss"] = met["loss"]
            out[f"model/{arch}/{name}/lr"] = met["lr"]
            out[f"model/{arch}/{name}/gnorm"] = met["grad_norm"]
            for k, v in _flat(p2).items():
                out[f"model/{arch}/{name}/params/{k}"] = v
            for k, v in _flat(st2.mu).items():
                out[f"model/{arch}/{name}/mu/{k}"] = v
            if name == "step" and arch == ARCHS[0]:
                # a second step from this state, on the next batch
                b2 = JPipe(JData(c.vocab_size, S, B)).batch_at(1)
                (_, _), g2 = vg(p2, b2)
                p3, st3, met3 = step(p2, st2, b2)
                sec = f"model/{arch}/second"
                out[f"{sec}/tokens"], out[f"{sec}/labels"] = b2["tokens"], b2["labels"]
                out[f"{sec}/step"] = st2.step
                out[f"{sec}/loss"], out[f"{sec}/lr"] = met3["loss"], met3["lr"]
                out[f"{sec}/gnorm"] = met3["grad_norm"]
                for tname, t in (("start", p2), ("start_mu", st2.mu), ("start_nu", st2.nu),
                                 ("grads", g2), ("params", p3), ("mu", st3.mu)):
                    for k, v in _flat(t).items():
                        out[f"{sec}/{tname}/{k}"] = v

    # the pipeline's statistics on a larger batch
    V, Sq, Bt = STAT_BATCH
    out["pipe/tokens"] = JPipe(JData(V, Sq, Bt)).batch_at(0)["tokens"]

    # checkpoints: the reference writes both codecs, and restores the port's
    cp, mu, nu, step = _ckpt_inputs()
    bf = lambda t: jax.tree.map(  # noqa: E731
        lambda u: jax.lax.bitcast_convert_type(jnp.asarray(u), jnp.bfloat16), t)
    tree = (bf(cp), jopt.OptState(jnp.int32(step), f32(mu), f32(nu)))
    zstd = jckpt.zstandard
    for codec in CODECS if zstd is not None else ("zlib",):
        jckpt.zstandard = zstd if codec == "zstd" else None
        jckpt.CheckpointManager(str(d / f"ref_{codec}")).save(
            step, tree, extra={"step": step, "by": "repro"}, blocking=True)
        restored, extra = jckpt.CheckpointManager(str(d / f"port_{codec}")).restore(tree)
        for k, v in jckpt._flatten(restored)[0]:
            a = np.asarray(v)
            out[f"ckpt/{codec}/{k}"] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        out[f"ckpt/{codec}/extra"] = np.array(json.dumps(extra, sort_keys=True))
    jckpt.zstandard = zstd

    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})


def _port_ckpt_tree(device="cpu"):
    cp, mu, nu, step = _ckpt_inputs()

    def bf(u):
        return torch.from_numpy(u.view(np.int16).copy()).view(torch.bfloat16).to(device)

    def f(a):
        return torch.from_numpy(a.copy()).to(device)

    return (tree_map(bf, cp), OptState(torch.tensor(step, dtype=torch.int32),
                                       tree_map(f, mu), tree_map(f, nu)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("training_ref")
    # the port writes its checkpoints first, for the child to restore
    zstd = ckpt_mod.zstandard
    try:
        for codec in CODECS:
            if codec == "zstd" and zstd is None:
                continue
            ckpt_mod.zstandard = zstd if codec == "zstd" else None
            ckpt_mod.CheckpointManager(d / f"port_{codec}").save(
                7, _port_ckpt_tree(), extra={"step": 7, "by": "repro_torch"}, blocking=True)
    finally:
        ckpt_mod.zstandard = zstd
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return d, dict(np.load(d / "out.npz"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _close(got: torch.Tensor, want: np.ndarray, rel: float, what: str) -> None:
    want = np.asarray(want, np.float64)
    tol = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got.detach().double().numpy() - want).max() if want.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# --------------------------------------------------------------- AdamW
def test_lr_at_matches_reference(reference):
    _, ref = reference
    cfg = AdamWConfig(**OPT_CFG)
    for s in LR_STEPS:
        got = lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, ref[f"lr/{s}"], OPT_REL, f"lr_at({s})")


def test_clip_by_global_norm_matches_reference(reference):
    _, ref = reference
    _, grads = _opt_inputs()
    clipped, norm = clip_by_global_norm(tree_map(_t, grads[0]), CLIP)
    _close(norm, ref["clip/norm"], OPT_REL, "global norm")
    for k, v in _flat(clipped).items():
        _close(v, ref[f"clip/{k}"], OPT_REL, f"clipped {k}")


@pytest.mark.parametrize("i", range(N_OPT_STEPS))
def test_adamw_update_matches_reference(reference, i):
    """Steps 0-2 are warmup, 3-7 cosine; the state is carried from step 0."""
    _, ref = reference
    params, grads = _opt_inputs()
    cfg = AdamWConfig(**OPT_CFG)
    p = tree_map(_t, params)
    st = init_opt_state(p)
    for j in range(i + 1):
        p, st, om = adamw_update(cfg, p, tree_map(_t, grads[j]), st)
    assert int(st.step) == i + 1 and st.step.dtype == torch.int32
    _close(om["lr"], ref[f"adamw/{i}/lr"], OPT_REL, "lr")
    _close(om["grad_norm"], ref[f"adamw/{i}/gnorm"], OPT_REL, "grad norm")
    for name, t in (("p", p), ("mu", st.mu), ("nu", st.nu)):
        for k, v in _flat(t).items():
            assert v.dtype == torch.float32
            _close(v, ref[f"adamw/{i}/{name}/{k}"], OPT_REL, f"step {i} {name} {k}")


# ----------------------------------------------------------- train step
def _model(ref, arch):
    cfg = get_config(arch, smoke=True)
    prefix = f"model/{arch}/params/"
    np_params = _tree({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})
    batch = {"tokens": _t(ref[f"model/{arch}/tokens"]), "labels": _t(ref[f"model/{arch}/labels"])}
    return build_model(cfg), params_from_jax(np_params, device="cpu", dtype=torch.float32), batch


def _check_step(ref, arch, name, grads_ref, new_params, mu, met):
    lr = float(ref[f"model/{arch}/{name}/lr"])
    _close(met["lr"], ref[f"model/{arch}/{name}/lr"], OPT_REL, "lr")
    assert abs(float(met["loss"]) - float(ref[f"model/{arch}/{name}/loss"])) <= LOSS_TOL
    _close(met["grad_norm"], ref[f"model/{arch}/{name}/gnorm"], GRAD_REL, "grad norm")
    for k, v in _flat(new_params).items():
        want = ref[f"model/{arch}/{name}/params/{k}"]
        g = np.abs(grads_ref[k])
        big = g > GRAD_REL * g.max()
        err = np.abs(v.double().numpy() - want)
        assert err[big].max(initial=0.0) <= PARAM_TOL, f"{name} {k}: {err[big].max()}"
        assert err[~big].max(initial=0.0) <= 2 * lr, f"{name} {k}: {err[~big].max()}"
    for k, v in _flat(mu).items():
        _close(v, ref[f"model/{arch}/{name}/mu/{k}"], GRAD_REL, f"{name} mu {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(reference, arch):
    _, ref = reference
    model, params, batch = _model(ref, arch)
    loss, met, grads = loss_and_grads(model, params, batch, remat=True)
    assert abs(float(loss) - float(ref[f"model/{arch}/loss"])) <= LOSS_TOL
    grads_ref = {k[len(f"model/{arch}/grads/"):]: v for k, v in ref.items()
                 if k.startswith(f"model/{arch}/grads/")}
    assert set(grads_ref) == set(_flat(grads))
    for k, v in _flat(grads).items():
        assert v.dtype == torch.float32
        _close(v, grads_ref[k], GRAD_REL, f"grad {k}")
    step = make_train_step(model, AdamWConfig(**STEP_CFG), StepConfig())
    p2, st2, m = step(params, init_opt_state(params), batch)
    _check_step(ref, arch, "step", grads_ref, p2, st2.mu, m)
    for k, v in _flat(params).items():     # the update is functional
        np.testing.assert_array_equal(v.numpy(), ref[f"model/{arch}/params/{k}"])


def _sub(ref, prefix):
    return _tree({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})


def test_train_step_from_reference_state_matches_reference(reference):
    """The second step of SmolLM, both packages starting from the reference's
    params and AdamW state after its first step (`opt_state_from_jax`)."""
    _, ref = reference
    arch = "smollm-360m"
    sec = f"model/{arch}/second"
    model = build_model(get_config(arch, smoke=True))
    params = params_from_jax(_sub(ref, f"{sec}/start/"), device="cpu", dtype=torch.float32)
    state = opt_state_from_jax(ref[f"{sec}/step"], _sub(ref, f"{sec}/start_mu/"),
                               _sub(ref, f"{sec}/start_nu/"), device="cpu")
    assert int(state.step) == 1
    batch = {"tokens": _t(ref[f"{sec}/tokens"]), "labels": _t(ref[f"{sec}/labels"])}
    step = make_train_step(model, AdamWConfig(**STEP_CFG), StepConfig())
    p3, st3, m = step(params, state, batch)
    assert int(st3.step) == 2
    grads_ref = _flat(_sub(ref, f"{sec}/grads/"))
    _check_step(ref, arch, "second", grads_ref, p3, st3.mu, m)


def test_train_step_microbatches_match_reference(reference):
    _, ref = reference
    arch = "smollm-360m"
    model, params, batch = _model(ref, arch)
    grads_ref = {k[len(f"model/{arch}/grads/"):]: v for k, v in ref.items()
                 if k.startswith(f"model/{arch}/grads/")}
    step = make_train_step(model, AdamWConfig(**STEP_CFG), StepConfig(n_microbatches=2))
    p2, st2, m = step(params, init_opt_state(params), batch)
    assert float(m["aux"]) == 0.0 and float(m["nll"]) == float(m["loss"])
    _check_step(ref, arch, "micro", grads_ref, p2, st2.mu, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_no_remat(reference, arch):
    _, ref = reference
    model, params, batch = _model(ref, arch)
    l0, met0, g0 = loss_and_grads(model, params, batch, remat=False)
    l1, met1, g1 = loss_and_grads(model, params, batch, remat=True)
    assert torch.equal(l0, l1) and all(torch.equal(met0[k], met1[k]) for k in met0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps(reference):
    _, ref = reference
    model, params, batch = _model(ref, "smollm-360m")
    logits = make_prefill_step(model)(params, batch)
    with torch.no_grad():
        assert torch.equal(logits, model.forward_logits(params, batch).logits)
        cache = model.init_cache(B, 2 * S, device="cpu")
        _, cache = model.prefill(params, batch["tokens"], cache)
        tok = batch["labels"][:, -1]
        want, _ = model.decode_step(params, tok, {**cache, "kv": tree_map(
            torch.clone, cache["kv"])})
    got, cache2 = make_serve_step(model)(params, tok, cache)
    assert torch.equal(got, want) and int(cache2["len"]) == S + 1


# ------------------------------------------------------- grad_cast_bf16
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grad_cast_bf16_matches_reference(reference, dtype):
    """The cotangent's values equal the reference function's.  For an f32
    input the reference returns them as bf16; autograd hands them back in
    the input's dtype."""
    _, ref = reference
    x, ct = _grad_cast_inputs()
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    xt = _t(x).to(dt).requires_grad_(True)
    y = L.grad_cast_bf16(xt)
    assert torch.equal(y, xt)
    y.backward(_t(ct).to(dt))
    assert xt.grad.dtype == dt and str(ref[f"gc/{dtype}/dtype"]) == "bfloat16"
    np.testing.assert_array_equal(xt.grad.float().numpy(), ref[f"gc/{dtype}"])
    if dtype == "f32":      # the values really were rounded
        assert not np.array_equal(ref["gc/f32"], ct)
    with torch.no_grad():
        assert L.grad_cast_bf16(xt) is xt


# ---------------------------------------------------------- checkpoints
def _skip_absent(codec):
    if codec == "zstd" and ckpt_mod.zstandard is None:
        pytest.skip("zstandard is not installed")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def _want_bits():
    cp, mu, nu, step = _ckpt_inputs()
    return {**{f"0/{k}": v for k, v in _flat(cp).items()}, "1/.step": np.int32(step),
            **{f"1/.mu/{k}": v for k, v in _flat(mu).items()},
            **{f"1/.nu/{k}": v for k, v in _flat(nu).items()}}


@pytest.mark.parametrize("codec", CODECS)
def test_reference_checkpoint_restores_in_port(reference, codec):
    _skip_absent(codec)
    d, _ = reference
    like = tree_map(torch.zeros_like, _port_ckpt_tree()[0]), OptState(
        torch.zeros((), dtype=torch.int32), *(tree_map(torch.zeros_like, t)
                                              for t in _port_ckpt_tree()[1][1:]))
    mgr = ckpt_mod.CheckpointManager(d / f"ref_{codec}")
    assert mgr.latest_step() == 7
    tree, extra = mgr.restore(like)
    assert extra == {"step": 7, "by": "repro"}
    manifest = json.loads((d / f"ref_{codec}" / "step_00000007" / "manifest.json").read_text())
    assert manifest["codec"] == codec
    want = _want_bits()
    got = dict(ckpt_mod.flatten(tree))
    assert [a["key"] for a in manifest["arrays"]] == [k for k, _ in ckpt_mod.flatten(tree)]
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == dict(ckpt_mod.flatten(like))[k].dtype
        np.testing.assert_array_equal(_bits(v), want[k], err_msg=k)


@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_in_reference(reference, codec):
    _skip_absent(codec)
    d, ref = reference
    want = _want_bits()
    for k, v in want.items():
        got = ref[f"ckpt/{codec}/{k}"]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    assert json.loads(str(ref[f"ckpt/{codec}/extra"])) == {"step": 7, "by": "repro_torch"}


@pytest.mark.parametrize("codec", CODECS)
def test_checkpoint_format_matches_reference(reference, codec):
    """The same tree gives the same manifest and the same payload bytes."""
    _skip_absent(codec)
    d, _ = reference

    def read(path):
        manifest = json.loads((path / "manifest.json").read_text())
        raw = (path / "data.msgpack.zst").read_bytes()
        if codec == "zlib":
            payload = zlib.decompress(raw)
        else:
            payload = ckpt_mod.zstandard.ZstdDecompressor().decompressobj().decompress(raw)
        return {k: v for k, v in manifest.items() if k != "extra"}, payload

    assert read(d / f"port_{codec}" / "step_00000007") == read(
        d / f"ref_{codec}" / "step_00000007")


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65535, 65536, 70000])
def test_bin_framing_matches_msgpack(n):
    msgpack = pytest.importorskip("msgpack")
    data = bytes(range(256)) * (n // 256) + bytes(n % 256)
    packed = ckpt_mod.pack_bin(data)
    assert packed == msgpack.packb(data)
    import io

    assert ckpt_mod.unpack_bin(io.BytesIO(packed)) == data


def test_checkpoint_keeps_the_newest_three_and_refuses_missing_zstd(tmp_path, monkeypatch):
    mgr = ckpt_mod.CheckpointManager(tmp_path)
    tree = _port_ckpt_tree()
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, tree, extra={"step": s})
    mgr.wait()
    assert mgr.list_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not [p for p in os.listdir(tmp_path) if p.startswith("tmp.")]
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    if manifest["codec"] == "zstd":
        with pytest.raises(RuntimeError, match="zstandard not installed"):
            mgr.restore(tree)
    mgr.save(6, tree, extra={"step": 6}, blocking=True)
    restored, extra = mgr.restore(tree)
    assert extra == {"step": 6}
    for a, b in zip(ckpt_mod.flatten(restored), ckpt_mod.flatten(tree)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


# ------------------------------------------------------------ heartbeat
def test_heartbeat_matches_reference():
    """Dead and straggler sets, the fleet median and the healthy nodes of
    both monitors, driven by one injected clock through the same beats."""
    from repro.ft.heartbeat import (HeartbeatConfig as JCfg,
                                    HeartbeatMonitor as JMon)

    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    kw = dict(timeout_s=5.0, straggler_factor=2.0, straggler_patience=2)
    ours, theirs = HeartbeatMonitor(4, HeartbeatConfig(**kw), clock), JMon(4, JCfg(**kw), clock)
    rng = np.random.default_rng(3)
    seen_dead, seen_strag = set(), set()
    for tick in range(40):
        now[0] += 0.5
        for node in range(4):
            if node == 3 and tick >= 12:          # node 3 dies at tick 12
                continue
            every = 3 if node == 2 and tick >= 20 else 1   # node 2 slows down
            if tick % every == 0:
                step = tick // every + int(rng.integers(0, 2))
                ours.beat(node, step)
                theirs.beat(node, step)
        got = (ours.check_dead(), ours.check_stragglers(), ours.fleet_p50(),
               ours.healthy_nodes())
        want = (theirs.check_dead(), theirs.check_stragglers(), theirs.fleet_p50(),
                theirs.healthy_nodes())
        assert got == want, (tick, got, want)
        seen_dead |= got[0]
        seen_strag |= got[1]
    assert seen_dead == {3} and 2 in seen_strag


# ------------------------------------------------ the port's own training
def _smoke_setup(device="cpu"):
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=device)
    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, 32, 4), device=device)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                           StepConfig())
    return model, params, pipe, step


def _trainer(d, steps, pipe, step, params):
    return Trainer(step, params, pipe,
                   TrainerConfig(total_steps=steps, ckpt_every=5, log_every=1, ckpt_dir=str(d)),
                   ckpt=ckpt_mod.CheckpointManager(d))


def test_loss_decreases():
    _, params, pipe, step = _smoke_setup()
    opt = init_opt_state(params)
    losses = []
    for i in range(25):
        params, opt, m = step(params, opt, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert int(opt.step) == 25


def test_resume_is_bitwise_deterministic(tmp_path):
    """Kill at step 7, resume from the step-5 checkpoint, arrive at the same
    step-10 params as the uninterrupted run."""
    _, params0, pipe, step = _smoke_setup()
    t = _trainer(tmp_path / "a", 10, pipe, step, tree_map(torch.clone, params0))
    t.run()
    t1 = _trainer(tmp_path / "b", 7, pipe, step, tree_map(torch.clone, params0))
    t1.run()                                    # "crashes" after step 7
    assert t1.ckpt.list_steps() == [5, 7]
    t2 = _trainer(tmp_path / "b", 10, pipe, step, tree_map(torch.clone, params0))
    assert t2.maybe_resume()
    assert t2.step in (5, 7)
    t2.run()
    for a, b in zip(tree_leaves(t.params), tree_leaves(t2.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(t.opt_state.mu), tree_leaves(t2.opt_state.mu)):
        assert torch.equal(a, b)
    assert int(t2.opt_state.step) == 10


def test_opt_state_from_jax():
    params = {"tok": {"embed": np.ones((3, 2), np.float32)},
              "blocks": {"moe": {"router": np.zeros((2, 2), np.float32)}}}
    st = opt_state_from_jax(np.int32(4), params, params, device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 4
    for leaf in tree_leaves(st.mu) + tree_leaves(st.nu):
        assert leaf.dtype == torch.float32


# ------------------------------------------------------------- pipeline
def test_pipeline_is_deterministic_and_seekable():
    cfg = DataConfig(256, 32, 4, seed=5)
    a, b = SyntheticTokenPipeline(cfg, device="cpu"), SyntheticTokenPipeline(cfg, device="cpu")
    it = iter(a)
    for s in range(4):
        x = next(it)
        for k in ("tokens", "labels"):
            assert torch.equal(x[k], b.batch_at(s)[k])
            assert x[k].dtype == torch.int32 and x[k].shape == (4, 32)
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    other = SyntheticTokenPipeline(DataConfig(256, 32, 4, seed=6), device="cpu")
    assert not torch.equal(a.batch_at(0)["tokens"], other.batch_at(0)["tokens"])
    shards = [SyntheticTokenPipeline(DataConfig(256, 32, 4, n_shards=2, shard_id=i),
                                     device="cpu").batch_at(0)["tokens"] for i in range(2)]
    assert shards[0].shape == (2, 32) and not torch.equal(shards[0], shards[1])
    with pytest.raises(ValueError):
        SyntheticTokenPipeline(DataConfig(256, 32, 3, n_shards=2), device="cpu")


def test_pipeline_statistics_match_reference(reference):
    """Different bits by design, the same distribution: the most frequent
    tokens' shares and the share of 'previous + 1' tokens agree."""
    _, ref = reference
    V, Sq, Bt = STAT_BATCH
    want = ref["pipe/tokens"].astype(np.int64)
    got = SyntheticTokenPipeline(DataConfig(V, Sq, Bt), device="cpu").batch_at(0)[
        "tokens"].numpy().astype(np.int64)

    def stats(t):
        counts = np.bincount(t.ravel(), minlength=V) / t.size
        follow = np.mean(t[:, 1:] == (t[:, :-1] + 1) % V)
        return counts[:4], follow

    (cg, fg), (cw, fw) = stats(got), stats(want)
    assert np.all(np.abs(cg - cw) < 0.02), (cg, cw)
    assert abs(fg - fw) < 0.03 and fg > 0.2, (fg, fw)


# ------------------------------------------------------------- launcher
def test_launch_train_smoke(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    history = launch_train.main(args)
    assert [r["step"] for r in history] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in history)
    assert ckpt_mod.CheckpointManager(tmp_path).list_steps() == [2, 4]
    history = launch_train.main(args[:4] + ["6"] + args[5:] + ["--resume"])
    assert "resumed at step 4" in capsys.readouterr().out
    assert [r["step"] for r in history] == [5, 6]
    assert L._ATTN_BACKEND[0] == "torch"


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
