"""The port's ssm family (xLSTM: mLSTM and sLSTM blocks) against the JAX
reference, on the xlstm-1.3b SMOKE config (one period of 7 mLSTM blocks and
one sLSTM block), built from the reference's own params through
`params_from_jax`.

Both packages run the port's own seeded SMOKE weights, cast to f32 (the
reference code runs unchanged; its sLSTM ``h`` stays bf16 in the cache),
so that they compute the same thing up to f32 rounding; the params'
structure, shapes and dtypes are held to the reference's `init`.  Held,
with these tolerances:

  * `Model.forward_logits` and `Model.loss`: logits within 1e-3, loss
    within 1e-4;
  * cached prefill + greedy decode: the tokens equal, logits within 1e-3;
  * the state after a prefill of 9 tokens, mLSTM ``C, n, m`` and sLSTM
    ``c, n, h, m``, and after a second prefill of 9 into the same cache
    (with its logits, 1e-3): within 1e-4 of max(1, the leaf's largest
    magnitude; the sLSTM ``n`` grows to ~5), on a cache whose sLSTM ``h`` is
    f32 in both packages (a bf16 ``h`` rounds each step, and an f32
    rounding difference now and then flips one of those roundings);
  * one f32 train step's grads (remat on): within 1e-4 of each leaf's
    largest magnitude, as `test_torch_training.py` holds them, but for the
    sLSTM's input-gate bias ``b_i``: the stabilised state is unchanged by
    a shift of every input gate (c and n scale together), so its gradient
    is rounding noise in both packages (~1e-12), held below 1e-8 of the
    largest gradient;
  * `mlstm_prefill` at S = 100 (two chunks, the second padded): with one
    head against the reference's `mlstm_prefill` (output and state); with
    two heads against the reference's own recurrent `mlstm_decode` run
    token by token, within 1e-4 relative to the output's largest
    magnitude.  The reference's chunkwise prefill reassembles its chunks'
    outputs out of order once there is more than one head and more than
    one chunk (ROADMAP §3); the child records how far it is from its own
    recurrence there, so the fault stays visible.

Port-only: the `ServeEngine` on the port's own SMOKE weights cast to f32,
every request equal to its solo run, a recycled lane included; the lane
reset writes `init_cache`'s sLSTM ``m`` (-1e30), not 0; the training
launcher trains the family and cuts depth in whole periods.  The reference
runs in a child process through this file's own ``__main__`` branch.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import transformer as MT  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCH = "xlstm-1.3b"
B, S, PLEN, N_DECODE, MAX_SEQ = 2, 29, 9, 4, 48
LOGIT_TOL, LOSS_TOL, STATE_TOL, GRAD_REL = 1e-3, 1e-4, 1e-4, 1e-4
ZERO_GRAD = 1e-8                    # of the largest grad: a leaf the loss does not depend on
UNIT_S, UNIT_D = 100, 16            # mlstm_prefill over two chunks, the second padded
STATE = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(25).integers(0, vocab, (B, S)).astype(np.int32)


def _unit_x() -> np.ndarray:
    return np.random.default_rng(26).standard_normal((B, UNIT_S, UNIT_D)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _sub(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _port_params() -> dict:
    """The port's own seeded weights for SMOKE and for one mLSTM block of
    width UNIT_D with 1 and 2 heads, as f32 numpy: the child runs the
    reference on these, so that it need not compile the reference's init."""
    cfg = get_config(ARCH, smoke=True)
    out = {f"params/{k}": v for k, v in _flat(build_model(cfg).init(0, device="cpu")).items()}
    for nh in (1, 2):
        gen = torch.Generator().manual_seed(nh)
        out.update({f"unit{nh}/params/{k}": v
                    for k, v in XL.init_mlstm(gen, UNIT_D, nh, torch.float32, "cpu").items()})
    return {k: v.float().numpy() for k, v in out.items()}


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.models import xlstm as JX

    @jax.custom_vjp
    def grad_cast_keep_dtype(x):        # tests/test_torch_training.py's patch
        return x

    grad_cast_keep_dtype.defvjp(
        lambda x: (x, None), lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    JL.grad_cast_bf16 = grad_cast_keep_dtype

    def state(cache):
        return {f"{blk}/{k}": cache[blk][k].astype(jnp.float32)
                for blk, keys in STATE.items() for k in keys}

    def f32_h(cache):                   # the sLSTM h in f32: no bf16 rounding to flip
        return {**cache, "slstm": {**cache["slstm"],
                                   "h": cache["slstm"]["h"].astype(jnp.float32)}}

    given = dict(np.load(d / "params.npz"))
    out = {}
    cfg = jget(ARCH, smoke=True)
    model = jbuild(cfg)
    for key, leaf in _flat(jax.eval_shape(model.init, jax.random.PRNGKey(0))).items():
        out[f"shape/{key}"] = np.array(f"{tuple(leaf.shape)} {leaf.dtype}")
    p = jax.tree.map(jnp.asarray, _tree(_sub(given, "params/")))
    toks = jnp.asarray(_tokens(cfg.vocab_size))
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}

    def loss_fn(p, b):
        JT.set_remat(True)
        (loss, _), logits = model.loss(p, b), model.forward_logits(p, b).logits
        JT.set_remat(False)
        return loss, logits

    (out["loss"], out["logits"]), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        p, batch)
    out.update({f"grads/{k}": v for k, v in _flat(g).items()})

    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    logits, cache = prefill(p, toks[:, :PLEN], model.init_cache(B, MAX_SEQ))
    steps, tokens = [logits], []
    for _ in range(N_DECODE):
        tok = jnp.argmax(logits, -1)
        tokens.append(tok)
        logits, cache = decode(p, tok, cache)
        steps.append(logits)
    out["steps"], out["tokens"] = jnp.stack(steps), jnp.stack(tokens)
    _, cache = prefill(p, toks[:, :PLEN], f32_h(model.init_cache(B, MAX_SEQ)))
    out.update({f"prefill/{k}": v for k, v in state(cache).items()})
    out["chunked_logits"], cache = prefill(p, toks[:, PLEN:2 * PLEN], cache)
    out.update({f"chunked/{k}": v for k, v in state(cache).items()})

    x = jnp.asarray(_unit_x())
    for nh in (1, 2):
        mp = {k: jnp.asarray(v) for k, v in _sub(given, f"unit{nh}/params/").items()}
        y, st = jax.jit(JX.mlstm_prefill)(mp, x, JX.init_mlstm_state(B, UNIT_D, nh))
        out[f"unit{nh}/chunkwise"] = y
        out.update({f"unit{nh}/{k}": v for k, v in st.items()})
        step = jax.jit(JX.mlstm_decode)
        st, ys = JX.init_mlstm_state(B, UNIT_D, nh), []
        for t in range(UNIT_S):
            yt, st = step(mp, x[:, t:t + 1], st)
            ys.append(yt)
        out[f"unit{nh}/recurrent"] = jnp.concatenate(ys, axis=1)
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("xlstm_ref")
    given = _port_params()
    np.savez(d / "params.npz", **given)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return {**given, **dict(np.load(d / "out.npz"))}


@pytest.fixture(scope="module")
def port(reference):
    cfg = get_config(ARCH, smoke=True)
    params = params_from_jax(_tree(_sub(reference, "params/")), device="cpu",
                             dtype=torch.float32)
    return cfg, build_model(cfg), params


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0, err_msg=what)


def _check_state(cache, ref: dict, prefix: str) -> None:
    for blk, keys in STATE.items():
        for k in keys:
            want = ref[f"{prefix}/{blk}/{k}"]
            _close(cache[blk][k], want, STATE_TOL * max(1.0, float(np.abs(want).max())),
                   f"{blk}/{k}")
    assert cache["mlstm"]["C"].abs().max() > 0 and cache["slstm"]["c"].abs().max() > 0


def _f32_h_cache(model):
    """A cache whose sLSTM h is f32, in both packages: with the bf16 h of
    `init_cache`, an f32 rounding difference now and then flips one bf16
    rounding of h, which the recurrence then carries (~4e-4 in c)."""
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    cache["slstm"]["h"] = cache["slstm"]["h"].float()
    return cache


# ------------------------------------------------------------------ tests
def test_init_matches_the_reference_shapes_and_dtypes(reference, port):
    cfg, _, _ = port
    want = _sub(reference, "shape/")
    got = _flat(MT.init_lm(cfg, None, "meta"))
    assert set(got) == set(want)
    for k, v in got.items():
        assert f"{tuple(v.shape)} {str(v.dtype).replace('torch.', '')}" == str(want[k]), k


def test_forward_logits_and_loss(reference, port):
    cfg, model, params = port
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = model.forward_logits(params, batch)
    assert out.logits.shape == (B, S, cfg.vocab_size)
    _close(out.logits, reference["logits"], LOGIT_TOL)
    loss, _ = model.loss(params, batch)
    assert abs(float(loss) - float(reference["loss"])) < LOSS_TOL


def test_prefill_and_decode(reference, port):
    cfg, model, params = port
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    logits, cache = model.prefill(params, torch.from_numpy(_tokens(cfg.vocab_size)[:, :PLEN]),
                                  cache)
    steps = [logits]
    for i in range(N_DECODE):
        tok = torch.argmax(logits, -1)
        assert tok.tolist() == reference["tokens"][i].tolist(), i
        logits, cache = model.decode_step(params, tok, cache)
        steps.append(logits)
    _close(torch.stack(steps), reference["steps"], LOGIT_TOL)
    assert int(cache["len"]) == PLEN + N_DECODE


def test_prefill_state_and_chunked_prefill(reference, port):
    cfg, model, params = port
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    _, cache = model.prefill(params, toks[:, :PLEN], _f32_h_cache(model))
    _check_state(cache, reference, "prefill")
    logits, cache = model.prefill(params, toks[:, PLEN:2 * PLEN], cache)
    _close(logits, reference["chunked_logits"], LOGIT_TOL)
    _check_state(cache, reference, "chunked")
    assert int(cache["len"]) == 2 * PLEN


def test_train_step_grads(reference, port):
    cfg, model, params = port
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    loss, _, grads = loss_and_grads(model, params, {"tokens": toks, "labels": toks.roll(-1, 1)},
                                    remat=True)
    assert abs(float(loss) - float(reference["loss"])) < LOSS_TOL
    want = _sub(reference, "grads/")
    got = _flat(grads)
    assert set(got) == set(want)
    floor = ZERO_GRAD * max(float(np.abs(g).max()) for g in want.values())
    zero = []
    for k, v in got.items():
        scale = float(np.abs(want[k]).max())
        if scale < floor:      # zero but for rounding: held to be as small here
            zero.append(k)
            assert float(v.abs().max()) < floor, k
        else:
            _close(v, want[k], GRAD_REL * scale, f"grad {k}")
    assert zero == ["periods/slstm/mix/b_i"]


@pytest.mark.parametrize("nh", (1, 2))
def test_mlstm_prefill_over_a_padded_second_chunk(reference, nh):
    mp = params_from_jax(_sub(reference, f"unit{nh}/params/"), device="cpu",
                         dtype=torch.float32)
    x = torch.from_numpy(_unit_x())
    y, st = XL.mlstm_prefill(mp, x, XL.init_mlstm_state(B, UNIT_D, nh))
    assert UNIT_S > XL.CHUNK and UNIT_S % XL.CHUNK
    rec = reference[f"unit{nh}/recurrent"]
    scale = float(np.abs(rec).max())
    _close(y, rec, STATE_TOL * scale, "vs the reference's recurrence")
    for k in ("C", "n", "m"):
        _close(st[k], reference[f"unit{nh}/{k}"], STATE_TOL * max(
            1.0, float(np.abs(reference[f"unit{nh}/{k}"]).max())), k)
    chunkwise = reference[f"unit{nh}/chunkwise"]
    if nh == 1:
        _close(y, chunkwise, STATE_TOL * scale, "vs the reference's chunkwise prefill")
    else:   # the reference's chunks come back out of order (ROADMAP §3)
        assert np.abs(chunkwise - rec).max() > 0.1 * scale


# ---------------------------------------------------------- port only
def _f32_port(seed):
    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    model = build_model(get_config(ARCH, smoke=True))
    return model, f32(model.init(seed, device="cpu"))


def _solo(model, params, prompt, n_new, max_seq):
    cache = model.init_cache(1, max_seq, device="cpu")
    logits, cache = model.prefill(params, torch.tensor([prompt]), cache)
    toks = []
    for _ in range(n_new):
        tok = torch.argmax(logits, -1)
        toks.append(int(tok[0]))
        logits, cache = model.decode_step(params, tok, cache)
    return toks


class _LaneWatch:
    """Stands in for the model inside the engine and records, at every
    prefill, whether each leaf of the lane equals `init_cache`'s."""

    def __init__(self, model):
        self.model = model
        self.fresh = _flat(model.init_cache(1, 32, device="cpu"))
        self.seen = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, tokens, cache, extra=None):
        lane = _flat(cache)
        assert list(lane) == list(self.fresh)
        self.seen.append({k: torch.equal(v, self.fresh[k]) for k, v in lane.items()})
        return self.model.prefill(params, tokens, cache, extra)


def test_engine_equals_solo_runs_and_resets_recycled_lanes():
    """Five requests through two lanes, so three are served on recycled
    lanes: every request's tokens equal its solo run, and every lane leaf
    holds `init_cache`'s value when its prefill starts (the sLSTM ``m``
    -1e30, which a zeroed lane would get wrong)."""
    model, params = _f32_port(7)
    watch = _LaneWatch(model)
    assert bool((watch.fresh["slstm/m"] == -1e30).all()) and XL.SLSTM_INIT["m"] == -1e30
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, int(n)).tolist() for n in (9, 3, 6, 2, 5)]
    eng = ServeEngine(watch, params, n_slots=2, max_seq=32, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert eng.recycled_total == len(prompts) and len(watch.seen) == len(prompts)
    for i, leaves in enumerate(watch.seen):
        assert all(leaves.values()), (i, [k for k, ok in leaves.items() if not ok])
    assert [r.output for r in reqs] == [_solo(model, params, p, 5, 32) for p in prompts]


def test_training_launcher_trains_xlstm_in_whole_periods(tmp_path):
    history = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    with pytest.raises(SystemExit, match="whole periods of 8"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--layers", "12",
                           "--ckpt-dir", str(tmp_path)])


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
