"""The port's audio family (the whisper encoder-decoder) against the JAX
reference, on the whisper-small SMOKE config (2 encoder and 2 decoder
layers, 32 frames, heads of 16).

Both packages run the port's own seeded SMOKE weights, cast to f32 (the
reference code runs unchanged; its K/V cache stays bf16), on seeded f32
frames, so that they compute the same thing up to f32 rounding; the
params' structure, shapes and dtypes are held to the reference's `init`.
Held, with these tolerances:

  * `Model.forward_logits` (encode, then the decoder over a fresh K/V
    cache) and `Model.loss`: logits within 1e-3, loss within 1e-4;
  * `Model.prefill` with frames + greedy decode: the tokens equal, logits
    within 1e-3; the encoder output the prefill puts in the cache within
    1e-4, and f32 (encode's dtype; the leaf is replaced, not written into
    the bf16 buffer);
  * a second prefill into the same cache (the frames again): logits
    within 1e-3;
  * cross-attention (`layers.attention(..., cross_kv=)`) on random f32
    inputs: within 1e-5, the cache handed back untouched;
  * one f32 train step's grads (remat on): within 1e-4 of each leaf's
    largest magnitude, as `test_torch_training.py` holds them; the four
    leaves whose gradient passes through the bf16 K/V cache (`KV_PATH`)
    within half a bf16 ulp of theirs, all but 2% of their elements within
    1e-4.

Port-only: a decode step over two lanes at positions 5 and 9 (the cache's
``len`` a [B] tensor) equals each lane decoded alone, so each lane takes
its own sinusoidal positions; the training launcher refuses the family
and names the missing frames.  The reference runs in a child process
through this file's own ``__main__`` branch.
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
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as MT  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCH = "whisper-small"
B, S, PLEN, N_DECODE, MAX_SEQ = 2, 29, 9, 4, 48
LOGIT_TOL, LOSS_TOL, ENC_TOL, XATTN_TOL, GRAD_REL = 1e-3, 1e-4, 1e-4, 1e-5, 1e-4
XQ, XK = 5, 32                      # cross-attention: query and key rows
# the leaves whose gradient passes through the decoder's bf16 K/V cache
# (forward_logits writes K and V into it, so their cotangent is rounded to
# bf16 in both packages, and an f32 difference can flip one rounding): held
# within half a bf16 ulp (2**-9) of the leaf's largest magnitude, and at
# most 2% of their elements beyond GRAD_REL
KV_PATH = ("tok/embed", "blocks/ln1/scale", "blocks/attn/wk", "blocks/attn/wv")
KV_GRAD_REL, KV_GRAD_SHARE = 2.0 ** -9, 0.02


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(27)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            "x": rng.standard_normal((B, XQ, cfg.d_model)).astype(np.float32),
            "k": rng.standard_normal((B, XK, cfg.n_kv_heads, cfg.hd)).astype(np.float32),
            "v": rng.standard_normal((B, XK, cfg.n_kv_heads, cfg.hd)).astype(np.float32)}


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
    """The port's own seeded SMOKE weights as f32 numpy: the child runs the
    reference on these, so that it need not compile the reference's init."""
    params = build_model(get_config(ARCH, smoke=True)).init(0, device="cpu")
    return {f"params/{k}": v.float().numpy() for k, v in _flat(params).items()}


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.models import layers as JL
    from repro.models import transformer as JT

    @jax.custom_vjp
    def grad_cast_keep_dtype(x):        # tests/test_torch_training.py's patch
        return x

    grad_cast_keep_dtype.defvjp(
        lambda x: (x, None), lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))
    JL.grad_cast_bf16 = grad_cast_keep_dtype

    out = {}
    cfg = jget(ARCH, smoke=True)
    model = jbuild(cfg)
    for key, leaf in _flat(jax.eval_shape(model.init, jax.random.PRNGKey(0))).items():
        out[f"shape/{key}"] = np.array(f"{tuple(leaf.shape)} {leaf.dtype}")
    p = jax.tree.map(jnp.asarray, _tree(_sub(dict(np.load(d / "params.npz")), "params/")))
    inp = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    toks, frames = inp["tokens"], inp["frames"]
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1), "frames": frames}

    def loss_fn(p, b):
        JT.set_remat(True)
        (loss, _), logits = model.loss(p, b), model.forward_logits(p, b).logits
        JT.set_remat(False)
        return loss, logits

    (out["loss"], out["logits"]), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        p, batch)
    out.update({f"grads/{k}": v for k, v in _flat(g).items()})

    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    logits, cache = prefill(p, toks[:, :PLEN], model.init_cache(B, MAX_SEQ),
                            {"frames": frames})
    out["enc_out"] = cache["enc_out"]
    out["enc_dtype"] = np.array(str(cache["enc_out"].dtype))
    steps, tokens = [logits], []
    for _ in range(N_DECODE):
        tok = jnp.argmax(logits, -1)
        tokens.append(tok)
        logits, cache = decode(p, tok, cache)
        steps.append(logits)
    out["steps"], out["tokens"] = jnp.stack(steps), jnp.stack(tokens)
    _, cache = prefill(p, toks[:, :PLEN], model.init_cache(B, MAX_SEQ), {"frames": frames})
    out["chunked_logits"], _ = prefill(p, toks[:, PLEN:2 * PLEN], cache, {"frames": frames})

    xp = p["blocks"]["xattn"]
    xp = {k: v[0] for k, v in xp.items()}
    out["xattn"], _ = JL.attention(xp, inp["x"], jnp.arange(XQ), "none", causal=False,
                                   cross_kv=(inp["k"], inp["v"]))
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper_ref")
    given = _port_params()
    np.savez(d / "params.npz", **given)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=150, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return {**given, **dict(np.load(d / "out.npz"))}


@pytest.fixture(scope="module")
def port(reference):
    cfg = get_config(ARCH, smoke=True)
    params = params_from_jax(_tree(_sub(reference, "params/")), device="cpu",
                             dtype=torch.float32)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    return cfg, build_model(cfg), params, inp


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0,
                               err_msg=what)


# ------------------------------------------------------------------ tests
def test_init_matches_the_reference_shapes_and_dtypes(reference, port):
    cfg = port[0]
    want = _sub(reference, "shape/")
    got = _flat(MT.init_lm(cfg, None, "meta"))
    assert set(got) == set(want)
    for k, v in got.items():
        assert f"{tuple(v.shape)} {str(v.dtype).replace('torch.', '')}" == str(want[k]), k


def test_forward_logits_and_loss(reference, port):
    cfg, model, params, inp = port
    toks = inp["tokens"]
    batch = {"tokens": toks, "labels": toks.roll(-1, 1), "frames": inp["frames"]}
    out = model.forward_logits(params, batch)
    assert out.logits.shape == (B, S, cfg.vocab_size)
    _close(out.logits, reference["logits"], LOGIT_TOL)
    loss, _ = model.loss(params, batch)
    assert abs(float(loss) - float(reference["loss"])) < LOSS_TOL
    with pytest.raises(ValueError, match="frames"):
        model.forward_logits(params, {"tokens": toks})


def test_prefill_encode_and_decode(reference, port):
    cfg, model, params, inp = port
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    assert cache["enc_out"].dtype == torch.bfloat16
    logits, cache = model.prefill(params, inp["tokens"][:, :PLEN], cache,
                                  {"frames": inp["frames"]})
    assert str(cache["enc_out"].dtype) == f"torch.{reference['enc_dtype']}" == "torch.float32"
    _close(cache["enc_out"], reference["enc_out"], ENC_TOL)
    steps = [logits]
    for i in range(N_DECODE):
        tok = torch.argmax(logits, -1)
        assert tok.tolist() == reference["tokens"][i].tolist(), i
        logits, cache = model.decode_step(params, tok, cache)
        steps.append(logits)
    _close(torch.stack(steps), reference["steps"], LOGIT_TOL)
    assert int(cache["len"]) == PLEN + N_DECODE
    with pytest.raises(ValueError, match="frames"):
        model.prefill(params, inp["tokens"][:, :PLEN], cache)


def test_chunked_prefill(reference, port):
    cfg, model, params, inp = port
    extra = {"frames": inp["frames"]}
    _, cache = model.prefill(params, inp["tokens"][:, :PLEN],
                             model.init_cache(B, MAX_SEQ, device="cpu"), extra)
    logits, cache = model.prefill(params, inp["tokens"][:, PLEN:2 * PLEN], cache, extra)
    _close(logits, reference["chunked_logits"], LOGIT_TOL)
    assert int(cache["len"]) == 2 * PLEN


def test_cross_attention(reference, port):
    _, _, params, inp = port
    xp = {k: v[0] for k, v in params["blocks"]["xattn"].items()}
    cache = {"k": inp["k"]}
    y, kept = L.attention(xp, inp["x"], torch.arange(XQ), "none", causal=False,
                          cache=cache, cross_kv=(inp["k"], inp["v"]))
    _close(y, reference["xattn"], XATTN_TOL)
    assert kept is cache


def test_train_step_grads(reference, port):
    _, model, params, inp = port
    toks = inp["tokens"]
    batch = {"tokens": toks, "labels": toks.roll(-1, 1), "frames": inp["frames"]}
    loss, _, grads = loss_and_grads(model, params, batch, remat=True)
    assert abs(float(loss) - float(reference["loss"])) < LOSS_TOL
    want = _sub(reference, "grads/")
    got = _flat(grads)
    assert set(got) == set(want)
    for k, v in got.items():
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        err = np.abs(v.double().numpy() - want[k]) / scale
        if k in KV_PATH:
            assert err.max() <= KV_GRAD_REL and (err > GRAD_REL).mean() <= KV_GRAD_SHARE, k
        else:
            assert err.max() <= GRAD_REL, (k, err.max())


def test_each_lane_decodes_at_its_own_position(port):
    """Two lanes at positions 5 and 9 (`len` a [B] tensor) in one decode
    step: each lane's logits equal its own batch-1 decode."""
    cfg, model, params, inp = port
    solo, caches = [], []
    for b, n in enumerate((5, 9)):
        cache = model.init_cache(1, MAX_SEQ, device="cpu")
        _, cache = model.prefill(params, inp["tokens"][b:b + 1, :n], cache,
                                 {"frames": inp["frames"][b:b + 1]})
        caches.append(cache)
        solo.append(model.decode_step(params, inp["tokens"][b:b + 1, n], cache)[0])
    both = {"kv": {k: torch.cat([c["kv"][k] for c in caches], dim=1) for k in ("k", "v")},
            "enc_out": torch.cat([c["enc_out"] for c in caches]),
            "len": torch.tensor([5, 9])}
    logits, _ = model.decode_step(params, inp["tokens"][[0, 1], [5, 9]], both)
    for b in range(2):
        _close(logits[b:b + 1], solo[b].numpy(), 1e-5, f"lane {b}")
    assert (logits[0] - logits[1]).abs().max() > 1e-3


def test_training_launcher_names_the_missing_frames():
    with pytest.raises(SystemExit, match="frames"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
