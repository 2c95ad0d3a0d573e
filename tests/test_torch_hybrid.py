"""The port's moe and hybrid families against the JAX reference, on the
SMOKE configs of jamba-v0.1-52b (Mamba + attention periods, an MoE FFN on
every second layer), qwen3-moe-30b-a3b and moonshot-v1-16b-a3b (shared
experts), built from the reference's own params through `params_from_jax`.

The reference params are cast to f32 (the reference code runs unchanged;
its cache stays bf16, the Mamba conv window included) so that the two
packages compute the same thing up to f32 rounding; bf16 would round at
other places in XLA-CPU and torch-CPU.  Held, with these tolerances:

  * `Model.forward_logits` and `Model.loss` (aux and z included): logits
    within 1e-3, loss within 1e-4;
  * cached prefill + greedy decode: the tokens equal, logits within 1e-3;
  * the Mamba state after the prefill: h within 1e-4, the bf16 conv window
    within one bf16 ulp of the inputs' scale (2e-2);
  * a chunked prefill (two prefills into one cache): logits within 1e-3
    and the state as above;
  * the params' structure, shapes and dtypes (bf16; the router, ``A_log``
    and ``D_skip`` f32), and `params_from_jax(..., dtype=torch.bfloat16)`
    keeping those three in f32.

The reference runs in a child process through this file's own
``__main__`` branch.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.registry import F32_LEAVES  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCHS = ("jamba-v0.1-52b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
B, S, PLEN, CHUNK, N_DECODE, MAX_SEQ = 2, 29, 9, 4, 4, 48
LOGIT_TOL, LOSS_TOL, H_TOL, CONV_TOL = 1e-3, 1e-4, 1e-4, 2e-2


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(sum(map(ord, cfg.name))).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    out, dtypes = {}, {}
    for arch in ARCHS:
        cfg = jget(arch, smoke=True)
        model = jbuild(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        for key, leaf in _flat(params).items():
            out[f"params/{arch}/{key}"] = leaf.astype(jnp.float32)
            dtypes[f"{arch}/{key}"] = str(leaf.dtype)
        p = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        forward, loss = jax.jit(model.forward_logits), jax.jit(model.loss)
        prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
        toks = jnp.asarray(_tokens(cfg))
        batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
        fwd = forward(p, batch)
        out[f"{arch}/logits"], out[f"{arch}/aux"], out[f"{arch}/z"] = (
            fwd.logits, fwd.aux_loss, fwd.z_loss)
        out[f"{arch}/loss"] = loss(p, batch)[0]
        cache = model.init_cache(B, MAX_SEQ)
        logits, cache = prefill(p, toks[:, :PLEN], cache)
        if "mamba" in cache:
            out[f"{arch}/prefill_h"] = cache["mamba"]["h"]
            out[f"{arch}/prefill_conv"] = cache["mamba"]["conv"].astype(jnp.float32)
        steps, tokens = [logits], []
        for _ in range(N_DECODE):
            tok = jnp.argmax(logits, -1)
            tokens.append(tok)
            logits, cache = decode(p, tok, cache)
            steps.append(logits)
        out[f"{arch}/steps"], out[f"{arch}/tokens"] = jnp.stack(steps), jnp.stack(tokens)
        cache = model.init_cache(B, MAX_SEQ)
        _, cache = prefill(p, toks[:, :CHUNK], cache)
        logits, cache = prefill(p, toks[:, CHUNK:PLEN], cache)
        out[f"{arch}/chunked_logits"] = logits
        if "mamba" in cache:
            out[f"{arch}/chunked_h"] = cache["mamba"]["h"]
            out[f"{arch}/chunked_conv"] = cache["mamba"]["conv"].astype(jnp.float32)
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})
    (d / "dtypes.txt").write_text("\n".join(f"{k} {v}" for k, v in dtypes.items()))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("hybrid_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    dtypes = dict(line.split() for line in (d / "dtypes.txt").read_text().splitlines())
    return dict(np.load(d / "out.npz")), dtypes


def _np_params(ref_out, arch) -> dict:
    prefix = f"params/{arch}/"
    return _tree({k[len(prefix):]: v for k, v in ref_out.items() if k.startswith(prefix)})


def _model(reference, arch, dtype=torch.float32):
    cfg = get_config(arch, smoke=True)
    return cfg, build_model(cfg), params_from_jax(_np_params(reference[0], arch),
                                                  device="cpu", dtype=dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss(reference, arch):
    ref_out = reference[0]
    cfg, model, params = _model(reference, arch)
    toks = torch.from_numpy(_tokens(cfg))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = model.forward_logits(params, batch)
    assert out.logits.shape == (B, S, cfg.vocab_size)
    _close(out.logits, ref_out[f"{arch}/logits"], LOGIT_TOL)
    _close(out.aux_loss, ref_out[f"{arch}/aux"], LOSS_TOL)
    _close(out.z_loss, ref_out[f"{arch}/z"], LOSS_TOL)
    assert float(out.aux_loss) > 0 and float(out.z_loss) > 0
    loss, parts = model.loss(params, batch)
    assert abs(float(loss) - float(ref_out[f"{arch}/loss"])) < LOSS_TOL
    assert float(loss) == pytest.approx(float(parts["nll"]) + 0.01 * float(parts["aux"])
                                        + 0.001 * float(parts["z"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(reference, arch):
    ref_out = reference[0]
    cfg, model, params = _model(reference, arch)
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    logits, cache = model.prefill(params, torch.from_numpy(_tokens(cfg)[:, :PLEN]), cache)
    if cfg.family == "hybrid":
        _close(cache["mamba"]["h"], ref_out[f"{arch}/prefill_h"], H_TOL)
        _close(cache["mamba"]["conv"], ref_out[f"{arch}/prefill_conv"], CONV_TOL)
        assert cache["mamba"]["h"].abs().max() > 0
    steps = [logits]
    for i in range(N_DECODE):
        tok = torch.argmax(logits, -1)
        assert tok.tolist() == ref_out[f"{arch}/tokens"][i].tolist(), i
        logits, cache = model.decode_step(params, tok, cache)
        steps.append(logits)
    _close(torch.stack(steps), ref_out[f"{arch}/steps"], LOGIT_TOL)
    assert int(cache["len"]) == PLEN + N_DECODE


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill(reference, arch):
    ref_out = reference[0]
    cfg, model, params = _model(reference, arch)
    toks = torch.from_numpy(_tokens(cfg))
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    _, cache = model.prefill(params, toks[:, :CHUNK], cache)
    logits, cache = model.prefill(params, toks[:, CHUNK:PLEN], cache)
    _close(logits, ref_out[f"{arch}/chunked_logits"], LOGIT_TOL)
    if cfg.family == "hybrid":
        _close(cache["mamba"]["h"], ref_out[f"{arch}/chunked_h"], H_TOL)
        _close(cache["mamba"]["conv"], ref_out[f"{arch}/chunked_conv"], CONV_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_shapes_and_dtypes(reference, arch):
    ref_out, dtypes = reference
    params = build_model(get_config(arch, smoke=True)).init(3, device="cpu")
    flat = _flat(params)
    want = _flat(_np_params(ref_out, arch))
    assert set(flat) == set(want)
    for k, v in flat.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).replace("torch.", "") == dtypes[f"{arch}/{k}"], k


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_the_f32_leaves(reference, arch):
    """In bf16, the router, A_log and D_skip stay f32, as the reference
    keeps them; every other leaf is bf16."""
    _, _, params = _model(reference, arch, dtype=torch.bfloat16)
    kept = set()
    for k, v in _flat(params).items():
        leaf = k.split("/")[-1]
        assert v.dtype == (torch.float32 if leaf in F32_LEAVES else torch.bfloat16), k
        if leaf in F32_LEAVES:
            kept.add(leaf)
    assert kept == ({"router", "A_log", "D_skip"} if arch.startswith("jamba") else {"router"})


def test_layer_counts_that_are_not_whole_periods_raise():
    import dataclasses

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), n_layers=12)
    with pytest.raises(ValueError, match="whole periods"):
        build_model(cfg)


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
