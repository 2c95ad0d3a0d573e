"""The port's dense model stack against the JAX reference (the moe and
hybrid families are held in `test_torch_hybrid.py`, ssm in
`test_torch_xlstm.py`, audio in `test_torch_whisper.py`; their full-width
param counts here).

`repro_torch.models.layers` (rmsnorm, RoPE in its three styles, blockwise
attention with q_offset / kv_valid_len / GQA / padding, cached attention,
SwiGLU and GELU MLPs, tied and untied unembedding) is held to
`repro.models.layers` at f32 with atol 1e-5.  The whole model
(`Model.forward_logits`, `prefill`, `decode_step`, `loss`) is held to the
reference on the SMOKE configs of smollm-360m and chatglm3-6b (2d RoPE,
qkv bias), built from the reference's own params through `params_from_jax`,
in two settings:

  * ``f32``: the reference params cast to f32 (the reference code runs
    unchanged; its cache stays bf16): logits within 1e-3, greedy tokens
    equal;
  * ``bf16``: the params as the reference makes them: logits within 0.05,
    the reference's own bound for two attention paths
    (`tests/test_kernels.py:169`); the port decodes the reference's tokens
    (XLA-CPU and torch-CPU round bf16 in their own orders).

Backend ``"cuda"`` on CPU tensors takes the flash-attention wrapper's plain
version; it must agree with backend ``"torch"`` to f32 rounding.  The
reference runs in a child process through this file's own ``__main__``
branch.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
ARCHS = ("smollm-360m", "chatglm3-6b")
SETTINGS = ("f32", "bf16")
LOGIT_TOL = {"f32": 1e-3, "bf16": 0.05}
B, S, PLEN, N_DECODE, MAX_SEQ = 2, 37, 9, 5, 64
# blockwise_attention cases: (Sq, Sk, causal, q_offset, kv_valid_len, block, block_q)
BLOCKWISE = {
    "square_padded": (37, 37, True, 0, None, 16, None),
    "offset": (12, 50, True, 30, None, 16, None),
    "valid_len": (5, 50, True, 3, 8, 16, 4),
    "noncausal": (20, 33, False, 0, None, 8, None),
    "cache_like": (1, 64, True, 40, 41, 512, None),
}
ROPE = ("full", "2d", "none")
FULL_CONFIGS = ("smollm-360m", "chatglm3-6b", "llava-next-mistral-7b", "xlstm-1.3b",
                "whisper-small")
WRAPPING_CONFIGS = ("jamba-v0.1-52b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")


def _rng(tag: str):
    return np.random.default_rng(sum(map(ord, tag)))


def _layer_inputs() -> dict:
    r = _rng("layers")
    d, H, Hkv, hd, ff, V = 24, 4, 2, 16, 40, 30
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    inp = {
        "x": f(B, 7, d), "scale": (1 + 0.1 * f(d)).astype(np.float32),
        "rope_x": f(B, 7, 3, hd), "rope_pos": r.integers(0, 3000, (B, 7)).astype(np.int32),
        "q": f(B, 37, H, hd), "k": f(B, 64, Hkv, hd), "v": f(B, 64, Hkv, hd),
        "wq": f(d, H, hd) * 0.2, "wk": f(d, Hkv, hd) * 0.2, "wv": f(d, Hkv, hd) * 0.2,
        "wo": f(H, hd, d) * 0.2, "bq": f(H, hd) * 0.1, "bk": f(Hkv, hd) * 0.1,
        "bv": f(Hkv, hd) * 0.1,
        "cache_k": f(B, 16, Hkv, hd), "cache_v": f(B, 16, Hkv, hd),
        "w_in": f(d, ff) * 0.2, "w_gate": f(d, ff) * 0.2, "w_out": f(ff, d) * 0.2,
        "embed": f(V, d) * 0.1, "lm_head": f(d, V) * 0.1,
    }
    return inp


def _tokens(cfg) -> np.ndarray:
    return _rng(cfg.name).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
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
    from repro.models import layers as JL

    out = {}
    inp = {k: jnp.asarray(v) for k, v in _layer_inputs().items()}
    out["rmsnorm"] = JL.rmsnorm(inp["x"], inp["scale"])
    for style in ROPE:
        out[f"rope_{style}"] = JL.apply_rope(inp["rope_x"], inp["rope_pos"], style)
        out[f"rope1d_{style}"] = JL.apply_rope(inp["rope_x"], inp["rope_pos"][0], style)
    blockwise = jax.jit(JL.blockwise_attention, static_argnames=(
        "causal", "q_offset", "block_size", "kv_valid_len", "block_q"))
    for name, (sq, sk, causal, qo, kvl, blk, bq) in BLOCKWISE.items():
        out[f"blockwise_{name}"] = blockwise(
            inp["q"][:, :sq], inp["k"][:, :sk], inp["v"][:, :sk], causal=causal,
            q_offset=qo, block_size=blk, kv_valid_len=kvl, block_q=bq)
        # one row at a time with its own offset: the port's per-row form
        for b in range(B):
            out[f"blockwise_row{b}_{name}"] = blockwise(
                inp["q"][b:b + 1, :sq], inp["k"][b:b + 1, :sk], inp["v"][b:b + 1, :sk],
                causal=causal, q_offset=qo + 3 * b, block_size=blk,
                kv_valid_len=None if kvl is None else kvl + 3 * b, block_q=bq)
    attn = {k: inp[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}
    x = inp["x"][:, :3]
    cache = {"k": inp["cache_k"].astype(jnp.bfloat16), "v": inp["cache_v"].astype(jnp.bfloat16),
             "len": jnp.int32(4)}
    pos = 4 + jnp.arange(3)[None] + jnp.zeros((B, 1), jnp.int32)
    y, nc = JL.attention(attn, x, pos, "full", cache=cache, block_size=8)
    out["attn_cached"], out["attn_cached_k"], out["attn_cached_v"] = y, nc["k"], nc["v"]
    y, _ = JL.attention(attn, inp["x"], jnp.arange(7), "2d", block_size=4)
    out["attn_free"] = y
    for mt in ("swiglu", "gelu"):
        out[f"mlp_{mt}"] = JL.mlp({k: inp[k] for k in ("w_in", "w_gate", "w_out")},
                                  inp["x"], mt)
    out["unembed_tied"] = JL.unembed({"embed": inp["embed"]}, inp["x"])
    out["unembed_untied"] = JL.unembed({"embed": inp["embed"], "lm_head": inp["lm_head"]},
                                       inp["x"])

    for arch in ARCHS:
        cfg = jget(arch, smoke=True)
        model = jbuild(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        forward, loss = jax.jit(model.forward_logits), jax.jit(model.loss)
        prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
        for key, leaf in _flatten(params).items():
            out[f"params/{arch}/{key}"] = leaf.astype(jnp.float32)
        toks = jnp.asarray(_tokens(cfg))
        for setting in SETTINGS:
            p = jax.tree.map(lambda a: a.astype(jnp.float32), params) if setting == "f32" else params
            tag = f"{arch}/{setting}"
            batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
            out[f"{tag}/logits"] = forward(p, batch).logits
            out[f"{tag}/loss"] = loss(p, batch)[0]
            cache = model.init_cache(B, MAX_SEQ)
            logits, cache = prefill(p, toks[:, :PLEN], cache)
            steps, tokens = [logits], []
            for _ in range(N_DECODE):
                tok = jnp.argmax(logits, -1)
                tokens.append(tok)
                logits, cache = decode(p, tok, cache)
                steps.append(logits)
            out[f"{tag}/steps"] = jnp.stack(steps)
            out[f"{tag}/tokens"] = jnp.stack(tokens)
            out[f"{tag}/cache_k"] = cache["kv"]["k"]
            out[f"{tag}/cache_len"] = cache["len"]
    for arch in FULL_CONFIGS:
        out[f"param_count/{arch}"] = np.int64(jbuild(jget(arch)).param_count())
    for arch in FULL_CONFIGS + WRAPPING_CONFIGS:
        # the reference's own count wraps at 2**31 on the WRAPPING_CONFIGS
        # (ROADMAP §3): take the exact product of its leaves' shapes too
        leaves = jax.tree.leaves(jbuild(jget(arch)).init_shapes())
        out[f"param_exact/{arch}"] = np.int64(sum(int(np.prod(l.shape, dtype=np.int64))
                                                  for l in leaves))
    np.savez(d / "out.npz", **{k: np.asarray(jnp.asarray(v).astype(jnp.float32))
                               if jnp.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
                               for k, v in out.items()})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("models_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# ------------------------------------------------------------ layer parity
def test_rmsnorm(reference):
    inp = _layer_inputs()
    _close(L.rmsnorm(_t(inp["x"]), _t(inp["scale"])), reference["rmsnorm"])


@pytest.mark.parametrize("style", ROPE)
def test_apply_rope(reference, style):
    inp = _layer_inputs()
    x, pos = _t(inp["rope_x"]), torch.from_numpy(inp["rope_pos"])
    _close(L.apply_rope(x, pos, style), reference[f"rope_{style}"])
    _close(L.apply_rope(x, pos[0], style), reference[f"rope1d_{style}"])


@pytest.mark.parametrize("name", list(BLOCKWISE))
def test_blockwise_attention(reference, name):
    sq, sk, causal, qo, kvl, blk, bq = BLOCKWISE[name]
    inp = _layer_inputs()
    q, k, v = _t(inp["q"][:, :sq]), _t(inp["k"][:, :sk]), _t(inp["v"][:, :sk])
    got = L.blockwise_attention(q, k, v, causal=causal, q_offset=qo, block_size=blk,
                                kv_valid_len=kvl, block_q=bq)
    _close(got, reference[f"blockwise_{name}"])
    # per-row offsets and visible lengths ([B] tensors) equal row-by-row runs
    rows = torch.tensor([qo + 3 * b for b in range(B)])
    lens = None if kvl is None else torch.tensor([kvl + 3 * b for b in range(B)])
    got = L.blockwise_attention(q, k, v, causal=causal, q_offset=rows, block_size=blk,
                                kv_valid_len=lens, block_q=bq)
    for b in range(B):
        _close(got[b:b + 1], reference[f"blockwise_row{b}_{name}"])


def test_attention_with_cache_and_without(reference):
    inp = _layer_inputs()
    attn = {k: _t(inp[k]) for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}
    cache = {"k": _t(inp["cache_k"], torch.bfloat16), "v": _t(inp["cache_v"], torch.bfloat16),
             "len": torch.tensor(4, dtype=torch.int32)}
    pos = 4 + torch.arange(3)[None].expand(B, 3)
    y, nc = L.attention(attn, _t(inp["x"][:, :3]), pos, "full", cache=cache, block_size=8)
    _close(y, reference["attn_cached"])
    assert nc["k"] is cache["k"] and int(nc["len"]) == 7     # written in place
    _close(nc["k"], reference["attn_cached_k"], 2e-2)    # one bf16 ulp at |x| < 4
    _close(nc["v"], reference["attn_cached_v"], 2e-2)
    y, nc = L.attention(attn, _t(inp["x"]), torch.arange(7), "2d", block_size=4)
    assert nc is None
    _close(y, reference["attn_free"])


@pytest.mark.parametrize("mlp_type", ("swiglu", "gelu"))
def test_mlp(reference, mlp_type):
    inp = _layer_inputs()
    p = {k: _t(inp[k]) for k in ("w_in", "w_gate", "w_out")}
    _close(L.mlp(p, _t(inp["x"]), mlp_type), reference[f"mlp_{mlp_type}"])


@pytest.mark.parametrize("tied", (True, False))
def test_unembed(reference, tied):
    inp = _layer_inputs()
    p = {"embed": _t(inp["embed"])} if tied else {"embed": _t(inp["embed"]),
                                                  "lm_head": _t(inp["lm_head"])}
    _close(L.unembed(p, _t(inp["x"])), reference[f"unembed_{'tied' if tied else 'untied'}"])


# ------------------------------------------------------------ model parity
def _model(reference, arch, setting):
    cfg = get_config(arch, smoke=True)
    prefix = f"params/{arch}/"
    flat = {k[len(prefix):]: v for k, v in reference.items() if k.startswith(prefix)}
    dtype = torch.float32 if setting == "f32" else torch.bfloat16
    return cfg, build_model(cfg), params_from_jax(_unflatten(flat), device="cpu", dtype=dtype)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss(reference, arch, setting):
    cfg, model, params = _model(reference, arch, setting)
    toks = torch.from_numpy(_tokens(cfg))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    tag = f"{arch}/{setting}"
    out = model.forward_logits(params, batch)
    assert out.logits.shape == (B, S, cfg.vocab_size)
    _close(out.logits, reference[f"{tag}/logits"], LOGIT_TOL[setting])
    loss, _ = model.loss(params, batch)
    assert abs(float(loss) - float(reference[f"{tag}/loss"])) < LOGIT_TOL[setting]


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(reference, arch, setting):
    cfg, model, params = _model(reference, arch, setting)
    tag = f"{arch}/{setting}"
    want_tokens = reference[f"{tag}/tokens"]
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    logits, cache = model.prefill(params, torch.from_numpy(_tokens(cfg)[:, :PLEN]), cache)
    steps = [logits]
    for i in range(N_DECODE):
        tok = torch.argmax(logits, -1)
        if setting == "f32":
            assert tok.tolist() == want_tokens[i].tolist(), i
        else:
            tok = torch.from_numpy(want_tokens[i]).long()   # teacher-forced
        logits, cache = model.decode_step(params, tok, cache)
        steps.append(logits)
    _close(torch.stack(steps), reference[f"{tag}/steps"], LOGIT_TOL[setting])
    assert int(cache["len"]) == int(reference[f"{tag}/cache_len"]) == PLEN + N_DECODE
    _close(cache["kv"]["k"], reference[f"{tag}/cache_k"], 0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_backend_on_cpu_equals_torch_backend(reference, arch):
    """Backend "cuda" sends the cache-free attention to the flash wrapper,
    whose CPU path is the plain oracle: f32 rounding apart, the same."""
    cfg, model, params = _model(reference, arch, "f32")
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    want = model.forward_logits(params, batch).logits
    before = flash_ops.launches
    L.set_attention_backend("cuda")
    try:
        got = model.forward_logits(params, batch).logits
    finally:
        L.set_attention_backend("torch")
    assert flash_ops.launches == before
    _close(got, want.numpy(), 1e-5)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_per_row_cache_len_equals_one_row_at_a_time(reference):
    """A [B] cache len: each row decodes at its own position, as if alone."""
    cfg, model, params = _model(reference, "smollm-360m", "f32")
    toks = torch.from_numpy(_tokens(cfg))
    lens = (4, 9)
    cache = model.init_cache(B, MAX_SEQ, device="cpu")
    solo = []
    for b, n in enumerate(lens):
        one = model.init_cache(1, MAX_SEQ, device="cpu")
        _, one = model.prefill(params, toks[b:b + 1, :n], one)
        cache["kv"]["k"][:, b], cache["kv"]["v"][:, b] = one["kv"]["k"][:, 0], one["kv"]["v"][:, 0]
        solo.append(model.decode_step(params, toks[b:b + 1, n], one)[0])
    cache["len"] = torch.tensor(lens)
    logits, cache = model.decode_step(params, toks[torch.arange(B), torch.tensor(lens)], cache)
    assert cache["len"].tolist() == [n + 1 for n in lens]
    for b in range(B):
        _close(logits[b:b + 1], solo[b].numpy(), 1e-6)


@pytest.mark.parametrize("arch", FULL_CONFIGS)
def test_param_count_matches_the_reference(reference, arch):
    count = build_model(get_config(arch)).param_count()
    assert count == int(reference[f"param_count/{arch}"]) == int(reference[f"param_exact/{arch}"])


@pytest.mark.parametrize("arch", WRAPPING_CONFIGS)
def test_param_count_is_the_exact_product(reference, arch):
    """The reference's `param_count` wraps on a leaf of >= 2**31 elements;
    the port's is the exact sum of its leaves' shape products."""
    assert build_model(get_config(arch)).param_count() == int(reference[f"param_exact/{arch}"])


def test_ssm_layer_counts_that_are_not_whole_periods_raise():
    cfg = dataclasses.replace(get_config("xlstm-1.3b", smoke=True), n_layers=12)
    with pytest.raises(ValueError, match="whole periods of 8"):
        build_model(cfg)


def test_init_matches_the_reference_shapes_and_dtypes(reference):
    cfg = get_config("chatglm3-6b", smoke=True)
    params = build_model(cfg).init(3, device="cpu")
    flat = {k: v for k, v in _flatten(params).items()}
    prefix = "params/chatglm3-6b/"
    want = {k[len(prefix):]: v for k, v in reference.items() if k.startswith(prefix)}
    assert set(flat) == set(want)
    for k, v in flat.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.bfloat16, k


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
