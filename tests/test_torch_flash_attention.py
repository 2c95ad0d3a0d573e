"""Flash attention in the PyTorch port against the JAX reference.

The port's `kernels.flash_attention.ops.flash_attention`, given CPU
tensors, computes its plain PyTorch version (`ref.attention_ref`).  It is
held to the reference's Pallas kernel in interpret mode (through the
reference's `kernels/flash_attention/ops.py`, blocks of 64) and to the
reference's oracle `attention_ref`, on the five cases of
`tests/test_kernels.py`: f32 at atol = rtol = 1e-5 (only the order of the
sums differs), bf16 at 2e-2 (the Pallas wrapper scales q in bf16, the port
in f32, and the outputs round to bf16).  Sq < Sk is held to the oracle
alone: the Pallas kernel's mask (q_pos >= k_pos) differs from the oracle's
offset mask there (ROADMAP §3).  Rows that see no key (causal, Sq > Sk) are
0 in the port, NaN in the reference's oracle: the rows that see a key are
held to the oracle, the others to zeros.  The gradients of the port's
autograd wrapper are held to the reference's (its custom VJP recomputes
through the oracle).

The reference runs in a child process through this file's own
``__main__`` branch, with a timeout: Pallas interpret mode has a JAX-side
deadlock under CPU load (ROADMAP §3), and a hang must cost one test only.
The CUDA kernel runs only on a card (`test_torch_flash_attention_cuda.py`).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
# tests/test_kernels.py's cases: (B, Hq, Hkv, S, hd, causal, dtype)
CASES = {
    "gqa": (2, 4, 2, 128, 64, True, "float32"),
    "mha": (1, 8, 8, 256, 64, True, "float32"),
    "noncausal_hd32": (2, 6, 2, 96, 32, False, "float32"),
    "mqa_ragged": (1, 4, 1, 130, 64, True, "float32"),
    "bf16_hd128": (1, 4, 2, 128, 128, True, "bfloat16"),
}
# Sq != Sk: (B, Hq, Hkv, Sq, Sk, hd, causal)
OFFSET_CASES = {
    "short_q": (2, 4, 2, 40, 100, 64, True),      # decode-like: q at the end
    "one_row": (1, 6, 3, 1, 77, 64, True),
    "short_q_noncausal": (1, 4, 4, 24, 50, 32, False),
    "long_q": (1, 4, 2, 90, 60, 64, True),        # 30 rows see no key
}
GRAD_CASES = ("gqa", "noncausal_hd32")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(B, Hq, Hkv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32))


def _case(name):
    if name in CASES:
        B, Hq, Hkv, S, hd, causal, dt = CASES[name]
        return _qkv(B, Hq, Hkv, S, S, hd, seed=len(name)), causal, dt
    B, Hq, Hkv, Sq, Sk, hd, causal = OFFSET_CASES[name]
    return _qkv(B, Hq, Hkv, Sq, Sk, hd, seed=len(name) + 100), causal, "float32"


def _cotangent(name):
    (q, _, _), _, _ = _case(name)
    return np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as jops
    from repro.kernels.flash_attention.ref import attention_ref

    out = {}
    for name in list(CASES) + list(OFFSET_CASES):
        (q, k, v), causal, dt = _case(name)
        q, k, v = (jnp.asarray(a).astype(dt) for a in (q, k, v))
        out[f"oracle_{name}"] = np.asarray(
            attention_ref(q, k, v, causal=causal).astype(jnp.float32))
        if name in CASES:
            out[f"pallas_{name}"] = np.asarray(jops.flash_attention(
                q, k, v, causal=causal, block_q=64, block_k=64).astype(jnp.float32))
    for name in GRAD_CASES:
        (q, k, v), causal, _ = _case(name)
        w = jnp.asarray(_cotangent(name))

        def loss(fn, q, k, v):
            return jnp.sum(fn(q, k, v) * w)

        flash = lambda q, k, v: jops.flash_attention(q, k, v, causal=causal,
                                                     block_q=64, block_k=64)
        oracle = lambda q, k, v: attention_ref(q, k, v, causal=causal)
        for tag, fn in (("pallas", flash), ("oracle", oracle)):
            grads = jax.grad(lambda q, k, v: loss(fn, q, k, v), argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            for g_name, g in zip("qkv", grads):
                out[f"grad_{tag}_{name}_{g_name}"] = np.asarray(g)
    np.savez(d / "out.npz", **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("flash_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _port(name, grad=False):
    (q, k, v), causal, dt = _case(name)
    dtype = getattr(torch, dt)
    t = [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in (q, k, v)]
    return t, ops.flash_attention(*t, causal=causal)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_oracle(reference, name):
    before = ops.launches
    _, out = _port(name)
    assert ops.launches == before                 # the CPU path launches nothing
    dt = CASES[name][-1]
    assert out.dtype == getattr(torch, dt) and out.shape == reference[f"oracle_{name}"].shape
    got = out.float().numpy()
    tol = TOL[dt]
    np.testing.assert_allclose(got, reference[f"pallas_{name}"], atol=tol, rtol=tol)
    np.testing.assert_allclose(got, reference[f"oracle_{name}"], atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(OFFSET_CASES))
def test_offset_mask_matches_the_oracle(reference, name):
    B, Hq, Hkv, Sq, Sk, hd, causal = OFFSET_CASES[name]
    _, out = _port(name)
    got, want = out.numpy(), reference[f"oracle_{name}"]
    blind = max(0, Sq - Sk) if causal else 0     # rows that see no key
    np.testing.assert_allclose(got[:, :, blind:], want[:, :, blind:], atol=1e-5, rtol=1e-5)
    if blind:
        assert np.isnan(want[:, :, :blind]).all()    # the reference's softmax
        assert not got[:, :, :blind].any()           # the port's max(l, 1e-30)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_the_reference(reference, name):
    (q, k, v), out = _port(name, grad=True)
    out.backward(torch.from_numpy(_cotangent(name)))
    for g_name, t in zip("qkv", (q, k, v)):
        for tag in ("pallas", "oracle"):
            np.testing.assert_allclose(t.grad.numpy(),
                                       reference[f"grad_{tag}_{name}_{g_name}"],
                                       atol=1e-5, rtol=1e-5)


def test_autograd_wrapper_equals_differentiating_the_plain_version():
    (qn, kn, vn), causal, _ = _case("mqa_ragged")
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(qn.shape).astype(np.float32))
    grads = []
    for fn in (ops.flash_attention, ref.attention_ref):
        t = [torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn)]
        (fn(*t, causal=causal) * w).sum().backward()
        grads.append([x.grad for x in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, k.to("meta"), k)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(torch.zeros(1, 3, 8, 64), k, k)
    with pytest.raises(ValueError, match="takes q"):
        ops.flash_attention(q[0], k, k)


def test_kernel_wrapper_refuses_other_head_dims_and_dtypes():
    """The CUDA path's checks run before anything is built or launched: a
    head dim past the largest template instance (128) is refused."""
    k = torch.zeros(1, 2, 8, 192)
    with pytest.raises(ValueError, match="head dims"):
        ops._launch(torch.zeros(1, 4, 8, 192), k, k, True)
    k16 = torch.zeros(1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ops._launch(torch.zeros(1, 4, 8, 64, dtype=torch.float16), k16, k16, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("hd", [1, 16, 20, 32, 48, 63, 64, 65, 96, 127, 128, 192])
def test_variant_rule(dtype, hd):
    """"wgmma" iff bf16 at hd 64 or 128; everything else is "simt"."""
    want = "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"
    assert ops.variant(dtype, hd) == want


# (shape, strides in elements, base offset in bytes, itemsize, expected problem)
TMA_CASES = [
    ((4, 15, 2048, 64), (15 * 2048 * 64, 2048 * 64, 64, 1), 0, 2, None),   # contiguous
    ((4, 15, 2048, 64), (2048 * 15 * 64, 64, 15 * 64, 1), 256, 2, None),   # the model's view
    ((2, 32, 2048, 128), (32 * 2048 * 128, 2048 * 128, 128, 1), 16, 2, None),
    ((1, 1, 7, 64), (3, 5, 64, 1), 32, 2, None),            # length-1 dims: strides unread
    ((1, 4, 64, 64), (4 * 64 * 72, 64 * 72, 72, 1), 2, 2, "16-byte aligned"),
    ((1, 4, 64, 64), (4 * 64 * 72, 64 * 72, 72, 1), 8, 2, "16-byte aligned"),
    ((1, 2, 64, 64), (2 * 64 * 68, 64 * 68, 68, 1), 0, 2, "dim 2"),   # rows 136 bytes apart
    ((1, 2, 64, 64), (2 * 64 * 64 + 4, 64 * 64 + 4, 64, 1), 0, 2, "dim 1"),
    ((3, 2, 64, 64), (2 * 64 * 64 + 4, 64 * 64, 64, 1), 0, 2, "dim 0"),
    ((2, 4, 64, 64), (0, 64 * 64, 64, 1), 0, 2, "dim 0"),     # broadcast batch
    ((1, 4, 64, 64), (4 * 64 * 64, 64 * 64, 64, 2), 0, 2, "not contiguous"),
    ((1, 4, 64, 64), (4 * 64 * 64, 64 * 64, 64, 1), 0, 4, None),   # 256-byte f32 rows
]


@pytest.mark.parametrize("shape,strides,offset,itemsize,problem", TMA_CASES)
def test_tma_preconditions(shape, strides, offset, itemsize, problem):
    """The "wgmma" variant's TMA checker, fed shapes, strides and offsets: a
    16-byte aligned base, a contiguous head dim, and every other stride of
    a dim longer than 1 a positive multiple of 16 bytes."""
    got = ops.tma_problem(shape, strides, 0x7F0000000000 + offset, itemsize)
    if problem is None:
        assert got is None
    else:
        assert got is not None and problem in got, got


def test_tma_strides_of_length_one_dims_are_valid():
    t = torch.zeros(1, 4, 1, 64)[:, 1:2]
    assert ops._tma_strides(t) == (64, 64, 64)
    t = torch.zeros(2, 300, 5, 64).transpose(1, 2)
    assert ops._tma_strides(t) == (300 * 5 * 64, 64, 5 * 64)


def test_effective_blocks_never_exceed_seq():
    assert ops.effective_blocks(1, 1) == (1, 1)
    assert ops.effective_blocks(4096, 64) == (512, 64)
    assert ops.effective_blocks(100, 2000, 64, 128) == (64, 128)


def test_build_targets_hopper_and_keys_by_source():
    lib = common.library_path("flash_attention")
    assert lib.parent == common.BUILD_DIR and lib.name.startswith("libflash_attention-")
    src = (common.CSRC / "flash_attention.cu").read_text()
    assert "flash_attention_fwd" in src and "sm_90a" in src


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
