"""The selective scan of the PyTorch port against the JAX reference.

`repro_torch.kernels.ssm_scan.ops`, given CPU tensors, computes its plain
PyTorch version (`ref.ssm_scan_ref`, a doubling associative scan).  It is
held to the reference's Pallas kernel in interpret mode (`ssm_scan`) and to
its oracle (`ssm_scan_ref`, `lax.associative_scan`) at the reference test's
three shapes (`tests/test_kernels.py:110-115`) and at two of its
time-block invariance cases (`:138-146`); the seeded form (h0 in, h_last
out) is held to the reference's chunked prefill, `mamba_prefill(params, x,
state)`, whose state seeds the scan with ``h + d_cum * h0``: its output and
its new h, and the port's `mamba_prefill` on the same params and state.

Tolerances: f32 1e-5 absolute (the sums run in other orders: a doubling
scan against XLA's associative scan, an einsum against the kernel's dot);
bf16 5e-2, the reference test's own.  The reference runs in a child
process (with a timeout: the interpreter can deadlock under load, ROADMAP
§3) through this file's own ``__main__`` branch.  The CUDA kernel runs only
on a card (`test_torch_ssm_scan_cuda.py`).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
# the reference test's cases: (B, S, d, N, block_d, block_t, dtype)
CASES = {
    "f32_small": (2, 64, 32, 8, 16, 32, "float32"),
    "f32_mid": (1, 128, 64, 16, 64, 64, "float32"),
    "bf16": (1, 256, 128, 16, 128, 128, "bfloat16"),
}
BLOCK_T = (16, 32)              # time-block invariance: (1, 64, 16, 4), block_d 16
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the seeded prefill: a Mamba mixer of d_model 24 (di 48, N 8), a 21-token chunk
MAMBA = dict(B=2, S=21, D=24, N=8, W=4)


def _scan_inputs(B, S, d, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.0, (B, S, d, N)).astype(np.float32),
            (0.1 * rng.standard_normal((B, S, d, N))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


def _invariance_inputs():
    rng = np.random.default_rng(3)
    return (rng.uniform(0.8, 1.0, (1, 64, 16, 4)).astype(np.float32),
            (0.1 * rng.standard_normal((1, 64, 16, 4))).astype(np.float32),
            rng.standard_normal((1, 64, 4)).astype(np.float32))


def _mamba_inputs():
    c = MAMBA
    rng = np.random.default_rng(21)
    di = 2 * c["D"]
    return {
        "x": rng.standard_normal((c["B"], c["S"], c["D"])).astype(np.float32),
        "h0": (0.5 * rng.standard_normal((c["B"], di, c["N"]))).astype(np.float32),
        "conv0": rng.standard_normal((c["B"], c["W"] - 1, di)).astype(np.float32),
    }


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.kernels.ssm_scan.ops import ssm_scan
    from repro.kernels.ssm_scan.ref import ssm_scan_ref
    from repro.models import mamba as JM

    out = {}
    for name, (B, S, dd, N, bd, bt, dt) in CASES.items():
        a, u, c = (jnp.asarray(x).astype(dt) for x in _scan_inputs(B, S, dd, N, seed=S + dd))
        out[f"pallas_{name}"] = ssm_scan(a, u, c, block_d=bd, block_t=bt).astype(jnp.float32)
        out[f"oracle_{name}"] = ssm_scan_ref(a, u, c).astype(jnp.float32)
    a, u, c = (jnp.asarray(x) for x in _invariance_inputs())
    for bt in BLOCK_T:
        out[f"pallas_bt{bt}"] = ssm_scan(a, u, c, block_d=16, block_t=bt)
    out["oracle_invariance"] = ssm_scan_ref(a, u, c)

    m = MAMBA
    params = JM.init_mamba(jax.random.PRNGKey(5), m["D"], 2, m["N"], m["W"], jnp.float32)
    for k, v in params.items():
        out[f"param/{k}"] = v
    inp = _mamba_inputs()
    state = {"h": jnp.asarray(inp["h0"]), "conv": jnp.asarray(inp["conv0"])}
    y, st = jax.jit(JM.mamba_prefill)(params, jnp.asarray(inp["x"]), state)
    out["prefill_y"], out["prefill_h"], out["prefill_conv"] = y, st["h"], st["conv"]
    out["forward_y"] = jax.jit(JM.mamba_forward)(params, jnp.asarray(inp["x"]))
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssm_scan_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_oracle(reference, name):
    B, S, d, N, bd, bt, dt = CASES[name]
    dtype = getattr(torch, dt)
    a, u, c = (torch.from_numpy(x).to(dtype) for x in _scan_inputs(B, S, d, N, seed=S + d))
    before = ops.launches
    y = ops.ssm_scan(a, u, c, block_d=bd, block_t=bt)
    assert ops.launches == before                 # the CPU path launches nothing
    assert y.dtype == dtype and y.shape == (B, S, d)
    _close(y, reference[f"pallas_{name}"], TOL[dt])
    _close(y, reference[f"oracle_{name}"], TOL[dt])


@pytest.mark.parametrize("block_t", BLOCK_T)
def test_time_block_invariance(reference, block_t):
    a, u, c = (torch.from_numpy(x) for x in _invariance_inputs())
    y = ops.ssm_scan(a, u, c, block_d=16, block_t=block_t)
    _close(y, reference[f"pallas_bt{block_t}"], 1e-5)
    _close(y, reference["oracle_invariance"], 1e-5)


def test_seeded_scan_chains_like_one_scan():
    """h0 in and h_last out: two scans chained through the state equal one
    scan, and h_last is the state after the last step, at any S (1, and
    lengths no block divides)."""
    a, u, c = (torch.from_numpy(x) for x in _scan_inputs(2, 45, 12, 8, seed=9))
    h0 = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 8)).astype(np.float32))
    y, h = ops.selective_scan(a, u, c, h0)
    y1, h1 = ops.selective_scan(a[:, :1], u[:, :1], c[:, :1], h0)
    y2, h2 = ops.selective_scan(a[:, 1:], u[:, 1:], c[:, 1:], h1)
    _close(torch.cat([y1, y2], 1), y.numpy(), 1e-5)
    _close(h2, h.numpy(), 1e-5)
    # the recurrence itself, one step at a time
    hs = h0.clone()
    for t in range(a.shape[1]):
        hs = a[:, t] * hs + u[:, t]
        _close((hs * c[:, t, None]).sum(-1), y[:, t].numpy(), 1e-5)
    _close(h, hs.numpy(), 1e-5)


def _port_mamba(reference):
    return {k[len("param/"):]: torch.from_numpy(v) for k, v in reference.items()
            if k.startswith("param/")}


def test_seeded_prefill_matches_the_reference_chunked_prefill(reference):
    params = _port_mamba(reference)
    inp = _mamba_inputs()
    state = {"h": torch.from_numpy(inp["h0"]), "conv": torch.from_numpy(inp["conv0"])}
    y, st = M.mamba_prefill(params, torch.from_numpy(inp["x"]), state)
    _close(y, reference["prefill_y"], 1e-5)
    _close(st["h"], reference["prefill_h"], 1e-5)
    _close(st["conv"], reference["prefill_conv"], 0)
    _close(M.mamba_forward(params, torch.from_numpy(inp["x"])), reference["forward_y"], 1e-5)


@pytest.mark.parametrize("seeded", [False, True])
def test_scan_gradients_recompute_through_the_plain_version(seeded):
    """With inputs that need a gradient the scan is an autograd Function (on
    the card its forward is the kernel); its backward equals the plain
    version's own gradients, through y and h_last alike."""
    rng = np.random.default_rng(11)
    a, u, c = (torch.from_numpy(x) for x in _scan_inputs(2, 19, 6, 4, seed=11))
    h0 = torch.from_numpy(rng.standard_normal((2, 6, 4)).astype(np.float32)) if seeded else None
    w_y = torch.from_numpy(rng.standard_normal((2, 19, 6)).astype(np.float32))
    w_h = torch.from_numpy(rng.standard_normal((2, 6, 4)).astype(np.float32))
    grads = []
    for fn in (ops.selective_scan, ref.ssm_scan_ref):
        ins = [t.clone().requires_grad_(True) for t in (a, u, c, h0) if t is not None]
        y, h = fn(*ins, *([None] if h0 is None else []))
        ((y * w_y).sum() + (h * w_h).sum()).backward()
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # only y used: h_last's gradient is taken as zero
    ins = [t.clone().requires_grad_(True) for t in (a, u, c)]
    ops.selective_scan(*ins)[0].sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in ins)


def test_plain_version_is_the_associative_scan():
    """`ssm_scan_ref` at S = 1 and a length that is no power of two."""
    for S in (1, 37):
        a, u, c = (torch.from_numpy(x) for x in _scan_inputs(1, S, 3, 4, seed=S))
        y, h = ref.ssm_scan_ref(a, u, c)
        hs = torch.zeros(1, 3, 4)
        for t in range(S):
            hs = a[:, t] * hs + u[:, t]
        _close(h, hs.numpy(), 1e-6)
        assert y.shape == (1, S, 3) and h.dtype == torch.float32


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
