"""The MoE FFN and the DSDE MoE dispatch of the PyTorch port against the JAX
reference, on the same numpy inputs.

`repro_torch.models.moe.moe_ffn` is held to `repro.models.moe.moe_ffn`
(f32 params from the reference's own `init_moe`): the output within 1e-5
(f32; the scatter-add and the einsums sum in other orders), the aux loss,
the router z loss and the drop fraction within 1e-6, and the slot
assignment exactly — each item's slot, source token and overflow flag, and
its gate within 1e-6.  The reference's assignment is read from its own
dispatch: the child runs `moe_ffn` eagerly with `jax.vmap` wrapped so that
the `pack` step's metadata is kept.  Cases: dropless, with drops (a
capacity factor of 0.5), shared experts (moonshot's `moe_shared_ff`), the
GELU experts, and exact ties in the router (`lax.top_k` takes the lower
index).

`repro_torch.core.dsde.moe_dispatch` / `moe_combine` are held to the
reference's on the rank axis at p = 4, as `examples/moe_dsde.py` drives
them (identity experts, so the combine returns the tokens): every output
bit-equal but the combined tokens (1e-6: the scatter-add's order), and the
`OpCounter` ledgers equal by kind.  Their token -> expert assignment is
held to `moe_ffn`'s, and the experts run on the dispatched slots and
combined give `moe_ffn`'s output.  The reference runs in a child process
(4 forced host devices) through this file's own ``__main__`` branch.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dsde  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe as X  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
# name -> (B, S, D, E, top_k, d_ff, mlp_type, shared_ff, capacity_factor, router)
CASES = {
    "dropless": (2, 5, 16, 4, 2, 32, "swiglu", 0, 1.25, "random"),
    "drops": (2, 40, 16, 4, 2, 32, "swiglu", 0, 0.5, "random"),
    "shared": (1, 7, 16, 8, 3, 24, "swiglu", 24, 1.25, "random"),
    "gelu": (2, 6, 16, 4, 1, 32, "gelu", 0, 1.25, "random"),
    "ties": (2, 9, 16, 6, 2, 32, "swiglu", 0, 1.25, "ties"),
}
NP, N_TOK, DD, E_DSDE, K_DSDE = 4, 32, 16, 8, 2
DSDE_CF = {"roomy": 2.0, "tight": 0.5}


def _moe_inputs(name):
    B, S, D, E, k, ff, mt, shared, cf, router = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.standard_normal((B, S, D)).astype(np.float32)


def _dsde_inputs():
    rng = np.random.default_rng(8)
    tokens = rng.standard_normal((NP * N_TOK, DD)).astype(np.float32)
    logits = rng.standard_normal((NP * N_TOK, E_DSDE)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :K_DSDE].astype(np.int32)
    gate = np.take_along_axis(probs, idx, -1)
    gate = (gate / gate.sum(-1, keepdims=True)).astype(np.float32)
    return tokens, idx, gate


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
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import dsde as jdsde
    from repro.core.rma import OpCounter as JOpCounter
    from repro.models import moe as JX

    kept = []

    def vmap(fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def run(*args):
            res = mapped(*args)
            kept.append(res)
            return res
        return run

    names = {k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")}
    JX.jax = types.SimpleNamespace(**{**names, "vmap": vmap})
    out = {}
    for i, name in enumerate(CASES):
        B, S, D, E, k, ff, mt, shared, cf, router = CASES[name]
        params = JX.init_moe(jax.random.PRNGKey(i), D, E, ff, mt, shared, jnp.float32)
        if router == "ties":
            params["router"] = jnp.zeros_like(params["router"]).at[:, -1].set(
                params["router"][:, 0])
        for key, v in _flat(params).items():
            out[f"{name}/param/{key}"] = v
        kept.clear()
        y, met = JX.moe_ffn(params, jnp.asarray(_moe_inputs(name)), k, cf, mt)
        meta = kept[0][1]
        out[f"{name}/y"], out[f"{name}/aux"] = y, met.aux_loss
        out[f"{name}/z"], out[f"{name}/drop"] = met.router_z_loss, met.drop_fraction
        for key in ("slot", "src", "gate", "ok"):
            out[f"{name}/meta/{key}"] = meta[key][0]

    mesh = jax.make_mesh((NP,), ("ep",))
    tokens, idx, gate = _dsde_inputs()
    snaps = {}
    for tag, cf in DSDE_CF.items():
        def body(t, e, g, cf=cf):
            disp = jdsde.moe_dispatch(t, e, g, E_DSDE, "ep", capacity_factor=cf)
            comb = jdsde.moe_combine(disp.expert_inputs, disp, t.shape[0], "ep")
            return tuple(jnp.asarray(r)[None] for r in (*disp, comb))

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("ep"), P("ep"), P("ep")),
                              out_specs=P("ep"), check_vma=False))
        with JOpCounter() as c:
            res = f(jnp.asarray(tokens), jnp.asarray(idx), jnp.asarray(gate))
        for j, r in enumerate(res):
            out[f"dsde_{tag}/{j}"] = r
        snaps[tag] = c.snapshot()
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})
    (d / "snaps.json").write_text(json.dumps(snaps))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


def _params(ref_out, name):
    prefix = f"{name}/param/"
    return _tree({k[len(prefix):]: torch.from_numpy(v) for k, v in ref_out.items()
                  if k.startswith(prefix)})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, atol=tol, rtol=0)


# ------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_the_reference(reference, name):
    ref_out, _ = reference
    B, S, D, E, k, ff, mt, shared, cf, router = CASES[name]
    params = _params(ref_out, name)
    x = torch.from_numpy(_moe_inputs(name))
    y, met = X.moe_ffn(params, x, k, cf, mt)
    assert y.shape == (B, S, D) and y.dtype == torch.float32
    _close(y.numpy(), ref_out[f"{name}/y"], 1e-5)
    _close(float(met.aux_loss), ref_out[f"{name}/aux"], 1e-6)
    _close(float(met.router_z_loss), ref_out[f"{name}/z"], 1e-6)
    _close(float(met.drop_fraction), ref_out[f"{name}/drop"], 1e-6)
    # "drops" overflows by its capacity factor; "ties" sends every token to
    # experts 0 and 1 (or E - 1), 18 items to 16 slots
    assert (float(met.drop_fraction) > 0.0) == (name in ("drops", "ties"))


@pytest.mark.parametrize("name", list(CASES))
def test_slot_assignment_matches_the_reference(reference, name):
    ref_out, _ = reference
    B, S, D, E, k, ff, mt, shared, cf, router = CASES[name]
    r = X.route(_params(ref_out, name), torch.from_numpy(_moe_inputs(name)).reshape(-1, D),
                k, cf)
    meta = {key: ref_out[f"{name}/meta/{key}"] for key in ("slot", "src", "gate", "ok")}
    np.testing.assert_array_equal(r.slot.numpy(), meta["slot"])
    np.testing.assert_array_equal(r.src.numpy(), meta["src"])
    np.testing.assert_array_equal(r.ok.numpy(), meta["ok"])
    _close(r.s_gate.numpy(), meta["gate"], 1e-6)
    if name == "ties":
        # every router column but the last is 0, so those E - 1 experts tie:
        # the lower index wins, after the last expert where its logit is > 0
        last = r.logits[:, -1:]
        want = torch.where(last > 0, torch.tensor([E - 1, 0]), torch.tensor([0, 1]))
        assert torch.equal(r.expert_idx, want)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = X.select_top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 0], [0, 1, 2]]
    assert torch.equal(vals, probs.gather(1, idx))


def test_capacity_floor_keeps_short_calls_dropless():
    assert X.capacity(8, 2, 16) == 8            # Jamba's decode over 8 lanes
    assert X.capacity(1, 2, 16) == 4
    assert X.capacity(1024, 2, 16) == 160       # a 1024-token prefill
    assert X.capacity(8, 8, 128) == 8           # qwen3-moe's decode over 8 lanes


# ------------------------------------------------------------ DSDE dispatch
def _port_dsde(cf):
    tokens, idx, gate = _dsde_inputs()
    mesh = Mesh(NP, "ep", device="cpu")
    with OpCounter() as c:
        disp = dsde.moe_dispatch(torch.from_numpy(tokens).reshape(NP, N_TOK, DD),
                                 torch.from_numpy(idx).reshape(NP, N_TOK, K_DSDE),
                                 torch.from_numpy(gate).reshape(NP, N_TOK, K_DSDE),
                                 E_DSDE, mesh, capacity_factor=cf)
        comb = dsde.moe_combine(disp.expert_inputs, disp, N_TOK, mesh)
    return disp, comb, c.snapshot()


@pytest.mark.parametrize("tag", list(DSDE_CF))
def test_moe_dispatch_and_combine_match_the_reference(reference, tag):
    ref_out, snaps = reference
    disp, comb, snap = _port_dsde(DSDE_CF[tag])
    for j, got in enumerate(disp):
        want = ref_out[f"dsde_{tag}/{j}"].reshape(got.shape)
        np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype),
                                      err_msg=f"dispatch output {j}")
    _close(comb.numpy(), ref_out[f"dsde_{tag}/4"].reshape(comb.shape), 1e-6)
    tokens = _dsde_inputs()[0].reshape(NP, N_TOK, DD)
    routed = int(disp.combine_valid.sum())
    if tag == "roomy":      # identity experts, gates summing to 1: the tokens come back
        assert routed == NP * N_TOK * K_DSDE
        _close(comb.numpy(), tokens, 1e-5)
    else:
        assert routed < NP * N_TOK * K_DSDE
    ref = snaps[tag]
    for k in ("puts", "gets", "accs", "colls", "raw_msgs", "by_axis"):
        assert snap[k] == ref[k], k


def test_dispatch_assignment_and_experts_give_moe_ffn():
    """Expert parallelism over the rank axis computes `moe_ffn`: the
    dispatch sends each token to the experts `moe_ffn` routes it to, with
    its gates, and the experts run on the dispatched slots and combined
    give `moe_ffn`'s output (dropless at this capacity)."""
    rng = np.random.default_rng(4)
    T, D, E, k, ff = NP * N_TOK, DD, E_DSDE, K_DSDE, 24
    gen = torch.Generator().manual_seed(2)
    params = X.init_moe(gen, D, E, ff, "swiglu", 0, torch.float32, "cpu")
    x = torch.from_numpy(rng.standard_normal((1, T, D)).astype(np.float32))
    want, met = X.moe_ffn(params, x, k, capacity_factor=4.0)
    r = X.route(params, x[0], k, capacity_factor=4.0)
    assert float(met.drop_fraction) == 0.0

    mesh = Mesh(NP, "ep", device="cpu")
    disp = dsde.moe_dispatch(x.reshape(NP, N_TOK, D), r.expert_idx.reshape(NP, N_TOK, k),
                             r.gate.reshape(NP, N_TOK, k), E, mesh, capacity_factor=4.0)
    local_e = E // NP
    experts = torch.arange(E).reshape(NP, local_e, 1).expand_as(disp.combine_valid)
    valid = disp.combine_valid
    sent = sorted(zip(disp.combine_idx[valid].tolist(), experts[valid].tolist()))
    routed = sorted(zip(r.src[r.ok].tolist(),
                        r.expert_idx.reshape(-1)[torch.argsort(r.expert_idx.reshape(-1),
                                                               stable=True)][r.ok].tolist()))
    assert sent == routed and len(sent) == T * k
    gate_of = {(t, e): g for t, e, g in zip(r.src.tolist(), r.expert_idx.reshape(-1)[
        torch.argsort(r.expert_idx.reshape(-1), stable=True)].tolist(), r.s_gate.tolist())}
    for t, e, g in zip(disp.combine_idx[valid].tolist(), experts[valid].tolist(),
                       disp.gate_weights[valid].tolist()):
        assert g == gate_of[(t, e)]

    ex = params["experts"]
    w = {n: ex[n].reshape(NP, local_e, *ex[n].shape[1:]) for n in ex}
    h = torch.einsum("pecd,pedf->pecf", disp.expert_inputs, w["w_in"])
    h = torch.nn.functional.silu(torch.einsum("pecd,pedf->pecf", disp.expert_inputs,
                                              w["w_gate"])) * h
    out = torch.einsum("pecf,pefd->pecd", h, w["w_out"])
    got = dsde.moe_combine(out, disp, N_TOK, mesh).reshape(1, T, D)
    _close(got.numpy(), want.numpy(), 1e-5)


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
