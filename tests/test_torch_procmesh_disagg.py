"""Disaggregated serving with one rank a process (`DisaggEngine(...,
mesh=ProcMesh)`) and the peer forms of kernel rows 2, 3 and 8-10, against
the stacked port engine and the JAX reference.

Four CPU processes are spawned once for the whole file (`procmesh.run`:
gloo over a `FileStore` for handles, barriers and tokens, windows and pools
as shared files); every rank runs the engine in the eight modes of
`tests/test_torch_disagg.py` (the interrupted pull aside) on the reference
engine's parameters, then the peer forms' plain versions (what a CPU
`ProcMesh` takes in the `ops` wrappers) at shifts 1, p - 1 and p + 1.  One
JAX child on 4 forced host devices (this file's ``__main__`` branch) writes
the reference engine's parameters first, so the ranks can start, then runs
the reference engine in inline_flow, paged_fused and rendezvous, and the
reference's `ref.py` oracles of rows 2, 3 and 8-10 under `shard_map`.  The
stacked `Mesh(4)` engine runs in the test process.

Held equal: every rank's tokens, `steps_run`, `msg_stats` (and its plans),
retries, stalls, novel pages, prefix hits, pins, live pages, queue
counters, conservation and the drain's failure reasons to the stacked
engine's; the tokens in the three modes also to the JAX engine's.  The
peer plain versions: copies and integer state bit-equal to the oracles,
attention within 1e-5.  The host gather a step (the controller's read of
every rank's results) shows in `host_gathers` and in no op ledger.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import procmesh  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paops  # noqa: E402
from repro_torch.kernels.paged_gather import ops as pgops  # noqa: E402
from repro_torch.kernels.rmaq import ops as rmaqops  # noqa: E402
from repro_torch.rmem import pages as tpg  # noqa: E402
from repro_torch.serve.disagg import (  # noqa: E402
    DisaggConfig, DisaggEngine, params_from_jax)
from repro_torch.serve.engine import DrainError  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, SEED, N_PROMPTS = 4, 3, 10
TIMEOUT = 240.0          # s: the ranks' join; a hung rank is killed and fails the test
ATOL_ATTN = 1e-5
MODES = {
    "inline_noflow": dict(flow=False),
    "inline_flow": dict(),
    "paged_fused": dict(paged=True),
    "paged_gather": dict(paged=True, attend="gather"),
    "inline_retry": dict(flow=False, n_prefill=3, queue_capacity=2, max_recv_per_step=1),
    "paged_stall": dict(paged=True, pool_pages=8, queue_capacity=4, max_recv_per_step=1,
                        n_lanes=1),
    "rendezvous": dict(transport="rendezvous"),
    "rendezvous_stall": dict(transport="rendezvous", pool_pages=4, novel_slots=1,
                             n_prefill=3, max_recv_per_step=1, n_lanes=1),
}
SHARED_PREFIX = {"paged_stall", "rendezvous", "rendezvous_stall"}
JAX_MODES = ("inline_flow", "paged_fused", "rendezvous")
SHIFTS = (1, NP - 1, NP + 1)
# the peer rows' inputs: a pool of 10 pages [4, 2, 32], 6 ids a rank (holes
# and ids past the pool), q [2, 32]; a ring of 8 rows of 3 words whose
# counters leave 5, 5, 2 and 0 slots free, one tail past 2**31 and one
# that wraps past 2**32
CAP, QK, QW = 8, 5, 3


def _peer_inputs() -> dict:
    rng = np.random.default_rng(30)
    return {
        "pool": rng.standard_normal((NP, 10, 4, 2, 32)).astype(np.float32),
        "ids": rng.integers(-2, 12, (NP, 6)).astype(np.int32),
        "q": rng.standard_normal((NP, 2, 32)).astype(np.float32),
        "x": rng.standard_normal((NP, 3, 5)).astype(np.float32),
        "cnt": np.array([1, 2**31 - 1, -7, 4], np.int32),
        "local": np.array([2**31 - 2, -5, 0, 17], np.int32),
        "buf": rng.standard_normal((NP, CAP, QW)).astype(np.float32),
        "ctr": np.array([[0, 3], [2**31 - 2, 2**31 + 1], [-3, 3], [5, 13]],
                        np.int64).astype(np.int32),
        "msgs": rng.standard_normal((NP, QK, QW)).astype(np.float32),
    }


# ================================================================ engine runs
def _prompts(cfg: DisaggConfig, shared_prefix: bool) -> dict:
    rng = np.random.default_rng(0)
    if not shared_prefix:
        return {i: rng.integers(0, cfg.vocab, size=cfg.block_tokens)
                for i in range(N_PROMPTS)}
    half = cfg.block_tokens // 2
    prefix = rng.integers(0, cfg.vocab, size=half)
    return {i: np.concatenate([prefix, rng.integers(0, cfg.vocab, size=half)])
            for i in range(N_PROMPTS)}


def _drive(eng, mode: str, drain_error) -> dict:
    """Submit the mode's prompts and run to the end (the stall mode first
    through a drain cut after 5 steps); the framework-independent outcome."""
    prompts = _prompts(eng.cfg, mode in SHARED_PREFIX)
    for rid, toks in prompts.items():
        eng.submit(rid, toks)
    out = {}
    if mode == "rendezvous_stall":
        try:
            eng.run_until_drained(max_steps=5)
        except drain_error as e:
            out["drain_error"] = {"undrained": list(e.undrained),
                                  "reasons": {str(k): v for k, v in e.reasons.items()}}
    res = eng.run_until_drained()
    out["results"] = {str(r): int(t) for r, t in res.items()}
    out["reference_ok"] = all(res[r] == eng.reference(t) for r, t in prompts.items())
    return out


def _summary(eng, mode: str) -> dict:
    with OpCounter() as c:
        out = _drive(eng, mode, DrainError)
    ms = eng.msg_stats
    qs, ps, fs = eng.queue_stats(), eng.paged_stats(), eng.flow_stats()
    out.update({
        "steps_run": eng.steps_run,
        "msg_stats": {k: v for k, v in ms.items() if k != "plans"},
        "plans": ms["plans"],
        "ledger": (c.raw_msgs, c.coalesced_msgs, c.puts, c.gets, c.accs),
        "retries": eng.retries, "credit_stalls": eng.credit_stalls,
        "pool_stalls": eng.pool_stalls, "novel_pages_shipped": eng.novel_pages_shipped,
        "prefix_hits": ps.get("prefix_hits"),
        "pool_conservation_ok": ps.get("pool_conservation_ok"),
        "conservation_ok": fs.get("conservation_ok"),
        "lane_sends": eng.lane_sends.tolist(),
        "queue": {k: v.tolist() for k, v in qs.items()},
        "rendezvous_stats": eng.rendezvous_stats(),
        "pins_left": len(eng._pins), "stalled_left": len(eng._stalled),
        "live_pages": None if eng.kv is None else
        [c["live"] for _, c in sorted(eng.kv.conservation()["per_owner"].items())],
        "host_gathers": eng.host_gathers,
    })
    return out


def _engine(mode: str, params: dict, mesh=None) -> DisaggEngine:
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return DisaggEngine(NP, DisaggConfig(**MODES[mode]), seed=SEED, params=params, **kw)


def _params(d: pathlib.Path) -> dict:
    return params_from_jax(dict(np.load(d / "params.npz")), device="cpu")


def _peer_rows(mesh, inp: dict) -> dict:
    """The peer forms through their ops surfaces (rows 2, 3, 8, 9, 10) on
    this rank's block of the inputs, at every shift of SHIFTS."""
    r = mesh.rank
    t = {k: torch.from_numpy(v[r:r + 1].copy()) for k, v in inp.items()}
    pool = mesh.symmetric(t["pool"].shape[1:], torch.float32)
    pool.copy_(t["pool"])
    buf = mesh.symmetric((CAP, QW), torch.float32)
    ctr = mesh.symmetric((2,), torch.int32)
    before = (pgops.launches, paops.shift_launches, dict(rmaqops.launches))
    out = {}
    for s in SHIFTS:
        out[f"gather{s}"] = pgops.paged_gather(pool, t["ids"], s, mesh).numpy()
        out[f"gather_shift{s}"] = tpg.gather_shift(mesh, pool, t["ids"], s).numpy()
        out[f"attention{s}"] = paops.paged_attention_shift(t["q"], pool, t["ids"], s,
                                                           mesh).numpy()
        y, c = rmaqops.notified_put(t["x"], t["cnt"], s, mesh)
        out[f"notified_put{s}"], out[f"notified_put_cnt{s}"] = y.numpy(), c.numpy()
        out[f"notify_accumulate{s}"] = rmaqops.notify_accumulate(t["cnt"], t["local"], s,
                                                                 mesh).numpy()
        buf.copy_(t["buf"])
        ctr.copy_(t["ctr"])
        for i, res in enumerate(rmaqops.queue_push(buf, ctr, t["msgs"], s, mesh)):
            out[f"push{s}/{i}"] = res.clone().numpy()
    out["launched"] = before != (pgops.launches, paops.shift_launches, dict(rmaqops.launches))
    try:
        pgops.paged_gather(t["pool"], t["ids"], 1, mesh)     # not in a segment
    except procmesh.ProcMeshError as e:
        out["refused"] = str(e)
    return out


def _rank_main(mesh, d: str) -> dict:
    d = pathlib.Path(d)
    params = _params(d)
    out = {"modes": {}, "barriers": {}}
    for mode in MODES:
        eng = _engine(mode, params, mesh)
        held = mesh.barriers, mesh.host_gathers
        out["modes"][mode] = _summary(eng, mode)
        out["barriers"][mode] = (mesh.barriers - held[0], mesh.host_gathers - held[1])
    out["peer"] = _peer_rows(mesh, _peer_inputs())
    return out


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro.serve.disagg as D
    import repro.serve.engine as DE
    from repro.compat import shard_map
    from repro.kernels.paged_attention import ref as aref
    from repro.kernels.paged_gather import ref as gref
    from repro.kernels.rmaq import ref as qref

    orig = D.shard_map

    def padded_shard_map(f, *, mesh, in_specs, out_specs, **kw):
        # jax releases after 0.4.37 reject the engine's rank-1 outputs
        # against rank-2 out_specs (tests/test_torch_disagg.py)
        def g(*args):
            return jax.tree.map(
                lambda s, x: x.reshape(x.shape + (1,) * (len(s) - x.ndim)),
                out_specs, f(*args), is_leaf=lambda s: isinstance(s, P))
        return orig(g, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw)

    D.shard_map = padded_shard_map
    mesh = jax.make_mesh((NP,), ("serve",))
    engines = {mode: D.DisaggEngine(mesh, "serve", D.DisaggConfig(**MODES[mode]), seed=SEED)
               for mode in JAX_MODES}
    params = {k: np.asarray(v) for k, v in engines[JAX_MODES[0]].params.items()}
    np.savez(d / "params.partial.npz", **params)
    os.replace(d / "params.partial.npz", d / "params.npz")   # the ranks may start
    runs = {}
    for mode, eng in engines.items():
        assert all(np.array_equal(np.asarray(eng.params[k]), v) for k, v in params.items())
        runs[mode] = _drive(eng, mode, DE.DrainError)
    (d / "engine.json").write_text(json.dumps(runs))

    inp = {k: jnp.asarray(v) for k, v in _peer_inputs().items()}

    def sm(fn, ins, outs):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=ins, out_specs=outs,
                                 check_vma=False))

    s1, s2, s3 = P("serve"), P("serve", None), P("serve", None, None)
    out = {}
    for s in SHIFTS:
        out[f"gather{s}"] = sm(lambda pg, i, s=s: gref.paged_gather_ref(pg[0], i[0], s, "serve")[None],
                               (P("serve"), s2), P("serve"))(inp["pool"], inp["ids"])
        out[f"attention{s}"] = sm(
            lambda q, pg, i, s=s: aref.paged_attention_shift_ref(q[0], pg[0], i[0], s,
                                                                 "serve")[None],
            (s3, P("serve"), s2), s3)(inp["q"], inp["pool"], inp["ids"])
        y, c = sm(lambda x, n, s=s: qref.notified_put_ref(x, n, s, "serve"), (s3, s1),
                  (s3, s1))(inp["x"], inp["cnt"])
        out[f"notified_put{s}"], out[f"notified_put_cnt{s}"] = y, c
        out[f"notify_accumulate{s}"] = sm(
            lambda n, lo, s=s: qref.notify_accumulate_ref(n, lo, s, "serve"), (s1, s1),
            s1)(inp["cnt"], inp["local"])

        def push(b, c, m, s=s):
            ob, oc, sent, notif = qref.queue_push_ref(b[0], c[0], m[0], s, "serve", CAP)
            return ob[None], oc[None], sent, notif

        res = sm(push, (s3, s2, s3), (s3, s2, s1, s1))(inp["buf"], inp["ctr"], inp["msgs"])
        for i, r in enumerate(res):
            out[f"push{s}/{i}"] = r
    np.savez(d / "oracles.npz", **{k: np.asarray(v) for k, v in out.items()})


# ================================================================ fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX engine's runs, the oracles, every rank's results): the ranks
    start as soon as the child has written the reference's parameters."""
    d = tmp_path_factory.mktemp("procmesh_disagg")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "child", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 150
        while not (d / "params.npz").exists():
            if child.poll() is not None or time.monotonic() > deadline:
                out, err = child.communicate(timeout=60) if child.poll() is not None else ("", "")
                pytest.fail(f"the JAX child wrote no parameters:\n{out[-2000:]}{err[-4000:]}")
            time.sleep(0.2)
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(str(d),), timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=150)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    engine = json.loads((d / "engine.json").read_text())
    return engine, dict(np.load(d / "oracles.npz")), ranks, _params(d)


@pytest.fixture(scope="module")
def stacked(runs):
    """Every mode on the stacked Mesh(4) engine, in this process."""
    params = runs[3]
    return {mode: _summary(_engine(mode, params), mode) for mode in MODES}


# ================================================================ tests
def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_rank_serves_as_the_stacked_engine(mode, runs, stacked):
    """Tokens, steps, msg_stats and plans, the op ledger over the run,
    retries, stalls, pages, pins, queue counters, conservation and the
    drain's failure reasons: every rank's equal the stacked engine's."""
    _, _, ranks, _ = runs
    want = stacked[mode]
    assert want["reference_ok"] and len(want["results"]) == N_PROMPTS
    for r, res in enumerate(ranks):
        got = res["modes"][mode]
        assert got == want, (r, {k for k in want if got.get(k) != want[k]})


@pytest.mark.parametrize("mode", JAX_MODES)
def test_each_rank_serves_the_jax_engines_tokens(mode, runs):
    engine, _, ranks, _ = runs
    assert engine[mode]["reference_ok"]
    for res in ranks:
        assert res["modes"][mode]["results"] == engine[mode]["results"]


def test_the_host_gather_is_no_protocol_message(runs, stacked):
    """One packed read of every rank's results a step, counted apart: the
    op ledger over a run is exactly steps x the traced step's counts (on
    either mesh), and each rank's mesh counted one host gather a step plus
    the stats' own reads (queue counters, and the flow state's three)."""
    _, _, ranks, _ = runs
    for mode, want in stacked.items():
        ms, steps = want["msg_stats"], want["steps_run"]
        assert want["ledger"][:2] == (steps * ms["raw_msgs_per_step"],
                                      steps * ms["wire_msgs_per_step"])
        assert want["host_gathers"] == steps
        stats_reads = 1 + (3 if MODES[mode].get("flow", True) else 0)
        for res in ranks:
            assert res["modes"][mode]["host_gathers"] == steps
            assert res["barriers"][mode][1] == steps + stats_reads


def test_the_wire_fingerprints_hold_over_processes(runs):
    """paged raw 8 -> wire 3, inline 2 transfers an append, rendezvous 4 a
    step with no payload on the ring; every pin dropped, every page free."""
    _, _, ranks, _ = runs
    for res in ranks:
        m = res["modes"]
        paged = m["paged_fused"]["msg_stats"]
        assert (paged["raw_msgs_per_step"], paged["wire_msgs_per_step"]) == (8, 3)
        assert m["inline_flow"]["msg_stats"]["wire_msgs_per_step"] == 2
        rs = m["rendezvous"]["rendezvous_stats"]
        assert rs["ring_payload_appends"] == 0 and rs["wire_msgs_per_step"] == 4
        for mode in ("paged_fused", "paged_stall", "rendezvous", "rendezvous_stall"):
            pool_ok = (m[mode]["rendezvous_stats"] if mode.startswith("rendezvous")
                       else m[mode])["pool_conservation_ok"]
            assert pool_ok and m[mode]["conservation_ok"]
            assert m[mode]["pins_left"] == 0 and not any(m[mode]["live_pages"])
        assert m["inline_retry"]["retries"] > 0 and m["paged_stall"]["pool_stalls"] > 0
        err = m["rendezvous_stall"]["drain_error"]
        assert set(err["reasons"].values()) == {"pool", "pull", "queue"}


@pytest.mark.parametrize("shift", SHIFTS)
def test_peer_plain_versions_match_the_reference_oracles(shift, runs):
    """Rows 3 (and `gather_shift`'s hole mode), 2, 8, 9 and 10 on the CPU
    ProcMesh against the reference's `ref.py` under `shard_map`: copies and
    integer state bit-equal, attention within 1e-5."""
    _, oracle, ranks, _ = runs
    ids = _peer_inputs()["ids"]
    for r, res in enumerate(ranks):
        got = res["peer"]
        assert not got["launched"]                   # CPU tensors never launch
        for name in ("gather", "notified_put", "notified_put_cnt", "notify_accumulate",
                     "push", "attention"):
            keys = [f"{name}{shift}/{i}" for i in range(4)] if name == "push" \
                else [f"{name}{shift}"]
            for key in keys:
                want = oracle[key][r:r + 1]
                g = got[key].reshape(want.shape)
                if name == "attention":
                    np.testing.assert_allclose(g, want, rtol=0, atol=ATOL_ATTN)
                else:
                    np.testing.assert_array_equal(_bits(g), _bits(want.astype(g.dtype)),
                                                  err_msg=f"rank {r} {key}")
        holes = oracle[f"gather{shift}"][r:r + 1].copy()
        holes[:, ids[r] < 0] = 0
        np.testing.assert_array_equal(_bits(got[f"gather_shift{shift}"]), _bits(holes))


def test_a_pool_outside_every_segment_is_refused(runs):
    _, _, ranks, _ = runs
    for res in ranks:
        assert "outside every symmetric segment" in res["peer"]["refused"]


def test_the_engine_refuses_a_mesh_of_another_size():
    m = procmesh.ProcMesh(2, 0, device="cpu")
    with pytest.raises(ValueError, match="ProcMesh of 4 ranks"):
        DisaggEngine(NP, DisaggConfig(), mesh=m)
    m.close()


def test_the_disagg_example_runs_one_rank_a_process(capsys):
    from repro_torch.examples import disagg_serve

    out = disagg_serve.main(["--procs", "4", "--device", "cpu"])
    assert out["agree"] == disagg_serve.N_REQUESTS and out["ring_payload_appends"] == 0
    text = capsys.readouterr().out
    assert "4 processes: every rank's tokens and counts identical" in text
    assert "decode == single-host reference (all 3 modes): 12/12" in text


# ================================================================ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _card_rank(mesh) -> dict:
    """Each peer kernel of rows 2, 3 and 8-10 against its plain version on
    the card at the test's inputs and shifts 0, 1, -1, p + 1; this rank's
    launches counted."""
    from repro_torch.kernels.paged_attention import ref as paref
    from repro_torch.kernels.paged_gather import ref as pgref
    from repro_torch.kernels.rmaq import ref as qref

    inp, r, dev = _peer_inputs(), mesh.rank, mesh.device
    t = {k: torch.from_numpy(v[r:r + 1].copy()).to(dev) for k, v in inp.items()}
    pool = mesh.symmetric(t["pool"].shape[1:], torch.float32)
    pool.copy_(t["pool"])
    buf = mesh.symmetric((CAP, QW), torch.float32)
    ctr = mesh.symmetric((2,), torch.int32)
    before = (pgops.launches, paops.shift_launches, dict(rmaqops.launches))
    same, err = True, 0.0
    for s in (0, 1, -1, mesh.p + 1):
        for holes in (False, True):
            same &= torch.equal(pgops.paged_gather(pool, t["ids"], s, mesh, holes=holes),
                                pgref.paged_gather_peer_ref(pool, t["ids"], s, mesh, holes))
        got = paops.paged_attention_shift(t["q"], pool, t["ids"], s, mesh)
        want = paref.paged_attention_peer_ref(t["q"], pool, t["ids"], s, mesh,
                                              scale=32 ** -0.5)
        err = max(err, float((got - want).abs().max()))
        same &= all(torch.equal(a, b) for a, b in zip(
            rmaqops.notified_put(t["x"], t["cnt"], s, mesh),
            qref.notified_put_peer_ref(t["x"], t["cnt"], s, mesh)))
        same &= torch.equal(rmaqops.notify_accumulate(t["cnt"], t["local"], s, mesh),
                            qref.notify_accumulate_peer_ref(t["cnt"], t["local"], s, mesh))
        outs = []
        for fn in (rmaqops.queue_push, qref.queue_push_peer_ref):
            buf.copy_(t["buf"])
            ctr.copy_(t["ctr"])
            outs.append([x.clone() for x in fn(buf, ctr, t["msgs"], s, mesh, CAP)])
        same &= all(torch.equal(a, b) for a, b in zip(*outs))
    torch.cuda.synchronize()
    after = (pgops.launches, paops.shift_launches, dict(rmaqops.launches))
    return {"same": bool(same), "err": err,
            "launched": [after[0] - before[0], after[1] - before[1],
                         {k: after[2][k] - before[2][k] for k in after[2]}]}


@pytest.mark.cuda
def test_peer_kernels_equal_their_plain_versions_on_the_card(card):
    for res in procmesh.run(_card_rank, 3, timeout=TIMEOUT):
        assert res["same"] and res["err"] <= 1e-4
        # 4 shifts: 2 gathers, 1 attention, 1 notified put, 2 launches of
        # notify_accumulate and of queue_push each
        assert res["launched"] == [8, 4, {"notified_put": 4, "notify_accumulate": 8,
                                          "queue_push": 8}]


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
