"""Disaggregated serving, whole slice: the PyTorch port's engine against the
JAX reference engine with the same parameters and prompts.

The reference engine needs a 4-device mesh, so this file's own ``__main__``
branch runs it in a child process with forced host devices and dumps its
`params`, results and stats; the port's engine (``device="cpu"``,
`params_from_jax`) must then reproduce, per mode: every token,
`steps_run`, `msg_stats`, the novel pages shipped, prefix hits, `retries`,
stalls, and conservation; in the rendezvous modes also
`rendezvous_stats()`, the pins, the cancelled pull and the reasons a
failed drain gives.  Both engines are driven by the same `_drive`.  The
reference counts for the default config are pinned literally (raw -> wire
per step, wire bytes per step, steps).

The child patches `repro.serve.disagg.shard_map` (in this test file only):
jax releases after 0.4.37 reject the engine's rank-1 outputs against rank-2
`out_specs`, so the shim pads each output leaf with trailing unit axes up to
its spec's length.  Nothing in `repro` changes.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.mesh import MeshError  # noqa: E402
from repro_torch.serve.disagg import (  # noqa: E402
    DisaggConfig, DisaggEngine, params_from_jax)
from repro_torch.serve.engine import DrainError  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
P_RANKS, SEED, N_PROMPTS = 4, 3, 10

MODES = {
    "inline_noflow": dict(flow=False),
    "inline_flow": dict(),
    "paged_fused": dict(paged=True),
    "paged_gather": dict(paged=True, attend="gather"),
    # backpressure: 3 producers into one 2-slot ring bounce sends that must
    # be replayed; a tiny credit window and page pool stall at the origin
    "inline_retry": dict(flow=False, n_prefill=3, queue_capacity=2,
                         max_recv_per_step=1),
    "paged_stall": dict(paged=True, pool_pages=8, queue_capacity=4,
                        max_recv_per_step=1, n_lanes=1),
    # the consumer pulls: descriptors on the ring, pages by one-sided gets
    "rendezvous": dict(transport="rendezvous"),
    # one block's worth of pages per owner and three producers into one
    # 1-wide decoder: jobs wait for pulls to release pages; a drain cut
    # after 5 steps fails first, its requests stuck on a pull, a dry pool
    # or the queue
    "rendezvous_stall": dict(transport="rendezvous", pool_pages=4,
                             novel_slots=1, n_prefill=3, max_recv_per_step=1,
                             n_lanes=1),
    # the interrupted pull: descriptors queue at one 1-wide decoder, and a
    # request holding pins is cancelled before its pull
    "rendezvous_cancel": dict(transport="rendezvous", n_prefill=3,
                              max_recv_per_step=1, n_lanes=1),
}
# half of every prompt is one shared prefix
SHARED_PREFIX = {"paged_stall", "rendezvous", "rendezvous_stall",
                 "rendezvous_cancel"}
# reference counts for the default config: (raw, wire, bytes_wire, steps)
TABLE = {
    "inline_noflow": (5, 2, 16516, 5),
    "inline_flow": (6, 2, 16548, 5),
    "paged_fused": (8, 3, 8516, 10),
    "paged_gather": (8, 3, 8516, 10),
    "rendezvous": (8, 4, 66084, 10),
}


def _prompts(cfg: DisaggConfig, shared_prefix: bool) -> dict:
    rng = np.random.default_rng(0)
    if not shared_prefix:
        return {i: rng.integers(0, cfg.vocab, size=cfg.block_tokens)
                for i in range(N_PROMPTS)}
    half = cfg.block_tokens // 2
    prefix = rng.integers(0, cfg.vocab, size=half)
    return {i: np.concatenate([prefix, rng.integers(0, cfg.vocab, size=half)])
            for i in range(N_PROMPTS)}


def _drive(eng, mode: str, prompts: dict, drain_error) -> tuple[dict, dict]:
    """Submit the prompts and run to the end, as in the reference's
    `rendezvous_sub.py`: the cancel mode steps until a request holds pins
    and cancels it; the stall mode first runs a drain cut after 5 steps.
    Works on either package's engine (`drain_error` is its DrainError)."""
    for rid, toks in prompts.items():
        eng.submit(rid, toks)
    extra = {}
    if mode == "rendezvous_cancel":
        for _ in range(32):
            eng.step()
            live = sorted(rid for rid in eng._pins if rid not in eng.results)
            if live:
                break
        victim = live[0]
        extra["victim"] = victim
        extra["victim_pins"] = len(eng._pins[victim])
        extra["cancel_known"] = eng.cancel(victim)
        extra["pinned_after_cancel"] = sorted(eng._pins)
        extra["conservation_after_cancel"] = eng.kv.conservation()["ok"]
        extra["cancel_unknown"] = eng.cancel(10**6)
    if mode == "rendezvous_stall":
        try:
            eng.run_until_drained(max_steps=5)
        except drain_error as e:
            extra["drain_error"] = {"undrained": list(e.undrained),
                                    "reasons": {str(k): v for k, v in e.reasons.items()}}
    res = eng.run_until_drained()
    if eng.kv is not None:
        extra["live_pages"] = [c["live"] for _, c in
                               sorted(eng.kv.conservation()["per_owner"].items())]
    extra["pins_left"] = len(getattr(eng, "_pins", {}))
    extra["stalled_left"] = len(eng._stalled)
    return res, extra


def _summary(eng, res: dict, prompts: dict, extra: dict) -> dict:
    """The framework-independent outcome of one engine run."""
    prompts = {r: t for r, t in prompts.items() if r in res}
    qs = eng.queue_stats()
    ps, fs = eng.paged_stats(), eng.flow_stats()
    ms = {k: v for k, v in eng.msg_stats.items() if k != "plans"}
    return {
        "results": {str(r): int(t) for r, t in res.items()},
        "reference_ok": all(res[r] == eng.reference(t) for r, t in prompts.items()),
        "steps_run": eng.steps_run,
        "msg_stats": ms,
        "plans": [{k: v for k, v in pl.items() if k != "axis"}
                  for pl in eng.msg_stats["plans"]],
        "retries": eng.retries,
        "credit_stalls": eng.credit_stalls,
        "pool_stalls": eng.pool_stalls,
        "novel_pages_shipped": eng.novel_pages_shipped,
        "prefix_hits": ps.get("prefix_hits"),
        "pool_conservation_ok": ps.get("pool_conservation_ok"),
        "conservation_ok": fs.get("conservation_ok"),
        "lane_sends": eng.lane_sends.tolist(),
        "enqueued": qs["enqueued"].tolist(),
        "dropped_by_me": qs["dropped_by_me"].tolist(),
        "notifications": qs["notifications"].tolist(),
        "mode": eng.mode,
        "transport_selected": eng.transport_selected,
        "rendezvous_stats": eng.rendezvous_stats(),
        **extra,
    }


# ------------------------------------------------------- reference (child)
def _reference_child(d: pathlib.Path) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    import repro.serve.disagg as D
    import repro.serve.engine as DE

    orig = D.shard_map

    def padded_shard_map(f, *, mesh, in_specs, out_specs, **kw):
        def g(*args):
            return jax.tree.map(
                lambda s, x: x.reshape(x.shape + (1,) * (len(s) - x.ndim)),
                out_specs, f(*args), is_leaf=lambda s: isinstance(s, P))
        return orig(g, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw)

    D.shard_map = padded_shard_map
    mesh = jax.make_mesh((P_RANKS,), ("serve",))
    for mode, kw in MODES.items():
        cfg = D.DisaggConfig(**kw)
        eng = D.DisaggEngine(mesh, "serve", cfg, seed=SEED)
        prompts = _prompts(cfg, mode in SHARED_PREFIX)
        res, extra = _drive(eng, mode, prompts, DE.DrainError)
        np.savez(d / f"{mode}.params.npz",
                 **{k: np.asarray(v) for k, v in eng.params.items()})
        (d / f"{mode}.json").write_text(json.dumps(_summary(eng, res, prompts, extra)))


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("disagg_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={P_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(d)], capture_output=True,
                          text=True, timeout=210, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return d


def _port_run(d: pathlib.Path, mode: str):
    cfg = DisaggConfig(**MODES[mode])
    params = params_from_jax(dict(np.load(d / f"{mode}.params.npz")), device="cpu")
    eng = DisaggEngine(P_RANKS, cfg, seed=SEED, params=params, device="cpu")
    prompts = _prompts(cfg, mode in SHARED_PREFIX)
    res, extra = _drive(eng, mode, prompts, DrainError)
    return eng, _summary(eng, res, prompts, extra)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_reference(reference_runs, mode):
    ref = json.loads((reference_runs / f"{mode}.json").read_text())
    eng, got = _port_run(reference_runs, mode)
    assert ref["reference_ok"] and got["reference_ok"]
    assert got == ref
    assert len(got["results"]) == N_PROMPTS - (mode == "rendezvous_cancel")
    if mode in TABLE:
        raw, wire, nbytes, steps = TABLE[mode]
        ms = got["msg_stats"]
        assert (ms["raw_msgs_per_step"], ms["wire_msgs_per_step"],
                ms["bytes_wire_per_step"], got["steps_run"]) == (raw, wire, nbytes, steps)
    if mode.startswith(("paged", "rendezvous")):
        stats = got["rendezvous_stats"] if mode.startswith("rendezvous") else got
        assert stats["pool_conservation_ok"] and got["conservation_ok"]
        assert got["live_pages"] == [0] * len(got["live_pages"])


def test_default_paged_modes_ship_forty_novel_pages(reference_runs):
    for mode in ("paged_fused", "paged_gather"):
        ref = json.loads((reference_runs / f"{mode}.json").read_text())
        assert ref["novel_pages_shipped"] == 40 and ref["retries"] == 0


def test_rendezvous_modes_pull_with_no_payload_on_the_ring(reference_runs):
    """The rendezvous fingerprint in all three modes: descriptors only on
    the ring, 4 wire transfers a step (1 put + 3 gets) against eager's 2,
    every published page pulled or cancelled, no pin left."""
    for mode in ("rendezvous", "rendezvous_stall", "rendezvous_cancel"):
        ref = json.loads((reference_runs / f"{mode}.json").read_text())
        rs = ref["rendezvous_stats"]
        n = len(ref["results"])
        cfg = DisaggConfig(**MODES[mode])
        assert ref["mode"] == "rendezvous" and rs["transport_selected"] == "rendezvous"
        assert rs["ring_payload_appends"] == 0 and rs["wire_msgs_per_step"] == 4
        assert rs["descriptor_bytes"] == rs["descriptor_appends"] * cfg.table_nbytes
        assert rs["pins_outstanding"] == 0 and ref["pins_left"] == 0
        assert ref["stalled_left"] == 0
        assert ref["msg_stats"]["gets"] == 3 and ref["msg_stats"]["puts"] == 1
        if mode != "rendezvous_cancel":
            assert rs["descriptor_appends"] == n == N_PROMPTS
            assert rs["pulled_pages"] == n * cfg.pages_per_block - rs["prefix_hits"]
    stall = json.loads((reference_runs / "rendezvous_stall.json").read_text())
    assert stall["pool_stalls"] > 0
    err = stall["drain_error"]
    assert err["undrained"] and sorted(map(int, err["reasons"])) == err["undrained"]
    assert set(err["reasons"].values()) == {"pool", "pull", "queue"}
    cancel = json.loads((reference_runs / "rendezvous_cancel.json").read_text())
    assert cancel["cancel_known"] and not cancel["cancel_unknown"]
    assert cancel["victim_pins"] > 0 and cancel["conservation_after_cancel"]
    assert cancel["victim"] not in cancel["pinned_after_cancel"]
    assert str(cancel["victim"]) not in cancel["results"]


def test_backpressure_modes_exercise_their_paths(reference_runs):
    retry = json.loads((reference_runs / "inline_retry.json").read_text())
    stall = json.loads((reference_runs / "paged_stall.json").read_text())
    assert retry["retries"] > 0
    assert stall["pool_stalls"] > 0 and stall["prefix_hits"] > 0


# ------------------------------------------------------------- port only
def test_drain_error_names_every_undrained_request():
    eng = DisaggEngine(P_RANKS, DisaggConfig(), device="cpu")
    for rid in range(3):
        eng.submit(rid, np.arange(16))
    with pytest.raises(DrainError) as ei:
        eng.run_until_drained(max_steps=0)
    assert ei.value.undrained == (0, 1, 2)
    assert ei.value.reasons == {0: "queue", 1: "queue", 2: "queue"}


def test_config_and_params_are_validated():
    with pytest.raises(ValueError, match="transport must be"):
        DisaggConfig(transport="pull")
    with pytest.raises(ValueError, match="expected_reuse"):
        DisaggConfig(transport="auto", expected_reuse=1.5)
    with pytest.raises(ValueError, match="exclusive"):
        DisaggConfig(transport="rendezvous", paged=True)
    with pytest.raises(ValueError, match="credit flow"):
        DisaggConfig(transport="rendezvous", flow=False)
    with pytest.raises(ValueError, match="credit flow"):
        DisaggEngine(P_RANKS, DisaggConfig(paged=True, flow=False), device="cpu")
    with pytest.raises(ValueError, match="attend"):
        DisaggEngine(P_RANKS, DisaggConfig(paged=True, attend="dense"), device="cpu")
    with pytest.raises(KeyError):
        params_from_jax({"emb_k": np.zeros((97, 32))}, device="cpu")
    bad = params_from_jax({k: np.zeros(s, np.float32) for k, s in (
        ("emb_k", (5, 32)), ("emb_v", (97, 32)), ("w_q", (32,)),
        ("readout", (32, 97)))}, device="cpu")
    with pytest.raises(ValueError, match="emb_k"):
        DisaggEngine(P_RANKS, DisaggConfig(), params=bad, device="cpu")


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(MeshError, match="no CUDA device"):
        DisaggEngine(P_RANKS, DisaggConfig())
    with pytest.raises(MeshError):
        params_from_jax({})


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch.serve.disagg, repro_torch.kernels.common; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_imports_jax_or_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs there")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=script.parent,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
