"""The model-vs-measured drift gate: the PyTorch port's `obs.drift` against
the JAX reference's, in process on the CPU.

The reference's gate cases run against both packages' modules.  Then the
port drives its own protocols at the reference smoke benchmarks' shapes
(`obs.drift_docs.set_a`, p = 4 stacked ranks) and the two gates read the
same documents: they agree on every entry but one,
``rma_plan:coalesced.wire_transfers``, which each package's own perf
model predicts (the H100 model never packs on one card, the TPU model
packs the 8-byte puts into 1).  The traced conformance slices are built by
each package's own simulator and `critpath` and compared field for field.
"""

import copy
import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import drift as tdrift  # noqa: E402
from repro_torch.obs import drift_docs  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PACKAGES = ("repro", "repro_torch")
MODEL_ONLY = ("rma_plan", "coalesced.wire_transfers")


def _pkg(name: str):
    return (importlib.import_module(f"{name}.obs.drift"),
            importlib.import_module(f"{name}.core.perfmodel"))


# ------------------------------------------------- the reference's cases
def _write_benches(root, model, tamper=None):
    k, msg_bytes = 32, 8
    packed = model.DEFAULT_MODEL.select_aggregation(k, float(msg_bytes)) == "pack"
    rma_plan = {
        "k_msgs": k, "msg_bytes": msg_bytes,
        "eager": {"raw_msgs": k, "wire_transfers": k},
        "coalesced": {"raw_msgs": k, "wire_transfers": 1 if packed else k},
    }
    serve_flow = {
        "queue_backpressure": {
            "retry": {"wire_transfers_per_append": 2, "measured_msg_rate_per_s": 1e5},
            "credit": {"wire_transfers_per_append": 2, "measured_msg_rate_per_s": 2e5},
        },
        "serve_engine": {
            "retry": {"retries": 3, "msg_stats": {"wire_msgs_per_step": 2}},
            "credit": {"retries": 0, "msg_stats": {"wire_msgs_per_step": 2}},
        },
        "model": {"modeled_msg_rate_per_s": 1e6},
    }
    rmem = {"inline": {"wire_transfers_per_append": 2},
            "paged": {"wire_transfers_per_append": 2}}
    if tamper:
        tamper(rma_plan, serve_flow, rmem)
    for name, doc in (("BENCH_rma_plan.json", rma_plan),
                      ("BENCH_serve_flow.json", serve_flow),
                      ("BENCH_rmem.json", rmem)):
        (root / name).write_text(json.dumps(doc))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_matching_benches_pass_the_gate(pkg, tmp_path):
    drift, model = _pkg(pkg)
    _write_benches(tmp_path, model)
    entries = drift.gate(str(tmp_path), json_path=str(tmp_path / "BENCH_drift.json"))
    assert entries and not drift.violations(entries)
    doc = json.loads((tmp_path / "BENCH_drift.json").read_text())
    assert doc["violations"] == 0 and doc["count_tol"] == drift.COUNT_TOL
    rates = [e for e in entries if not e["gate"]]
    assert rates and all(e["tol"] == drift.RATE_TOL for e in rates)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wire_count_drift_fails_the_gate(pkg, tmp_path):
    drift, model = _pkg(pkg)

    def tamper(rma_plan, serve_flow, rmem):
        serve_flow["serve_engine"]["credit"]["msg_stats"]["wire_msgs_per_step"] = 3
    _write_benches(tmp_path, model, tamper)
    with pytest.raises(SystemExit, match="drift beyond tolerance"):
        drift.gate(str(tmp_path))
    bad = drift.violations(drift.collect(str(tmp_path)))
    assert [e["metric"] for e in bad] == ["engine.credit.wire_msgs_per_step"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_credit_retries_are_gated_at_zero(pkg, tmp_path):
    drift, model = _pkg(pkg)

    def tamper(rma_plan, serve_flow, rmem):
        serve_flow["serve_engine"]["credit"]["retries"] = 1
    _write_benches(tmp_path, model, tamper)
    with pytest.raises(SystemExit):
        drift.gate(str(tmp_path))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rate_drift_is_informational_only(pkg, tmp_path):
    drift, model = _pkg(pkg)

    def tamper(rma_plan, serve_flow, rmem):
        serve_flow["queue_backpressure"]["credit"]["measured_msg_rate_per_s"] = 1e12
    _write_benches(tmp_path, model, tamper)
    assert not drift.violations(drift.gate(str(tmp_path)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_table_marks_drift_rows(pkg, tmp_path):
    drift, model = _pkg(pkg)

    def tamper(rma_plan, serve_flow, rmem):
        rmem["paged"]["wire_transfers_per_append"] = 4
    _write_benches(tmp_path, model, tamper)
    table = drift.format_table(drift.collect(str(tmp_path)))
    assert "DRIFT" in table and "| info |" in table


def test_port_constants_are_the_references():
    jdrift, _ = _pkg("repro")
    for name in ("COUNT_TOL", "RATE_TOL", "WIRE_TRANSFERS_PER_FUSED_APPEND",
                 "FUSED_STAGING_PAGES", "SEGMENT_BUDGET_VT", "TTFT_BUDGET_VT",
                 "RENDEZVOUS_SEGMENT_BUDGET_VT", "RENDEZVOUS_TTFT_BUDGET_VT",
                 "EAGER_WIRE_MSGS_PER_STEP", "RENDEZVOUS_WIRE_MSGS_PER_STEP"):
        assert getattr(tdrift, name) == getattr(jdrift, name), name


def test_step_summary_gets_the_table(tmp_path, monkeypatch):
    _write_benches(tmp_path, _pkg("repro_torch")[1])
    summary = tmp_path / "summary.md"
    monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(summary))
    tdrift.gate(str(tmp_path))
    text = summary.read_text()
    assert text.startswith("### Model-vs-measured drift") and "| rma_plan |" in text


# ----------------------------------------------- the port's own documents
@pytest.fixture(scope="module")
def set_a():
    return drift_docs.set_a("cpu")


def _collect(drift, docs: dict, root: pathlib.Path) -> list:
    drift_docs.write(docs, str(root))
    return drift.collect(str(root))


def test_set_a_passes_the_port_gate(set_a, tmp_path):
    drift_docs.write(set_a, str(tmp_path))
    entries = tdrift.gate(str(tmp_path), json_path=str(tmp_path / "drift.json"))
    assert not tdrift.violations(entries)
    assert all(e["gate"] for e in entries)          # no timing field: no rate row
    assert len(entries) == 53
    by = {(e["bench"], e["metric"]): e for e in entries}
    assert by[MODEL_ONLY]["observed"] == drift_docs.RMA_K
    assert set_a["rma_plan"]["packed"]["wire_transfers"] == 1
    flood = set_a["serve_flow"]["queue_backpressure"]
    assert flood["retry"]["retries"] >= max(1, flood["retry"]["full_ring_steps"])
    assert flood["credit"]["retries"] == 0 and flood["credit"]["credit_stalls"] > 0
    engines = set_a["serve_flow"]["serve_engine"]
    assert engines["retry"]["retries"] >= 1 and engines["credit"]["retries"] == 0


def test_set_a_through_both_gates_differs_only_by_the_model(set_a, tmp_path):
    jdrift, _ = _pkg("repro")
    ours, theirs = _collect(tdrift, set_a, tmp_path), _collect(jdrift, set_a, tmp_path)
    assert [(e["bench"], e["metric"]) for e in ours] == \
        [(e["bench"], e["metric"]) for e in theirs]
    differ = [(a["bench"], a["metric"]) for a, b in zip(ours, theirs) if a != b]
    assert differ == [MODEL_ONLY]
    jmodel = _pkg("repro")[1].DEFAULT_MODEL
    assert jmodel.select_aggregation(drift_docs.RMA_K, float(drift_docs.RMA_MSG_BYTES)) == "pack"


def _tamper_engine_wire(d):
    d["serve_flow"]["serve_engine"]["credit"]["msg_stats"]["wire_msgs_per_step"] += 1


def _tamper_paged_append(d):
    d["rmem"]["paged"]["wire_transfers_per_append"] = 3


def _tamper_ttft(d):
    d["serve_flow"]["sim_serve"]["ttft_vt"]["p99"] = 601.0


def _tamper_ring_payload(d):
    d["serve_flow"]["transport"]["short_chat"]["rendezvous"]["ring_payload_appends"] = 1


def _tamper_flip(d):
    d["serve_flow"]["transport"]["crossover"]["flip_exact"] = 0


def _tamper_staging(d):
    d["rmem"]["decode"]["fused"]["staging_pages_resident"] = 3


def _tamper_eager_raw(d):
    d["rma_plan"]["eager"]["raw_msgs"] = 31


def _tamper_kv_pull(d):
    d["serve_flow"]["sim_rendezvous"]["segments_vt"]["kv_pull"]["p99"] = 250.0


TAMPERS = {
    "engine.credit.wire_msgs_per_step": _tamper_engine_wire,
    "paged.wire_transfers_per_append": _tamper_paged_append,
    "ttft.p99_vt": _tamper_ttft,
    "transport.short_chat.rdv.ring_payload_appends": _tamper_ring_payload,
    "transport.crossover.flip_exact": _tamper_flip,
    "decode.fused.staging_pages_resident": _tamper_staging,
    "eager.raw_msgs": _tamper_eager_raw,
    "seg.kv_pull.p99_vt": _tamper_kv_pull,
}


@pytest.mark.parametrize("metric", sorted(TAMPERS))
def test_tampered_documents_flag_the_same_metric_in_both(set_a, tmp_path, metric):
    jdrift, _ = _pkg("repro")
    docs = copy.deepcopy(set_a)
    TAMPERS[metric](docs)
    ours = [e["metric"] for e in tdrift.violations(_collect(tdrift, docs, tmp_path))]
    theirs = [e["metric"] for e in jdrift.violations(_collect(jdrift, docs, tmp_path))
              if (e["bench"], e["metric"]) != MODEL_ONLY]
    assert ours == theirs == [metric]


def _reference_traced(protocol: str) -> dict:
    """The reference's traced slice, stitched by its own `critpath` as
    `drift_docs._traced` stitches the port's."""
    from repro.obs import causal, critpath
    from repro.obs import trace as obs_trace
    from repro.sim.conformance import run_one

    tracer = obs_trace.Tracer()
    report = run_one(protocol, drift_docs.SIM_RANKS, drift_docs.SIM_SCHEDULE,
                     drift_docs.SIM_SEED, tracer=tracer)
    events = list(tracer.events)
    bds, connected = [], 0
    for _, dag in sorted(causal.build_dags(events).items()):
        bd = critpath.ttft_breakdown(dag)
        if bd is None:
            continue
        connected += bool(dag.connected())
        bd["critical_path"], _ = critpath.critical_path(dag)
        bd["wall"] = dag.wall()
        bds.append(bd)
    agg = critpath.aggregate(bds)
    block = {
        "ranks": drift_docs.SIM_RANKS, "schedule": drift_docs.SIM_SCHEDULE,
        "seed": drift_docs.SIM_SEED, "virtual_time": report["virtual_time"],
        "requests": len(bds), "connected": connected,
        "segment_sum_exact": sum(1 for b in bds if b["segment_sum"] == b["ttft"]),
        "critical_path_le_wall": sum(1 for b in bds if b["critical_path"] <= b["wall"]),
        "ttft_vt": agg["ttft"], "segments_vt": agg["segments"],
    }
    if protocol == "serve":
        block["sync_ledger"] = critpath.SyncLedger.from_events(events).summary()
    else:
        block.update({k: report[k] for k in ("pulled", "abandoned", "descriptor_sends",
                                             "payload_sends")})
    return block


@pytest.mark.parametrize("protocol", ["serve", "rendezvous"])
def test_sim_blocks_equal_the_references(set_a, protocol):
    ours = set_a["serve_flow"][f"sim_{protocol}"]
    want = json.loads(json.dumps(_reference_traced(protocol), default=float))
    assert json.loads(json.dumps(ours, default=float)) == want
    assert ours["requests"] > 0 and ours["connected"] == ours["requests"]


def test_set_b_records_gate_clean(tmp_path):
    """The full-width path's document writer at a small width: records of
    four finished engines fold into documents the gate passes."""
    from repro_torch.serve.disagg import DisaggConfig, DisaggEngine

    base = dict(n_prefill=2, block_tokens=16, d_model=16, vocab=61, queue_capacity=8,
                max_recv_per_step=4, n_lanes=2, page_tokens=4, novel_slots=4,
                pool_pages=32)
    recs = {}
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 61, 8)
    prompts = {rid: np.concatenate([prefix, rng.integers(0, 61, 8)]) for rid in range(8)}
    for name, kw in (("fused", dict(paged=True, attend="fused")),
                     ("gather", dict(paged=True, attend="gather")),
                     ("inline", dict(paged=False)),
                     ("rendezvous", dict(transport="rendezvous"))):
        eng = DisaggEngine(4, DisaggConfig(**base, **kw), seed=1, device="cpu")
        drift_docs._served(eng, prompts)
        recs[name] = drift_docs.run_record(eng, len(prompts))
    docs = drift_docs.set_b(**recs)
    drift_docs.write(docs, str(tmp_path))
    entries = tdrift.gate(str(tmp_path))
    assert not tdrift.violations(entries)
    metrics = {e["metric"] for e in entries}
    assert {"engine.credit.retries", "transport.full_width.rdv.descriptor_appends",
            "decode.gather.staging_pages_resident", "paged.wire_transfers_per_append"} <= metrics
    assert not (tmp_path / "BENCH_rma_plan.json").exists()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_main_exits_one_on_drift(pkg, tmp_path):
    drift, model = _pkg(pkg)
    _write_benches(tmp_path, model)
    assert drift.main(["--root", str(tmp_path)]) == 0

    def tamper(rma_plan, serve_flow, rmem):
        rmem["inline"]["wire_transfers_per_append"] = 3
    _write_benches(tmp_path, model, tamper)
    assert drift.main(["--root", str(tmp_path), "--json", str(tmp_path / "d.json")]) == 1
    assert json.loads((tmp_path / "d.json").read_text())["violations"] == 1


def test_module_entry_point(tmp_path):
    """``python -m repro_torch.obs.drift --root DIR``: 0 clean, 1 on drift."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("GITHUB_STEP_SUMMARY", None)
    run = lambda: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.obs.drift", "--root", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env)
    _write_benches(tmp_path, _pkg("repro_torch")[1])
    ok = run()
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "| rma_plan | coalesced.wire_transfers |" in ok.stdout

    def tamper(rma_plan, serve_flow, rmem):
        serve_flow["serve_engine"]["credit"]["retries"] = 2
    _write_benches(tmp_path, _pkg("repro_torch")[1], tamper)
    bad = run()
    assert bad.returncode == 1 and "engine.credit.retries" in bad.stdout


def test_gate_loads_no_jax_and_no_reference(tmp_path):
    """The gate and the document writer, run end to end on the CPU, import
    nothing of JAX or the reference package."""
    code = ("import sys; from repro_torch.obs import drift, drift_docs; "
            f"drift_docs.write({{'rma_plan': drift_docs.rma_plan_doc('cpu')}}, {str(tmp_path)!r}); "
            f"drift.gate({str(tmp_path)!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
