"""Model-vs-measured drift gate over the count documents (the `repro.obs.drift`
counterpart).

The port's perf model (`core.perfmodel`, priced for one H100) *predicts*
structural counts; the op ledgers *observe* them in each ``BENCH_*.json``.
Every entry is ``{bench, metric, predicted, observed, tol, gate}``:

  * **Gated counts** (``gate=True``, ``tol=COUNT_TOL``) — wire-transfer and
    message counts.  The deferred substrate is deterministic, so the
    model's structural predictions (k raw messages coalesce into what
    `select_aggregation` picks; a fused enqueue/append is exactly 2 wire
    transfers) must hold *exactly*: the stated tolerance is 0.
  * **One-sided budgets** (``gate=True``) — the TTFT segment p99s of the
    traced conformance slices, in virtual ticks, at or under a budget.
  * **Informational rates** (``gate=False``, ``tol=RATE_TOL``) — modeled vs
    measured message rates; they appear in the table but never gate.

The one prediction that differs from the reference's:
``rma_plan:coalesced.wire_transfers`` comes from the H100 model's
`select_aggregation`, which never packs on one card, so it predicts k
where the TPU model predicts 1.

Run standalone: ``python -m repro_torch.obs.drift --root DIR`` (exit 1 on
drift); ``--json PATH`` writes the entries.  `obs.drift_docs` writes the
three documents by driving the port.
"""

from __future__ import annotations

import json
import os
from typing import Optional

# Stated tolerances (the acceptance criterion's "stated tolerance"):
# deterministic transfer counts must match the model exactly; measured
# wall-clock rates may drift two orders of magnitude on shared runners
# before we even flag them informationally.
COUNT_TOL = 0.0
RATE_TOL = 100.0

# The §6/§9/§10 fused protocols (queue enqueue, credit send, inline and
# paged KV append) are all "one reservation gather + one payload scatter":
# the model charges every fused append exactly this many wire transfers
# (see PerfModel.p_queue_enqueue / p_enqueue_credit / p_append_paged).
WIRE_TRANSFERS_PER_FUSED_APPEND = 2

# The §13 fused paged-attention kernel stages pages through a double
# buffer: at most this many KV pages are ever resident in decode staging,
# independent of the request's block length (the gather baseline stages
# pages_per_block).  Structural, so gated at COUNT_TOL.
FUSED_STAGING_PAGES = 2

# §15 per-segment TTFT budgets, in VIRTUAL ticks, for the traced serve
# conformance slice bench_serve_flow pins at (64 ranks, delay, seed 0).
# Virtual time makes the measured p99s deterministic — the budgets sit at
# ~2x the current values, so a protocol change that doubles a segment's
# tail (an extra sync round, a serialized alloc) gates, while benign
# reshuffles do not.  A budget of 0 means "this segment must stay empty at
# p99 in this scenario" (credits are over-provisioned; queue_wait rides
# prefill's milestone).
SEGMENT_BUDGET_VT = {
    "queue_wait": 0.0,
    "credit_stall": 0.0,
    "sync_wait": 0.0,
    "page_alloc": 300.0,
    "kv_wire": 320.0,
    "kv_pull": 0.0,          # the eager slice issues no consumer pulls
    "prefill": 350.0,
    "attend": 280.0,
    "host": 0.0,
}
TTFT_BUDGET_VT = 600.0

# §16 budgets for the traced rendezvous pull slice (same fixed point: 64
# ranks, delay, seed 0).  The pull protocol's shape differs from eager
# serve: descriptors ride the ring (kv_wire is descriptor latency), the
# payload cost moves into kv_pull (the consumer-issued gets), and a small
# credit_stall tail is expected because descriptors and grants share the
# tiny smoke-scale ring.  Budgets sit at ~2x the pinned measurements.
RENDEZVOUS_SEGMENT_BUDGET_VT = {
    "queue_wait": 0.0,
    "credit_stall": 40.0,
    "sync_wait": 0.0,
    "page_alloc": 50.0,
    "kv_wire": 380.0,
    "kv_pull": 200.0,
    "prefill": 350.0,
    "attend": 150.0,
    "host": 0.0,
}
RENDEZVOUS_TTFT_BUDGET_VT = 650.0

# §16 structural wire counts: the eager engine's fused append is 2 wire
# transfers per step; the rendezvous engine adds the pull's fused gather
# (2 get transfers: id scatter + payload reply), never a ring payload.
EAGER_WIRE_MSGS_PER_STEP = 2
RENDEZVOUS_WIRE_MSGS_PER_STEP = 4


def _entry(bench: str, metric: str, predicted: float, observed: float,
           tol: float = COUNT_TOL, gate: bool = True) -> dict:
    pred = float(predicted)
    obs = float(observed)
    denom = max(abs(pred), 1e-12)
    rel_err = abs(obs - pred) / denom
    return {
        "bench": bench,
        "metric": metric,
        "predicted": pred,
        "observed": obs,
        "rel_err": rel_err,
        "tol": tol,
        "gate": gate,
        "ok": rel_err <= tol,
    }


def _budget_entry(bench: str, metric: str, budget: float,
                  observed: float) -> dict:
    """A one-sided gate: observed must stay AT OR UNDER the budget (latency
    ceilings, unlike _entry's two-sided match).  rel_err is the overshoot
    fraction, 0 when within budget."""
    pred = float(budget)
    obs = float(observed)
    over = max(0.0, obs - pred) / max(abs(pred), 1.0)
    return {
        "bench": bench,
        "metric": metric,
        "predicted": pred,
        "observed": obs,
        "rel_err": over,
        "tol": 0.0,
        "gate": True,
        "ok": obs <= pred,
    }


def _load(root: str, name: str) -> Optional[dict]:
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _collect_rma_plan(doc: dict) -> list[dict]:
    from ..core.perfmodel import DEFAULT_MODEL

    k = int(doc["k_msgs"])
    msg_bytes = float(doc["msg_bytes"])
    packed = DEFAULT_MODEL.select_aggregation(k, msg_bytes) == "pack"
    return [
        _entry("rma_plan", "eager.raw_msgs", k, doc["eager"]["raw_msgs"]),
        _entry("rma_plan", "eager.wire_transfers", k,
               doc["eager"]["wire_transfers"]),
        _entry("rma_plan", "coalesced.raw_msgs", k,
               doc["coalesced"]["raw_msgs"]),
        _entry("rma_plan", "coalesced.wire_transfers", 1 if packed else k,
               doc["coalesced"]["wire_transfers"]),
    ]


def _collect_serve_flow(doc: dict) -> list[dict]:
    out = []
    for scheme in ("retry", "credit"):
        qb = doc.get("queue_backpressure", {}).get(scheme)
        if qb is not None:
            out.append(_entry(
                "serve_flow", f"queue.{scheme}.wire_transfers_per_append",
                WIRE_TRANSFERS_PER_FUSED_APPEND,
                qb["wire_transfers_per_append"]))
            modeled = doc.get("model", {}).get("modeled_msg_rate_per_s")
            if modeled and "measured_msg_rate_per_s" in qb:
                out.append(_entry(
                    "serve_flow", f"queue.{scheme}.msg_rate_per_s",
                    modeled, qb["measured_msg_rate_per_s"],
                    tol=RATE_TOL, gate=False))
        eng = doc.get("serve_engine", {}).get(scheme)
        if eng is not None:
            out.append(_entry(
                "serve_flow", f"engine.{scheme}.wire_msgs_per_step",
                WIRE_TRANSFERS_PER_FUSED_APPEND,
                eng["msg_stats"]["wire_msgs_per_step"]))
    # credit flow control exists to make this count structural, not lucky
    credit = doc.get("serve_engine", {}).get("credit")
    if credit is not None:
        out.append(_entry("serve_flow", "engine.credit.retries", 0,
                          credit["retries"]))
    out.extend(_collect_transport(doc.get("transport")))
    out.extend(_collect_sim_serve(doc.get("sim_serve")))
    out.extend(_collect_sim_rendezvous(doc.get("sim_rendezvous")))
    return out


def _collect_transport(tp: Optional[dict]) -> list[dict]:
    """§16 transport gates: the pull path issues ZERO ring-payload
    transfers (descriptors only), both engines' per-step wire counts are
    structural, and the modeled eager/rendezvous crossover is a sharp
    flip (selecting at f* − ε and f* + ε must disagree)."""
    if not tp:
        return []
    out = []
    for size_name, series in tp.items():
        if size_name == "crossover":
            out.append(_entry(
                "serve_flow", "transport.crossover.flip_exact",
                1, series["flip_exact"]))
            continue
        out.append(_entry(
            "serve_flow", f"transport.{size_name}.rdv.ring_payload_appends",
            0, series["rendezvous"]["ring_payload_appends"]))
        out.append(_entry(
            "serve_flow", f"transport.{size_name}.rdv.wire_msgs_per_step",
            RENDEZVOUS_WIRE_MSGS_PER_STEP,
            series["rendezvous"]["wire_msgs_per_step"]))
        out.append(_entry(
            "serve_flow", f"transport.{size_name}.eager.wire_msgs_per_step",
            EAGER_WIRE_MSGS_PER_STEP,
            series["eager"]["wire_msgs_per_step"]))
        out.append(_entry(
            "serve_flow", f"transport.{size_name}.rdv.descriptor_appends",
            series["rendezvous"]["requests"],
            series["rendezvous"]["descriptor_appends"]))
    return out


def _collect_sim_rendezvous(ss: Optional[dict]) -> list[dict]:
    """§16 causal gates over the traced rendezvous slice: zero payload
    sends in the descriptor ring (COUNT_TOL — structural), complete and
    exact stitching of every completed pull, and the kv_pull segment
    within its latency budget."""
    if not ss:
        return []
    n = ss.get("requests", 0)
    out = [
        _entry("sim_rendezvous", "payload_sends", 0, ss["payload_sends"]),
        _entry("sim_rendezvous", "requests_connected", n, ss["connected"]),
        _entry("sim_rendezvous", "segment_sum_exact", n,
               ss["segment_sum_exact"]),
        _entry("sim_rendezvous", "critical_path_le_wall", n,
               ss["critical_path_le_wall"]),
        _budget_entry("sim_rendezvous", "ttft.p99_vt",
                      RENDEZVOUS_TTFT_BUDGET_VT, ss["ttft_vt"]["p99"]),
    ]
    segs = ss.get("segments_vt", {})
    for seg, budget in RENDEZVOUS_SEGMENT_BUDGET_VT.items():
        summ = segs.get(seg)
        if summ is not None:
            out.append(_budget_entry(
                "sim_rendezvous", f"seg.{seg}.p99_vt", budget, summ["p99"]))
    return out


def _collect_sim_serve(ss: Optional[dict]) -> list[dict]:
    """§15 causal gates over the traced serve slice: stitching must be
    complete and exact (COUNT_TOL — virtual time leaves no slack), and the
    per-segment p99s must stay within their latency budgets."""
    if not ss:
        return []
    n = ss.get("requests", 0)
    out = [
        _entry("sim_serve", "requests_connected", n, ss["connected"]),
        _entry("sim_serve", "segment_sum_exact", n, ss["segment_sum_exact"]),
        _entry("sim_serve", "critical_path_le_wall", n,
               ss["critical_path_le_wall"]),
        _budget_entry("sim_serve", "ttft.p99_vt", TTFT_BUDGET_VT,
                      ss["ttft_vt"]["p99"]),
    ]
    segs = ss.get("segments_vt", {})
    for seg, budget in SEGMENT_BUDGET_VT.items():
        summ = segs.get(seg)
        if summ is not None:
            out.append(_budget_entry(
                "sim_serve", f"seg.{seg}.p99_vt", budget, summ["p99"]))
    return out


def _collect_rmem(doc: dict) -> list[dict]:
    out = []
    for mode in ("inline", "paged"):
        d = doc.get(mode)
        if d is not None and "wire_transfers_per_append" in d:
            out.append(_entry(
                "rmem", f"{mode}.wire_transfers_per_append",
                WIRE_TRANSFERS_PER_FUSED_APPEND,
                d["wire_transfers_per_append"]))
    # §13 fused-vs-gather decode staging bound: the fused kernel's window
    # is the double-buffer (<= FUSED_STAGING_PAGES resident), the gather
    # baseline materializes the whole block.  Structural, so COUNT_TOL.
    dec = doc.get("decode")
    if dec is not None:
        ppb = int(dec["pages_per_block"])
        page_nbytes = float(dec["page_nbytes"])
        for path, pages in (("fused", min(FUSED_STAGING_PAGES, ppb)),
                            ("gather", ppb)):
            d = dec.get(path)
            if d is None:
                continue
            out.append(_entry(
                "rmem", f"decode.{path}.staging_pages_resident",
                pages, d["staging_pages_resident"]))
            out.append(_entry(
                "rmem", f"decode.{path}.staging_bytes_per_decode",
                pages * page_nbytes, d["staging_bytes_per_decode"]))
            out.append(_entry(
                "rmem", f"decode.{path}.wire_transfers_per_append",
                WIRE_TRANSFERS_PER_FUSED_APPEND,
                d["wire_transfers_per_append"]))
        # measured attend_us stays out of the table: a wall-clock time is
        # no structural count, so it is no drift
    return out


def collect(root: str = ".") -> list[dict]:
    """Gather drift entries from every smoke-bench JSON present in `root`."""
    entries: list[dict] = []
    for name, fn in (
        ("BENCH_rma_plan.json", _collect_rma_plan),
        ("BENCH_serve_flow.json", _collect_serve_flow),
        ("BENCH_rmem.json", _collect_rmem),
    ):
        doc = _load(root, name)
        if doc is not None:
            entries.extend(fn(doc))
    return entries


def format_table(entries: list[dict]) -> str:
    """Markdown model-vs-measured table (for stdout and step summaries)."""
    lines = [
        "| bench | metric | predicted | observed | rel err | tol | gate | ok |",
        "|---|---|---:|---:|---:|---:|---|---|",
    ]
    for e in entries:
        lines.append(
            f"| {e['bench']} | {e['metric']} | {e['predicted']:g} "
            f"| {e['observed']:g} | {e['rel_err']:.3g} | {e['tol']:g} "
            f"| {'yes' if e['gate'] else 'info'} "
            f"| {'OK' if e['ok'] else 'DRIFT'} |")
    return "\n".join(lines)


def violations(entries: list[dict]) -> list[dict]:
    return [e for e in entries if e["gate"] and not e["ok"]]


def write_json(entries: list[dict], path: str) -> None:
    bad = violations(entries)
    with open(path, "w") as f:
        json.dump({"entries": entries, "violations": len(bad),
                   "count_tol": COUNT_TOL, "rate_tol": RATE_TOL},
                  f, indent=2)
        f.write("\n")


def gate(root: str = ".", json_path: Optional[str] = None) -> list[dict]:
    """Collect, report, persist; raise SystemExit on gated drift."""
    entries = collect(root)
    table = format_table(entries)
    print("# model-vs-measured drift", flush=True)
    print(table, flush=True)
    if json_path:
        write_json(entries, json_path)
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary:
        try:
            with open(summary, "a") as f:
                f.write("### Model-vs-measured drift\n\n" + table + "\n")
        except OSError:
            pass
    bad = violations(entries)
    if bad:
        names = ", ".join(f"{e['bench']}:{e['metric']}" for e in bad)
        raise SystemExit(
            f"model-vs-measured drift beyond tolerance on {len(bad)} "
            f"metric(s): {names}")
    return entries


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="directory with BENCH_*.json")
    ap.add_argument("--json", default=None, help="write BENCH_drift.json here")
    args = ap.parse_args(argv)
    try:
        gate(args.root, args.json)
    except SystemExit as e:
        print(e, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
