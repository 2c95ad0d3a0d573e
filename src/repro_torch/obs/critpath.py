"""Critical-path TTFT attribution and the sync-plane time ledger (§15).

Given the per-request DAGs stitched by `obs.causal.build_dags`, this module
answers the paper's core accounting question — *where did the time go?* —
two complementary ways:

  * **Segment breakdown** (`ttft_breakdown`): the interval from a request's
    ``serve.request.submit`` to its ``serve.request.first_token`` is cut at
    every milestone event carrying a ``seg`` attribute.  Each cut charges
    the elapsed time *since the previous milestone* to that segment, so the
    segments **partition** the TTFT interval exactly: their sum telescopes
    to TTFT with no double counting, exact in virtual time under
    `sim.sched` (the acceptance criterion).  Time before the first labelled
    milestone — and any unlabelled tail — lands in ``host`` rather than
    vanishing.

    Canonical segments (DESIGN.md §15 defines each):

      ``queue_wait``    submitted but not yet admitted / dequeued
      ``credit_stall``  blocked on flow-control credit refresh
      ``sync_wait``     inside flush / flush_remote / fence completion
      ``page_alloc``    acquiring KV pages from the remote heap
      ``kv_wire``       KV bytes in flight on the fabric (eager push)
      ``kv_pull``       consumer-issued one-sided KV gets (rendezvous §16)
      ``prefill``       prefill compute
      ``attend``        decode attention compute to the first token
      ``host``          everything not otherwise labelled

  * **Critical path** (`critical_path`): the longest elapsed-time chain
    through the DAG — max over causal chains of ``end(last) − ts(first)``.
    By construction it is ≤ the DAG's wall time (every chain lives inside
    the DAG's interval) and == wall time for a serial DAG (one chain spans
    it); the property tests pin both.

  * **Sync-plane ledger** (`SyncLedger`): every ``fabric.flush`` /
    ``fabric.flush_remote`` / ``fabric.fence`` / ``sync.flush*`` event
    carrying a ``wait`` attr is attributed to the epoch that incurred it
    and the requests riding that epoch (`obs.causal.epoch_scope`).  A wait
    shared by k requests is split evenly — totals stay conservative (the
    per-request shares sum to the epoch's wait, never more).  This is the
    baseline the ROADMAP's sync-plane diet must drive down.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .causal import RequestDAG, build_dags
from .metrics import Histogram

SEGMENTS = ("queue_wait", "credit_stall", "sync_wait", "page_alloc",
            "kv_wire", "kv_pull", "prefill", "attend", "host")

# sync-plane event names the ledger recognises (instant events with `wait`)
SYNC_EVENTS = ("fabric.flush", "fabric.flush_remote", "fabric.fence",
               "sync.flush", "sync.flush_local")

SUBMIT = "serve.request.submit"
FIRST_TOKEN = "serve.request.first_token"


# ======================================================================
# critical path
# ======================================================================
def critical_path(dag: RequestDAG) -> tuple:
    """Longest elapsed-time chain through the DAG: ``(length, node indices)``.

    Edges always point forward in stable trace order (see `build_dags`), so
    a single backward DP over indices suffices: for each node, the furthest
    end time reachable along causal edges, then maximise end − start over
    starting nodes.
    """
    evs = dag.events
    n = len(evs)
    if n == 0:
        return 0, []
    end = [ev["ts"] + ev.get("dur", 0) for ev in evs]
    succs: dict[int, list] = {}
    for a, b in dag.edges:
        succs.setdefault(a, []).append(b)
    # maxend[i]: furthest end reachable from i; nxt[i]: successor achieving it
    maxend = list(end)
    nxt: list[Optional[int]] = [None] * n
    for i in range(n - 1, -1, -1):
        for j in succs.get(i, ()):
            if maxend[j] > maxend[i]:
                maxend[i] = maxend[j]
                nxt[i] = j
    start = max(range(n), key=lambda i: maxend[i] - evs[i]["ts"])
    length = maxend[start] - evs[start]["ts"]
    path = [start]
    while nxt[path[-1]] is not None:
        path.append(nxt[path[-1]])
    return length, path


# ======================================================================
# segment breakdown
# ======================================================================
def ttft_breakdown(dag: RequestDAG) -> Optional[dict]:
    """Exact partition of [submit, first_token] into named segments.

    Returns ``{"rid", "ttft", "segments": {seg: t}, "segment_sum"}`` with
    ``segment_sum == ttft`` by construction, or None if the request never
    reached its first token (incomplete under chaos).
    """
    i_sub = dag.find(SUBMIT)
    i_tok = dag.find(FIRST_TOKEN)
    if i_sub is None or i_tok is None:
        return None
    t0 = dag.events[i_sub]["ts"]
    t1 = dag.events[i_tok]["ts"]
    segs = dict.fromkeys(SEGMENTS, 0)
    prev = t0
    for ev in dag.events:  # already in stable time order
        seg = ev.get("args", {}).get("seg")
        if seg is None or not (t0 < ev["ts"] <= t1):
            continue
        segs[seg if seg in segs else "host"] += ev["ts"] - prev
        prev = ev["ts"]
    segs["host"] += t1 - prev  # unlabelled tail: never dropped
    return {"rid": dag.rid, "ttft": t1 - t0, "segments": segs,
            "segment_sum": sum(segs.values())}


def aggregate(breakdowns: Sequence[dict]) -> dict:
    """Aggregate per-request breakdowns into per-segment summaries.

    ``{"n", "ttft": summary, "segments": {seg: summary}}`` where summary is
    `obs.metrics.Histogram.summary()` (count/sum/min/max/p50/p90/p99).
    """
    ttft = Histogram()
    hists = {seg: Histogram() for seg in SEGMENTS}
    for b in breakdowns:
        ttft.observe(b["ttft"])
        for seg, v in b["segments"].items():
            hists.setdefault(seg, Histogram()).observe(v)
    return {
        "n": len(breakdowns),
        "ttft": ttft.summary(),
        "segments": {seg: h.summary() for seg, h in hists.items()
                     if h.summary()["count"]},
    }


# ======================================================================
# sync-plane ledger
# ======================================================================
class SyncLedger:
    """Attribution of every sync-plane wait to its epoch and requests.

    ``entries`` is the raw list (kind, rank, epoch, wait, rids); the
    roll-ups answer "what is the sync plane costing, and who pays?".
    """

    def __init__(self) -> None:
        self.entries: list[dict] = []

    @classmethod
    def from_events(cls, events: Sequence[dict]) -> "SyncLedger":
        led = cls()
        for ev in events:
            if ev["name"] not in SYNC_EVENTS:
                continue
            args = ev.get("args", {})
            led.entries.append({
                "kind": ev["name"],
                "rank": ev["rank"],
                "ts": ev["ts"],
                "epoch": args.get("epoch"),
                "wait": args.get("wait", 0),
                "rids": list(args.get("rids", ())),
            })
        return led

    def total_wait(self) -> int:
        return sum(e["wait"] for e in self.entries)

    def by_kind(self) -> dict:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e["kind"]] = out.get(e["kind"], 0) + e["wait"]
        return out

    def by_epoch(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e["epoch"]] = out.get(e["epoch"], 0) + e["wait"]
        return out

    def by_rid(self) -> dict:
        """Per-request shares: an epoch's wait splits evenly across the
        rids riding it, so shares sum to the attributable total (waits on
        rid-less epochs stay on the epoch roll-up only)."""
        out: dict[int, float] = {}
        for e in self.entries:
            rids = e["rids"]
            if not rids or not e["wait"]:
                continue
            share = e["wait"] / len(rids)
            for rid in rids:
                out[rid] = out.get(rid, 0.0) + share
        return out

    def summary(self) -> dict:
        return {
            "events": len(self.entries),
            "total_wait": self.total_wait(),
            "by_kind": self.by_kind(),
            "attributed_wait": round(sum(self.by_rid().values()), 6),
        }


# ======================================================================
# whole-trace report
# ======================================================================
def report(events: Sequence[dict]) -> dict:
    """One-call analysis of a traced run: DAG connectivity, per-request
    breakdowns, aggregate segment percentiles, and the sync ledger."""
    dags = build_dags(events)
    breakdowns = []
    requests = []
    for rid in sorted(dags):
        dag = dags[rid]
        cp_len, _ = critical_path(dag)
        b = ttft_breakdown(dag)
        if b is not None:
            breakdowns.append(b)
        requests.append({
            "rid": rid,
            "ranks": dag.ranks(),
            "events": len(dag.events),
            "connected": dag.connected(),
            "wall": dag.wall(),
            "critical_path": cp_len,
            "breakdown": b,
        })
    return {
        "requests": requests,
        "completed": len(breakdowns),
        "connected": all(r["connected"] for r in requests),
        "aggregate": aggregate(breakdowns),
        "sync_ledger": SyncLedger.from_events(events).summary(),
    }


def format_report(rep: dict) -> str:
    """Human-readable critical-path report (flight dumps, CLI)."""
    lines = []
    agg = rep["aggregate"]
    lines.append(f"requests: {len(rep['requests'])}  "
                 f"completed: {rep['completed']}  "
                 f"connected: {rep['connected']}")
    if agg["n"]:
        t = agg["ttft"]
        lines.append(f"ttft: p50={t['p50']} p99={t['p99']} (n={agg['n']})")
        lines.append(f"{'segment':<14}{'p50':>10}{'p99':>10}{'sum':>12}")
        for seg in SEGMENTS:
            s = agg["segments"].get(seg)
            if s:
                lines.append(f"{seg:<14}{s['p50']:>10}{s['p99']:>10}"
                             f"{s['sum']:>12}")
    led = rep["sync_ledger"]
    lines.append(f"sync plane: total_wait={led['total_wait']} over "
                 f"{led['events']} events  by_kind={led['by_kind']}")
    for r in rep["requests"]:
        if not r["connected"]:
            lines.append(f"  DISCONNECTED rid={r['rid']} "
                         f"ranks={r['ranks']} events={r['events']}")
    return "\n".join(lines)
