"""The port's causal stitching, critical-path attribution and flight
recorder (`repro_torch.obs`): `tests/test_causal.py` replayed on
`repro_torch`, then held to the JAX package in-process (the same parsed
chrome trace of a traced 256-rank serve run, the same DAGs, breakdowns and
ledger), and the port's real `DisaggEngine` traced on the CPU.

The acceptance criteria pinned here:

  * a 256-rank traced serve conformance run yields one weakly-connected
    per-request DAG across ranks for every completed request;
  * the TTFT segment breakdown partitions [submit, first_token] exactly —
    ``segment_sum == ttft`` in virtual time, never approximately;
  * the critical path through any stitched DAG is ≤ its wall time, and
    == wall time for a serial (single-chain) DAG;
  * the sync-plane ledger's per-request shares are conservative (they sum
    to the attributable wait, never more);
  * a failing run under the flight recorder dumps a Perfetto trace plus a
    critical-path report that replay **byte-identically** from the same
    ``(seed, schedule)`` repro line.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import critpath, flight
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.causal import (build_dags, current_epoch_rids, current_rid,
                              edge, edge_rid, epoch_scope, request_scope)
from repro_torch.obs.critpath import (SEGMENTS, SyncLedger, aggregate,
                                critical_path, ttft_breakdown)
from repro_torch.obs.export import dumps_chrome_trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.trace import NULL_TRACER, Tracer, set_tracer


@pytest.fixture(autouse=True)
def _restore_tracer():
    """Every test leaves the process-wide tracer as it found it."""
    prev = obs_trace.TRACER
    yield
    set_tracer(prev)


def _ev(name, ts, rank=0, dur=None, **args):
    rec = {"ph": "i" if dur is None else "X", "name": name, "ts": ts,
           "rank": rank, "args": args}
    if dur is not None:
        rec["dur"] = dur
    return rec


# ================================================================ edge ids
class TestEdgeIds:
    def test_edge_is_a_pure_function(self):
        # no global counter: both sides of a boundary mint the same id
        assert edge(7, "flow0-3") == edge(7, "flow0-3") == "7:flow0-3"
        assert edge(7, "kv", i=2) == "7:kv#2"
        assert edge(7, "kv", i=0) == "7:kv"      # i=0 is the plain form

    def test_edge_rid_roundtrip(self):
        assert edge_rid(edge(41, "hop")) == 41
        assert edge_rid(edge(41, "hop", i=3)) == 41
        assert edge_rid("not-an-edge") is None


# ================================================================== scopes
class TestScopes:
    def test_request_scope_binds_and_restores(self):
        assert current_rid() is None
        with request_scope(5):
            assert current_rid() == 5
            with request_scope(6):               # scopes nest
                assert current_rid() == 6
            assert current_rid() == 5
        assert current_rid() is None

    def test_epoch_scope_sorts_rids(self):
        assert current_epoch_rids() == ()
        with epoch_scope([3, 1, 2]):
            assert current_epoch_rids() == (1, 2, 3)
        assert current_epoch_rids() == ()

    def test_scope_restored_on_exception(self):
        with pytest.raises(RuntimeError):
            with request_scope(9):
                raise RuntimeError("boom")
        assert current_rid() is None


# ========================================================== DAG stitching
class TestBuildDags:
    def test_explicit_edge_joins_cross_rank(self):
        e = edge(1, "wire")
        evs = [
            _ev("produce", 10, rank=0, rid=1, edge=e),
            _ev("consume", 20, rank=3, cause=e),
        ]
        dags = build_dags(evs)
        assert set(dags) == {1}
        dag = dags[1]
        assert dag.ranks() == [0, 3]
        assert (0, 1) in dag.edges
        assert dag.connected()

    def test_program_order_chains_same_rank(self):
        evs = [
            _ev("a", 10, rank=2, rid=4),
            _ev("b", 30, rank=2, rid=4),
            _ev("c", 20, rank=2, rid=4),
        ]
        dag = build_dags(evs)[4]
        # chained in TIME order (a -> c -> b), not insertion order
        names = [dag.events[i]["name"] for i in range(3)]
        assert names == ["a", "c", "b"]
        assert dag.edges == [(0, 1), (1, 2)]

    def test_rid_less_events_are_excluded(self):
        evs = [_ev("noise", 5, rank=0), _ev("a", 10, rank=0, rid=1)]
        dags = build_dags(evs)
        assert len(dags[1].events) == 1

    def test_cause_without_earlier_producer_is_ignored(self):
        # forward-only joins keep the graph acyclic by construction: a
        # cause firing before its producer in stable order makes no edge
        e = edge(2, "wire")
        evs = [
            _ev("consume", 10, rank=1, rid=2, cause=e),
            _ev("produce", 20, rank=0, rid=2, edge=e),
        ]
        dag = build_dags(evs)[2]
        assert dag.edges == []                   # different ranks, no chain
        assert not dag.connected()

    def test_events_join_via_edge_id_alone(self):
        # a consumer that only carries `cause` still lands in the right DAG
        e = edge(8, "flow1-2")
        evs = [
            _ev("send", 10, rank=1, rid=8, edge=e),
            _ev("deliver", 15, rank=2, cause=e),
        ]
        dag = build_dags(evs)[8]
        assert len(dag.events) == 2 and dag.connected()

    def test_disconnected_halves_detected(self):
        evs = [
            _ev("a", 10, rank=0, rid=3),
            _ev("b", 20, rank=1, rid=3),         # no edge, different rank
        ]
        assert not build_dags(evs)[3].connected()


# ================================================= critical-path properties
class TestCriticalPathProperties:
    def _random_dag(self, rng):
        """A random rid-1 event soup with random (acyclic-safe) causal
        links — build_dags only ever creates forward edges."""
        n = rng.randint(2, 24)
        evs = []
        for i in range(n):
            ts = rng.randint(0, 1000)
            dur = rng.choice([None, rng.randint(0, 50)])
            evs.append(_ev(f"e{i}", ts, rank=rng.randint(0, 4), dur=dur,
                           rid=1))
        # sprinkle explicit producer/consumer pairs
        for k in range(rng.randint(0, n)):
            e = edge(1, f"hop{k}")
            evs[rng.randrange(n)]["args"]["edge"] = e
            evs[rng.randrange(n)]["args"]["cause"] = e
        return build_dags(evs)[1]

    def test_critical_path_never_exceeds_wall(self):
        rng = random.Random(1234)
        for _ in range(50):
            dag = self._random_dag(rng)
            cp, path = critical_path(dag)
            assert 0 <= cp <= dag.wall()
            # the reported path is a real chain: indices strictly increase
            assert all(a < b for a, b in zip(path, path[1:]))

    def test_serial_dag_critical_path_equals_wall(self):
        # one rank, program order chains everything: a single chain spans
        # the DAG, so the critical path IS the wall time
        evs = [_ev(f"s{i}", 10 * i, rank=0, dur=5, rid=1) for i in range(6)]
        dag = build_dags(evs)[1]
        cp, path = critical_path(dag)
        assert cp == dag.wall() == 55
        assert path == list(range(6))

    def test_parallel_branches_take_the_longer_chain(self):
        e_fast, e_slow = edge(1, "fast"), edge(1, "slow")
        evs = [
            _ev("fork", 0, rank=0, rid=1, edge=e_fast),
            _ev("fork2", 0, rank=0, rid=1, edge=e_slow),
            _ev("fast", 10, rank=1, cause=e_fast),
            _ev("slow", 40, rank=2, cause=e_slow),
        ]
        cp, path = critical_path(build_dags(evs)[1])
        assert cp == 40
        assert path[-1] == 3                     # ends on the slow branch

    def test_traced_serve_run_cp_le_wall_every_request(self):
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        run_one("serve", 16, "delay", 0, tracer=tr)
        dags = build_dags(list(tr.events))
        assert dags
        for dag in dags.values():
            cp, _ = critical_path(dag)
            assert cp <= dag.wall()


# ========================================================= TTFT breakdown
class TestTtftBreakdown:
    def _request_events(self):
        return [
            _ev("serve.request.submit", 100, rank=0, rid=1),
            _ev("serve.request.prefill", 130, rank=0, rid=1, seg="prefill"),
            _ev("serve.request.page_alloc", 150, rank=0, rid=1,
                seg="page_alloc"),
            _ev("serve.decode.deliver", 180, rank=2, rid=1, seg="kv_wire",
                cause=edge(1, "flow0-2")),
            _ev("serve.request.first_token", 200, rank=2, rid=1,
                seg="attend"),
        ]

    def test_segments_partition_ttft_exactly(self):
        dag = build_dags(self._request_events())[1]
        bd = ttft_breakdown(dag)
        assert bd["ttft"] == 100
        assert bd["segments"]["prefill"] == 30
        assert bd["segments"]["page_alloc"] == 20
        assert bd["segments"]["kv_wire"] == 30
        assert bd["segments"]["attend"] == 20
        assert bd["segment_sum"] == bd["ttft"]   # telescoping: exact

    def test_unlabelled_tail_lands_in_host(self):
        evs = self._request_events()
        evs[-1]["args"].pop("seg")               # first_token unlabelled
        bd = ttft_breakdown(build_dags(evs)[1])
        assert bd["segments"]["host"] == 20      # the tail is never dropped
        assert bd["segment_sum"] == bd["ttft"]

    def test_unknown_segment_name_lands_in_host(self):
        evs = self._request_events()
        evs[1]["args"]["seg"] = "mystery"
        bd = ttft_breakdown(build_dags(evs)[1])
        assert bd["segments"]["host"] == 30
        assert bd["segment_sum"] == bd["ttft"]

    def test_incomplete_request_returns_none(self):
        evs = self._request_events()[:-1]        # never reached first token
        assert ttft_breakdown(build_dags(evs)[1]) is None

    def test_aggregate_summaries(self):
        bd = ttft_breakdown(build_dags(self._request_events())[1])
        agg = aggregate([bd, bd])
        assert agg["n"] == 2
        assert agg["ttft"]["count"] == 2 and agg["ttft"]["p99"] == 100
        assert agg["segments"]["prefill"]["sum"] == 60
        assert set(agg["segments"]) <= set(SEGMENTS)

    def test_traced_serve_run_sums_exact_for_all_requests(self):
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        report = run_one("serve", 32, "reorder", 0, tracer=tr)
        assert report["requests_checked"] > 0
        n = 0
        for dag in build_dags(list(tr.events)).values():
            bd = ttft_breakdown(dag)
            if bd is None:
                continue
            assert bd["segment_sum"] == bd["ttft"]
            n += 1
        assert n == report["requests_checked"]


# ========================================================== sync-plane ledger
class TestSyncLedger:
    def _sync_events(self):
        return [
            _ev("fabric.fence", 50, rank=-1, wait=12, epoch=3, rids=[1, 2]),
            _ev("fabric.flush", 60, rank=0, wait=4, epoch=3, rids=[1]),
            _ev("fabric.flush", 70, rank=1, wait=6, epoch=4, rids=()),
            _ev("serve.request.submit", 10, rank=0, rid=1),  # not sync plane
        ]

    def test_total_and_by_kind(self):
        led = SyncLedger.from_events(self._sync_events())
        assert len(led.entries) == 3
        assert led.total_wait() == 22
        assert led.by_kind() == {"fabric.fence": 12, "fabric.flush": 10}
        assert led.by_epoch() == {3: 16, 4: 6}

    def test_per_request_shares_are_conservative(self):
        led = SyncLedger.from_events(self._sync_events())
        shares = led.by_rid()
        # the fence's 12 splits evenly over rids (1, 2); rid 1 also pays
        # its solo flush; the rid-less flush attributes to nobody
        assert shares == {1: 10.0, 2: 6.0}
        assert sum(shares.values()) <= led.total_wait()
        assert led.summary()["attributed_wait"] == 16.0

    def test_traced_serve_run_waits_carry_epoch_rids(self):
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        run_one("serve", 32, "delay", 0, tracer=tr)
        led = SyncLedger.from_events(list(tr.events))
        assert led.entries                       # the sync plane was traced
        waited = [e for e in led.entries if e["wait"]]
        if waited:                               # schedule-dependent
            assert any(e["rids"] for e in waited)
            assert sum(led.by_rid().values()) <= led.total_wait() + 1e-9


# ================================================= serve conformance (§15)
class TestServeConformance:
    def test_256_rank_connected_dag_per_request(self):
        """The acceptance criterion, asserted here *outside* the protocol's
        own checks: every completed request at 256 ranks stitches into one
        weakly-connected cross-rank DAG with an exact segment partition."""
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        report = run_one("serve", 256, "reorder", 0, tracer=tr)
        assert report["requests_checked"] > 0
        dags = build_dags(list(tr.events))
        completed = 0
        for dag in dags.values():
            bd = ttft_breakdown(dag)
            if bd is None:
                continue
            completed += 1
            assert dag.connected()
            assert len(dag.ranks()) >= 2         # prefill and decode ranks
            assert bd["segment_sum"] == bd["ttft"]
        assert completed == report["requests_checked"]

    def test_serve_trace_byte_identical_across_replays(self):
        from repro_torch.sim.conformance import run_one

        traces = []
        for _ in range(2):
            tr = Tracer()
            run_one("serve", 64, "delay", 0, tracer=tr)
            assert tr.clock_domain == "virtual"
            traces.append(dumps_chrome_trace(tr))
        assert traces[0] == traces[1]

    def test_whole_trace_report(self):
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        run_one("serve", 32, "duplicate", 1, tracer=tr)
        rep = critpath.report(list(tr.events))
        assert rep["connected"]
        assert rep["completed"] == len(rep["requests"])
        assert rep["aggregate"]["ttft"]["count"] == rep["completed"]
        txt = critpath.format_report(rep)
        assert "ttft:" in txt and "sync plane:" in txt
        assert "DISCONNECTED" not in txt


# ============================================================ flight recorder
class TestFlightRecorder:
    def test_ring_keeps_newest_and_counts_drops(self):
        fr = FlightRecorder(capacity=4)
        for i in range(10):
            fr.event(f"e{i}", rank=0)
        assert [e["name"] for e in fr.events] == ["e6", "e7", "e8", "e9"]
        assert fr.dropped == 6
        fr.clear()
        assert len(fr.events) == 0 and fr.dropped == 0

    def test_export_surfaces_ring_drops_as_truncation_marker(self):
        from repro_torch.obs.export import chrome_trace

        fr = FlightRecorder(capacity=2)
        for i in range(5):
            fr.event(f"e{i}", rank=0)
        doc = chrome_trace(fr)
        (mark,) = [e for e in doc["traceEvents"]
                   if e["name"] == "trace.truncated"]
        assert mark["args"] == {"dropped": 3, "kept": 2}
        assert doc["metadata"]["dropped_events"] == 3

    def test_dump_writes_trace_and_report(self, tmp_path):
        fr = FlightRecorder(capacity=16)
        fr.event("serve.request.submit", rank=0, rid=1)
        fr.event("serve.request.first_token", rank=0, rid=1, seg="attend")
        trace_path, report_path = fr.dump(str(tmp_path / "f"), reason="boom")
        assert trace_path.endswith("f.trace.json")
        assert report_path.endswith("f.critpath.txt")
        doc = json.loads(open(trace_path).read())
        assert any(e["name"] == "serve.request.submit"
                   for e in doc["traceEvents"])
        txt = open(report_path).read()
        assert txt.startswith("reason: boom\n")
        assert "ring: kept=2 dropped=0" in txt
        assert "ttft:" in txt

    def test_on_error_noop_without_flight_recorder(self, tmp_path):
        with Tracer():                           # a plain tracer, not a ring
            assert flight.on_error(RuntimeError("x"),
                                   dump_dir=str(tmp_path)) is None
        assert obs_trace.TRACER is NULL_TRACER
        assert flight.on_error(RuntimeError("x")) is None

    def test_on_error_noop_without_dump_dir(self):
        prev = set_tracer(FlightRecorder())      # no dump_dir anywhere
        try:
            assert flight.on_error(RuntimeError("x")) is None
        finally:
            set_tracer(prev)

    def test_on_error_dumps_with_deterministic_names(self, tmp_path):
        fr = FlightRecorder(dump_dir=str(tmp_path))
        fr.event("e", rank=0)
        prev = set_tracer(fr)
        try:
            paths = flight.on_error(ValueError("first"), tag="heap0")
            assert paths is not None
            assert paths[0].endswith("flight-valueerror-heap0.trace.json")
            # a second dump from the same recorder gets an ordinal, so it
            # never clobbers the first
            paths2 = flight.on_error(ValueError("second"), tag="heap0")
            assert paths2[0].endswith("flight-valueerror-heap0-2.trace.json")
        finally:
            set_tracer(prev)

    def test_lock_timeout_triggers_flight_dump(self, tmp_path):
        from repro_torch.core.locks_sim import LockOrigin, LockTimeout, LockWindow

        win = LockWindow(p=1)
        LockOrigin(win, rank=0).lock_exclusive(0)
        fr = FlightRecorder(dump_dir=str(tmp_path))
        prev = set_tracer(fr)
        try:
            with pytest.raises(LockTimeout):
                LockOrigin(win, rank=1).lock_shared(0, max_retries=2)
        finally:
            set_tracer(prev)
        dumps = sorted(p.name for p in tmp_path.iterdir())
        assert "flight-locktimeout-lock_shared.trace.json" in dumps
        assert "flight-locktimeout-lock_shared.critpath.txt" in dumps

    def test_failing_run_flight_dump_replays_byte_identically(self, tmp_path):
        """The acceptance criterion: an injected failure (tear) under the
        flight recorder dumps a trace + critpath report that are a pure
        function of ``(seed, schedule)`` — two replays, identical bytes."""
        from repro_torch.sim.conformance import run_suite

        dumps = []
        for d in ("replay1", "replay2"):
            results = run_suite(["queue"], 32, ["tear"], [0],
                                trace_dir=str(tmp_path / d), flight=True)
            (failing,) = [r for r in results if not r["ok"]]
            assert failing["trace"].endswith("queue-tear-seed0.trace.json")
            assert failing["critpath"].endswith("queue-tear-seed0.critpath.txt")
            dumps.append((open(failing["trace"], "rb").read(),
                          open(failing["critpath"], "rb").read()))
        assert dumps[0] == dumps[1]
        doc = json.loads(dumps[0][0])
        assert doc["metadata"]["clock_domain"] == "virtual"
        assert obs_trace.TRACER is NULL_TRACER   # restored after the sweep


# ==================================================== serve protocol plumbing
class TestServeProtocolReport:
    def test_report_carries_causal_rollups(self):
        from repro_torch.sim.conformance import run_one

        report = run_one("serve", 16, "reorder", 0)
        assert report["protocol"] == "serve"
        assert report["requests_checked"] > 0
        assert report["ttft_p99"] > 0
        assert report["sync_wait"] >= 0

    def test_serve_needs_two_ranks(self):
        from repro_torch.sim.conformance import ConformanceError, run_one

        with pytest.raises(ConformanceError, match=">= 2 ranks"):
            run_one("serve", 1, "reorder", 0)


# ==================================================== against the reference
jconf = pytest.importorskip("repro.sim.conformance")
from repro.obs import causal as jcausal  # noqa: E402
from repro.obs import critpath as jcritpath  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.sim import conformance as tconf  # noqa: E402


def _dag_view(dag):
    return (dag.rid, [(e["name"], e["ts"], e["rank"]) for e in dag.events],
            dag.edges, dag.connected(), dag.wall())


class TestServeTraceMatchesReference:
    """One traced 256-rank serve run in each package: the parsed chrome
    traces are equal given one process name, and the port's stitching and
    attribution read the reference's events exactly as the reference does."""

    @pytest.fixture(scope="class")
    def traces(self):
        want, got = jtrace.Tracer(), Tracer()
        jconf.run_one("serve", 256, "delay", 2, tracer=want)
        tconf.run_one("serve", 256, "delay", 2, tracer=got)
        return want, got

    def test_chrome_traces_equal(self, traces):
        want, got = traces
        assert json.loads(dumps_chrome_trace(got, process_name="serve")) == \
            json.loads(jexport.dumps_chrome_trace(want, process_name="serve"))
        assert got.clock_domain == want.clock_domain == "virtual"

    def test_dags_breakdowns_and_ledger_equal(self, traces):
        want, got = traces
        events = list(want.events)
        jd, td = jcausal.build_dags(events), build_dags(events)
        assert sorted(td) == sorted(jd) and len(td) == 64 * 3
        for rid in jd:
            assert _dag_view(td[rid]) == _dag_view(jd[rid])
            assert ttft_breakdown(td[rid]) == jcritpath.ttft_breakdown(jd[rid])
            assert critical_path(td[rid]) == jcritpath.critical_path(jd[rid])
        bds = [ttft_breakdown(d) for d in td.values()]
        assert aggregate(bds) == jcritpath.aggregate(
            [jcritpath.ttft_breakdown(d) for d in jd.values()])
        assert SyncLedger.from_events(events).summary() == \
            jcritpath.SyncLedger.from_events(events).summary()
        assert critpath.format_report(critpath.report(events)) == \
            jcritpath.format_report(jcritpath.report(events))


# ===================================== the port's engine, traced on the CPU
_ENGINE_MODES = {
    "paged": dict(paged=True),
    "rendezvous": dict(transport="rendezvous"),
    "eager": dict(),
    "inline": dict(flow=False),
}


@pytest.mark.parametrize("mode", sorted(_ENGINE_MODES))
def test_traced_disagg_engine_partitions_ttft(mode):
    """The port's `DisaggEngine` (p = 4, 6 requests) under a `Tracer`: every
    request's segments partition its TTFT exactly (integer µs) and its
    critical path stays within its wall time.  The engine's DAG connects
    only for requests prefilled on rank 0, and never without flow control:
    `serve.request.submit` carries no rank (it lands on rank 0) and nothing
    joins it to another prefill rank, and the decode side's ``rid:kv``
    cause has no producer event inline.  The reference's engine does the
    same (`src/repro/serve/disagg.py`, submit against the decode cause)."""
    from repro_torch.serve.disagg import DisaggConfig, DisaggEngine

    cfg = DisaggConfig(**_ENGINE_MODES[mode])
    eng = DisaggEngine(4, cfg, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, cfg.block_tokens) for _ in range(6)]
    with Tracer() as tr:
        for rid, toks in enumerate(prompts):
            eng.submit(rid, toks)
        out = eng.run_until_drained()
    assert out == {rid: eng.reference(t) for rid, t in enumerate(prompts)}
    dags = build_dags(list(tr.events))
    assert sorted(dags) == list(range(6))
    for rid, dag in dags.items():
        bd = ttft_breakdown(dag)
        assert bd is not None and bd["segment_sum"] == bd["ttft"]
        cp, _ = critical_path(dag)
        assert cp <= dag.wall()
        prefill = {e["rank"] for e in dag.events
                   if e["rank"] < cfg.n_prefill
                   and e["name"] != "serve.request.submit"}
        if mode == "inline":
            assert prefill == set() and not dag.connected()
        else:
            assert len(prefill) == 1
            assert dag.connected() == (prefill == {0}), (rid, prefill)
