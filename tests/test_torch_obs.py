"""The port's observability layer (`repro_torch.obs`, DESIGN.md §12):
`tests/test_obs.py` without its drift-gate class, replayed on `repro_torch`
(tracer, clock seam, metrics registry, Chrome-trace export determinism),
then held to the JAX package in-process (equal exports and registries).

The two contracts pinned here:

  * **Trace determinism** — the same ``(seed, schedule)`` conformance run
    exports byte-identical traces across two runs (virtual clock domain),
    including at the acceptance criterion's 256 ranks.
  * **No-op invariance** — running instrumented code with no tracer (the
    default `NullTracer`) produces exactly the same protocol results as a
    traced run: instrumentation observes, never perturbs.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import chrome_trace, dumps_chrome_trace
from repro_torch.obs.metrics import Histogram, MetricsRegistry, snapshot_delta
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer, set_tracer


@pytest.fixture(autouse=True)
def _restore_tracer():
    """Every test leaves the process-wide tracer as it found it."""
    prev = obs_trace.TRACER
    yield
    set_tracer(prev)


# ================================================================== tracer
class TestTracer:
    def test_default_is_noop(self):
        assert obs_trace.TRACER is NULL_TRACER
        assert not obs_trace.TRACER.enabled
        # the null span is a shared singleton: no allocation on hot paths
        assert obs_trace.TRACER.span("x") is NULL_SPAN
        with obs_trace.TRACER.span("x") as sp:
            sp.set(a=1)                          # absorbed silently

    def test_event_and_span_recording(self):
        tr = Tracer()
        tr.event("e.one", rank=3, n=7)
        with tr.span("s.outer", rank=1, k=2) as sp:
            tr.event("e.inner", rank=1)
            sp.set(raw=5, coalesced=1)
        assert [e["name"] for e in tr.events] == ["e.one", "e.inner", "s.outer"]
        outer = tr.named("s.outer")[0]
        assert outer["ph"] == "X"
        assert outer["args"] == {"k": 2, "raw": 5, "coalesced": 1}
        assert outer["dur"] >= 0
        assert tr.ranks() == [1, 3]
        assert len(tr.by_rank(1)) == 2

    def test_span_nesting_intervals_contain_children(self):
        tr = Tracer(clock=_TickClock())
        with tr.span("outer", rank=0):
            with tr.span("inner", rank=0):
                pass
        inner, outer = tr.named("inner")[0], tr.named("outer")[0]
        assert outer["ts"] <= inner["ts"]
        assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]

    def test_context_manager_installs_and_restores(self):
        assert obs_trace.TRACER is NULL_TRACER
        with Tracer() as tr:
            assert obs_trace.TRACER is tr
        assert obs_trace.TRACER is NULL_TRACER

    def test_clock_seam_switches_domain(self):
        tr = Tracer()
        assert tr.clock_domain == "wall_us"
        clk = _TickClock()
        tr.attach_clock(clk)
        assert tr.clock_domain == "virtual"
        clk.now = 42
        tr.event("a")
        assert tr.events[-1]["ts"] == 42
        tr.detach_clock()
        assert tr.clock_domain == "wall_us"


class _TickClock:
    """Minimal stand-in for sim.sched.VirtualClock."""

    def __init__(self):
        self.now = 0


# ============================================== snapshot schema unification
class TestSnapshotUnification:
    def test_snapshot_delta_nested_and_missing_keys(self):
        cur = {"a": 5, "nested": {"x": 3, "y": 1}, "tag": "s", "new": 2}
        prev = {"a": 2, "nested": {"x": 1}, "tag": "s"}
        assert snapshot_delta(cur, prev) == {
            "a": 3, "nested": {"x": 2, "y": 1}, "tag": "s", "new": 2}
        assert snapshot_delta(cur, None) == cur

    def test_opcounter_delta(self):
        from repro_torch.core.rma import OpCounter

        with OpCounter() as c:
            OpCounter.record("puts", 2, axis="x")
            before = c.snapshot()
            OpCounter.record("gets", 3, axis="x")
        d = c.delta(before)
        assert d["puts"] == 0 and d["gets"] == 3
        assert d["by_axis"]["x"] == {"gets": 3, "puts": 0}
        # accepts the live object too
        assert c.delta(c)["raw_msgs"] == 0

    def test_syncstats_delta(self):
        from repro_torch.core.epoch import SyncStats

        with SyncStats() as s:
            SyncStats.record("flush_msgs", 4)
            before = s.snapshot()
            SyncStats.record("flush_msgs", 1)
            SyncStats.record("barrier_stages", 3)
        d = s.delta(before)
        assert d["flush_msgs"] == 1 and d["barrier_stages"] == 3

    def test_planstats_snapshot_shares_schema(self):
        from repro_torch.core.plan import PlanStats

        st = PlanStats()
        st.raw, st.coalesced, st.bytes_wire = 8, 2, 64
        snap = st.snapshot()
        # same message-count key naming as OpCounter/SyncStats (§12.3)
        assert snap["raw_msgs"] == 8 and snap["coalesced_msgs"] == 2
        st.raw += 4
        assert st.delta(snap)["raw_msgs"] == 4

    def test_fabric_delta(self):
        import numpy as np

        from repro_torch.core.fabric import LocalFabric

        fab = LocalFabric(2)
        cells = np.zeros((2, 1), np.int64)
        fab.register("cell", cells)
        before = fab.snapshot()
        fab.put(0, 1, "cell", (0,), 7)
        fab.flush(0)
        fab.fence()
        d = fab.delta(before)
        assert d["puts"] == 1 and d["epoch"] == 1
        assert d["sync_flush_msgs"] == 1

    def test_registry_ingests_all_four_schemas(self):
        import numpy as np

        from repro_torch.core.epoch import SyncStats
        from repro_torch.core.fabric import LocalFabric
        from repro_torch.core.plan import PlanStats
        from repro_torch.core.rma import OpCounter

        reg = MetricsRegistry()
        with OpCounter() as c:
            OpCounter.record("puts", 2, axis="w")
        reg.ingest("rma", c.snapshot())
        reg.ingest("sync", SyncStats().snapshot())
        reg.ingest("plan", PlanStats().snapshot())
        fab = LocalFabric(2)
        fab.register("cell", np.zeros((2, 1), np.int64))
        fab.fence()
        reg.ingest("fabric", fab.snapshot())
        flat = reg.flat()
        assert flat["rma.puts"] == 2
        assert flat["rma.by_axis.w.puts"] == 2       # nested dicts recurse
        assert "sync.flush_msgs" in flat
        assert "plan.raw_msgs" in flat
        assert flat["fabric.epoch"] == 1
        assert "fabric.sync_barrier_stages" in flat


# ======================================================== metrics registry
class TestMetricsRegistry:
    def test_get_or_create_keyed_by_labels(self):
        reg = MetricsRegistry()
        a = reg.counter("ops", axis="x")
        b = reg.counter("ops", axis="x")
        c = reg.counter("ops", axis="y")
        assert a is b and a is not c
        a.inc(3)
        assert reg.flat() == {"ops{axis=x}": 3, "ops{axis=y}": 0}

    def test_histogram_percentiles(self):
        h = Histogram()
        for v in range(1, 101):
            h.observe(float(v))
        s = h.summary()
        assert s["count"] == 100 and s["min"] == 1.0 and s["max"] == 100.0
        assert s["p50"] == 51.0 and s["p99"] == 99.0
        assert Histogram().summary()["count"] == 0

    def test_flat_is_deterministic(self):
        reg = MetricsRegistry()
        reg.gauge("b").set(2)
        reg.gauge("a").set(1)
        reg.histogram("h").observe(5.0)
        assert list(reg.flat()) == ["a", "b", "h"]
        assert reg.flat()["h"]["count"] == 1


# ========================================================= trace determinism
class TestTraceDeterminism:
    def _traced(self, protocol, ranks, schedule, seed):
        from repro_torch.sim.conformance import run_one

        tr = Tracer()
        report = run_one(protocol, ranks, schedule, seed, tracer=tr)
        return tr, report

    def test_byte_identical_across_replays(self):
        tr1, _ = self._traced("queue", 64, "reorder", 0)
        tr2, _ = self._traced("queue", 64, "reorder", 0)
        assert tr1.clock_domain == "virtual"       # the Scheduler attached
        b1, b2 = dumps_chrome_trace(tr1), dumps_chrome_trace(tr2)
        assert b1 == b2
        assert len(tr1.events) > 0

    def test_different_seed_different_trace(self):
        tr1, _ = self._traced("epoch", 16, "delay", 0)
        tr2, _ = self._traced("epoch", 16, "delay", 1)
        assert dumps_chrome_trace(tr1) != dumps_chrome_trace(tr2)

    def test_256_rank_trace_byte_identical_and_loadable(self):
        """The acceptance criterion: 256 ranks, virtual time, Perfetto-shaped."""
        tr1, _ = self._traced("epoch", 256, "reorder", 0)
        tr2, _ = self._traced("epoch", 256, "reorder", 0)
        b1 = dumps_chrome_trace(tr1)
        assert b1 == dumps_chrome_trace(tr2)
        doc = json.loads(b1)
        assert doc["metadata"]["clock_domain"] == "virtual"
        evs = doc["traceEvents"]
        # per-rank thread tracks plus the control track
        names = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
        assert "control" in names
        assert {f"rank {r}" for r in (0, 255)} <= names
        # every non-metadata event is a well-formed complete/instant event
        for e in evs:
            if e["ph"] == "M":
                continue
            assert e["ph"] in ("X", "i") and "ts" in e and "tid" in e

    def test_run_one_restores_previous_tracer(self):
        from repro_torch.sim.conformance import run_one

        assert obs_trace.TRACER is NULL_TRACER
        run_one("epoch", 8, "delay", 0, tracer=Tracer())
        assert obs_trace.TRACER is NULL_TRACER

    def test_suite_exports_failing_run_traces(self, tmp_path):
        from repro_torch.sim.conformance import run_suite

        # tear is the fault-injection schedule: the queue protocol MUST
        # fail under it, and the suite must export that run's trace
        results = run_suite(["queue"], 32, ["tear"], [0],
                            trace_dir=str(tmp_path))
        assert any(not r["ok"] for r in results)
        failing = [r for r in results if not r["ok"]]
        for r in failing:
            assert r["trace"].endswith("queue-tear-seed0.trace.json")
            doc = json.loads(open(r["trace"]).read())
            assert doc["metadata"]["clock_domain"] == "virtual"
        assert obs_trace.TRACER is NULL_TRACER     # restored after the sweep


# ========================================================== no-op invariance
class TestNoopInvariance:
    def test_untraced_equals_traced_report(self):
        from repro_torch.sim.conformance import run_one

        plain = run_one("queue", 32, "duplicate", 3)
        traced_tr = Tracer()
        traced = run_one("queue", 32, "duplicate", 3, tracer=traced_tr)
        assert plain == traced
        assert len(traced_tr.events) > 0           # the tracer did observe

    def test_flow_report_unchanged_under_tracing(self):
        from repro_torch.sim.conformance import run_one

        plain = run_one("flow", 16, "reorder", 1)
        traced = run_one("flow", 16, "reorder", 1, tracer=Tracer())
        assert plain == traced


# ================================================== lock timeout diagnostics
class TestLockTimeoutDiagnostics:
    def test_wait_and_attempts_carried(self):
        from repro_torch.core.locks_sim import LockOrigin, LockTimeout, LockWindow

        win = LockWindow(p=1)
        holder = LockOrigin(win, rank=0)
        holder.lock_exclusive(0)
        blocked = LockOrigin(win, rank=1)
        with pytest.raises(LockTimeout) as ei:
            blocked.lock_shared(0, backoff=1e-6, max_retries=3)
        e = ei.value
        assert e.attempts == 3
        assert e.wait_s > 0
        assert "after 3 retries" in str(e)
        assert "held_by=rank 0" in str(e)          # pre-existing holder info

    def test_timeout_emits_trace_event(self):
        from repro_torch.core.locks_sim import LockOrigin, LockTimeout, LockWindow

        win = LockWindow(p=1)
        LockOrigin(win, rank=0).lock_exclusive(0)
        with Tracer() as tr:
            with pytest.raises(LockTimeout):
                LockOrigin(win, rank=1).lock_shared(0, max_retries=2)
        (ev,) = tr.named("lock.timeout")
        assert ev["args"]["attempts"] == 2
        assert ev["args"]["op"] == "lock_shared"
        assert ev["args"]["wait_us"] >= 0


# ========================================================== serve latency
class _StubServeModel:
    """Token t always produces (t + 1) % vocab; its cache has the [B, ...]
    leaf layout a real KV cache has."""

    vocab = 17

    def init_cache(self, b, max_seq, device=None):
        return {"k": torch.zeros(b, max_seq, 4, device=device),
                "len": torch.zeros((), dtype=torch.int32, device=device)}

    def _next(self, last):
        return torch.nn.functional.one_hot(
            (last.long() + 1) % self.vocab, self.vocab).float()

    def prefill(self, params, tokens, cache, _):
        return self._next(tokens[:, -1]), cache

    def decode_step(self, params, tokens, cache):
        return self._next(tokens), cache


class TestServeLatencyMetrics:
    def test_engine_ttft_tbt_histograms(self):
        from repro_torch.serve.engine import Request, ServeEngine

        eng = ServeEngine(_StubServeModel(), {}, n_slots=2, max_seq=32,
                          device="cpu")
        with Tracer() as tr:
            reqs = [Request(rid=i, prompt=[1, 2], max_new=4) for i in range(3)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
        m = eng.serve_metrics()
        assert m["ttft_us"]["count"] == 3          # one first-token per request
        assert m["ttft_us"]["p50"] > 0
        # 4 tokens per request, first from prefill: 3 decode gaps each
        assert m["tbt_us"]["count"] == 9
        assert len(tr.named("serve.request.submit")) == 3
        assert len(tr.named("serve.request.first_token")) == 3
        assert len(tr.named("serve.request.drain")) == 3

    def test_chrome_export_carries_serve_events(self):
        from repro_torch.serve.engine import Request, ServeEngine

        eng = ServeEngine(_StubServeModel(), {}, n_slots=1, max_seq=32,
                          device="cpu")
        with Tracer() as tr:
            eng.submit(Request(rid=7, prompt=[3], max_new=2))
            eng.run_until_drained()
        doc = chrome_trace(tr)
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"serve.request.submit", "serve.request.first_token",
                "serve.request.drain"} <= names
        assert doc["metadata"]["clock_domain"] == "wall_us"


# ===================================================== attend-step latency
class TestAttendLatencyHistogram:
    """§13 per-decode-step `serve.attend_us` rides the same exact-order-
    statistics histogram as TTFT/TBT: nearest-rank percentiles, no bucket
    error, empty-safe summaries."""

    def test_exact_nearest_rank_percentiles(self):
        reg = MetricsRegistry()
        h = reg.histogram("serve.attend_us")
        vals = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0, 6.0, 10.0]
        for v in vals:
            h.observe(v)
        xs = sorted(vals)
        for q in (0, 50, 90, 99, 100):
            rank = max(0, min(len(xs) - 1,
                              int(round(q / 100.0 * (len(xs) - 1)))))
            assert h.percentile(q) == xs[rank]
        s = h.summary()
        # nearest-rank on n=10: p50 -> rank round(4.5)=4, p90 -> 8, p99 -> 9
        assert s == {"count": 10, "sum": 55.0, "min": 1.0, "max": 10.0,
                     "p50": 5.0, "p90": 9.0, "p99": 10.0}

    def test_registry_get_or_create_accumulates(self):
        reg = MetricsRegistry()
        reg.histogram("serve.attend_us").observe(3.0)
        reg.histogram("serve.attend_us").observe(4.0)   # same instance
        assert reg.histogram("serve.attend_us").summary()["count"] == 2

    def test_empty_attend_histogram_is_zero_summary(self):
        s = Histogram().summary()
        assert s["count"] == 0
        assert all(s[k] == 0.0 for k in ("sum", "min", "max", "p50", "p90",
                                         "p99"))

    def test_single_observation_all_percentiles_equal(self):
        h = Histogram()
        h.observe(42.0)
        assert h.percentile(50) == h.percentile(99) == 42.0


# ============================================ disabled-span contract (§15 s1)
class TestNullSpanContract:
    def test_null_span_is_shared_and_absorbing(self):
        # one module-level singleton: every disabled span IS the same object
        assert NULL_TRACER.span("a") is NULL_TRACER.span("b") is NULL_SPAN
        sp = NULL_TRACER.span("x", rank=3, k=1)
        assert sp.set(raw=5) is sp               # chains, discards
        with sp as inner:
            assert inner is sp

    def test_null_tracer_mirrors_tracer_surface(self):
        # instrumented code never branches on tracer *type*; the two
        # tracers must expose the same callables
        for name in ("event", "span", "attach_clock", "detach_clock",
                     "enabled"):
            assert hasattr(NULL_TRACER, name), name
        NULL_TRACER.event("e", rank=0, a=1)      # all no-ops, no state
        NULL_TRACER.attach_clock(_TickClock())
        NULL_TRACER.detach_clock()

    def test_span_rejects_reserved_causal_attrs(self):
        # edge/cause are instant-event links (obs.causal): a span interval
        # has no single firing point, so the producer fails loudly
        tr = Tracer()
        with pytest.raises(ValueError, match="reserved causal attrs"):
            tr.span("s", rank=0, edge="1:hop")
        with pytest.raises(ValueError, match="reserved causal attrs"):
            tr.span("s", rank=0, cause="1:hop")
        tr.event("e", rank=0, edge="1:hop", cause="2:hop")  # events: fine
        assert tr.events[-1]["args"]["edge"] == "1:hop"

    def test_null_span_skips_validation(self):
        # the disabled path does zero work — including the reserved-attr
        # check (kwargs are never inspected when tracing is off)
        assert NULL_TRACER.span("s", edge="1:hop") is NULL_SPAN

    def test_disabled_path_cost_microbench(self):
        """Pin the zero-cost-when-off contract: the guarded disabled path
        (attribute load + falsy branch) must be far cheaper than recording.
        The 2x bound is deliberately generous — the real ratio is >10x —
        so a noisy CI runner cannot flake this, but an accidental dict
        build or lock acquisition on the disabled path still fails it."""
        import time

        n = 20_000

        def loop(tr):
            t0 = time.perf_counter()
            for _ in range(n):
                if tr.enabled:
                    tr.event("bench.op", rank=0, a=1, b=2)
            return time.perf_counter() - t0

        disabled = min(loop(NULL_TRACER) for _ in range(3))
        enabled = min(loop(Tracer()) for _ in range(3))
        assert disabled * 2 < enabled, (disabled, enabled)


# ===================================== histogram deltas + exemplars (§15 s2)
class TestHistogramSnapshotDelta:
    def test_hist_delta_summarizes_the_suffix(self):
        h = Histogram()
        h.observe(1.0)
        h.observe(5.0)
        before = {"lat": h.snapshot(), "n": 2}
        h.observe(9.0)
        h.observe(3.0)
        cur = {"lat": h.snapshot(), "n": 4}
        d = snapshot_delta(cur, before)
        assert d["n"] == 2
        # percentiles don't subtract: the delta is the summary of ONLY the
        # observations recorded between the two snapshots
        assert d["lat"]["count"] == 2
        assert d["lat"]["sum"] == 12.0
        assert d["lat"]["min"] == 3.0 and d["lat"]["max"] == 9.0

    def test_hist_delta_against_nothing_is_the_full_summary(self):
        h = Histogram()
        for v in (2.0, 4.0):
            h.observe(v)
        d = snapshot_delta({"lat": h.snapshot()}, None)
        assert d["lat"]["count"] == 2 and d["lat"]["sum"] == 6.0

    def test_empty_suffix_is_a_zero_summary(self):
        h = Histogram()
        h.observe(7.0)
        snap = {"lat": h.snapshot()}
        d = snapshot_delta({"lat": h.snapshot()}, snap)
        assert d["lat"]["count"] == 0

    def test_p99_exemplar_names_the_tail_request(self):
        h = Histogram()
        for rid, v in enumerate([10.0, 20.0, 300.0]):
            h.observe(v, exemplar=rid)
        s = h.summary()
        assert s["p99"] == 300.0
        assert s["p99_exemplar"] == 2            # the rid to go look at

    def test_exemplar_free_summary_keeps_prior_shape(self):
        h = Histogram()
        h.observe(5.0)
        assert "p99_exemplar" not in h.summary()

    def test_latest_exemplar_wins_per_value(self):
        h = Histogram()
        h.observe(9.0, exemplar=1)
        h.observe(9.0, exemplar=2)
        assert h.summary()["p99_exemplar"] == 2


# ================================== export: gzip + bounded traces (§15 s3)
class TestExportGzipAndTruncation:
    def _filled(self, n=10):
        tr = Tracer(clock=_TickClock())
        for i in range(n):
            tr.event(f"e{i}", rank=0)
        return tr

    def test_gzip_roundtrip_and_suffix(self, tmp_path):
        import gzip

        from repro_torch.obs.export import dump_chrome_trace

        tr = self._filled(3)
        path = dump_chrome_trace(tr, str(tmp_path / "t.json"), gzipped=True)
        assert path.endswith("t.json.gz")
        raw = gzip.decompress((tmp_path / "t.json.gz").read_bytes())
        assert raw.decode() == dumps_chrome_trace(tr)

    def test_gzip_bytes_are_a_pure_function_of_the_payload(self, tmp_path):
        from repro_torch.obs.export import dump_chrome_trace

        tr = self._filled(3)
        dump_chrome_trace(tr, str(tmp_path / "a.json"), gzipped=True)
        dump_chrome_trace(tr, str(tmp_path / "b.json"), gzipped=True)
        # mtime pinned to 0, no embedded filename: byte-identity survives
        # compression, so gzipped flight dumps still replay exactly
        assert (tmp_path / "a.json.gz").read_bytes() == \
               (tmp_path / "b.json.gz").read_bytes()

    def test_max_events_keeps_newest_with_marker(self):
        tr = self._filled(10)
        doc = chrome_trace(tr, max_events=4)
        kept = [e["name"] for e in doc["traceEvents"]
                if e["name"].startswith("e")]
        assert kept == ["e6", "e7", "e8", "e9"]  # newest survive
        (mark,) = [e for e in doc["traceEvents"]
                   if e["name"] == "trace.truncated"]
        assert mark["args"] == {"dropped": 6, "kept": 4}
        assert doc["metadata"]["dropped_events"] == 6

    def test_untruncated_trace_has_no_marker(self):
        doc = chrome_trace(self._filled(3))
        assert not [e for e in doc["traceEvents"]
                    if e["name"] == "trace.truncated"]
        assert doc["metadata"]["dropped_events"] == 0

    def test_truncation_is_logged_to_stderr(self, tmp_path, capsys):
        from repro_torch.obs.export import dump_chrome_trace

        dump_chrome_trace(self._filled(10), str(tmp_path / "t.json"),
                          max_events=4)
        err = capsys.readouterr().err
        assert "truncated" in err and "6 oldest events cut" in err


# ==================================================== against the reference
jconf = pytest.importorskip("repro.sim.conformance")
from repro.core import fabric as jfabric  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.core import fabric as tfabric  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.sim import conformance as tconf  # noqa: E402


class TestExportMatchesReference:
    @pytest.mark.parametrize("protocol", ["queue", "heap", "lock"])
    def test_256_rank_trace_bytes_equal(self, protocol):
        """Given one process name, the two packages' exports of one traced
        256-rank run are the same bytes."""
        want, got = jtrace.Tracer(), Tracer()
        jconf.run_one(protocol, 256, "reorder", 3, tracer=want)
        tconf.run_one(protocol, 256, "reorder", 3, tracer=got)
        assert dumps_chrome_trace(got, process_name="p") == \
            jexport.dumps_chrome_trace(want, process_name="p")

    def test_gzip_and_truncation_bytes_equal(self, tmp_path):
        from repro_torch.obs.export import dump_chrome_trace

        want, got = jtrace.Tracer(), Tracer()
        jconf.run_one("flow", 32, "delay", 0, tracer=want)
        tconf.run_one("flow", 32, "delay", 0, tracer=got)
        a = jexport.dump_chrome_trace(want, str(tmp_path / "a.json.gz"),
                                      process_name="p", max_events=500)
        b = dump_chrome_trace(got, str(tmp_path / "b.json.gz"),
                              process_name="p", max_events=500)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()

    def test_default_process_names(self):
        tr = Tracer()
        assert chrome_trace(tr)["traceEvents"][0]["args"]["name"] == \
            "repro_torch"


class TestMetricsMatchReference:
    def test_fabric_ledgers_ingest_alike(self):
        def run(fabric_mod, metrics_mod):
            fab = fabric_mod.LocalFabric(3)
            fab.register("cell", np.zeros((3, 2), np.int64))
            before = fab.snapshot()
            fab.put(0, 1, "cell", (0,), 7)
            fab.add(1, 2, "cell", (1,), 2)
            fab.flush(0)
            fab.fence_add(2, "cell", (0,), 1)
            fab.fence()
            got = fab.get(2, 1, "cell")
            reg = metrics_mod.MetricsRegistry()
            reg.ingest("fabric", fab.snapshot(), pool="a")
            reg.ingest("delta", fab.delta(before))
            reg.counter("c", k="v").inc(3)
            reg.gauge("g").set(2.5)
            h = reg.histogram("h")
            for v in (5, 1, 4, 2, 3, 9):
                h.observe(v, exemplar=int(v) * 10)
            return (reg.flat(), h.summary(), h.percentile(75),
                    got.tolist(), fab.gather(0, "cell").tolist())

        assert run(tfabric, tmetrics) == run(jfabric, jmetrics)

    def test_histogram_snapshot_delta_alike(self):
        rng = random.Random(4)
        vals = [rng.random() * 100 for _ in range(200)]
        out = []
        for mod in (jmetrics, tmetrics):
            h = mod.Histogram()
            for v in vals[:120]:
                h.observe(v)
            snap = {"h": h.snapshot()}
            for v in vals[120:]:
                h.observe(v)
            out.append((mod.snapshot_delta({"h": h.snapshot()}, snap),
                        [h.percentile(q) for q in (0, 10, 50, 90, 99, 100)]))
        assert out[0] == out[1]
