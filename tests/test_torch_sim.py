"""The port's simulated fabric (`repro_torch.sim`): `tests/test_sim.py`
replayed on `repro_torch` (256-rank conformance under chaos schedules,
(seed, schedule) reproducibility of forced violations, the fabric diff
tests' golden traces on the default fabric, the chaos transport's units),
then held to the JAX package in-process: equal conformance reports for
every protocol, the same `tear` verdicts, the same golden host traces.
Both simulators are numpy; no JAX child runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fabric import FabricError, LocalFabric
from repro_torch.sim.conformance import ConformanceError, RunSpec, run_one, run_suite
from repro_torch.sim.fabric import SCHEDULES, SimFabric
from repro_torch.sim.sched import Scheduler, VirtualClock

CHAOS3 = ("reorder", "delay", "duplicate")


# ===================================================================== scale
class TestConformance256:
    """The acceptance gate: queue, flow, and heap protocols at 256 simulated
    ranks under the three chaos schedules, invariants checked every step."""

    @pytest.mark.parametrize("schedule", CHAOS3)
    def test_queue_256(self, schedule):
        rep = run_one("queue", 256, schedule, seed=7)
        assert rep["accepted"] == rep["drained"] > 0

    @pytest.mark.parametrize("schedule", CHAOS3)
    def test_flow_256(self, schedule):
        rep = run_one("flow", 256, schedule, seed=7)
        assert rep["sent"] == rep["received"] > 0

    @pytest.mark.parametrize("schedule", CHAOS3)
    def test_heap_256(self, schedule):
        rep = run_one("heap", 256, schedule, seed=7)
        assert rep["allocs"] > 0 and rep["stale_tags_checked"] > 0

    def test_epoch_and_lock_256(self):
        assert run_one("epoch", 256, "reorder", seed=3)["epochs"] == 4
        rep = run_one("lock", 256, "delay", seed=3)
        assert rep["acquires"] == 2 * 256

    def test_kv_membership_change_under_chaos(self):
        rep = run_one("kv", 64, "duplicate", seed=3)
        assert rep["migrated"] is not None        # the leave actually moved pages
        assert rep["mapped"] > 0

    def test_chaos_schedules_are_not_vacuous(self):
        """Each schedule must actually perturb the wire, or the suite proves
        nothing: delays > 0 ticks, duplicates delivered and deduped, drops
        retransmitted."""
        dup = run_one("queue", 64, "duplicate", seed=5)["chaos"]
        assert dup["duplicates"] > 0 and dup["dup_discarded"] > 0
        drop = run_one("queue", 64, "drop", seed=5)["chaos"]
        assert drop["dropped"] > 0 and drop["retransmits"] == drop["dropped"]
        storm = run_one("heap", 64, "cas-storm", seed=5)
        assert storm["chaos"]["schedule"] == "cas-storm" and storm["allocs"] > 0

    def test_scale_regime_1024_ranks(self):
        """The regime no CI hardware reaches: 1024 simulated ranks."""
        rep = run_one("queue", 1024, "reorder", seed=11)
        assert rep["accepted"] == rep["drained"] > 1024


# ============================================================ reproducibility
class TestReproducibility:
    def test_same_seed_same_schedule_identical_run(self):
        a = run_one("queue", 32, "reorder", seed=42)
        b = run_one("queue", 32, "reorder", seed=42)
        assert a == b                              # events, vt, counts, chaos

    def test_forced_violation_reproduces_exactly(self):
        """The acceptance property: a forced invariant violation (the `tear`
        fault schedule breaks write-with-notification) reproduces at the
        same step with the same detail from its reported (seed, schedule)."""
        with pytest.raises(ConformanceError) as e1:
            run_one("queue", 64, "tear", seed=0)
        with pytest.raises(ConformanceError) as e2:
            run_one("queue", 64, "tear", seed=0)
        assert e1.value.step == e2.value.step
        assert e1.value.detail == e2.value.detail
        assert "--schedules tear --seeds 0" in e1.value.spec.repro()

    def test_tear_caught_on_epoch_protocol_too(self):
        with pytest.raises(ConformanceError, match="decoupled from payload"):
            run_one("epoch", 64, "tear", seed=1)

    def test_suite_driver_reports_repro_line(self):
        results = run_suite(["epoch"], 32, ["tear"], [9])
        assert len(results) == 1 and not results[0]["ok"]
        assert "--ranks 32 --schedules tear --seeds 9" in str(results[0]["error"])

    def test_suite_survives_non_conformance_failures(self):
        """A livelock (SchedulerError) or transport-internal FabricError in
        one run must not abort the sweep: it is reported with the same
        (seed, schedule) repro line and the remaining runs still execute."""
        from repro_torch.sim import conformance as cf

        def explode(spec, **kw):
            from repro_torch.sim.sched import SchedulerError

            raise SchedulerError("no quiescence after 42 events")

        cf.PROTOCOLS["_boom"] = explode
        try:
            results = run_suite(["_boom", "epoch"], 16, ["reorder"], [1])
        finally:
            del cf.PROTOCOLS["_boom"]
        assert [r["ok"] for r in results] == [False, True]
        err = str(results[0]["error"])
        assert "SchedulerError" in err and "--seeds 1" in err

    def test_scheduler_trace_is_deterministic(self):
        def runner(seed):
            sched = Scheduler(seed)

            def task(name):
                for _ in range(3):
                    yield

            for i in range(5):
                sched.spawn(f"t{i}", task(i))
            sched.run()
            return sched.trace

        assert runner(1) == runner(1)
        assert runner(1) != runner(2)


# ================================================================= diff test
class TestFabricDiff:
    """Refactored host paths on the DEFAULT fabric must be byte-identical to
    the pre-refactor behavior: these golden traces (state, receipts, stats,
    and the fabric's OpCounter/SyncStats ledgers) were captured from the
    direct-mutation implementations before the `Fabric` seam existed."""

    def test_host_queue_golden_trace(self):
        from repro_torch.rmaq.queue import HostQueueGroup

        g = HostQueueGroup(p=4, capacity=8, item_width=1)
        assert isinstance(g.fabric, LocalFabric)
        acc1 = g.step({0: [(1, np.float32(10)), (1, np.float32(11)),
                           (2, np.float32(12))], 3: [(1, np.float32(30))]})
        acc2 = g.step({r: [((r + 1) % 4, np.float32(100 + r))
                           for _ in range(6)] for r in range(4)})
        d1 = g.drain(1, 3)
        g.step({2: [(1, np.float32(77))]})
        assert acc1 == {0: [True] * 3, 3: [True]}
        assert acc2[0] == [True] * 5 + [False]     # ring-full backpressure
        assert g.ctrs.tolist() == [[0, 6, 6, 1, 6], [3, 9, 9, 0, 9],
                                   [0, 7, 7, 0, 7], [0, 6, 6, 0, 6]]
        assert [float(x[0]) for x in d1] == [10.0, 11.0, 30.0]
        assert [float(x[0]) for x in g.drain(1)] == [100.0] * 5 + [77.0]
        snap = g.fabric.snapshot()
        assert (snap["puts"], snap["gets"], snap["accs"]) == (28, 3, 22)
        assert snap["raw_msgs"] == snap["coalesced_msgs"] == 53
        assert snap["sync_flush_msgs"] == 7 and snap["sync_barrier_stages"] == 6
        assert snap["epoch"] == 3

    def test_host_flow_golden_trace(self):
        from repro_torch.rmaq.channel import Lane
        from repro_torch.rmaq.flow import HostFlowChannel

        f = HostFlowChannel(p=3, capacity=4, lanes=[Lane("kv", (1,), "float32")],
                            n_producers=2)
        sends = [f.send(i % 2, "kv", np.float32([i]), i, 2) for i in range(6)]
        f.flush()
        msgs = f.recv(2)
        sends.append(f.send(0, "kv", np.float32([9]), 9, 2))
        f.flush()
        assert sends == [True, True, True, True, False, False, True]
        assert [(m["src"], m["tag"]) for m in msgs] == [(0, 0), (0, 2),
                                                        (1, 1), (1, 3)]
        assert f.stats(2) == {"head": 4, "tail": 5, "enqueued": 5,
                              "dropped_by_me": 0, "notifications": 5,
                              "refreshes": 3, "deferred": 2, "rejected": 0,
                              "rebinds": 0,
                              "sends_by_kind": {"payload": 5, "descriptor": 0},
                              "bytes_by_kind": {"payload": 100, "descriptor": 0}}
        c = f.conservation(2)
        assert c["granted_minus_head"] == c["outstanding_plus_occupancy"] == 4
        snap = f.fabric.snapshot()
        # each refresh now reads the target's attach id beside its grant
        # block (the elastic-rebind guard): 3 refreshes -> 3 extra gets
        assert (snap["puts"], snap["gets"], snap["accs"]) == (5, 8, 6)
        assert snap["raw_msgs"] == 19 and snap["sync_flush_msgs"] == 3

    def test_host_heap_golden_trace(self):
        from repro_torch.rmem import heap

        pool = heap.HostPagePool(6)
        a = [pool.alloc() for _ in range(4)]
        pool.ref_add(a[1])
        freed = [pool.release(a[0]), pool.release(a[1]), pool.release(a[1])]
        b = pool.alloc()
        assert (a, b, freed) == ([0, 1, 2, 3], 1, [True, False, True])
        assert pool.conservation() == {"free": 3, "live": 3,
                                       "free_plus_live": 6, "capacity": 6}
        # AMO complexity unchanged: counts still live on the words themselves
        assert pool.total_amos == 20
        assert pool.gen.tolist() == [2, 3, 1, 1, 0, 0]

    def test_device_path_op_counts_unchanged(self):
        """The device path never touches the fabric seam: a queue append
        still counts raw=5 -> wire=2 with the same per-kind attribution
        (the plan fingerprint)."""
        from repro_torch.core.rma import OpCounter
        from repro_torch.mesh import Mesh
        from repro_torch.rmaq import queue as rq

        mesh = Mesh(1, "w", device="cpu")
        desc, state = rq.queue_allocate(mesh, 8, (), torch.float32)
        with OpCounter() as c:
            rq.enqueue(desc, state, torch.ones((1, 2)),
                       torch.zeros((1, 2), dtype=torch.int32))
        assert c.snapshot() == {
            "puts": 1, "gets": 1, "accs": 2, "colls": 0,
            "raw_msgs": 5, "coalesced_msgs": 2,
            "by_axis": {"w": {"accs": 2, "gets": 1, "puts": 1}},
        }

    def test_descriptor_cache_charges_fabric(self):
        from repro_torch.core import window as w

        win = w.Window("dynamic", None, (), torch.float32)
        fab = LocalFabric()
        cache = w.DescriptorCache(fabric=fab)
        rid = win.attach("a", (4,), torch.float32)
        cache.lookup(win, rid)
        cache.lookup(win, rid)                     # warm: 1 op, not a refetch
        assert cache.remote_ops == fab.ops.gets == 3


# ============================================================== fabric units
class TestSimFabricUnits:
    def _fab(self, schedule, seed=0):
        clock = VirtualClock()
        return SimFabric(4, SCHEDULES[schedule], seed, clock=clock), clock

    def test_delayed_put_invisible_until_delivered(self):
        fab, clock = self._fab("delay")
        store = np.zeros((4, 2), np.int64)
        fab.register("m", store)
        fab.put(0, 1, "m", (0,), 5)
        fab.flush(0)
        assert store[1, 0] == 0                    # in flight, not visible
        clock.advance(50)
        fab.deliver_due(clock.now)
        assert store[1, 0] == 5

    def test_flush_remote_is_remote_completion(self):
        fab, _ = self._fab("delay")
        store = np.zeros((4, 2), np.int64)
        fab.register("m", store)
        fab.put(0, 1, "m", (0,), 7)
        fab.flush_remote(0)                        # MPI_Win_flush semantics
        assert store[1, 0] == 7 and fab.next_due() is None

    def test_fence_add_waits_for_payload(self):
        fab, clock = self._fab("delay", seed=1)
        store = np.zeros((4, 2), np.int64)
        fab.register("m", store)
        fab.fence()                                # open epoch 1
        fab.put(0, 1, "m", (0,), 9)
        fab.flush(0)
        fab.fence_add(1, "m", (1,), 1)             # the notification
        assert store[1, 1] == 0                    # gated on the payload
        clock.advance(50)
        fab.deliver_due(clock.now)
        assert store[1].tolist() == [9, 1]         # payload, THEN notify

    def test_fence_add_waits_for_staged_unflushed_payload(self):
        """The contract covers ops ISSUED this epoch, not just flushed ones:
        a notification after a staged-but-unflushed put must still gate."""
        fab, clock = self._fab("delay", seed=2)
        store = np.zeros((4, 2), np.int64)
        fab.register("m", store)
        fab.put(0, 1, "m", (0,), 9)                # staged, no flush yet
        fab.fence_add(1, "m", (1,), 1)
        assert store[1, 1] == 0                    # gated on the staged put
        fab.flush(0)
        clock.advance(50)
        fab.deliver_due(clock.now)
        assert store[1].tolist() == [9, 1]

    def test_gate_held_across_other_sources_deliveries(self):
        """A gated notification must survive ANOTHER source's batch driving
        outstanding to zero while the first source's payload is still
        staged (the multi-producer write-with-notification hole)."""
        fab, clock = self._fab("delay", seed=4)
        store = np.zeros((4, 3), np.int64)
        fab.register("m", store)
        fab.put(0, 1, "m", (0,), 11)               # src 0: staged, NOT flushed
        fab.put(2, 1, "m", (1,), 22)
        fab.flush(2)                               # src 2: in flight
        fab.fence_add(1, "m", (2,), 1)
        clock.advance(50)
        fab.deliver_due(clock.now)                 # src 2 lands, outstanding=0
        assert store[1, 1] == 22
        assert store[1, 2] == 0                    # gate HELD: src 0 pending
        fab.flush(0)
        clock.advance(50)
        fab.deliver_due(clock.now)
        assert store[1].tolist() == [11, 22, 1]    # both payloads, then notify

    def test_drop_retransmit_preserves_per_link_fifo(self):
        """Non-reorder schedules promise per-link FIFO: a dropped batch's
        retransmit time is the link's FIFO floor, so later batches cannot
        overtake it."""
        from repro_torch.sim.fabric import ChaosConfig

        chaos = ChaosConfig("drop-fifo", delay_min=0, delay_max=2, drop_p=0.5,
                            retransmit_after=6)
        clock = VirtualClock()
        fab = SimFabric(4, chaos, seed=0, clock=clock)
        store = np.zeros((4, 1), np.int64)
        fab.register("m", store)
        applied = []
        fab.on_deliver = lambda info: applied.append(store[1, 0].item())
        for i in range(1, 9):
            fab.put(0, 1, "m", (0,), i)
            fab.flush(0)
        clock.advance(200)
        fab.deliver_due(clock.now)
        assert fab.dropped > 0                     # the chaos actually bit
        assert applied == sorted(applied), f"FIFO violated: {applied}"

    def test_two_channels_share_one_fabric_under_distinct_names(self):
        """Region names are namespaced per channel, so one fabric can carry
        several host channels (e.g. a heartbeat channel beside a flow one)."""
        from repro_torch.rmaq.channel import HostChannel, Lane
        from repro_torch.rmaq.flow import HostFlowChannel

        fab = LocalFabric(p=2)
        a = HostChannel(2, 8, [Lane("hb", (1,), "float32")], fabric=fab,
                        name="hb")
        b = HostFlowChannel(2, 8, [Lane("kv", (1,), "float32")], fabric=fab,
                            name="kv")
        a.send(0, "hb", np.float32([1.0]), 0, 1)
        assert b.send(0, "kv", np.float32([2.0]), 0, 1)
        a.flush()
        b.flush()
        assert a.recv(1)[0]["lane"] == "hb"
        assert b.recv(1)[0]["lane"] == "kv"
        assert b.conservation(1)["granted_minus_head"] == 8

    def test_duplicate_deliveries_apply_exactly_once(self):
        fab, clock = self._fab("duplicate", seed=3)
        store = np.zeros((4, 1), np.int64)
        fab.register("m", store)
        for i in range(20):
            fab.add(0, 1, "m", (0,), 1)
            fab.flush(0)
        clock.advance(100)
        fab.deliver_due(clock.now)
        assert store[1, 0] == 20                   # dedup: no double-applied add
        assert fab.duplicates > 0 and fab.dup_discarded == fab.duplicates

    def test_local_ops_bypass_the_wire(self):
        fab, _ = self._fab("delay")
        store = np.zeros((4, 1), np.int64)
        fab.register("m", store)
        fab.put(2, 2, "m", (0,), 3)                # src == dst: local memory
        assert store[2, 0] == 3

    def test_duplicate_region_registration_rejected(self):
        fab, _ = self._fab("none")
        fab.register("m", np.zeros((4, 1)))
        with pytest.raises(FabricError):
            fab.register("m", np.zeros((4, 1)))

    def test_repro_line_roundtrips_through_spec(self):
        spec = RunSpec("flow", 256, "delay", 123)
        line = spec.repro()
        assert "--protocols flow" in line and "--seeds 123" in line


# ====================================================== against the reference
jconf = pytest.importorskip("repro.sim.conformance")
from repro_torch.sim import conformance as tconf  # noqa: E402

# under `tear` the reference's queue, epoch and rendezvous runs raise
# ConformanceError; heap, kv, lock and serve pass; flow and rebind decode a
# torn ring row and raise ValueError out of the suite, which the port
# reports as a ConformanceError instead (ROADMAP §3)
TEAR_CAUGHT = ("queue", "epoch", "rendezvous")
TEAR_PASSES = ("heap", "kv", "lock", "serve")
TEAR_TORN_ROW = ("flow", "rebind")


def _norm(text: str) -> str:
    return text.replace("repro.sim.conformance", "repro_torch.sim.conformance")


class TestReferenceParity:
    @pytest.mark.parametrize("protocol", sorted(tconf.PROTOCOLS))
    def test_reports_equal_to_reference(self, protocol):
        """Every protocol at 64 ranks under reorder, delay and duplicate,
        seeds 0 and 1: the report dicts (events, virtual time, counts, chaos
        stats) are equal in both packages."""
        for schedule in CHAOS3:
            for seed in (0, 1):
                want = jconf.run_one(protocol, 64, schedule, seed)
                got = tconf.run_one(protocol, 64, schedule, seed)
                assert got == want, (schedule, seed)

    def test_protocol_tables_match(self):
        assert sorted(tconf.PROTOCOLS) == sorted(jconf.PROTOCOLS)
        assert sorted(SCHEDULES) == sorted(jconf.SCHEDULES)
        for name, cfg in SCHEDULES.items():
            assert vars(cfg) == vars(jconf.SCHEDULES[name])

    @pytest.mark.parametrize("protocol", TEAR_CAUGHT)
    def test_tear_caught_with_the_reference_text(self, protocol):
        with pytest.raises(jconf.ConformanceError) as want:
            jconf.run_one(protocol, 64, "tear", 0)
        with pytest.raises(tconf.ConformanceError) as got:
            tconf.run_one(protocol, 64, "tear", 0)
        assert (got.value.step, got.value.detail) == (want.value.step,
                                                      want.value.detail)
        assert str(got.value) == _norm(str(want.value))
        assert "python -m repro_torch.sim.conformance" in str(got.value)

    @pytest.mark.parametrize("protocol", TEAR_PASSES)
    def test_tear_passes_alike(self, protocol):
        assert (tconf.run_one(protocol, 64, "tear", 0)
                == jconf.run_one(protocol, 64, "tear", 0))

    @pytest.mark.parametrize("protocol", TEAR_TORN_ROW)
    def test_torn_ring_row_reported_not_raised(self, protocol):
        """The reference lets a torn row's decode error escape the suite;
        the port reports it as the violation, so a `tear` sweep over every
        protocol completes."""
        with pytest.raises(ValueError):
            jconf.run_one(protocol, 64, "tear", 0)
        with pytest.raises(tconf.ConformanceError,
                           match="malformed delivery"):
            tconf.run_one(protocol, 64, "tear", 0)

    def test_cli_tear_expect_fail_exits_zero(self, capsys):
        assert tconf.main(["--ranks", "64", "--schedules", "tear",
                           "--expect-fail"]) == 0
        out = capsys.readouterr().out
        assert "3/8 runs passed" in out
        assert tconf.main(["--ranks", "32", "--protocols", "queue,epoch",
                           "--schedules", "tear"]) == 1

    def test_cli_smoke_exits_zero(self, capsys):
        assert tconf.main(["--smoke"]) == 0
        assert "81/81 runs passed" in capsys.readouterr().out


def _queue_golden(queue_mod):
    g = queue_mod.HostQueueGroup(p=4, capacity=8, item_width=1)
    acc1 = g.step({0: [(1, np.float32(10)), (1, np.float32(11)),
                       (2, np.float32(12))], 3: [(1, np.float32(30))]})
    acc2 = g.step({r: [((r + 1) % 4, np.float32(100 + r)) for _ in range(6)]
                   for r in range(4)})
    d1 = [x.tolist() for x in g.drain(1, 3)]
    g.step({2: [(1, np.float32(77))]})
    d2 = [x.tolist() for x in g.drain(1)]
    return (acc1, acc2, d1, d2, g.ctrs.tolist(), g.buf.tolist(),
            [g.stats(r) for r in range(4)], g.fabric.snapshot())


def _flow_golden(flow_mod, lane_cls):
    f = flow_mod.HostFlowChannel(p=3, capacity=4,
                                 lanes=[lane_cls("kv", (1,), "float32")],
                                 n_producers=2)
    sends = [f.send(i % 2, "kv", np.float32([i]), i, 2) for i in range(6)]
    flags1 = f.flush()
    msgs = [(m["lane"], m["kind"], m["src"], m["tag"], m["payload"].tolist())
            for m in f.recv(2)]
    sends.append(f.send(0, "kv", np.float32([9]), 9, 2))
    flags2 = f.flush()
    return (sends, flags1, flags2, msgs, f.stats(2), f.conservation(2),
            f.granted.tolist(), f.limit.tolist(), f.sent.tolist(),
            f.fabric.snapshot())


def _heap_golden(heap_mod):
    pool = heap_mod.HostPagePool(6)
    a = [pool.alloc() for _ in range(4)]
    pool.ref_add(a[1])
    freed = [pool.release(a[0]), pool.release(a[1]), pool.release(a[1])]
    b = pool.alloc()
    return (a, b, freed, pool.conservation(), pool.total_amos,
            pool.gen.tolist(), pool.next.tolist())


class TestGoldenTracesMatchReference:
    """`TestFabricDiff`'s three scripted host runs give equal receipts,
    counters, ring contents, stats and fabric ledgers in both packages."""

    def test_queue(self):
        from repro.rmaq import queue as jq
        from repro_torch.rmaq import queue as tq

        assert _queue_golden(tq) == _queue_golden(jq)

    def test_flow(self):
        from repro.rmaq import channel as jch, flow as jfl
        from repro_torch.rmaq import channel as tch, flow as tfl

        assert _flow_golden(tfl, tch.Lane) == _flow_golden(jfl, jch.Lane)

    def test_heap(self):
        from repro.rmem import heap as jheap
        from repro_torch.rmem import heap as theap

        assert _heap_golden(theap) == _heap_golden(jheap)
