"""The port's host protocol mirrors (`repro_torch.rmaq`): `HostQueueGroup`,
`HostChannel`, `HostFlowChannel` and `ft.heartbeat.ChannelHeartbeat`.

The Host parts of `tests/test_rmaq.py`, `tests/test_flow.py` and
`tests/test_rendezvous.py` replayed on `repro_torch`; then the same seeded
send schedules through the JAX package's mirrors and the port's (equal
flags, drains, stats and fabric ledgers, in-process: both are numpy), and
the port's mirrors against its own device path on the CPU (the plain
path): `HostQueueGroup` against `enqueue_epoch` / `dequeue`, against
`enqueue_shift` and `kernels.rmaq.ops.queue_push` in wrapping and
backpressured rounds, and `HostFlowChannel` against `flow.send` / `recv`
on a schedule that exhausts the credits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.rmaq.channel import ChannelError, HostChannel, Lane  # noqa: E402
from repro_torch.rmaq.flow import (FlowError, HostFlowChannel,  # noqa: E402
                                   initial_grants)
from repro_torch.rmaq.queue import HostQueueGroup, QueueError  # noqa: E402
from repro_torch.sim.conformance import ConformanceError, run_one  # noqa: E402

from .helpers import given, settings, st  # noqa: E402


# ----------------------------------------------------------------- host queue
class TestHostQueue:
    def test_capacity_must_be_power_of_two(self):
        with pytest.raises(QueueError):
            HostQueueGroup(p=2, capacity=12, item_width=1)

    def test_fifo_per_producer_exactly_once(self):
        g = HostQueueGroup(p=3, capacity=8, item_width=1)
        seen = []
        serial = 0
        for _ in range(10):
            sends = {
                r: [(0, np.asarray([100 * r + serial + i], np.float32))
                    for i in range(2)]
                for r in range(3)
            }
            serial += 2
            g.step(sends)
            seen += [float(m[0]) for m in g.drain(0)]
        assert len(seen) == len(set(seen)) == 60          # exactly once
        for r in range(3):                                 # FIFO per producer
            vals = [v for v in seen if int(v) // 100 == r]
            assert vals == sorted(vals)

    def test_wraparound_many_times_over(self):
        g = HostQueueGroup(p=2, capacity=4, item_width=1)
        for i in range(40):                                # 10x around the ring
            g.step({1: [(0, np.asarray([i], np.float32))]})
            (msg,) = g.drain(0)
            assert float(msg[0]) == i

    def test_backpressure_reject_then_retry(self):
        g = HostQueueGroup(p=2, capacity=4, item_width=1)
        flags = g.step({1: [(0, np.asarray([i], np.float32)) for i in range(6)]})
        assert flags[1] == [True] * 4 + [False] * 2        # origin-side reject
        assert g.stats(1)["dropped_by_me"] == 2
        assert [float(m[0]) for m in g.drain(0)] == [0.0, 1.0, 2.0, 3.0]
        flags = g.step({1: [(0, np.asarray([9], np.float32))]})
        assert flags[1] == [True]                          # retry succeeds

    def test_notification_count_matches_model_accounting(self):
        """Every admitted message is exactly one notification — the §6.5
        model's per-message accounting, asserted on the counter."""
        g = HostQueueGroup(p=2, capacity=8, item_width=1)
        g.step({1: [(0, np.asarray([i], np.float32)) for i in range(5)]})
        s = g.stats(0)
        assert s["notifications"] == s["enqueued"] == 5
        assert g.stats(1)["notifications"] == 0            # producers get none


# -------------------------------------------------------------------- channel
class TestHostChannel:
    def _ch(self):
        return HostChannel(
            p=2, capacity=8,
            lanes=[Lane("beat", (2,), "int32"), Lane("kv", (3,), "float32")],
        )

    def test_typed_lanes_roundtrip_and_demux(self):
        ch = self._ch()
        ch.send(1, "beat", [7, 42], tag=5, dest=0)
        ch.send(1, "kv", [1.5, 2.5, 3.5], tag=9, dest=0)
        ch.flush()
        msgs = ch.recv(0)
        assert [m["lane"] for m in msgs] == ["beat", "kv"]  # shared FIFO
        assert msgs[0]["payload"].dtype == np.int32
        assert msgs[0]["payload"].tolist() == [7, 42]
        assert msgs[0]["src"] == 1 and msgs[0]["tag"] == 5
        np.testing.assert_allclose(msgs[1]["payload"], [1.5, 2.5, 3.5])

    def test_unknown_lane_and_wide_dtype_rejected(self):
        ch = self._ch()
        with pytest.raises(ChannelError):
            ch.send(0, "nope", [1, 2], tag=0, dest=1)
        with pytest.raises(ChannelError):
            HostChannel(p=2, capacity=8, lanes=[Lane("bad", (2,), "float64")])


# ------------------------------------------------------- heartbeat transport
class TestChannelHeartbeat:
    def test_dead_node_detected_through_channel(self):
        from repro_torch.ft.heartbeat import (ChannelHeartbeat, HeartbeatConfig,
                                        HeartbeatMonitor)

        t = [0.0]
        mon = HeartbeatMonitor(3, HeartbeatConfig(timeout_s=5),
                               clock=lambda: t[0])
        hb = ChannelHeartbeat(mon, capacity=8)
        for s in range(6):
            t[0] = float(2 * s)
            hb.beat(0, s)
            hb.beat(1, s)
            if s < 2:
                hb.beat(2, s)                      # node 2 stops beating
            hb.poll()
        assert mon.check_dead() == {2}
        assert mon.healthy_nodes() == [0, 1]
        assert hb.stats()["enqueued"] == 14        # 2 + 2 + (2 only twice)

    def test_backpressure_shows_as_staleness_not_crash(self):
        from repro_torch.ft.heartbeat import (ChannelHeartbeat, HeartbeatConfig,
                                        HeartbeatMonitor)

        mon = HeartbeatMonitor(4, HeartbeatConfig(timeout_s=1e9))
        hb = ChannelHeartbeat(mon, capacity=2)     # tiny monitor ring
        for s in range(4):
            for node in range(4):
                hb.beat(node, s)
            hb.poll()                              # only 2 beats land per epoch
        assert hb.stats()["dropped_total"] > 0


# ------------------------------------------------------------ initial grants
class TestInitialGrants:
    def test_partition_is_exact_and_producer_limited(self):
        g = initial_grants(4, 2, 16, n_producers=2)
        assert g.sum() == 16                       # conservation starts exact
        assert (g[2:] == 0).all()                  # non-producers hold nothing
        assert (g[:2] > 0).all()                   # every producer-lane funded

    def test_remainder_distributed(self):
        g = initial_grants(3, 1, 8, n_producers=3)
        assert g.sum() == 8 and g.max() - g.min() <= 1

    def test_capacity_must_fund_every_producer_lane(self):
        with pytest.raises(FlowError):
            initial_grants(4, 2, 4, n_producers=4)  # 4 < 4*2


# ----------------------------------------------------------- host flow channel
class TestHostFlowCredits:
    def _fc(self, p=2, capacity=4, n_producers=None):
        return HostFlowChannel(p, capacity, [Lane("kv", (1,), "float32")],
                               n_producers=n_producers)

    def test_exhaustion_refresh_recovery_round_trip(self):
        """The round trip: spend the cache dry -> deferred sends
        with a refresh attempt -> consumer drains (credits granted back) ->
        refresh picks them up -> sends recover.  Nothing is ever rejected
        at the ring."""
        fc = self._fc(p=2, capacity=4)             # 2 credits per producer
        sent = [fc.send(1, "kv", [float(i)], tag=i, dest=0) for i in range(4)]
        assert sent == [True, True, False, False]  # cache dry after 2
        assert fc.deferred == 2 and fc.refreshes >= 1
        fc.flush()
        assert fc.rejected == 0                    # credited sends never bounce

        drained = fc.recv(0)                       # grants 2 credits back
        assert [float(m["payload"][0]) for m in drained] == [0.0, 1.0]

        refreshes_before = fc.refreshes
        assert fc.send(1, "kv", [9.0], tag=9, dest=0)   # recovery via refresh
        assert fc.refreshes == refreshes_before + 1     # cache was dry: 1 get
        assert fc.send(1, "kv", [10.0], tag=10, dest=0)
        assert fc.refreshes == refreshes_before + 1     # cache warm: no get
        fc.flush()
        assert fc.rejected == 0
        assert [float(m["payload"][0]) for m in fc.recv(0)] == [9.0, 10.0]

    def test_common_path_never_refreshes(self):
        """A sender that stays within its credit batch pays zero refreshes —
        the wire-identical common path."""
        fc = self._fc(p=2, capacity=8)             # 4 credits per producer
        for i in range(4):
            assert fc.send(1, "kv", [float(i)], tag=i, dest=0)
        assert fc.refreshes == 0 and fc.deferred == 0

    @given(seed=st.integers(0, 100))
    @settings(max_examples=20, deadline=None)
    def test_conservation_under_multi_producer_load(self, seed):
        """sum(outstanding credits) + ring occupancy == capacity for every
        target, at every quiescent point, under random multi-producer
        traffic with random partial drains."""
        rng = np.random.RandomState(seed)
        p, cap = 4, 8
        fc = self._fc(p=p, capacity=cap)
        for _ in range(12):
            for src in range(p):
                for _ in range(rng.randint(0, 4)):
                    fc.send(src, "kv", [1.0], tag=0, dest=rng.randint(0, p))
            fc.flush()
            assert fc.rejected == 0
            for t in range(p):
                if rng.rand() < 0.7:
                    fc.recv(t, max_n=rng.randint(0, cap + 1))
                c = fc.conservation(t)
                assert c["granted_minus_head"] == cap, c
                assert c["outstanding_plus_occupancy"] == cap, c

    def test_fifo_preserved_per_producer(self):
        fc = self._fc(p=2, capacity=8)
        seen = []
        serial = 0.0
        for _ in range(6):
            while fc.send(1, "kv", [serial], tag=0, dest=0):
                serial += 1.0
            fc.flush()
            seen += [float(m["payload"][0]) for m in fc.recv(0)]
        assert seen == sorted(seen)                # FIFO survives credit gating
        assert fc.rejected == 0


# ----------------------------------------------------- wrap-safe refresh


# ------------------------------------------------------------- lane kinds
class TestLaneKinds:
    def test_descriptor_lane_round_trip(self):
        """A descriptor-kind lane travels the same ring as payload lanes
        and comes back tagged: `recv` messages carry the lane's kind, and
        the flow channel ledgers the send under the descriptor column."""
        fc = HostFlowChannel(
            2, 8,
            [Lane("kv", (2,), "float32"),
             Lane("desc", (2,), "int32", kind="descriptor")])
        assert fc.send(1, "desc", np.int32([7, 3]), tag=0, dest=0)
        assert fc.send(1, "kv", np.float32([1.0, 2.0]), tag=1, dest=0)
        fc.flush()
        msgs = fc.recv(0)
        by_lane = {m["lane"]: m for m in msgs}
        assert by_lane["desc"]["kind"] == "descriptor"
        assert by_lane["kv"]["kind"] == "payload"
        assert [int(x) for x in by_lane["desc"]["payload"]] == [7, 3]
        assert fc.sends_by_kind == {"payload": 1, "descriptor": 1}
        assert fc.bytes_by_kind["descriptor"] == fc.ring_slot_nbytes()

    def test_default_kind_is_payload(self):
        assert Lane("kv", (1,), "float32").kind == "payload"

    def test_unknown_kind_rejected(self):
        with pytest.raises(ChannelError, match="kind"):
            HostFlowChannel(2, 8, [Lane("x", (1,), "float32", kind="bulk")])


# ------------------------------------------- attach-id guarded refresh
class TestRefreshGuard:
    def test_rebind_rebases_stale_credit_cache(self):
        """The rebase: after an elastic leave/join re-attaches a
        consumer window, a producer's cached (limit, sent) pair describes
        a ring that no longer exists.  The refresh must detect the attach
        id bump and REBASE (limit := fresh grant, sent := 0) instead of
        treating the fresh grant as more headroom on the old counters —
        the un-guarded merge either over-credits into the new ring or
        livelocks with sent permanently above any reachable limit."""
        fc = HostFlowChannel(2, 4, [Lane("kv", (1,), "float32")])
        # spend the producer's whole window so its cache is maximally stale
        sent = [fc.send(1, "kv", np.float32([float(i)]), tag=i, dest=0)
                for i in range(4)]
        assert sent == [True, True, False, False]
        fc.flush()

        fc.rebind(0)                       # consumer 0 re-attached: new ring
        assert fc.rebinds == 0             # discovery happens at refresh time

        # recovery: the next send refreshes, sees the new attach id, rebases
        assert fc.send(1, "kv", np.float32([42.0]), tag=9, dest=0)
        assert fc.rebinds == 1
        fc.flush()
        msgs = fc.recv(0)
        assert [float(m["payload"][0]) for m in msgs] == [42.0]  # old ring gone
        assert fc.rejected == 0
        # conservation against the REBORN ring: grants cover exactly the
        # window again (granted - head == capacity)
        assert fc.conservation(0)["granted_minus_head"] == fc.capacity

    def test_departed_sender_stays_frozen(self):
        """rebind freezes the DEPARTED producer rank (sent := limit): a
        zombie task must not spend credits into the reborn ring."""
        fc = HostFlowChannel(3, 8, [Lane("kv", (1,), "float32")],
                             n_producers=2)   # producers 0,1; consumer 2
        assert fc.send(1, "kv", np.float32([1.0]), tag=0, dest=2)
        fc.rebind(1)                       # rank 1 left and rejoined
        assert not fc.send(1, "kv", np.float32([2.0]), tag=1, dest=2)


# --------------------------------------------------- conformance protocols
class TestConformance:
    def test_rendezvous_clean_schedules(self):
        for schedule in ("none", "reorder"):
            rep = run_one("rendezvous", 32, schedule, seed=0)
            assert rep["payload_sends"] == 0, rep    # ring carried no KV bytes
            assert rep["descriptor_sends"] > 0
            assert rep["pulled"] > 0 and rep["abandoned"] > 0

    def test_rendezvous_tear_is_caught(self):
        """The fault-injection acceptance: a descriptor notification torn
        from its payload write must be detected, not silently consumed."""
        with pytest.raises(ConformanceError, match="torn descriptor"):
            run_one("rendezvous", 64, "tear", seed=0)

    def test_rebind_protocol_smoke(self):
        rep = run_one("rebind", 16, "reorder", seed=0)
        assert rep["rebinds"] == 15        # every producer rebased exactly once

# ==================================================== against the reference
jq = pytest.importorskip("repro.rmaq.queue")
from repro.ft import heartbeat as jhb  # noqa: E402
from repro.rmaq import channel as jch  # noqa: E402
from repro.rmaq import flow as jfl  # noqa: E402
from repro_torch.ft import heartbeat as thb  # noqa: E402
from repro_torch.kernels.rmaq import ops as rmaq_ops  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmaq import channel as tch  # noqa: E402
from repro_torch.rmaq import flow as tfl  # noqa: E402
from repro_torch.rmaq import queue as tq  # noqa: E402


def _queue_schedule(seed, p=5, epochs=8, cap=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(epochs):
        sends = {}
        for r in range(p):
            if rng.rand() < 0.8:
                sends[r] = [(int(rng.randint(p)), rng.randn(3).astype(np.float32))
                            for _ in range(rng.randint(0, 5))]
        drains = {t: int(rng.randint(0, cap + 1)) for t in range(p)}
        out.append((sends, drains))
    return out


def _run_queue(queue_mod, seed):
    g = queue_mod.HostQueueGroup(p=5, capacity=8, item_width=3)
    log = []
    for sends, drains in _queue_schedule(seed):
        flags = g.step(sends)
        got = {t: [row.tolist() for row in g.drain(t, n)] for t, n in drains.items()}
        log.append((flags, got, [g.stats(t) for t in range(5)]))
    return log, g.ctrs.tolist(), g.buf.tolist(), g.fabric.snapshot()


def _flow_schedule(seed, p=4, epochs=10):
    rng = np.random.RandomState(seed)
    return [([(int(rng.randint(2)), "ab"[rng.randint(2)], int(rng.randint(2, p)),
               int(rng.randint(1000))) for _ in range(rng.randint(0, 9))],
             {t: int(rng.randint(0, 5)) for t in range(p)})
            for _ in range(epochs)]


def _run_flow(flow_mod, lane_cls, seed):
    f = flow_mod.HostFlowChannel(
        4, 8, [lane_cls("a", (2,), "int32"), lane_cls("b", (2,), "float32")],
        n_producers=2)
    log = []
    for sends, drains in _flow_schedule(seed):
        oks = [f.send(src, lane, [tag, -tag], tag, dst)
               for src, lane, dst, tag in sends]
        flags = f.flush()
        got = {t: [(m["lane"], m["kind"], m["src"], m["tag"], m["payload"].tolist())
                   for m in f.recv(t, n)] for t, n in drains.items()}
        log.append((oks, flags, got, [f.conservation(t) for t in range(4)]))
    return (log, [f.stats(t) for t in range(4)], f.granted.tolist(),
            f.limit.tolist(), f.sent.tolist(), f.fabric.snapshot())


def _run_channel(channel_mod, seed):
    rng = np.random.RandomState(seed)
    ch = channel_mod.HostChannel(
        3, 4, [channel_mod.Lane("beat", (2,), "int32"),
               channel_mod.Lane("kv", (3,), "float32", kind="descriptor")])
    log = []
    for _ in range(6):
        for _ in range(rng.randint(0, 7)):
            lane = "beat" if rng.rand() < 0.5 else "kv"
            w = 2 if lane == "beat" else 3
            ch.send(int(rng.randint(3)), lane, rng.randint(-9, 9, w), int(rng.randint(99)),
                    int(rng.randint(3)))
        flags = ch.flush()
        got = [[(m["lane"], m["kind"], m["src"], m["tag"], m["payload"].tolist())
                for m in ch.recv(t, int(rng.randint(0, 4)))] for t in range(3)]
        log.append((flags, got, [ch.stats(t) for t in range(3)]))
    return log, ch.group.fabric.snapshot()


class TestMirrorsMatchReference:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_host_queue_group(self, seed):
        assert _run_queue(tq, seed) == _run_queue(jq, seed)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_host_flow_channel(self, seed):
        want = _run_flow(jfl, jch.Lane, seed)
        got = _run_flow(tfl, tch.Lane, seed)
        assert got == want
        assert got[1][0]["deferred"] > 0 and got[1][0]["refreshes"] > 0

    @pytest.mark.parametrize("seed", [0, 1])
    def test_host_channel(self, seed):
        assert _run_channel(tch, seed) == _run_channel(jch, seed)

    def test_channel_heartbeat(self):
        def run(hb_mod):
            t = [0.0]
            mon = hb_mod.HeartbeatMonitor(4, hb_mod.HeartbeatConfig(timeout_s=5),
                                          clock=lambda: t[0])
            hb = hb_mod.ChannelHeartbeat(mon, capacity=4)
            polled = []
            for s in range(8):
                t[0] = 1.5 * s
                for node in range(4):
                    if node != 3 or s < 3:
                        hb.beat(node, s)
                polled.append(hb.poll())
            return (polled, mon.check_dead(), mon.healthy_nodes(), hb.stats(),
                    mon.last_step)

        assert run(thb) == run(jhb)

    def test_admission_is_the_device_function(self):
        """The mirror admits through the device path's `admission_plan` on
        CPU tensors; it equals the reference's numpy admission."""
        rng = np.random.RandomState(3)
        for _ in range(20):
            p, cap = rng.randint(2, 9), 16
            C = rng.randint(0, 7, size=(p, p)).astype(np.int64)
            used = rng.randint(0, cap + 1, size=p).astype(np.int64)
            want = jq.admission_plan(C, used, cap, xp=np)
            got = tq.admission_plan(torch.from_numpy(C), torch.from_numpy(used), cap)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), b)


# ================================= the mirrors against the port's device path
def _u32(x):
    return np.asarray(x, np.uint64) & np.uint64(0xFFFFFFFF)


def _lift(ctrs):
    """A device counter block (uint32 values) as the mirror's 64-bit one:
    the same values mod 2**32, with head <= tail as integers (the mirror's
    counters never wrap, so tail - head is its occupancy)."""
    c = ctrs.numpy().astype(np.uint64)
    occ = (c[:, tq.TAIL] - c[:, tq.HEAD]) & np.uint64(0xFFFFFFFF)
    c[:, tq.TAIL] += np.where(c[:, tq.TAIL] < occ, np.uint64(1 << 32), np.uint64(0))
    c[:, tq.HEAD] = c[:, tq.TAIL] - occ
    return c


def _check_queue_equal(g, state):
    np.testing.assert_array_equal(g.buf.view(np.int32),
                                  state.buf.numpy().view(np.int32))
    np.testing.assert_array_equal(_u32(g.ctrs), state.ctrs.numpy().astype(np.uint64))


class TestHostQueueMatchesDevice:
    P, K, W, CAP = 8, 6, 2, 16

    def _pair(self):
        mesh = Mesh(self.P, "x", device="cpu")
        desc, state = tq.queue_allocate(mesh, self.CAP, (self.W,), torch.float32)
        return mesh, desc, state, HostQueueGroup(self.P, self.CAP, self.W)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_destinations_epoch_and_drain(self, seed):
        """Seeded random destinations (some -1: no message), epoch after
        epoch: the accepted flags, the ring, the five counters, and each
        rank's dequeue against its drain, slot for slot."""
        mesh, desc, state, g = self._pair()
        rng = np.random.RandomState(seed)
        for _ in range(6):
            msgs = rng.randn(self.P, self.K, self.W).astype(np.float32)
            dest = rng.randint(-1, self.P, size=(self.P, self.K))
            state, rec, _ = tq.enqueue_epoch(desc, state, torch.from_numpy(msgs),
                                             torch.from_numpy(dest))
            flags = g.step({r: [(int(d), msgs[r, j]) for j, d in enumerate(dest[r])
                                if d >= 0] for r in range(self.P)})
            for r in range(self.P):
                acc = rec.accepted[r].numpy()
                assert flags[r] == [bool(a) for a, d in zip(acc, dest[r]) if d >= 0]
                assert not acc[dest[r] < 0].any()
            _check_queue_equal(g, state)
            n = int(rng.randint(0, self.CAP + 1))
            state, items, valid = tq.dequeue(desc, state, n)
            for r in range(self.P):
                rows = g.drain(r, n)
                assert int(valid[r].sum()) == len(rows)
                for i, row in enumerate(rows):
                    np.testing.assert_array_equal(row.view(np.int32),
                                                  items[r, i].numpy().view(np.int32))
            _check_queue_equal(g, state)

    @pytest.mark.parametrize("round_", ["wrap", "backpressure"])
    def test_shift_round_against_queue_push_and_enqueue_shift(self, round_):
        """Every rank's k items to rank r + 1, from tails rebased to
        2**32 - 2 (the ring and the counter wrap) or with every even rank's
        ring left 3 slots free: the mirror, `kernels.rmaq.ops.queue_push`
        (its plain path here) and `queue.enqueue_shift` agree — accepted
        flags an accepted prefix of n_sent, rings bit-equal, TAIL, ENQ,
        NOTIF and DROP equal mod 2**32."""
        mesh, desc, state, g = self._pair()
        p, k, cap = self.P, self.K, self.CAP
        rng = np.random.RandomState(7)
        first = rng.randn(p, 3, self.W).astype(np.float32)
        state, _, _ = tq.enqueue_epoch(desc, state, torch.from_numpy(first),
                                       torch.from_numpy(rng.randint(0, p, (p, 3))))
        ctrs = state.ctrs.clone()
        if round_ == "wrap":
            ctrs[:, tq.HEAD] = (ctrs[:, tq.HEAD] + (2**32 - 2) - ctrs[:, tq.TAIL]) & 0xFFFFFFFF
            ctrs[:, tq.TAIL] = 2**32 - 2
        else:
            ctrs[::2, tq.HEAD] = (ctrs[::2, tq.TAIL] - (cap - 3)) & 0xFFFFFFFF
        ring = state.buf.clone()
        msgs = torch.from_numpy(rng.randn(p, k, self.W).astype(np.float32))
        g.buf[...] = ring.numpy()
        g.ctrs[...] = _lift(ctrs)

        flags = g.step({r: [((r + 1) % p, msgs[r, j].numpy()) for j in range(k)]
                        for r in range(p)})
        wire = tq.u32_to_wire(ctrs[:, [tq.HEAD, tq.TAIL]]).contiguous()
        k_ring, k_ctr, n_sent, n_notif = rmaq_ops.queue_push(ring.clone(), wire, msgs, 1, mesh)
        s_state, rec = tq.enqueue_shift(desc, tq.QueueState(ring.clone(), ctrs.clone()),
                                        msgs, 1)
        for r in range(p):
            assert flags[r] == [True] * int(n_sent[r]) + [False] * (k - int(n_sent[r]))
            assert flags[r] == rec.accepted[r].tolist()
        if round_ == "backpressure":
            assert int(n_sent.min()) < k
        else:
            assert ((ctrs[:, tq.TAIL] % cap) + n_sent.long() > cap).any()
        np.testing.assert_array_equal(g.buf.view(np.int32), k_ring.numpy().view(np.int32))
        _check_queue_equal(g, s_state)
        np.testing.assert_array_equal(_u32(g.ctrs[:, tq.TAIL]),
                                      k_ctr[:, 1].numpy().astype(np.uint32))
        notif = _u32(g.ctrs[:, tq.NOTIF]) - _u32(ctrs[:, tq.NOTIF].numpy())
        np.testing.assert_array_equal(notif & np.uint64(0xFFFFFFFF),
                                      n_notif.numpy().astype(np.uint64))


class TestHostFlowMatchesDevice:
    """p = 4 (2 producers, 2 consumers), 2 lanes, queue 64, the disagg
    shape: a seeded schedule far beyond the credits, each producer sending
    its oldest pending messages each epoch and keeping what is deferred,
    each consumer draining a few: the same messages arrive per (src, dest,
    lane) in the same order, nothing is rejected, and conservation holds
    after every epoch on both."""

    P, NPROD, CAP, K, DRAIN = 4, 2, 64, 16, 6

    def test_exhausted_credits_deliver_alike(self):
        p, cap = self.P, self.CAP
        rng = np.random.RandomState(11)
        todo = {r: [(int(rng.randint(self.NPROD, p)), int(rng.randint(2)), 1000 * r + i)
                    for i in range(120)] for r in range(self.NPROD)}
        lanes = [tch.Lane("a", (2,), torch.int32), tch.Lane("b", (2,), torch.int32)]
        hfc = HostFlowChannel(p, cap, lanes, n_producers=self.NPROD)
        mesh = Mesh(p, "x", device="cpu")
        channel, qs, fs = tfl.flow_allocate(mesh, cap, lanes, n_producers=self.NPROD)
        host_q = {r: list(v) for r, v in todo.items()}
        dev_q = {r: list(v) for r, v in todo.items()}
        got_h: dict = {}
        got_d: dict = {}
        deferred_d = 0
        for epoch in range(200):
            if not any(host_q.values()) and not any(dev_q.values()) and \
                    hfc.conservation(2)["occupancy"] == hfc.conservation(3)["occupancy"] == 0 \
                    and int(tq.available(qs).sum()) == 0:
                break
            for r in range(self.NPROD):                # the mirror
                keep = []
                for dst, lane, tag in host_q[r][: self.K]:
                    if not hfc.send(r, "ab"[lane], [tag, -tag], tag, dst):
                        keep.append((dst, lane, tag))
                host_q[r] = keep + host_q[r][self.K:]
            hfc.flush()
            for t in range(p):
                for m in hfc.recv(t, self.DRAIN):
                    got_h.setdefault((m["src"], t, m["lane"]), []).append(
                        m["payload"].tolist())
            dest = torch.full((p, self.K), -1, dtype=torch.int64)     # the device
            lane = torch.zeros((p, self.K), dtype=torch.int64)
            tag = torch.zeros((p, self.K), dtype=torch.int64)
            for r in range(self.NPROD):
                for j, (d, ln, tg) in enumerate(dev_q[r][: self.K]):
                    dest[r, j], lane[r, j], tag[r, j] = d, ln, tg
            payload = torch.stack([tag, -tag], dim=-1).to(torch.int32)
            qs, fs, rec = tfl.send(channel, qs, fs, "a", payload, tag, dest, lane)
            assert int(rec.rejected.sum()) == 0
            deferred_d += int(rec.n_deferred.sum())
            for r in range(self.NPROD):
                sent = rec.accepted[r].tolist()
                dev_q[r] = ([m for m, ok in zip(dev_q[r][: self.K], sent) if not ok]
                            + dev_q[r][self.K:])
            qs, fs, batch = tfl.recv(channel, qs, fs, self.DRAIN)
            words, ok = channel.payload_all(batch)
            for t in range(p):
                for i in range(self.DRAIN):
                    if ok[t, i]:
                        key = (int(batch.src[t, i]), t, "ab"[int(batch.lane_id[t, i])])
                        got_d.setdefault(key, []).append(words[t, i].tolist())
            assert hfc.rejected == 0
            for t in range(p):
                c = hfc.conservation(t)
                assert c["granted_minus_head"] == c["outstanding_plus_occupancy"] == cap
            c = tfl.conservation(channel, qs, fs)
            assert (c["granted_minus_head"] == cap).all()
            assert (c["outstanding_plus_occupancy"] == cap).all()
        else:
            raise AssertionError("the schedule did not drain in 200 epochs")
        assert got_h == got_d
        assert sum(map(len, got_h.values())) == 240
        for (src, _, _), seq in got_h.items():
            tags = [w[0] for w in seq]
            assert tags == sorted(tags) and all(t // 1000 == src for t in tags)
        assert hfc.deferred > 0 and deferred_d > 0
