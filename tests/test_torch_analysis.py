"""The port's `repro_torch.analysis` (memory-model checker, access IR,
lint): `tests/test_analysis.py` replayed on `repro_torch`, the lint run
over `src/repro_torch`, then held to the JAX package in-process (the same
access IR from one port plan, the same race verdicts, the same lint
findings).

Falsifiability anchors (the checker must be able to FAIL):

  * a hand-written racy two-rank program is flagged with the exact
    conflicting descriptor pair (both provenance strings);
  * the `tear` chaos schedule is flagged as notify-before-payload;
  * all six conformance protocols run CLEAN under the checker at 256
    simulated ranks;
  * the fabric ledgers are byte-identical with and without the shadow
    attached (golden-trace compatibility).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import ir as air
from repro_torch.analysis import lint
from repro_torch.analysis.races import (RaceChecker, check_ir, conflicts)
from repro_torch.core import plan as plan_mod
from repro_torch.core.fabric import LocalFabric
from repro_torch.core.locks_sim import (WRITER_BIT, LockOrigin, LockStateError,
                                  LockWindow, _AtomicWord)
from repro_torch.obs import trace as obs_trace
from repro_torch.sim import conformance as conf
from repro_torch.sim.fabric import SCHEDULES, SimFabric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local(p=3, cells=4):
    fab = LocalFabric(p=p)
    fab.register("win", np.zeros((p, cells), np.int64))
    return fab, fab.attach_shadow(RaceChecker(p))


def _sim(schedule, p=4, cells=4):
    fab = SimFabric(p, SCHEDULES[schedule], seed=0)
    fab.register("win", np.zeros((p, cells), np.int64))
    fab.register("ctr", np.zeros((p, 1), np.int64))
    return fab, fab.attach_shadow(RaceChecker(p))


# ========================================================== conflict matrix
class TestConflictMatrix:
    def test_mpi3_conflict_table(self):
        # reads don't conflict with reads; atomics don't conflict with
        # atomics; any pair involving put / local-write conflicts
        assert not conflicts("get", "get")
        assert not conflicts("get", "local-read")
        assert not conflicts("acc", "acc")
        assert not conflicts("acc", "fao")
        assert not conflicts("get", "acc")      # both atomic
        assert conflicts("put", "put")
        assert conflicts("put", "get")
        assert conflicts("put", "acc")
        assert conflicts("local-write", "get")
        assert conflicts("local-write", "acc")


# ================================================== crafted racy program
class TestCraftedRace:
    def test_two_rank_overlapping_puts_flagged_with_both_descriptors(self):
        """The falsifiability anchor: a hand-written racy two-rank program
        MUST be flagged, naming the exact conflicting descriptor pair."""
        fab, chk = _local()
        fab.put(0, 2, "win", (1,), 7)
        fab.put(1, 2, "win", (1,), 9)
        assert len(chk.violations) == 1
        v = chk.violations[0]
        assert v.rule == "unsynchronized-conflict"
        assert "put(src=0, dst=2" in v.a          # descriptor A, exactly
        assert "put(src=1, dst=2" in v.b          # descriptor B, exactly
        assert "bytes=[8:16)" in v.a              # int64 cell 1

    def test_fence_separates_the_epochs(self):
        fab, chk = _local()
        fab.put(0, 2, "win", (1,), 7)
        fab.fence()
        fab.put(1, 2, "win", (1,), 9)
        assert chk.violations == []

    def test_disjoint_bytes_do_not_conflict(self):
        fab, chk = _local()
        fab.put(0, 2, "win", (0,), 7)
        fab.put(1, 2, "win", (1,), 9)
        assert chk.violations == []

    def test_put_get_conflict_flagged(self):
        fab, chk = _local()
        fab.put(0, 2, "win", (1,), 7)
        fab.get(1, 2, "win", (1,))
        assert [v.rule for v in chk.violations] == ["unsynchronized-conflict"]

    def test_accumulates_commute(self):
        fab, chk = _local()
        fab.add(0, 2, "win", (1,), 1)
        fab.add(1, 2, "win", (1,), 1)
        fab.get(0, 2, "win", (1,))                # get is an atomic read
        assert chk.violations == []


# ===================================================== same-origin ordering
class TestSameOriginOrdering:
    def test_local_flush_does_not_order_remote_writes(self):
        """MPI_Win_flush_local completes the *source buffer*, not the
        target: back-to-back overlapping puts need flush_remote/fence."""
        fab, chk = _local()
        fab.put(0, 2, "win", (1,), 1)
        fab.flush(0)
        fab.put(0, 2, "win", (1,), 2)
        assert [v.rule for v in chk.violations] == ["same-origin-overlap"]

    def test_flush_remote_orders_them(self):
        fab, chk = _local()
        fab.put(0, 2, "win", (1,), 1)
        fab.flush_remote(0)
        fab.put(0, 2, "win", (1,), 2)
        assert chk.violations == []


# ======================================================== src-buffer reuse
class TestSrcBufferReuse:
    def test_rewrite_before_flush_flagged(self):
        _, chk = _local()
        buf = np.arange(4, dtype=np.int64)
        chk.access("put", 0, 1, "win", (0,), src_span=(id(buf), 0, 32))
        chk.local_write(0, buf, 8, 16)
        assert [v.rule for v in chk.violations] == ["src-buffer-reuse"]

    def test_flush_releases_the_span(self):
        _, chk = _local()
        buf = np.arange(4, dtype=np.int64)
        chk.access("put", 0, 1, "win", (0,), src_span=(id(buf), 0, 32))
        chk.sync("flush", 0)
        chk.local_write(0, buf, 8, 16)
        assert chk.violations == []

    def test_disjoint_span_clean(self):
        _, chk = _local()
        buf = np.arange(8, dtype=np.int64)
        chk.access("put", 0, 1, "win", (0,), src_span=(id(buf), 0, 16))
        chk.local_write(0, buf, 32, 64)
        assert chk.violations == []


# =================================================== notify-before-payload
class TestNotifyBeforePayload:
    def test_tear_schedule_flagged(self):
        """The falsifiability anchor: the tear fault (per-op delivery,
        ungated notification) MUST be flagged by the checker itself."""
        fab, chk = _sim("tear")
        fab.put(0, 1, "win", (0,), 5)
        fab.flush(0)                        # batch in flight (time frozen)
        fab.fence_add(1, "ctr", (0,), 1)    # tear: applies immediately
        assert any(v.rule == "notify-before-payload" for v in chk.violations)
        v = [v for v in chk.violations
             if v.rule == "notify-before-payload"][0]
        assert "put(src=0, dst=1" in v.a    # the gated payload, by name

    def test_gated_schedule_clean(self):
        fab, chk = _sim("reorder")
        fab.put(0, 1, "win", (0,), 5)
        fab.flush(0)
        fab.fence_add(1, "ctr", (0,), 1)    # held until the payload lands
        fab.fence()
        assert chk.violations == []


# ==================================================== lock AMO sync edges
class TestLockHappensBefore:
    def _locked_writers(self, sync):
        """Two ranks take the same lock word in turn and write one cell at
        a third rank; `sync` is called holding the lock, before unlock."""
        fab, chk = _sim("none", p=3)
        fab.register_words("lock", [_AtomicWord()], semantics="lock")
        for r in (0, 1):
            assert fab.cas(r, "lock", 0, 0, WRITER_BIT) == 0
            fab.put(r, 2, "win", (0,), r + 1)
            sync(fab, r)
            fab.fetch_add(r, "lock", 0, -WRITER_BIT)
        chk.finish()
        return chk

    def test_flush_remote_before_unlock_is_clean(self):
        chk = self._locked_writers(lambda fab, r: fab.flush_remote(r))
        assert chk.violations == []

    def test_unlock_without_flush_remote_flagged(self):
        # local flush only: the put is still in flight when the lock is
        # released — the release edge publishes nothing for it
        chk = self._locked_writers(lambda fab, r: fab.flush(r))
        assert "unsynchronized-conflict" in {v.rule for v in chk.violations}


# ======================================================== lock discipline
class TestLockDiscipline:
    def _lock_fab(self, p=2):
        fab, chk = _sim("none", p=p)
        fab.register_words("lock", [_AtomicWord()], semantics="lock")
        return fab, chk

    def test_writer_held_at_end_flagged(self):
        fab, chk = self._lock_fab()
        assert fab.cas(0, "lock", 0, 0, WRITER_BIT) == 0
        chk.finish()
        assert any(v.rule == "lock-discipline"
                   and "still holds the writer bit" in v.message
                   for v in chk.violations)

    def test_shared_release_without_acquire_flagged(self):
        fab, chk = self._lock_fab()
        fab.fetch_add(0, "lock", 0, -1)
        assert any(v.rule == "lock-discipline"
                   and "does not hold" in v.message
                   for v in chk.violations)

    def test_shared_to_exclusive_upgrade_attempt_flagged(self):
        fab, chk = self._lock_fab()
        fab.fetch_add(0, "lock", 0, 1)            # shared acquire
        fab.cas(0, "lock", 0, 0, WRITER_BIT)      # upgrade attempt (fails)
        assert any(v.rule == "lock-discipline"
                   and "shared→exclusive upgrade" in v.message
                   for v in chk.violations)

    def test_balanced_writer_is_clean(self):
        fab, chk = self._lock_fab()
        assert fab.cas(0, "lock", 0, 0, WRITER_BIT) == 0
        fab.fetch_add(0, "lock", 0, -WRITER_BIT)
        chk.finish()
        assert chk.violations == []


# ============================================= locks_sim exception safety
class TestLockOriginExceptionSafety:
    """The context-manager form releases on EVERY exit
    path, and a defensive release raises instead of corrupting the word."""

    def test_exclusive_cm_releases_on_exception(self):
        win = LockWindow(p=2)
        o = LockOrigin(win, rank=0)
        with pytest.raises(ValueError):
            with o.exclusive(1):
                assert win.local[1].v & WRITER_BIT
                raise ValueError("body blew up")
        assert win.local[1].v == 0 and win.master.v == 0
        assert win.holder[1] == -1

    def test_shared_and_all_cms_release_on_exception(self):
        win = LockWindow(p=2)
        o = LockOrigin(win, rank=0)
        with pytest.raises(RuntimeError):
            with o.shared(0):
                raise RuntimeError
        with pytest.raises(RuntimeError):
            with o.all_shared():
                raise RuntimeError
        assert win.local[0].v == 0 and win.master.v == 0

    def test_unlock_shared_without_hold_raises(self):
        o = LockOrigin(LockWindow(p=2), rank=0)
        with pytest.raises(LockStateError, match="unlock_shared"):
            o.unlock_shared(0)

    def test_unlock_exclusive_without_hold_raises(self):
        win = LockWindow(p=2)
        a, b = LockOrigin(win, 0), LockOrigin(win, 1)
        a.lock_exclusive(0)
        with pytest.raises(LockStateError, match="unlock_exclusive"):
            b.unlock_exclusive(0)          # not the holder
        a.unlock_exclusive(0)

    def test_unlock_all_without_hold_raises(self):
        o = LockOrigin(LockWindow(p=2), rank=0)
        with pytest.raises(LockStateError, match="unlock_all"):
            o.unlock_all()


# ================================================= golden-trace neutrality
class TestShadowNeutrality:
    def _drive(self, fab):
        fab.put(0, 1, "win", (0,), 3)
        fab.add(1, 0, "win", (1,), 2)
        fab.get(0, 1, "win", (0,))
        fab.flush(0)
        fab.fence_add(1, "win", (2,), 1)
        fab.fence()
        return fab.snapshot()

    def test_local_fabric_ledger_identical_with_shadow(self):
        plain = LocalFabric(p=2)
        plain.register("win", np.zeros((2, 4), np.int64))
        shadowed, chk = _local(p=2)
        assert self._drive(plain) == self._drive(shadowed)
        assert chk.events > 0                 # the shadow DID observe

    def test_sim_fabric_ledger_identical_with_shadow(self):
        plain = SimFabric(2, SCHEDULES["reorder"], seed=0)
        plain.register("win", np.zeros((2, 4), np.int64))
        shadowed, chk = _sim("reorder", p=2)
        assert self._drive(plain) == self._drive(shadowed)
        assert chk.events > 0


# ================================================ conformance integration
class TestConformanceCheckRaces:
    @pytest.mark.parametrize("protocol", sorted(conf.PROTOCOLS))
    def test_protocol_clean_at_256_ranks(self, protocol):
        report = conf.run_one(protocol, 256, "reorder", 0, check_races=True)
        assert report["races_checked"] > 0    # the shadow was attached

    def test_tear_run_fails_under_check_races(self):
        with pytest.raises(conf.ConformanceError):
            conf.run_one("queue", 64, "tear", 0, check_races=True)

    def test_repro_line_carries_the_flag(self):
        spec = conf.RunSpec("queue", 64, "tear", 0, check_races=True)
        assert spec.repro().endswith("--check-races")


# ========================================================== plan lowering
def _op(kind, sig, at=None, n=4):
    payload = torch.zeros(n, dtype=torch.float32)
    return plan_mod._RecordedOp(kind=kind, sig=sig, axis="w",
                                payload=payload, handle=None,
                                finalize=lambda a: a, at=at)


class _FakePlan:
    def __init__(self, ops):
        self.ops = ops


class TestFromPlan:
    def test_default_slots_are_race_free(self):
        """Without explicit `at=`, every op owns a disjoint slot of the
        fused buffer (§8 layout) — race-free by construction."""
        ir_ = air.from_plan(_FakePlan([
            _op("puts", ("ppermute", [(0, 1), (1, 0)])),
            _op("puts", ("ppermute", [(0, 1), (1, 0)])),
        ]))
        assert ir_.p == 2 and len(ir_.accesses) == 4
        assert check_ir(ir_) == []

    def test_explicit_aliasing_intervals_flagged_with_plan_provenance(self):
        ir_ = air.from_plan(_FakePlan([
            _op("puts", ("ppermute", [(0, 1)]), at=(0, 16)),
            _op("puts", ("ppermute", [(2, 1)]), at=(8, 24)),
        ]))
        out = check_ir(ir_)
        assert len(out) == 1
        assert out[0].rule == "unsynchronized-conflict"
        assert "plan[0]" in out[0].a and "plan[1]" in out[0].b

    def test_fao_and_gets_do_not_conflict(self):
        ir_ = air.from_plan(_FakePlan([
            _op("accs", ("local",), at=(0, 16)),
            _op("gets", ("all_gather",), at=(0, 16)),
        ]), p=2)
        assert check_ir(ir_) == []


# ========================================================= trace lowering
class TestFromTrace:
    def _traced(self, body):
        tracer = obs_trace.Tracer()
        prev = obs_trace.set_tracer(tracer)
        try:
            body()
        finally:
            obs_trace.set_tracer(prev)
        return tracer.events

    def test_cm_lock_usage_lowers_clean(self):
        win = LockWindow(p=2)
        o = LockOrigin(win, rank=0)

        def body():
            with o.exclusive(1):
                pass
            with o.shared(0):
                pass

        ir_ = air.from_trace(self._traced(body), p=2)
        assert len(ir_.lock_events) == 4      # 2 acquires + 2 releases
        assert check_ir(ir_) == []

    def test_acquire_without_release_flagged(self):
        win = LockWindow(p=2)
        o = LockOrigin(win, rank=1)
        ir_ = air.from_trace(self._traced(lambda: o.lock_exclusive(0)), p=2)
        out = check_ir(ir_)
        assert any("never released" in v.message for v in out)

    def test_trace_upgrade_flagged(self):
        events = [
            {"name": "lock.acquire", "rank": 0,
             "args": {"mode": "shared", "target": 3}},
            {"name": "lock.acquire", "rank": 0,
             "args": {"mode": "exclusive", "target": 3}},
        ]
        out = check_ir(air.from_trace(events, p=1))
        assert any("shared→exclusive upgrade" in v.message for v in out)


# ================================================================== lint
class TestLint:
    def _rules(self, src):
        return [f.rule for f in lint.check_source(src, "x/y.py")]

    def test_bare_except_flagged(self):
        assert self._rules(
            "try:\n    f()\nexcept:\n    pass\n") == ["ANL001"]

    def test_raw_lock_acquire_flagged(self):
        src = ("def f(lock):\n"
               "    lock.lock_exclusive(0)\n"
               "    work()\n")
        assert self._rules(src) == ["ANL002"]

    def test_try_finally_lock_accepted(self):
        src = ("def f(lock):\n"
               "    lock.lock_exclusive(0)\n"
               "    try:\n"
               "        work()\n"
               "    finally:\n"
               "        lock.unlock_exclusive(0)\n")
        assert self._rules(src) == []

    def test_cm_lock_accepted(self):
        src = ("def f(lock):\n"
               "    with lock.exclusive(0):\n"
               "        work()\n")
        assert self._rules(src) == []

    def test_nested_protected_acquire_not_double_flagged(self):
        # acquire inside a while/if is still recognized as protected
        src = ("def f(lock):\n"
               "    while True:\n"
               "        lock.lock_shared(0)\n"
               "        try:\n"
               "            work()\n"
               "        finally:\n"
               "            lock.unlock_shared(0)\n")
        assert self._rules(src) == []

    def test_region_bypass_flagged(self):
        src = ("def f(fab):\n"
               "    fab.regions['w'][0] = 1\n")
        assert self._rules(src) == ["ANL003"]

    def test_apply_add_outside_fabric_flagged(self):
        assert self._rules(
            "def f(s):\n    apply_add(s, 0, 1)\n") == ["ANL003"]

    def test_one_way_without_completion_flagged(self):
        src = ("def f(fab):\n"
               "    fab.put(0, 1, 'w', (0,), 1)\n")
        assert self._rules(src) == ["ANL004"]

    def test_one_way_with_flush_accepted(self):
        src = ("def f(fab):\n"
               "    fab.put(0, 1, 'w', (0,), 1)\n"
               "    fab.flush(0)\n")
        assert self._rules(src) == []

    def test_begin_plan_never_flushed_flagged(self):
        assert self._rules(
            "def f(ep):\n    pl = ep.begin_plan()\n") == ["ANL005"]

    def test_begin_plan_with_close_accepted(self):
        src = ("def f(ep, t):\n"
               "    pl = ep.begin_plan()\n"
               "    return ep.close(t)\n")
        assert self._rules(src) == []

    def test_request_event_without_rid_flagged(self):
        # ANL006: un-stamped request-lifecycle events disconnect the §15 DAG
        src = ("def f(tr, r):\n"
               "    tr.event('serve.request.submit', rank=r)\n")
        assert self._rules(src) == ["ANL006"]

    def test_request_span_without_rid_flagged(self):
        src = ("def f(tr, r):\n"
               "    with tr.span('serve.request.prefill', rank=r):\n"
               "        work()\n")
        assert self._rules(src) == ["ANL006"]

    def test_request_event_with_rid_accepted(self):
        src = ("def f(tr, r, rid):\n"
               "    tr.event('serve.request.submit', rank=r, rid=rid)\n")
        assert self._rules(src) == []

    def test_request_event_with_kwargs_splat_accepted(self):
        # a **attrs splat may carry rid — the rule can't see inside it
        src = ("def f(tr, r, attrs):\n"
               "    tr.event('serve.request.submit', rank=r, **attrs)\n")
        assert self._rules(src) == []

    def test_non_request_event_out_of_scope(self):
        src = ("def f(tr, r):\n"
               "    tr.event('fabric.flush', rank=r, wait=3)\n")
        assert self._rules(src) == []

    def test_src_repro_is_clean(self):
        findings = lint.check_paths([os.path.join(REPO, "src", "repro_torch")])
        assert findings == [], "\n".join(str(f) for f in findings)


# ==================================================== against the reference
jair = pytest.importorskip("repro.analysis.ir")
from repro.analysis import lint as jlint  # noqa: E402
from repro.analysis import races as jraces  # noqa: E402
from repro.sim import conformance as jconf  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmaq import queue as rq  # noqa: E402


def _accesses(ir_):
    return [(a.seq, a.rank, a.window, a.dst, a.kind, a.lo, a.hi, a.epoch,
             a.prov) for a in ir_.accesses]


def _port_plan(p=4, collectives=True):
    """A port `RmaPlan` with the signatures the serving path records: shift
    puts (one at an explicit target interval), a shift get, an accumulate
    and, with `collectives`, a fused all-to-all, a gather and a kind-less
    rider."""
    mesh = Mesh(p, "w", device="cpu")
    plan = plan_mod.RmaPlan(mesh)
    x = torch.arange(p * 6, dtype=torch.float32).reshape(p, 6)
    plan.put_shift(x, 1)
    plan.put_shift(x, -1, at=(1000, 1024))
    plan.get_shift(x, 2)
    plan.accumulate_shift(x, torch.zeros_like(x), 1)
    if collectives:
        plan.put_all_to_all(torch.zeros(p, p, 3))
        plan.all_gather(torch.zeros(p, 5, dtype=torch.int32))
        plan.all_gather(torch.zeros(p, 2), kind=None)
    return plan


def _tap_enqueue_plans(p=8, k=3):
    """The plans one device `enqueue_epoch` flushes, tapped at
    `RmaPlan.flush`."""
    mesh = Mesh(p, "w", device="cpu")
    desc, state = rq.queue_allocate(mesh, 8, (2,), torch.float32)
    plans = []
    flush = plan_mod.RmaPlan.flush

    def tap(self, *a, **kw):
        plans.append(self)
        return flush(self, *a, **kw)

    plan_mod.RmaPlan.flush = tap
    try:
        rng = np.random.RandomState(0)
        dest = torch.as_tensor(rng.randint(-1, p, size=(p, k)))
        rq.enqueue_epoch(desc, state, torch.ones(p, k, 2), dest)
    finally:
        plan_mod.RmaPlan.flush = flush
    return plans


class TestFromPlanMatchesReference:
    @pytest.mark.parametrize("flushed", [False, True])
    def test_same_accesses_for_a_point_to_point_plan(self, flushed):
        """Shift puts and gets, an accumulate, an explicit interval: the
        reference's `from_plan` and the port's read one port plan alike."""
        plan = _port_plan(collectives=False)
        if flushed:
            plan.flush(aggregate=True)
        for p in (None, 4):
            want, got = jair.from_plan(plan, p=p), air.from_plan(plan, p=p)
            assert got.p == want.p
            assert _accesses(got) == _accesses(want)
            assert check_ir(got) == jraces.check_ir(want) == []

    def test_collective_sources_get_their_own_blocks(self):
        """Collective ops: the same (src, dst, kind) accesses in the same
        order; the port gives each source its own block of the slot, so the
        plan is race-free, where the reference flags every pair of sources
        of the all-to-all put and of the rider."""
        plan = _port_plan()
        want, got = jair.from_plan(plan, p=4), air.from_plan(plan, p=4)
        key = [(a.seq, a.rank, a.window, a.dst, a.kind) for a in got.accesses]
        assert key == [(a.seq, a.rank, a.window, a.dst, a.kind)
                       for a in want.accesses]
        assert check_ir(got) == []
        flagged = jraces.check_ir(want)
        assert flagged and all("sig=all_to_all" in v.a or "kind=rider" in v.a
                               for v in flagged)

    def test_enqueue_epoch_plans_lower_race_free(self):
        """The reservation gather and the fused payload transfer of one
        device `enqueue_epoch` lower race-free; two aliasing puts at one
        interval are flagged (the negative control)."""
        plans = _tap_enqueue_plans()
        assert len(plans) == 2
        for plan in plans:
            assert check_ir(air.from_plan(plan, p=8)) == []
        # the reference's lowering flags the payload plan's all-to-all put
        assert jraces.check_ir(jair.from_plan(plans[1], p=8))
        bad = _FakePlan([_op("puts", ("ppermute", [(0, 1)]), at=(0, 16)),
                         _op("puts", ("ppermute", [(2, 1)]), at=(8, 24))])
        assert [v.rule for v in check_ir(air.from_plan(bad))] == \
            ["unsynchronized-conflict"]


class TestRacesMatchReference:
    @pytest.mark.parametrize("protocol", sorted(conf.PROTOCOLS))
    def test_check_races_reports_equal(self, protocol):
        want = jconf.run_one(protocol, 64, "reorder", 1, check_races=True)
        got = conf.run_one(protocol, 64, "reorder", 1, check_races=True)
        assert got == want and got["races_checked"] > 0

    def test_tear_violations_equal(self):
        def violations(races_mod, sim_fabric_mod):
            fab = sim_fabric_mod.SimFabric(
                4, sim_fabric_mod.SCHEDULES["tear"], seed=0)
            fab.register("win", np.zeros((4, 4), np.int64))
            fab.register("ctr", np.zeros((4, 1), np.int64))
            chk = fab.attach_shadow(races_mod.RaceChecker(4))
            fab.fence()
            for src in (0, 2):
                fab.put(src, 1, "win", (src,), 5)
                fab.flush(src)
            fab.fence_add(1, "ctr", (0,), 1)
            fab.fence()
            chk.finish()
            return [str(v) for v in chk.violations]

        from repro.sim import fabric as jsimfab
        from repro_torch.sim import fabric as tsimfab

        from repro_torch.analysis import races as traces

        got = violations(traces, tsimfab)
        assert got == violations(jraces, jsimfab)

    def test_conflict_table_equal(self):
        kinds = ("put", "get", "acc", "fao", "local-read", "local-write")
        for a in kinds:
            for b in kinds:
                assert conflicts(a, b) == jraces.conflicts(a, b), (a, b)


class TestLintMatchesReference:
    def test_same_findings_on_both_trees(self):
        for tree in ("repro", "repro_torch"):
            path = os.path.join(REPO, "src", tree)
            assert [str(f) for f in lint.check_paths([path])] == \
                [str(f) for f in jlint.check_paths([path])]

    def test_cli_defaults_to_the_port(self, capsys):
        cwd = os.getcwd()
        os.chdir(REPO)
        try:
            assert lint.main([]) == 0
        finally:
            os.chdir(cwd)
        assert "0 finding(s) in src/repro_torch" in capsys.readouterr().out
