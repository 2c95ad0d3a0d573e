"""Property-based conformance suite over the simulated fabric (DESIGN.md §11).

Runs the *existing* host protocol state machines — queue enqueue/dequeue
(§6.2), credit grant/spend (§9), heap alloc/free/ref_update (§10), epoch
fence ordering (§2.3), and the Fig. 3 lock words — at 256+ simulated ranks
under seeded chaos schedules, asserting the global invariants **after every
simulated step**:

  * queue:  ``0 <= tail - head <= capacity`` per ring; drained payloads
    match the admission-order FIFO oracle per target; at quiescence every
    accepted message is drained exactly once and DROP == rejections.
  * flow:   ``sum(granted) - head == capacity`` per target at every event;
    ``rejected == 0`` always; outstanding credits + occupancy == capacity
    at quiescence.
  * heap:   ``free_top + live == n_pages`` per pool; stale (page, tag)
    descriptors never validate; a stale head CAS never succeeds across
    intervening alloc/free (no-ABA); illegal ops raise without corrupting.
  * epoch:  per-cell stamps are monotone and a closed fence implies every
    op of that epoch is visible; payload rides the stamp's transfer.
  * lock:   mutual exclusion over the Fig. 3 word layout — no lost update
    on a read-modify-write split across an interleaving window.
  * kv:     paged-KV prefix sharing + `ft.elastic.kv_membership_change`
    (rank leave/join mid-run) preserve pool conservation throughout.
  * serve:  an end-to-end disaggregated serving round (submit → prefill →
    KV page alloc → credited flow send → decode → first token) under full
    causal tracing (§15): every completed request's trace must stitch into
    one *connected* cross-rank DAG whose critical-path segment sum equals
    its measured TTFT exactly (virtual time), with every credited send
    admitted (rejected == 0) and every KV page returned.
  * rendezvous: the §16 pull protocol — descriptors only in the ring
    (checked structurally per event: every advertised slot is a well-formed
    2-word descriptor), pull pins keep source pages live, interrupted pulls
    reclaim, pool conservation at every event.
  * rebind: producer credit caches must REBASE (not ``max``) across an
    elastic re-attach of the consumer's window — the stale-grant livelock
    guard, checked with conservation at every event.

Every run is a pure function of its ``(seed, schedule)`` pair; a violation
raises `ConformanceError` carrying the exact repro command line.  The
fault-injection schedule ``tear`` (per-op delivery, notification not gated
on payload — the Quo-Vadis-RMA divergence class) MUST be caught; the CLI's
``--expect-fail`` asserts that it is.

CLI::

    python -m repro_torch.sim.conformance --ranks 256 --seeds 0,1 \
        --schedules reorder,delay,duplicate --protocols queue,flow,heap
    python -m repro_torch.sim.conformance --smoke        # 64-rank 3-seed subset
    python -m repro_torch.sim.conformance --schedules tear --expect-fail
    python -m repro_torch.sim.conformance --flight --trace-dir sim-traces
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import os
import random
import sys

import numpy as np

from ..core.locks_sim import (GLOBAL_EXCL_UNIT, GLOBAL_SHRD_MASK,
                                  WRITER_BIT, _AtomicWord)
from ..obs import causal as obs_causal
from ..obs import critpath as obs_critpath
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.export import dump_chrome_trace
from ..ft.elastic import kv_membership_change
from ..rmaq import queue as rq
from ..rmaq.channel import HDR, Lane
from ..rmaq.flow import HostFlowChannel
from ..rmaq.queue import HostQueueGroup
from ..rmem import heap
from ..rmem.pages import PagedKVPool, page_key
from .fabric import SCHEDULES, SimFabric
from .sched import Scheduler, VirtualClock


@dataclasses.dataclass(frozen=True)
class RunSpec:
    protocol: str
    n_ranks: int
    schedule: str
    seed: int
    check_races: bool = False

    def repro(self) -> str:
        return (
            "PYTHONPATH=src python -m repro_torch.sim.conformance "
            f"--protocols {self.protocol} --ranks {self.n_ranks} "
            f"--schedules {self.schedule} --seeds {self.seed}"
            + (" --check-races" if self.check_races else "")
        )


class ConformanceError(AssertionError):
    """An invariant violation, reproducible from its (seed, schedule)."""

    def __init__(self, spec: RunSpec, step: int, detail: str) -> None:
        self.spec = spec
        self.step = step
        self.detail = detail
        super().__init__(
            f"[{spec.protocol} p={spec.n_ranks} schedule={spec.schedule} "
            f"seed={spec.seed}] invariant violation at step {step}: {detail}\n"
            f"  repro: {spec.repro()}"
        )


def _rng(seed: int, salt: int) -> random.Random:
    return random.Random(seed * 1_000_003 + salt)


def _recv(spec: RunSpec, sched, hfc, rank: int, max_n) -> list:
    """`hfc.recv`, with a torn ring row (a notification whose payload never
    landed, so the header does not decode) reported as the violation it is
    instead of escaping the suite as a decode error."""
    try:
        return hfc.recv(rank, max_n)
    except (ValueError, IndexError) as e:
        raise ConformanceError(
            spec, sched.events,
            f"rank {rank}: malformed delivery (payload decoupled from "
            f"notification): {e}") from None


# the harness stashes each run's shadow race checker here so the driver
# (`_run_protocol`) can finalize it after the protocol returns
_SHADOWS: list = []


def _harness(spec: RunSpec, on_event):
    clock = VirtualClock()
    fab = SimFabric(spec.n_ranks, SCHEDULES[spec.schedule], spec.seed,
                    clock=clock)
    if spec.check_races:
        from ..analysis.races import RaceChecker
        _SHADOWS.append(fab.attach_shadow(RaceChecker(spec.n_ranks)))
    sched = Scheduler(spec.seed, clock=clock, on_event=on_event)
    sched.attach(fab)
    return fab, sched


# ======================================================================
# queue: enqueue/dequeue at p ranks, FIFO-per-target content oracle
# ======================================================================
def run_queue(spec: RunSpec, epochs: int = 3, capacity: int = 16,
              burst: int = 2) -> dict:
    p = spec.n_ranks

    def checker(kind, who, sched):
        ctrs = group.ctrs
        occ = ctrs[:, rq.TAIL].astype(np.int64) - ctrs[:, rq.HEAD].astype(np.int64)
        if occ.min() < 0 or occ.max() > capacity:
            raise ConformanceError(
                spec, sched.events,
                f"ring occupancy out of [0, {capacity}]: min {occ.min()}, max {occ.max()}")

    fab, sched = _harness(spec, checker)
    group = HostQueueGroup(p, capacity, 1, fabric=fab)
    oracle = [collections.deque() for _ in range(p)]   # admitted FIFO per target
    stage: dict[int, list] = {}
    state = {"epoch_done": 0, "accepted": 0, "rejected": 0, "drained": 0}
    val_ctr = itertools.count(1)

    def drain_check(r: int, n: int) -> None:
        for row in group.drain(r, n):
            got = float(row[0])
            if not oracle[r]:
                raise ConformanceError(
                    spec, sched.events, f"rank {r} drained value {got} never admitted")
            want = oracle[r].popleft()
            if got != want:
                raise ConformanceError(
                    spec, sched.events,
                    f"rank {r} drained {got}, expected {want} "
                    "(content/FIFO violation: payload decoupled from notification)")
            state["drained"] += 1

    def producer(r: int):
        rng = _rng(spec.seed, 17 * r + 1)
        for e in range(epochs):
            stage[r] = [(rng.randrange(p), float(next(val_ctr)))
                        for _ in range(rng.randint(1, burst))]
            yield
            while state["epoch_done"] <= e:
                yield
            for _ in range(rng.randint(1, 2)):
                drain_check(r, rng.randint(1, 4))
                yield

    def driver():
        for e in range(epochs):
            while len(stage) < p:
                yield
            sends = {r: [(dst, np.float32(v)) for dst, v in stage[r]]
                     for r in sorted(stage)}
            stage.clear()
            accepted = group.step(sends)
            # oracle: admission order is producers in rank order, messages
            # in program order — the rank-ordered fetch-and-add (§6.2)
            for r in sorted(sends):
                for (dst, v), ok in zip(sends[r], accepted[r]):
                    if ok:
                        oracle[dst].append(float(v))
                        state["accepted"] += 1
                    else:
                        state["rejected"] += 1
            state["epoch_done"] = e + 1
            yield

    for r in range(p):
        sched.spawn(f"rank{r:04d}", producer(r))
    sched.spawn("driver", driver())
    report = sched.run()

    fab.fence()                                         # complete stragglers
    for r in range(p):
        drain_check(r, capacity)
        if oracle[r]:
            raise ConformanceError(
                spec, sched.events,
                f"rank {r}: {len(oracle[r])} admitted messages lost in flight")
    if state["drained"] != state["accepted"]:
        raise ConformanceError(
            spec, sched.events,
            f"drained {state['drained']} != accepted {state['accepted']}")
    drops = int(group.ctrs[:, rq.DROP].sum())
    if drops != state["rejected"]:
        raise ConformanceError(
            spec, sched.events,
            f"DROP counters {drops} != observed rejections {state['rejected']}")
    return {"protocol": "queue", **report, **state, "chaos": fab.chaos_stats()}


# ======================================================================
# flow: credit conservation at every event, rejected == 0 always
# ======================================================================
def run_flow(spec: RunSpec, epochs: int = 3) -> dict:
    p = spec.n_ranks
    capacity = 1 << (2 * p - 1).bit_length()            # >= 2p, power of two

    def checker(kind, who, sched):
        granted = hfc.granted.sum(axis=(1, 2)).astype(np.int64)
        head = hfc.ch.group.ctrs[:, rq.HEAD].astype(np.int64)
        bad = np.nonzero(granted - head != capacity)[0]
        if bad.size:
            t = int(bad[0])
            raise ConformanceError(
                spec, sched.events,
                f"credit conservation: sum(granted[{t}])={granted[t]} - "
                f"head={head[t]} != capacity {capacity} "
                f"(+{bad.size - 1} more targets)")
        if hfc.rejected:
            raise ConformanceError(
                spec, sched.events,
                f"{hfc.rejected} credited sends rejected at the ring — "
                "credit admission must make ring-full impossible")

    fab, sched = _harness(spec, checker)
    hfc = HostFlowChannel(p, capacity, [Lane("c", (1,), "float32")], fabric=fab)
    staged = collections.Counter()
    state = {"epoch_done": 0, "sent": 0, "deferred": 0, "received": 0}

    def producer(r: int):
        rng = _rng(spec.seed, 31 * r + 5)
        for e in range(epochs):
            for _ in range(rng.randint(1, 2)):
                ok = hfc.send(r, "c", np.float32([r]), e, rng.randrange(p))
                state["sent" if ok else "deferred"] += 1
                yield
            staged[e] += 1
            yield
            while state["epoch_done"] <= e:
                yield
            state["received"] += len(_recv(spec, sched, hfc, r, rng.randint(1, 4)))
            yield

    def driver():
        for e in range(epochs):
            while staged[e] < p:
                yield
            hfc.flush()
            state["epoch_done"] = e + 1
            yield

    for r in range(p):
        sched.spawn(f"rank{r:04d}", producer(r))
    sched.spawn("driver", driver())
    report = sched.run()

    fab.fence()
    for r in range(p):
        state["received"] += len(_recv(spec, sched, hfc, r, None))
    for r in range(p):
        c = hfc.conservation(r)
        if (c["granted_minus_head"] != capacity
                or c["outstanding_plus_occupancy"] != capacity
                or c["occupancy"] != 0):
            raise ConformanceError(
                spec, sched.events, f"final conservation at target {r}: {c}")
    if state["received"] != state["sent"]:
        raise ConformanceError(
            spec, sched.events,
            f"received {state['received']} != credited sends {state['sent']}")
    return {"protocol": "flow", **report, **state,
            "refreshes": hfc.refreshes, "chaos": fab.chaos_stats()}


# ======================================================================
# heap: per-pool conservation, no-ABA, fail-loud illegal ops
# ======================================================================
def run_heap(spec: RunSpec, rounds: int = 6, n_pages: int = 6,
             check_stride: int = 8) -> dict:
    p = spec.n_ranks

    def check_pool(t: int, step: int) -> None:
        c = pools[t].conservation()
        if c["free_plus_live"] != n_pages:
            raise ConformanceError(
                spec, step,
                f"pool {t} conservation: free {c['free']} + live {c['live']} "
                f"!= {n_pages}")

    def checker(kind, who, sched):
        # full free-list walks are O(n_pages): sweep pools round-robin per
        # event and all of them at quiescence
        check_pool((sched.events // check_stride) % p, sched.events)

    fab, sched = _harness(spec, checker)
    pools = {t: heap.HostPagePool(n_pages, fabric=fab, name=f"pool{t}",
                                  owner=t) for t in range(p)}
    holders: collections.Counter = collections.Counter()   # (owner, pid) -> refs
    stale: list[tuple[int, int, int]] = []                 # freed (owner, pid, tag)
    state = {"allocs": 0, "frees": 0, "shares": 0, "aba_defended": 0,
             "stale_tags_checked": 0, "illegal_caught": 0}

    def worker(r: int):
        rng = _rng(spec.seed, 7 * r + 3)
        mine: list[tuple[int, int, int]] = []
        for _ in range(rounds):
            roll = rng.random()
            try:
                if roll < 0.45 or not mine:
                    t = rng.randrange(p)
                    pid = pools[t].alloc(origin=r)
                    if pid is not None:
                        mine.append((t, pid, pools[t].tag(pid)))
                        holders[(t, pid)] += 1
                        state["allocs"] += 1
                elif roll < 0.62:
                    t, pid, _ = mine[rng.randrange(len(mine))]
                    pools[t].ref_add(pid, 1, origin=r)
                    mine.append((t, pid, pools[t].tag(pid)))
                    holders[(t, pid)] += 1
                    state["shares"] += 1
                elif roll < 0.88:
                    t, pid, tag = mine.pop(rng.randrange(len(mine)))
                    freed = pools[t].release(pid, origin=r)
                    holders[(t, pid)] -= 1
                    if freed:
                        stale.append((t, pid, tag))
                        state["frees"] += 1
                else:
                    # deliberate protocol violation: double-free a page that
                    # is currently dead MUST raise and corrupt nothing
                    t = rng.randrange(p)
                    dead = [i for i in range(n_pages)
                            if pools[t].ref[i].v == 0]
                    if dead:
                        pid = dead[rng.randrange(len(dead))]
                        try:
                            pools[t].release(pid, origin=r)
                        except heap.HeapError:
                            state["illegal_caught"] += 1
                        else:
                            raise ConformanceError(
                                spec, sched.events,
                                f"double-free of dead page ({t}, {pid}) did "
                                "not raise HeapError")
                        check_pool(t, sched.events)
            except heap.HeapError as e:
                raise ConformanceError(
                    spec, sched.events, f"legal op raised HeapError: {e}")
            # stale descriptors must never validate (ABA tag defense)
            if stale and rng.random() < 0.3:
                t, pid, tag = stale[rng.randrange(len(stale))]
                state["stale_tags_checked"] += 1
                if pools[t].tag_valid(pid, tag):
                    raise ConformanceError(
                        spec, sched.events,
                        f"stale tag ({t}, {pid}, gen {tag}) still validates "
                        "after free (ABA)")
            yield

    def aba_prober():
        """The crafted stale-CAS interleaving: observe a head word, let the
        world move, then CAS with the stale observation — the generation
        tag must make it fail whenever any alloc/free intervened."""
        rng = _rng(spec.seed, 999)
        for _ in range(4):
            t = rng.randrange(p)
            old = fab.read_word(p, f"pool{t}.head", 0)
            version = pools[t].allocs + pools[t].frees
            yield
            yield
            got = fab.cas(p, f"pool{t}.head", 0, old, heap.head_pack(0, 0))
            moved = (pools[t].allocs + pools[t].frees) != version
            if got == old:
                if moved:
                    raise ConformanceError(
                        spec, sched.events,
                        f"stale CAS on pool {t} head succeeded across "
                        "intervening alloc/free (ABA tag failed)")
                # nothing intervened: the CAS was legitimate — undo it
                # (retry loop: only spurious cas-storm failures can miss)
                while fab.cas(p, f"pool{t}.head", 0,
                              heap.head_pack(0, 0), old) != heap.head_pack(0, 0):
                    pass
            else:
                state["aba_defended"] += 1
            yield

    for r in range(p):
        sched.spawn(f"rank{r:04d}", worker(r))
    sched.spawn("aba-prober", aba_prober())
    report = sched.run()

    live_expect = {t: len({pid for (tt, pid), n in holders.items()
                           if tt == t and n > 0}) for t in range(p)}
    for t in range(p):
        check_pool(t, sched.events)
        if pools[t].live_count() != live_expect[t]:
            raise ConformanceError(
                spec, sched.events,
                f"pool {t}: live {pools[t].live_count()} != "
                f"oracle {live_expect[t]}")
    return {"protocol": "heap", **report, **state,
            "amos": sum(pl.total_amos for pl in pools.values()),
            "chaos": fab.chaos_stats()}


# ======================================================================
# epoch: fence ordering — stamps monotone, fence close implies visibility
# ======================================================================
def run_epoch(spec: RunSpec, epochs: int = 4) -> dict:
    p = spec.n_ranks

    def checker(kind, who, sched):
        stamps = cells[:, 0].copy()
        if (stamps < shadow).any():
            t = int(np.nonzero(stamps < shadow)[0][0])
            raise ConformanceError(
                spec, sched.events,
                f"cell {t} epoch stamp regressed {shadow[t]} -> {stamps[t]}")
        np.maximum(shadow, stamps, out=shadow)
        # payload rides the stamp's fused transfer: a stamped cell must
        # carry that stamp's payload (tear decouples them)
        idx = np.arange(p)
        writer = (idx - 1) % p
        on = stamps > 0
        bad = np.nonzero(on & (cells[:, 1] != stamps * p + writer))[0]
        if bad.size:
            t = int(bad[0])
            raise ConformanceError(
                spec, sched.events,
                f"cell {t}: stamp {stamps[t]} visible but payload "
                f"{cells[t, 1]} is from another epoch (notification "
                "decoupled from payload)")

    fab, sched = _harness(spec, checker)
    cells = np.zeros((p, 2), np.int64)
    fab.register("cell", cells)
    shadow = np.zeros(p, np.int64)
    staged = collections.Counter()
    state = {"epoch_done": 0}

    def writer_task(r: int):
        for e in range(1, epochs + 1):
            dst = (r + 1) % p
            fab.put(r, dst, "cell", (1,), e * p + r)    # payload first…
            fab.put(r, dst, "cell", (0,), e)            # …stamp rides with it
            fab.flush(r)
            staged[e] += 1
            yield
            while state["epoch_done"] < e:
                yield

    def driver():
        for e in range(1, epochs + 1):
            while staged[e] < p:
                yield
            fab.fence()
            if not (cells[:, 0] == e).all():
                raise ConformanceError(
                    spec, sched.events,
                    f"fence {e} closed with stamps {cells[:, 0].min()}..",
                )
            state["epoch_done"] = e
            yield

    for r in range(p):
        sched.spawn(f"rank{r:04d}", writer_task(r))
    sched.spawn("driver", driver())
    report = sched.run()
    return {"protocol": "epoch", **report, "epochs": epochs,
            "chaos": fab.chaos_stats()}


# ======================================================================
# lock: Fig. 3 words — mutual exclusion, no lost update, lockall readers
# ======================================================================
def run_lock(spec: RunSpec, rounds: int = 2) -> dict:
    p = spec.n_ranks
    fab, sched = _harness(spec, None)
    master = _AtomicWord()
    local = [_AtomicWord() for _ in range(p)]
    fab.register_words("lock.master", [master], semantics="lock")
    fab.register_words("lock.local", local, semantics="lock")
    cells = np.zeros((p, 1), np.int64)
    fab.register("lock.cell", cells)
    commits = np.zeros(p, np.int64)
    state = {"acquires": 0, "reads": 0}
    MAX_TRIES = 200_000

    def writer(r: int):
        rng = _rng(spec.seed, 13 * r + 11)
        for _ in range(rounds):
            t = rng.randrange(p)
            tries = 0
            while True:                                 # paper §2.3 protocol
                old = fab.fetch_add(r, "lock.master", 0, GLOBAL_EXCL_UNIT)
                if not (old & GLOBAL_SHRD_MASK):
                    if fab.cas(r, "lock.local", t, 0, WRITER_BIT) == 0:
                        break
                fab.fetch_add(r, "lock.master", 0, -GLOBAL_EXCL_UNIT)
                tries += 1
                if tries > MAX_TRIES:
                    raise ConformanceError(
                        spec, sched.events,
                        f"rank {r} starved acquiring lock {t}")
                yield
            # critical section: non-atomic RMW split across a yield — only
            # mutual exclusion prevents the lost update
            v = int(fab.get(r, t, "lock.cell", (0,)))
            yield
            fab.put(r, t, "lock.cell", (0,), v + 1)
            fab.flush_remote(r)                         # complete before unlock
            commits[t] += 1
            state["acquires"] += 1
            fab.fetch_add(r, "lock.local", t, -WRITER_BIT)
            fab.fetch_add(r, "lock.master", 0, -GLOBAL_EXCL_UNIT)
            yield

    def reader(r: int):
        rng = _rng(spec.seed, 29 * r + 7)
        for _ in range(rounds):
            tries = 0
            while True:                                 # MPI_Win_lock_all
                if fab.fetch_add(r, "lock.master", 0, 1) < GLOBAL_EXCL_UNIT:
                    break
                fab.fetch_add(r, "lock.master", 0, -1)
                tries += 1
                if tries > MAX_TRIES:
                    raise ConformanceError(
                        spec, sched.events, f"reader {r} starved on lock_all")
                yield
            t = rng.randrange(p)
            seen = int(fab.get(r, t, "lock.cell", (0,)))
            if seen != commits[t]:
                raise ConformanceError(
                    spec, sched.events,
                    f"reader {r} saw cell {t} = {seen} under lock_all but "
                    f"{commits[t]} increments committed (torn/lost update)")
            state["reads"] += 1
            fab.fetch_add(r, "lock.master", 0, -1)
            yield

    for r in range(p):
        sched.spawn(f"w{r:04d}", writer(r))
        if r % 4 == 0:
            sched.spawn(f"r{r:04d}", reader(r))
    report = sched.run()

    if not (cells[:, 0] == commits).all():
        t = int(np.nonzero(cells[:, 0] != commits)[0][0])
        raise ConformanceError(
            spec, sched.events,
            f"lost update on cell {t}: {cells[t, 0]} != {commits[t]} commits")
    if master.v != 0 or any(w.v for w in local):
        raise ConformanceError(spec, sched.events, "lock words not released")
    return {"protocol": "lock", **report, **state,
            "amos": master.amo_count + sum(w.amo_count for w in local),
            "chaos": fab.chaos_stats()}


# ======================================================================
# kv: paged-KV prefix sharing + elastic leave/join mid-run
# ======================================================================
def run_kv(spec: RunSpec, rounds: int = 4, n_pages: int = 8) -> dict:
    p = spec.n_ranks
    n_owners = min(p, 8)
    n_requesters = min(p, 32)

    def checker(kind, who, sched):
        c = kv.conservation()
        if not c["ok"]:
            bad = {r: v for r, v in c["per_owner"].items()
                   if v["free_plus_live"] != v["capacity"]}
            raise ConformanceError(
                spec, sched.events, f"kv pool conservation violated: {bad}")

    fab, sched = _harness(spec, checker)
    kv = PagedKVPool(list(range(n_owners)), n_pages, fabric=fab)
    rid_ctr = itertools.count(1)
    state = {"mapped": 0, "released": 0, "dry": 0, "migrated": None}
    open_tables: list[int] = []

    def requester(r: int):
        rng = _rng(spec.seed, 41 * r + 19)
        for _ in range(rounds):
            key = page_key(np.full(4, rng.randrange(10), np.int32))
            dest = kv.route(key)
            if dest not in kv.owners:
                raise ConformanceError(
                    spec, sched.events,
                    f"routing returned departed owner {dest}")
            res = kv.acquire(dest, key)
            if res is None:
                state["dry"] += 1
                yield
                continue
            rid = next(rid_ctr)
            kv.table_set(rid, [res[0]])
            open_tables.append(rid)
            state["mapped"] += 1
            yield
            if open_tables and rng.random() < 0.6:
                kv.table_release(open_tables.pop(rng.randrange(len(open_tables))))
                state["released"] += 1
                yield

    def membership():
        """Mid-epoch leave + join: live pages re-home, conservation holds
        before/after (checked by `ft.elastic.kv_membership_change`)."""
        for _ in range(3 * n_requesters // 2):
            yield
        report = kv_membership_change(kv, leave=kv.owners[0], join=n_owners)
        state["migrated"] = {"moved": report["migration"]["moved"],
                             "merged": report["migration"]["merged"]}
        yield

    for r in range(n_requesters):
        sched.spawn(f"req{r:04d}", requester(r))
    sched.spawn("membership", membership())
    report = sched.run()

    while open_tables:                                   # drain every table
        kv.table_release(open_tables.pop())
    if kv.stats()["live_pages"] != {r: 0 for r in kv.owners}:
        raise ConformanceError(
            spec, sched.events,
            f"pages leaked after full release: {kv.stats()['live_pages']}")
    return {"protocol": "kv", **report, **state, "kv": kv.stats(),
            "chaos": fab.chaos_stats()}


# ======================================================================
# serve: end-to-end disaggregated request path under causal tracing (§15)
# ======================================================================
def run_serve(spec: RunSpec, reqs: int = 3, n_pages: int = 2) -> dict:
    """The serve path's causal contract, run as a conformance protocol.

    Prefill rank i pairs with decode rank ``n_pairs + i``.  Every request
    walks submit → prefill → KV page alloc (remote free-list, under
    `request_scope`) → credited flow send (tag IS the rid,
    ``causal_tags=True``) → chaos-delayed delivery → decode → attend →
    first token, each milestone stamped with the §15 segment it *ends*.
    The driver flushes/fences under `epoch_scope` of the in-flight rids so
    the sync-plane ledger can attribute fence waits to requests.

    At quiescence the collected trace is re-stitched (`obs.causal`) and the
    causal invariants asserted per completed request: the DAG is connected
    across ranks, the segment sum equals TTFT exactly (virtual time), and
    the critical path never exceeds the wall span.  A `Tracer` is installed
    for the run when none is active — the protocol cannot check causality
    untraced.
    """
    p = spec.n_ranks
    if p < 2:
        raise ConformanceError(spec, 0, "serve needs >= 2 ranks")
    n_pairs = max(1, p // 4)
    # one ring per rank; credits statically split across the prefill ranks
    capacity = 1 << max(3, (2 * n_pairs - 1).bit_length())

    own = obs_trace.Tracer() if not obs_trace.TRACER.enabled else None
    prev = obs_trace.set_tracer(own) if own is not None else None
    try:

        def checker(kind, who, sched):
            # credit admission makes ring-full impossible on the serve path
            if hfc.rejected:
                raise ConformanceError(
                    spec, sched.events,
                    f"{hfc.rejected} credited KV sends rejected at the ring")

        fab, sched = _harness(spec, checker)
        tracer = obs_trace.TRACER                       # attached to the clock
        hfc = HostFlowChannel(p, capacity, [Lane("kv", (1,), "float32")],
                              n_producers=n_pairs, fabric=fab, name="servq",
                              causal_tags=True)
        pools = {n_pairs + i: heap.HostPagePool(
                     n_pages, fabric=fab, name=f"kvpool{i}", owner=n_pairs + i)
                 for i in range(n_pairs)}
        rid_ctr = itertools.count(1)
        inflight: dict[int, tuple[int, int]] = {}       # rid -> (decode, page)
        done_by = collections.Counter()                 # decode rank -> finished
        state = {"submitted": 0, "completed": 0, "credit_stalls": 0,
                 "pool_stalls": 0}
        n_total = n_pairs * reqs

        def prefill(i: int):
            r, t = i, n_pairs + i
            rng = _rng(spec.seed, 53 * i + 23)
            tr = obs_trace.TRACER
            for _ in range(reqs):
                rid = next(rid_ctr)
                tr.event("serve.request.submit", rank=r, rid=rid)
                for _ in range(rng.randint(1, 2)):      # prefill compute
                    yield
                tr.event("serve.request.prefill", rank=r, rid=rid,
                         seg="prefill")
                # KV pages live on the decode side; alloc is the remote
                # CAS free-list pop, attributed to this request
                with obs_causal.request_scope(rid):
                    pid = pools[t].alloc(origin=r)
                while pid is None:                      # pool dry: pages
                    state["pool_stalls"] += 1           # return at decode
                    yield
                    with obs_causal.request_scope(rid):
                        pid = pools[t].alloc(origin=r)
                tr.event("serve.request.page_alloc", rank=r, rid=rid,
                         page=pid, seg="page_alloc")
                # tag IS the rid: the channel stamps the producer edge and
                # the consumer cause (flow.deliver) for cross-rank stitching
                while not hfc.send(r, "kv", np.float32([rid]), rid, t):
                    state["credit_stalls"] += 1
                    yield
                inflight[rid] = (t, pid)
                state["submitted"] += 1
                yield

        def decoder(i: int):
            t = n_pairs + i
            tr = obs_trace.TRACER
            while done_by[t] < reqs:
                try:                                    # emits flow.deliver
                    msgs = hfc.recv(t, 4)
                except (ValueError, IndexError) as e:
                    # a torn transfer (notification without payload — the
                    # Quo-Vadis-RMA divergence class) surfaces as a
                    # malformed ring row; detect it, don't crash on it
                    raise ConformanceError(
                        spec, sched.events,
                        f"decode rank {t}: malformed delivery "
                        f"(payload decoupled from notification): {e}")
                for m in msgs:
                    rid = int(m["tag"])
                    if rid not in inflight or \
                            int(np.asarray(m["payload"]).ravel()[0]) != rid:
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: KV payload for request {rid} "
                            "torn or unknown (notification decoupled from "
                            "payload)")
                    tr.event("serve.request.decode", rank=t, rid=rid,
                             cause=obs_causal.edge(
                                 rid, f"flow{int(m['src'])}-{t}"),
                             seg="kv_wire")
                    tr.event("serve.decode.attend", rank=t, rid=rid)
                    yield                               # attend compute
                    tr.event("serve.request.first_token", rank=t, rid=rid,
                             seg="attend")
                    _, pid = inflight.pop(rid)
                    with obs_causal.request_scope(rid):
                        pools[t].release(pid, origin=t)
                    done_by[t] += 1
                    state["completed"] += 1
                yield

        def driver():
            rounds = 0
            while state["completed"] < n_total:
                # the epoch's fence waits are paid by the staged requests;
                # fencing only every other round leaves the chaos schedule
                # room to reorder/delay deliveries in between
                with obs_causal.epoch_scope(sorted(inflight)):
                    hfc.flush()
                    if rounds % 2:
                        fab.fence()
                rounds += 1
                yield

        for i in range(n_pairs):
            sched.spawn(f"pre{i:04d}", prefill(i))
            sched.spawn(f"dec{i:04d}", decoder(i))
        sched.spawn("driver", driver())
        report = sched.run()

        # ---- causal invariants: re-stitch the trace and check every request
        events = list(tracer.events)
        dags = obs_causal.build_dags(events)
        ring_dropped = getattr(tracer, "dropped", 0)
        breakdowns = []
        for rid in range(1, n_total + 1):
            dag = dags.get(rid)
            if dag is None or dag.find("serve.request.submit") is None \
                    or dag.find("serve.request.first_token") is None:
                if ring_dropped:                        # flight ring shed the
                    continue                            # request's head: skip
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: trace missing or incomplete "
                    f"({'absent' if dag is None else 'no submit/first_token'})")
            if not dag.connected():
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: causal DAG disconnected across ranks "
                    f"{sorted(dag.ranks())} ({len(dag.events)} events, "
                    f"{len(dag.edges)} edges)")
            bd = obs_critpath.ttft_breakdown(dag)
            if bd["segment_sum"] != bd["ttft"]:
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: segment sum {bd['segment_sum']} != "
                    f"TTFT {bd['ttft']} (virtual time must be exact): "
                    f"{bd['segments']}")
            cp, _ = obs_critpath.critical_path(dag)
            if cp > dag.wall():
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: critical path {cp} exceeds wall "
                    f"{dag.wall()}")
            breakdowns.append(bd)
        for t, pool in pools.items():
            if pool.live_count() != 0:
                raise ConformanceError(
                    spec, sched.events,
                    f"decode rank {t}: {pool.live_count()} KV pages leaked")

        ledger = obs_critpath.SyncLedger.from_events(events)
        agg = obs_critpath.aggregate(breakdowns)
        return {"protocol": "serve", **report, **state,
                "requests_checked": len(breakdowns),
                "ttft_p99": agg["ttft"]["p99"] if breakdowns else 0,
                "sync_wait": ledger.total_wait(),
                "chaos": fab.chaos_stats()}
    finally:
        if own is not None:
            obs_trace.set_tracer(prev)


# ======================================================================
# rendezvous: descriptor-publish + consumer-pull, no payload in the ring
# ======================================================================
def run_rendezvous(spec: RunSpec, reqs: int = 3, n_pages: int = 3) -> dict:
    """The §16 rendezvous pull protocol as a conformance run.

    Prefill rank i pairs with decode rank ``n_pairs + i``, but unlike
    ``serve`` the KV pages live in the PREFILL rank's own pool and the ring
    carries only 2-word descriptors ``(page, generation)`` over a
    ``descriptor``-kind lane: publish is owner-local (zero payload wire),
    and the decoder — when it is ready — pins the named page through the
    owner's refcount bank (`HostPagePool.pin`), validates the generation
    tag, pulls the payload, and only then drops the pin and the producer's
    reference.  Invariants checked per event: every credited descriptor is
    admitted (``rejected == 0``) and pool conservation holds at the swept
    owner.  Structural no-payload invariant: every drained message must be
    descriptor-kind and exactly 2 words wide.

    A deterministic subset of requests is *abandoned* by the decoder after
    the descriptor arrives but before the pin — the "puller dies before
    flush" path.  Their pages stay live on the producer's reference alone
    until the post-run reaper drops it; at quiescence every pool must be
    fully free (refcount conservation across an interrupted pull).

    Under ``tear`` the descriptor decouples from its referent: the stale
    ``(page, gen)`` fails the tag compare, pins a dead page, or reads a
    payload that no longer matches the rid — each surfaces as a
    `ConformanceError` (the schedule MUST be caught).
    """
    p = spec.n_ranks
    if p < 2:
        raise ConformanceError(spec, 0, "rendezvous needs >= 2 ranks")
    n_pairs = max(1, p // 4)
    capacity = 1 << max(3, (2 * n_pairs - 1).bit_length())

    own = obs_trace.Tracer() if not obs_trace.TRACER.enabled else None
    prev = obs_trace.set_tracer(own) if own is not None else None
    try:
        sweep = itertools.count()

        def checker(kind, who, sched):
            if hfc.rejected:
                raise ConformanceError(
                    spec, sched.events,
                    f"{hfc.rejected} credited descriptor sends rejected")
            # every advertised ring slot must hold a fully-written 2-word
            # descriptor THE MOMENT the notification is visible (§6.1:
            # payload visible => notification visible).  A tail counter
            # that ran ahead of its row — the tear fault, notification not
            # gated on payload — shows up here as a zero/garbage header on
            # the very event that exposed it, not whenever a decoder task
            # happens to drain next.
            grp = hfc.ch.group
            cap = grp.buf.shape[1]
            for t in range(n_pairs, 2 * n_pairs):
                head = int(grp.ctrs[t, rq.HEAD])
                tail = int(grp.ctrs[t, rq.TAIL])
                for s in range(head, tail):
                    hdr = grp.buf[t, s % cap, :HDR].view(np.int32)
                    if (hdr[0] != 0 or hdr[3] != 2
                            or not 0 <= hdr[1] < n_pairs):
                        raise ConformanceError(
                            spec, sched.events,
                            f"target {t} ring slot {s % cap} advertised by "
                            f"tail={tail} holds a torn descriptor (header "
                            f"{hdr.tolist()}): notification not gated on "
                            "payload delivery")
            # round-robin conservation sweep over the owner pools: free
            # list + live refcounts must partition every pool at all times
            i = next(sweep) % n_pairs
            c = pools[i].conservation()
            if c["free_plus_live"] != c["capacity"]:
                raise ConformanceError(
                    spec, sched.events,
                    f"owner pool {i} conservation: {c}")

        fab, sched = _harness(spec, checker)
        tracer = obs_trace.TRACER
        hfc = HostFlowChannel(
            p, capacity, [Lane("desc", (2,), "int32", kind="descriptor")],
            n_producers=n_pairs, fabric=fab, name="rdvq", causal_tags=True)
        # pools are owned by the PREFILL ranks: publish never moves payload
        pools = {i: heap.HostPagePool(
                     n_pages, page_words=8, fabric=fab,
                     name=f"rdvpool{i}", owner=i)
                 for i in range(n_pairs)}
        rid_ctr = itertools.count(1)
        inflight: dict[int, tuple[int, int]] = {}       # rid -> (owner, page)
        abandoned: set[int] = set()
        done_by = collections.Counter()
        state = {"submitted": 0, "pulled": 0, "abandoned": 0,
                 "credit_stalls": 0, "pool_stalls": 0}
        n_total = n_pairs * reqs

        def prefill(i: int):
            r, t = i, n_pairs + i
            rng = _rng(spec.seed, 59 * i + 29)
            tr = obs_trace.TRACER
            for _ in range(reqs):
                rid = next(rid_ctr)
                tr.event("serve.request.submit", rank=r, rid=rid)
                for _ in range(rng.randint(1, 2)):      # prefill compute
                    yield
                tr.event("serve.request.prefill", rank=r, rid=rid,
                         seg="prefill")
                # the page comes from MY pool — owner-local alloc
                with obs_causal.request_scope(rid):
                    pid = pools[r].alloc(origin=r)
                while pid is None:
                    state["pool_stalls"] += 1
                    yield
                    with obs_causal.request_scope(rid):
                        pid = pools[r].alloc(origin=r)
                tr.event("serve.request.page_alloc", rank=r, rid=rid,
                         page=pid, seg="page_alloc")
                pools[r].pages[pid][0] = rid            # the "KV" payload
                desc = np.int32([pid, pools[r].tag(pid)])
                while not hfc.send(r, "desc", desc, rid, t):
                    state["credit_stalls"] += 1
                    yield
                inflight[rid] = (r, pid)
                state["submitted"] += 1
                yield

        def decoder(i: int):
            t = n_pairs + i
            tr = obs_trace.TRACER
            while done_by[t] < reqs:
                try:
                    msgs = hfc.recv(t, 4)
                except (ValueError, IndexError) as e:
                    raise ConformanceError(
                        spec, sched.events,
                        f"decode rank {t}: malformed delivery: {e}")
                for m in msgs:
                    rid = int(m["tag"])
                    words = np.asarray(m["payload"]).ravel()
                    # structural no-payload invariant: the ring slot holds a
                    # 2-word descriptor on a descriptor-kind lane, never KV
                    if m.get("kind") != "descriptor" or m["lane"] != "desc" \
                            or words.size != 2:
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: ring slot for request {rid} "
                            f"is not a pure descriptor (kind={m.get('kind')!r}"
                            f" lane={m['lane']!r} words={words.size})")
                    if rid not in inflight or rid in abandoned:
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: descriptor for request {rid} "
                            "duplicated or unknown")
                    owner = int(m["src"])
                    pid, tag0 = int(words[0]), int(words[1])
                    tr.event("serve.request.decode", rank=t, rid=rid,
                             cause=obs_causal.edge(
                                 rid, f"flow{owner}-{t}"),
                             seg="kv_wire")
                    if rid % 5 == 0:
                        # the puller dies before flush: descriptor consumed,
                        # pin never taken — the producer's ref alone keeps
                        # the page live until the reaper drops it
                        abandoned.add(rid)
                        state["abandoned"] += 1
                        done_by[t] += 1
                        continue
                    try:
                        with obs_causal.request_scope(rid):
                            pools[owner].pin(pid, origin=t)
                    except (heap.HeapError, ValueError, IndexError) as e:
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: pull pin for request {rid} "
                            f"hit a dead/garbage descriptor ({e}) — "
                            "descriptor decoupled from its referent")
                    if not pools[owner].tag_valid(pid, tag0):
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: request {rid} descriptor tag "
                            f"{tag0} stale at pin (page {pid} now "
                            f"{pools[owner].tag(pid)})")
                    yield                               # the pull epoch:
                    val = int(pools[owner].pages[pid][0])   # chaos window
                    if not pools[owner].tag_valid(pid, tag0):
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: page {pid} generation moved "
                            f"under a held pin (request {rid})")
                    if val != rid:
                        raise ConformanceError(
                            spec, sched.events,
                            f"decode rank {t}: pulled payload {val} != "
                            f"request {rid} (pin did not cover the pull)")
                    tr.event("serve.request.pull", rank=t, rid=rid,
                             page=pid, seg="kv_pull")
                    yield                               # attend compute
                    tr.event("serve.request.first_token", rank=t, rid=rid,
                             seg="attend")
                    with obs_causal.request_scope(rid):
                        pools[owner].unpin(pid, tag0, origin=t)  # pull pin
                        pools[owner].release(pid, origin=t)      # producer ref
                    inflight.pop(rid)
                    done_by[t] += 1
                    state["pulled"] += 1
                yield

        def driver():
            while state["pulled"] + state["abandoned"] < n_total:
                with obs_causal.epoch_scope(sorted(inflight)):
                    hfc.flush()
                    if sched.events % 2:
                        fab.fence()
                yield

        for i in range(n_pairs):
            sched.spawn(f"pre{i:04d}", prefill(i))
            sched.spawn(f"dec{i:04d}", decoder(i))
        sched.spawn("driver", driver())
        report = sched.run()

        fab.fence()
        # reaper: drop the producer refs of the abandoned pulls — the pages
        # a dead puller named must come back (refcount conservation)
        for rid in sorted(abandoned):
            owner, pid = inflight.pop(rid)
            pools[owner].release(pid, origin=owner)
        for i, pool in pools.items():
            if pool.live_count() != 0:
                raise ConformanceError(
                    spec, sched.events,
                    f"owner pool {i}: {pool.live_count()} pages leaked "
                    "after interrupted pulls were reaped")
        if hfc.sends_by_kind["payload"] != 0:
            raise ConformanceError(
                spec, sched.events,
                f"{hfc.sends_by_kind['payload']} ring-payload sends on the "
                "pull path (must be descriptor-only)")

        # ---- causal invariants, as in `serve` (abandoned rids excepted)
        events = list(tracer.events)
        dags = obs_causal.build_dags(events)
        ring_dropped = getattr(tracer, "dropped", 0)
        breakdowns = []
        for rid in range(1, n_total + 1):
            if rid in abandoned or rid % 5 == 0:
                continue
            dag = dags.get(rid)
            if dag is None or dag.find("serve.request.submit") is None \
                    or dag.find("serve.request.first_token") is None:
                if ring_dropped:
                    continue
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: trace missing or incomplete")
            if not dag.connected():
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: causal DAG disconnected across ranks "
                    f"{sorted(dag.ranks())}")
            bd = obs_critpath.ttft_breakdown(dag)
            if bd["segment_sum"] != bd["ttft"]:
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: segment sum {bd['segment_sum']} != "
                    f"TTFT {bd['ttft']}: {bd['segments']}")
            cp, _ = obs_critpath.critical_path(dag)
            if cp > dag.wall():
                raise ConformanceError(
                    spec, sched.events,
                    f"request {rid}: critical path {cp} exceeds wall "
                    f"{dag.wall()}")
            breakdowns.append(bd)

        agg = obs_critpath.aggregate(breakdowns)
        return {"protocol": "rendezvous", **report, **state,
                "requests_checked": len(breakdowns),
                "descriptor_sends": hfc.sends_by_kind["descriptor"],
                "payload_sends": hfc.sends_by_kind["payload"],
                "descriptor_bytes": hfc.bytes_by_kind["descriptor"],
                "kv_pull_p99": (agg["segments"].get("kv_pull", {})
                                .get("p99", 0) if breakdowns else 0),
                "ttft_p99": agg["ttft"]["p99"] if breakdowns else 0,
                "chaos": fab.chaos_stats()}
    finally:
        if own is not None:
            obs_trace.set_tracer(prev)


# ======================================================================
# rebind: stale credit cache across an elastic re-attach must rebase
# ======================================================================
def run_rebind(spec: RunSpec) -> dict:
    """Elastic membership vs the producer-side credit cache (§9/§14).

    Rank ``p-1`` is a pure consumer; every other rank produces.  Phase 1
    drives every producer deterministically dry (each spends its full
    initial grant, the consumer never drains).  Phase 2 fences the fabric
    and re-attaches the consumer's window (`HostFlowChannel.rebind`):
    fresh ring, fresh grants, bumped attach id.  Phase 3 resumes the
    producers: their first send finds the cache dry, refreshes, sees the
    attach id moved, and REBASES (limit := fresh grants, sent := 0)
    instead of ``max``-ing against the stale pre-rebind grant — without
    the guard the refreshed limit equals the already-spent counter and
    every post-rebind send defers forever (deterministic livelock, which
    the scheduler surfaces).  Phase 4 drains and asserts every
    post-rebind send arrived; credit conservation and ``rejected == 0``
    are checked at every event throughout.
    """
    p = spec.n_ranks
    if p < 2:
        raise ConformanceError(spec, 0, "rebind needs >= 2 ranks")
    T = p - 1
    nprod = p - 1
    capacity = 1 << max(3, (2 * nprod - 1).bit_length())

    def checker(kind, who, sched):
        if hfc.rejected:
            raise ConformanceError(
                spec, sched.events,
                f"{hfc.rejected} credited sends rejected at the ring")
        c = hfc.conservation(T)
        if c["granted_minus_head"] != capacity:
            raise ConformanceError(
                spec, sched.events,
                f"credit conservation at target {T} across rebind: {c}")

    fab, sched = _harness(spec, checker)
    hfc = HostFlowChannel(p, capacity, [Lane("c", (1,), "float32")],
                          n_producers=nprod, fabric=fab, name="rebq")
    state = {"dry": 0, "rebound": False, "sent_pre": 0, "sent_post": 0,
             "recv_post": 0}

    def producer(r: int):
        # phase 1: spend the whole initial grant, then go dry
        while hfc.send(r, "c", np.float32([r]), r, T):
            state["sent_pre"] += 1
            yield
        state["dry"] += 1
        while not state["rebound"]:
            yield
        # phase 3: the cache is stale (sent == old limit); the send's
        # refresh must observe the bumped attach id and rebase
        while not hfc.send(r, "c", np.float32([1000 + r]), r, T):
            yield
        state["sent_post"] += 1
        yield

    def driver():
        while state["dry"] < nprod:
            hfc.flush()
            yield
        # phase 2: quiesce, then re-attach the consumer's window
        hfc.flush()
        fab.fence()
        hfc.rebind(T)
        state["rebound"] = True
        yield
        # phase 4: drain — only post-rebind sends can arrive (the old
        # incarnation's ring died with the detach)
        while state["recv_post"] < nprod:
            hfc.flush()
            for m in _recv(spec, sched, hfc, T, None):
                val = int(np.asarray(m["payload"]).ravel()[0])
                if val < 1000:
                    raise ConformanceError(
                        spec, sched.events,
                        f"pre-rebind payload {val} delivered into the "
                        "re-attached ring")
                state["recv_post"] += 1
            yield

    for r in range(nprod):
        sched.spawn(f"rank{r:04d}", producer(r))
    sched.spawn("driver", driver())
    report = sched.run()

    if state["recv_post"] != state["sent_post"] or state["sent_post"] != nprod:
        raise ConformanceError(
            spec, sched.events,
            f"post-rebind: {state['sent_post']} credited sends, "
            f"{state['recv_post']} received (all {nprod} must survive)")
    if hfc.rebinds != nprod:
        raise ConformanceError(
            spec, sched.events,
            f"{hfc.rebinds} producer rebases != {nprod} producers — a "
            "stale grant was max()-ed instead of rebased")
    return {"protocol": "rebind", **report, **state,
            "rebinds": hfc.rebinds, "refreshes": hfc.refreshes,
            "chaos": fab.chaos_stats()}


# ======================================================================
# suite driver + CLI
# ======================================================================
PROTOCOLS = {
    "queue": run_queue,
    "flow": run_flow,
    "heap": run_heap,
    "epoch": run_epoch,
    "lock": run_lock,
    "kv": run_kv,
    "serve": run_serve,
    "rendezvous": run_rendezvous,
    "rebind": run_rebind,
}


def _run_protocol(spec: RunSpec, **overrides) -> dict:
    """Invoke one protocol runner; under ``check_races`` finalize the
    shadow `RaceChecker` the harness attached, turning any memory-model
    violation into a `ConformanceError` with the same repro line."""
    _SHADOWS.clear()
    try:
        report = PROTOCOLS[spec.protocol](spec, **overrides)
    finally:
        shadow = _SHADOWS.pop() if _SHADOWS else None
    if shadow is not None:
        shadow.finish()
        if shadow.violations:
            raise ConformanceError(
                spec, -1,
                f"race checker: {len(shadow.violations)} RMA memory-model "
                "violation(s):\n  "
                + "\n  ".join(str(v) for v in shadow.violations))
        report["races_checked"] = shadow.events
    return report


def run_one(protocol: str, n_ranks: int, schedule: str, seed: int,
            tracer=None, check_races: bool = False, **overrides) -> dict:
    """Run one conformance spec, optionally under an `obs` tracer.

    The tracer is installed as the global tracer for the run's duration;
    the harness's `Scheduler` attaches its virtual clock, so the collected
    trace is timestamped in deterministic virtual ticks — a pure function
    of ``(seed, schedule)``, byte-identical across replays (§12)."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r} (have {sorted(PROTOCOLS)})")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} (have {sorted(SCHEDULES)})")
    spec = RunSpec(protocol, n_ranks, schedule, seed, check_races)
    if tracer is None:
        return _run_protocol(spec, **overrides)
    prev = obs_trace.set_tracer(tracer)
    try:
        return _run_protocol(spec, **overrides)
    finally:
        obs_trace.set_tracer(prev)


def run_suite(protocols, n_ranks: int, schedules, seeds,
              trace_dir: str | None = None,
              check_races: bool = False,
              flight: bool = False) -> list[dict]:
    from ..core.fabric import FabricError
    from .sched import SchedulerError

    results = []
    for protocol in protocols:
        for schedule in schedules:
            for seed in seeds:
                spec = RunSpec(protocol, n_ranks, schedule, seed,
                               check_races)
                entry = {"spec": spec, "ok": True, "error": None}
                # with a trace dir, every run records under a fresh tracer
                # so a failing run's trace can be exported post-mortem;
                # --flight swaps in the bounded ring (O(1) memory) and adds
                # the critical-path report to the dump
                tracer = None
                if trace_dir:
                    tracer = (obs_flight.FlightRecorder(dump_dir=trace_dir)
                              if flight else obs_trace.Tracer())
                prev = (obs_trace.set_tracer(tracer)
                        if tracer is not None else None)
                try:
                    entry["report"] = _run_protocol(spec)
                except ConformanceError as e:
                    entry.update(ok=False, error=e)
                except (SchedulerError, FabricError) as e:
                    # livelock / transport-internal failures must not abort
                    # the sweep: report them with the same repro line
                    entry.update(ok=False, error=ConformanceError(
                        spec, -1, f"{type(e).__name__}: {e}"))
                finally:
                    if tracer is not None:
                        obs_trace.set_tracer(prev)
                if tracer is not None and not entry["ok"]:
                    os.makedirs(trace_dir, exist_ok=True)
                    stem = os.path.join(
                        trace_dir, f"{protocol}-{schedule}-seed{seed}")
                    if isinstance(tracer, obs_flight.FlightRecorder):
                        trace_path, report_path = tracer.dump(
                            stem, reason=str(entry["error"]))
                        entry["trace"] = trace_path
                        entry["critpath"] = report_path
                    else:
                        path = stem + ".trace.json"
                        dump_chrome_trace(tracer, path)
                        entry["trace"] = path
                results.append(entry)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the simulated-fabric conformance suite")
    ap.add_argument("--protocols",
                    default="queue,flow,heap,epoch,lock,serve,"
                            "rendezvous,rebind")
    ap.add_argument("--ranks", type=int, default=256)
    ap.add_argument("--schedules", default="reorder,delay,duplicate")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--sweep", type=int, default=0,
                    help="run N consecutive seeds starting at --seed-base")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="3-seed 64-rank subset (the bench-smoke rider)")
    ap.add_argument("--expect-fail", action="store_true",
                    help="exit 0 IFF at least one violation is caught "
                         "(fault-injection schedules like 'tear')")
    ap.add_argument("--check-races", action="store_true",
                    help="attach the repro_torch.analysis race checker as a "
                         "fabric shadow; any MPI-3 memory-model violation "
                         "fails the run with descriptor provenance")
    ap.add_argument("--summary", default=os.environ.get("GITHUB_STEP_SUMMARY"),
                    help="append a markdown summary to this file")
    ap.add_argument("--trace-dir", default=None,
                    help="export Perfetto traces of FAILING runs here "
                         "(virtual-time, replay-exact)")
    ap.add_argument("--flight", action="store_true",
                    help="record under a bounded flight-recorder ring and "
                         "dump trace + critical-path report of FAILING "
                         "runs to --trace-dir (default: sim-traces)")
    args = ap.parse_args(argv)
    if args.flight and not args.trace_dir:
        args.trace_dir = "sim-traces"

    if args.smoke:
        ranks, seeds = 64, [0, 1, 2]
        protocols = list(PROTOCOLS)
        schedules = ["reorder", "delay", "duplicate"]
    else:
        ranks = args.ranks
        protocols = [s for s in args.protocols.split(",") if s]
        schedules = [s for s in args.schedules.split(",") if s]
        if args.sweep:
            seeds = list(range(args.seed_base, args.seed_base + args.sweep))
        else:
            seeds = [int(s) for s in args.seeds.split(",") if s]

    results = run_suite(protocols, ranks, schedules, seeds,
                        trace_dir=args.trace_dir,
                        check_races=args.check_races,
                        flight=args.flight)
    lines = []
    n_fail = 0
    for r in results:
        spec = r["spec"]
        tag = f"{spec.protocol:6s} p={spec.n_ranks} {spec.schedule:9s} seed={spec.seed}"
        if r["ok"]:
            rep = r["report"]
            lines.append(f"PASS {tag}  events={rep['events']} "
                         f"vt={rep['virtual_time']}")
        else:
            n_fail += 1
            lines.append(f"FAIL {tag}\n  {r['error']}")
            if r.get("trace"):
                lines.append(f"  trace: {r['trace']}")
            if r.get("critpath"):
                lines.append(f"  critpath: {r['critpath']}")
    print("\n".join(lines))
    print(f"\n{len(results) - n_fail}/{len(results)} runs passed "
          f"({len(protocols)} protocols x {len(schedules)} schedules x "
          f"{len(seeds)} seeds at {ranks} ranks)")

    if args.summary:
        try:
            with open(args.summary, "a") as f:
                f.write(f"### sim-chaos conformance ({ranks} ranks)\n\n```\n")
                f.write("\n".join(lines))
                f.write("\n```\n")
        except OSError:
            pass

    if args.expect_fail:
        if n_fail == 0:
            print("ERROR: --expect-fail but every run passed "
                  "(fault injection not detected)")
            return 1
        return 0
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
