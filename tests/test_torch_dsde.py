"""Notified access and the DSDE protocols of the PyTorch port against the
JAX reference on the same numpy inputs, at p = 4.

Covered: the four DSDE protocols (`core.dsde`: the accumulate exchange,
the alltoall and reduce-scatter baselines, the queue exchange) on random
targets and on a skewed case that overflows the per-pair slots and the
queue's ring; the six `rmaq.notify` functions with counters that wrap
past 2**32; `queue.enqueue_shift` + `queue.drain`; `flow.refresh`.

The reference needs a 4-device mesh, which the main test process must not
have, so this file's own ``__main__`` branch runs the JAX side in a child
process with forced host devices and writes every output and every
`OpCounter` ledger; the tests run the port on the same inputs with
``device="cpu"`` and compare.  Outputs must be bit-equal and the ledgers
equal by kind.  Wire counts are held to each package's own model: the
reference packs the DSDE plan by its TPU model (raw 3 -> wire 1), the
port's H100 model never packs on one card (raw 3 -> wire 3).
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro.core.perfmodel import DEFAULT_MODEL as JAX_MODEL  # noqa: E402
from repro_torch.core import dsde as tdsde  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core.plan import u32_to_wire  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402
from repro_torch.parallel.overlap import CollectiveStrategist  # noqa: E402
from repro_torch.rmaq import channel as tch  # noqa: E402
from repro_torch.rmaq import flow as tfl  # noqa: E402
from repro_torch.rmaq import notify as tnotify  # noqa: E402
from repro_torch.rmaq import queue as tq  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP = 4
K, D = 6, 2                     # items a rank, words an item
CAP_PAIR, CAP_SKEW = 8, 2       # slots a pair: roomy, and overflowing
PERM_PART = [(0, 2), (1, 3), (3, 1)]        # rank 0 gets nothing
Q_CAP, Q_K, Q_W = 8, 5, 3       # enqueue_shift ring
F_CAP, F_LANES, F_PRODUCERS = 16, 2, 3
WRAP = 2**32 - 2                # counters start here and wrap
U32 = ("counter", "expected", "published", "limit", "granted", "sent", "qctrs")
# A skewed target set: ranks 0, 1 and 3 overflow a pair's CAP_SKEW slots and
# send nothing to rank 0 (see `test_dsde_keeps_the_first_slot_of_rank_0`);
# rank 3 receives 11 items, more than the queue's 8-slot ring holds.
SKEW = np.array([[1, 1, 1, 2, 3, 3], [2, 2, 2, 2, 3, 1],
                 [0, 0, 1, 3, 3, 2], [3, 3, 3, 3, 3, 3]], np.int32)
PROTOCOLS = ("exchange_accumulate", "exchange_alltoall_baseline",
             "exchange_reduce_scatter_baseline", "exchange_queue")


def _inputs() -> dict:
    rng = np.random.default_rng(14)

    def u32(*s):
        return rng.integers(WRAP - 8, 2**32, s, dtype=np.uint64).astype(np.uint32)

    return {
        "data": rng.standard_normal((NP, K, D)).astype(np.float32),
        "tg": rng.integers(0, NP, (NP, K)).astype(np.int32),
        "skew": SKEW,
        "x": rng.standard_normal((NP, 3, 5)).astype(np.float32),
        "counter": np.array([2**32 - 1, 2**32 - 1, WRAP, 7], np.uint32),
        "expected": rng.integers(0, 2**32, NP, dtype=np.uint64).astype(np.uint32),
        "send_counts": rng.integers(0, 9, (NP, NP)).astype(np.int32),
        "fx": rng.integers(-50, 50, (NP, 3)).astype(np.int32),
        "published": u32(NP, NP, 2),
        "limit": u32(NP, NP, F_LANES),
        "granted": u32(NP, NP, F_LANES),
        "sent": u32(NP, NP, F_LANES),
        "qbuf": rng.standard_normal((NP, Q_CAP, Q_W)).astype(np.float32),
        "qctrs": np.stack([np.full(5, WRAP, np.uint32)] * NP),
        "qmsgs": rng.standard_normal((NP, Q_K, Q_W)).astype(np.float32),
    }


# ================================================================ cases
# name -> (input names, jax fn over one rank's blocks, port fn over stacked
# tensors and a Mesh).  Every fn returns a tuple of arrays.
def _dsde_cases():
    from repro.core import dsde as jdsde

    cases = {}
    for proto in PROTOCOLS:
        for tgt, cap in (("tg", CAP_PAIR), ("skew", CAP_SKEW)):
            def jfn(d, t, proto=proto, cap=cap):
                r = getattr(jdsde, proto)(d, t, "x", cap)
                return r.recv_data, r.recv_valid, r.recv_counts, r.sent_dropped

            def tfn(m, d, t, proto=proto, cap=cap):
                return tuple(getattr(tdsde, proto)(d, t, m, cap))

            cases[f"{proto}/{tgt}"] = (("data", tgt), jfn, tfn)
    return cases


def _notify_cases():
    from repro.rmaq import notify as jn

    def jshift(s):
        return lambda x, c: jn.notified_put_shift(x, c, s, "x")

    def tshift(s):
        return lambda m, x, c: tnotify.notified_put_shift(x, c, s, m)

    cases = {f"notified_put_shift{s:+d}": (("x", "counter"), jshift(s), tshift(s))
             for s in (1, -1, 0, NP + 1)}
    cases["notified_put_perm"] = (
        ("x", "counter"), lambda x, c: jn.notified_put_perm(x, c, PERM_PART, "x"),
        lambda m, x, c: tnotify.notified_put_perm(x, c, PERM_PART, m))
    cases["accumulate_counts"] = (
        ("send_counts",), lambda s: (jn.accumulate_counts(s, "x"),),
        lambda m, s: (tnotify.accumulate_counts(s, m),))
    cases["fetch_and_add_ordered"] = (
        ("fx",), lambda x: jn.fetch_and_add_ordered(x, "x"),
        lambda m, x: tnotify.fetch_and_add_ordered(x, m))
    cases["fetch_credits"] = (
        ("published",), lambda g: (jn.fetch_credits(g, "x"),),
        lambda m, g: (tnotify.fetch_credits(u32_to_wire(g), m),))
    cases["wait_notifications"] = (
        ("x", "counter", "expected"), lambda x, c, e: jn.wait_notifications(x, c, e),
        lambda m, x, c, e: tnotify.wait_notifications(x, c, e))
    return cases


def _flow_lanes(lane_cls, dtype):
    return [lane_cls("a", (2,), dtype), lane_cls("b", (3,), dtype)]


def _queue_flow_cases():
    from repro.rmaq import channel as jch
    from repro.rmaq import flow as jfl
    from repro.rmaq import queue as jq

    @functools.lru_cache(maxsize=None)
    def jax_objs():          # built in the child only: it needs NP devices
        mesh = jax.make_mesh((NP,), ("x",))
        jdesc, _ = jq.queue_allocate(mesh, "x", Q_CAP, (Q_W,), jnp.float32)
        jchan, _, _ = jfl.flow_allocate(mesh, "x", F_CAP, _flow_lanes(jch.Lane, jnp.int32),
                                        n_producers=F_PRODUCERS)
        return jdesc, jchan

    tmesh = Mesh(NP, "x", device="cpu")
    tdesc, _ = tq.queue_allocate(tmesh, Q_CAP, (Q_W,), torch.float32)
    tchan, _, _ = tfl.flow_allocate(tmesh, F_CAP, _flow_lanes(tch.Lane, torch.int32),
                                    n_producers=F_PRODUCERS)

    def jq_case(shift):
        def fn(buf, ctrs, msgs):
            jdesc = jax_objs()[0]
            st, rec = jq.enqueue_shift(jdesc, jq.QueueState(buf, ctrs), msgs, shift)
            st, items, valid = jq.drain(jdesc, st)
            return (st.buf, st.ctrs, rec.accepted, rec.n_sent, rec.n_dropped,
                    rec.incoming, rec.notifications, items, valid)
        return fn

    def tq_case(shift):
        def fn(m, buf, ctrs, msgs):
            st, rec = tq.enqueue_shift(tdesc, tq.QueueState(buf, ctrs), msgs, shift)
            st, items, valid = tq.drain(tdesc, st)
            return (st.buf, st.ctrs, rec.accepted, rec.n_sent, rec.n_dropped,
                    rec.incoming, rec.notifications, items, valid)
        return fn

    cases = {f"enqueue_shift{s:+d}+drain": (("qbuf", "qctrs", "qmsgs"), jq_case(s), tq_case(s))
             for s in (1, -1, 0)}
    cases["flow.refresh"] = (
        ("sent", "limit", "granted"),
        lambda s, lim, g: (jfl.refresh(jax_objs()[1], jfl.FlowState(s, lim, g)).limit,),
        lambda m, s, lim, g: (tfl.refresh(tchan, tfl.FlowState(s, lim, g)).limit,))
    return cases


def _cases():
    return {**_dsde_cases(), **_notify_cases(), **_queue_flow_cases()}


DSDE_NAMES = [f"{p}/{t}" for p in PROTOCOLS for t in ("tg", "skew")]
OTHER_NAMES = ([f"notified_put_shift{s:+d}" for s in (1, -1, 0, NP + 1)]
               + ["notified_put_perm", "accumulate_counts", "fetch_and_add_ordered",
                  "fetch_credits", "wait_notifications"]
               + [f"enqueue_shift{s:+d}+drain" for s in (1, -1, 0)] + ["flow.refresh"])


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    from repro.core.rma import OpCounter as JOpCounter

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NP,), ("x",))
    out, snaps = {}, {}
    for name, (names, fn, _) in _cases().items():
        def body(*blocks, fn=fn):
            return tuple(jnp.asarray(r)[None] for r in fn(*[b[0] for b in blocks]))

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(P("x") for _ in names),
                              out_specs=P("x"), check_vma=False))
        with JOpCounter() as c:
            res = f(*[jnp.asarray(inp[n]) for n in names])
        for i, r in enumerate(res):
            out[f"{name}/{i}"] = np.asarray(r)
        snaps[name] = {"ops": c.snapshot(), "plans": c.plans}
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("dsde")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


# ================================================================ helpers
def _tensor(inputs: dict, name: str) -> torch.Tensor:
    a = inputs[name]
    return torch.from_numpy(a.astype(np.int64) if name in U32 else a.copy())


def _run_port(name: str, inputs: dict):
    names, _, fn = _cases()[name]
    m = Mesh(NP, "x", device="cpu")
    with OpCounter() as c:
        res = fn(m, *[_tensor(inputs, n) for n in names])
    return [r.numpy() for r in res], {"ops": c.snapshot(), "plans": c.plans}


def _assert_bit_equal(got: list, ref_out: dict, name: str) -> None:
    assert f"{name}/{len(got)}" not in ref_out, "the port returned fewer outputs"
    for i, g in enumerate(got):
        w = ref_out[f"{name}/{i}"]
        w = w.reshape(g.shape) if w.size == g.size else w
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g.view(np.uint32), w.astype(g.dtype).view(np.uint32),
                                          err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"output {i}")


def _group_coalesced(model, plans: list, p: int) -> int:
    """Wire transfers a plan ledger gets from `model`: each flushed plan of
    these cases is one all-to-all group of `raw` ops."""
    wire = 0
    for pl in plans:
        n = pl["raw"]
        pack = n > 1 and model.select_aggregation(n, p * pl["bytes_logical"] / n) == "pack"
        wire += 1 if pack else n
    return wire


# ================================================================ tests
@pytest.mark.parametrize("name", DSDE_NAMES)
def test_dsde_protocol_matches_reference(name, inputs, jax_ref):
    ref_out, ref_snaps = jax_ref
    got, snap = _run_port(name, inputs)
    _assert_bit_equal(got, ref_out, name)
    recv_valid, sent_dropped = got[1], got[3]
    n_items = NP * K
    assert recv_valid.sum() + sent_dropped.sum() == n_items      # conserved
    if name.endswith("/skew"):
        assert sent_dropped.sum() > 0

    ref = ref_snaps[name]
    for k in ("puts", "gets", "accs", "colls", "raw_msgs", "by_axis"):
        assert snap["ops"][k] == ref["ops"][k], k
    if "queue" in name:
        # the enqueue epoch forces packing in both packages: 5 ops -> 2
        assert snap["ops"]["coalesced_msgs"] == ref["ops"]["coalesced_msgs"] == 2
        assert snap["plans"] == ref["plans"]
    else:
        # wire counts: each package's own aggregation model
        assert snap["ops"]["coalesced_msgs"] == _group_coalesced(
            tperf.DEFAULT_MODEL, snap["plans"], NP)
        dsde_plan = [pl for pl in snap["plans"] if pl["raw"] == 3]
        ref_plan = [pl for pl in ref["plans"] if pl["raw"] == 3]
        assert len(dsde_plan) == len(ref_plan) == 1
        assert (dsde_plan[0]["raw"], dsde_plan[0]["coalesced"]) == (3, 3)
        assert (ref_plan[0]["raw"], ref_plan[0]["coalesced"]) == (3, 1)
        assert ref["ops"]["coalesced_msgs"] == _group_coalesced(JAX_MODEL, ref["plans"], NP)
        for k in ("groups", "bytes_logical"):
            assert dsde_plan[0][k] == ref_plan[0][k], k


@pytest.mark.parametrize("name", OTHER_NAMES)
def test_notify_queue_flow_match_reference(name, inputs, jax_ref):
    ref_out, ref_snaps = jax_ref
    got, snap = _run_port(name, inputs)
    _assert_bit_equal(got, ref_out, name)
    assert snap == ref_snaps[name]


def test_counters_wrapped_and_notifications_landed(inputs):
    """The inputs exercise what they claim: the counters wrap past 2**32 and
    a notified put bumps exactly the destinations."""
    m = Mesh(NP, "x", device="cpu")
    c = _tensor(inputs, "counter")
    x = _tensor(inputs, "x")
    _, after = tnotify.notified_put_perm(x, c, PERM_PART, m)
    moved = (after - c) % 2**32
    assert moved.tolist() == [0, 1, 1, 1] and bool((after < c).any())
    _, after = tnotify.notified_put_shift(x, c, 1, m)
    assert ((after - c) % 2**32).tolist() == [1] * NP


def test_dsde_keeps_the_first_slot_of_rank_0():
    """A dropped item writes nothing here.  In the reference it is scattered
    to send slot 0 with that slot's old value, which wipes the first item
    bound for rank 0 while the slot stays valid; the port keeps it."""
    m = Mesh(NP, "x", device="cpu")
    data = torch.arange(NP * K * D, dtype=torch.float32).reshape(NP, K, D) + 1
    tg = torch.tensor([[0, 1, 1, 1, 2, 3]] + [[1] * K] * (NP - 1), dtype=torch.int32)
    res = tdsde.exchange_accumulate(data, tg, m, 2)
    assert res.sent_dropped.tolist() == [1, 4, 4, 4]
    assert bool(res.recv_valid[0, 0]) and torch.equal(res.recv_data[0, 0], data[0, 0])
    got = res.recv_data[res.recv_valid]
    assert got.shape[0] == NP * K - int(res.sent_dropped.sum())
    assert bool((got != 0).all())


def test_psum_scatter_is_the_tiled_reduce_scatter():
    m = Mesh(NP, "x", device="cpu")
    x = torch.arange(NP * NP * 2, dtype=torch.int32).reshape(NP, NP * 2)
    out = m.psum_scatter(x)
    assert out.dtype == torch.int32 and out.shape == (NP, 2)
    assert torch.equal(out.reshape(-1), x.sum(0, dtype=torch.int32))
    with pytest.raises(MeshError):
        m.psum_scatter(torch.ones(NP, NP + 1))


def test_h100_dispatch_crossovers_come_from_the_port_constants():
    """`select_dispatch` prices the queue as the port runs it — the
    launch-bound reservation and enqueues plus `QUEUE_EXCHANGE_PASSES` over
    its O(p²) send buffers and whole-ring drain — and the all-to-all at one
    launch plus the padded matrix's bytes: the crossovers are the card's,
    not the TPU's."""
    m = tperf.DEFAULT_MODEL
    hw = m.hw
    strat = CollectiveStrategist()
    assert m.all_to_all(8.0, 64) == pytest.approx(
        hw.launch_latency + 2 * 8.0 * 64 * 63 / hw.copy_bandwidth)
    assert m.p_queue_reserve() == m.p_get(8.0)
    assert m.notification_latency() == hw.event_latency + hw.launch_latency
    assert m.queue_msg_rate(8.0) == pytest.approx(1.0 / hw.launch_latency)
    assert m.p_credit_refresh(fused=True) == 0.0
    assert m.p_credit_refresh(fused=False) == m.p_get(4.0)
    for args in ((4, 256.0, 64, 32), (2048, 256.0, 8, 4), (6, 8.0, 4096, 24)):
        n, b, p, cap = args
        ring = 1 << (p * cap - 1).bit_length()
        dense = (p * (p * n + 1) * (b + 5) + p * ring * (b + 9)) / hw.copy_bandwidth
        t_queue = (m.p_queue_reserve() + n * m.p_queue_enqueue(b)
                   + tperf.QUEUE_EXCHANGE_PASSES * dense)
        assert m.p_queue_exchange(*args) == pytest.approx(t_queue)
        want = "queue" if t_queue < m.all_to_all(cap * b, p) else "alltoall"
        assert strat.dispatch_plan(*args) == m.select_dispatch(*args) == want
    # the reference's sparse case goes to the all-to-all on one card (the
    # TPU picks the queue); its dense case stays there; and so does the
    # paper's DSDE setting at p = 4096 (k = 6, 8-byte items, 24 slots a
    # pair), where the card ran the all-to-all ~6x faster (PERF.md §5)
    assert strat.dispatch_plan(4, 256.0, 64, 32) == "alltoall"
    assert strat.dispatch_plan(2048, 256.0, 8, 4) == "alltoall"
    assert strat.dispatch_plan(6, 8.0, 4096, 24) == "alltoall"
    # the fit: the model gives the card's 39.860 ms for that exchange
    assert m.p_queue_exchange(6, 8.0, 4096, 24) == pytest.approx(39.860e-3, rel=0.01)
    # the queue's dense buffers are O(p²) whatever is sent, so in the model
    # even one message a rank does not reach the queue at that size (the
    # model's claim: the card measured k = 6 only)
    assert m.select_dispatch(1, 8.0, 4096, 24) == "alltoall"


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
