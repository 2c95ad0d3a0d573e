"""Notified-access queues, channels and credit flow: the PyTorch port
against the JAX reference on the same numpy inputs.

In-process: `admission_plan`, `_fifo_pos` and the plan's word codec
(f32/i32/u32/bool/bf16/f16/i8 word-for-word against the reference; the
64-bit payloads held to numpy bit equality).

Across ranks: the reference needs a 4-device mesh, which the main test
process must not have, so this file's own ``__main__`` branch runs the JAX
side in a child process with forced host devices and writes its outputs;
the test then runs the port on the same inputs and compares.  Covered:
`enqueue_epoch` + `dequeue`, and `flow.send` + `flow.recv`, with random
destinations and lanes (including invalid ones) and every uint32 counter
started at 2**32 - 3 so the sequence numbers and credits wrap.
"""

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
from repro.core import plan as jplan  # noqa: E402
from repro.rmaq import channel as jch  # noqa: E402
from repro.rmaq import flow as jfl  # noqa: E402
from repro.rmaq import queue as jq  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmaq import channel as tch  # noqa: E402
from repro_torch.rmaq import flow as tfl  # noqa: E402
from repro_torch.rmaq import queue as tq  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
P_RANKS, CAP, START = 4, 8, 2**32 - 3
EPOCHS = 4
# queue case: k messages per rank per epoch, item width W, drain width
Q_K, Q_W, Q_DRAIN = 3, 5, 3
# flow case: two int32 lanes of 3 words, 2 producers, drain width 2
F_K, F_WORDS, F_PRODUCERS, F_DRAIN = 3, 3, 2, 2


def _run_jax_child(case: str, workdir: pathlib.Path) -> dict:
    """Run `case` of this file's __main__ branch on 4 forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={P_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, case, str(workdir)],
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(workdir / "out.npz"))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


# ---------------------------------------------------------------- in-process
@pytest.mark.parametrize("seed", range(6))
def test_admission_plan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C = rng.integers(0, 5, (P_RANKS, P_RANKS)).astype(np.int32)
    used = rng.integers(0, CAP + 1, P_RANKS).astype(np.int32)
    g_ref, o_ref = jq.admission_plan(C, used, CAP, xp=np)
    g, o = tq.admission_plan(torch.from_numpy(C).long(), torch.from_numpy(used).long(), CAP)
    np.testing.assert_array_equal(g.numpy(), g_ref)
    np.testing.assert_array_equal(o.numpy(), o_ref)


@pytest.mark.parametrize("seed", range(4))
def test_fifo_pos_matches_reference_batched(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 6, (5, 11)).astype(np.int32)
    valid = rng.random((5, 11)) > 0.3
    got = tq._fifo_pos(torch.from_numpy(keys).long(), torch.from_numpy(valid), 6)
    for b in range(5):
        want = np.asarray(jq._fifo_pos(jnp.asarray(keys[b]), jnp.asarray(valid[b]), 6))
        np.testing.assert_array_equal(got[b].numpy(), want)


CODEC_32 = {
    "float32": (np.float32, jnp.float32, torch.float32),
    "int32": (np.int32, jnp.int32, torch.int32),
    "uint32": (np.uint32, jnp.uint32, torch.uint32),
    "bool": (np.bool_, jnp.bool_, torch.bool),
    "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
    "float16": (np.float16, jnp.float16, torch.float16),
    "int8": (np.int8, jnp.int8, torch.int8),
}


def _codec_sample(rng, name, shape):
    if name == "bool":
        return rng.random(shape) > 0.5
    if name in ("bfloat16", "float16"):
        return rng.integers(-128, 128, shape).astype(np.float32)  # exact in both
    if name == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(CODEC_32[name][0])
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(CODEC_32[name][0])


@pytest.mark.parametrize("lead", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CODEC_32))
def test_codec_words_match_reference(name, lead):
    rng = np.random.default_rng(lead)
    x = _codec_sample(rng, name, (3, 5))
    _, jdt, tdt = CODEC_32[name]
    w_ref = np.asarray(jplan._encode(jnp.asarray(x, jdt), lead))
    xt = torch.from_numpy(x).to(tdt)
    w = tplan._encode(xt, lead)
    assert w.dtype == torch.int32 and tuple(w.shape) == w_ref.shape
    np.testing.assert_array_equal(w.numpy().view(np.uint32), w_ref)
    back = tplan._decode(w, tuple(xt.shape), tdt)
    assert back.dtype == tdt
    assert torch.equal(back, xt)


@pytest.mark.parametrize("name", ["float64", "int64", "uint64"])
def test_codec_64bit_is_numpy_bit_exact(name):
    rng = np.random.default_rng(1)
    if name == "float64":
        x = rng.standard_normal((4, 3))
    else:
        x = rng.integers(0, 2**62, (4, 3)).astype(name)
        x[0, 0] = np.iinfo(name).max
        x[0, 1] = np.iinfo(name).min
    xt = torch.from_numpy(x)
    w = tplan._encode(xt, 1)
    assert tuple(w.shape) == (4, 6) and tplan._words_per_elt(xt.dtype) == 2
    np.testing.assert_array_equal(w.numpy().view(np.uint32), x.view(np.uint32))
    back = tplan._decode(w, (4, 3), xt.dtype)
    np.testing.assert_array_equal(back.numpy().view(np.uint64), x.view(np.uint64))


def test_plan_coalesces_same_signature_into_one_transfer():
    """Three gathers ride one fused transfer; bytes counted per rank."""
    mesh = Mesh(P_RANKS, "x", device="cpu")
    a = torch.arange(P_RANKS, dtype=torch.int32)
    b = torch.arange(P_RANKS * 5, dtype=torch.int64).reshape(P_RANKS, 5)
    c = torch.rand(P_RANKS, 2) > 0.5
    plan = tplan.RmaPlan(mesh)
    ha, hb = plan.all_gather(a, kind="gets"), plan.all_gather(b, kind="accs")
    hc = plan.all_gather(c, kind=None)
    with OpCounter() as cnt:
        stats = plan.flush(aggregate=True)
    assert (stats.raw, stats.coalesced, stats.packed_groups) == (3, 1, 1)
    assert stats.bytes_wire == (1 + 10 + 2) * 4 and stats.bytes_logical == 4 + 40 + 2
    assert (cnt.gets, cnt.accs, cnt.raw_msgs, cnt.coalesced_msgs) == (1, 1, 3, 1)
    for h, x in ((ha, a), (hb, b), (hc, c)):
        assert torch.equal(h.result(), x[None].expand((P_RANKS,) + tuple(x.shape)))


# -------------------------------------------------------- across 4 ranks
def _queue_inputs():
    rng = np.random.default_rng(11)
    return {
        "buf": np.zeros((P_RANKS, CAP, Q_W), np.float32),
        "ctrs": np.full((P_RANKS, tq.N_CTRS), START, np.uint32),
        "msgs": rng.standard_normal((EPOCHS, P_RANKS, Q_K, Q_W)).astype(np.float32),
        # -1 = no message, P_RANKS = out of range (never accepted)
        "dest": rng.integers(-1, P_RANKS + 1, (EPOCHS, P_RANKS, Q_K)).astype(np.int32),
    }


def _queue_child(d: pathlib.Path) -> None:
    inp = np.load(d / "in.npz")
    mesh = jax.make_mesh((P_RANKS,), ("x",))
    desc, _ = jq.queue_allocate(mesh, "x", CAP, (Q_W,), jnp.float32)

    def epoch(buf, ctrs, msgs, dest):
        s = jq.QueueState(buf[0], ctrs[0])
        s, rec, _ = jq.enqueue_epoch(desc, s, msgs[0], dest[0])
        s, items, valid = jq.dequeue(desc, s, Q_DRAIN)
        return (s.buf[None], s.ctrs[None], rec.accepted[None], rec.incoming[None],
                items[None], valid[None])

    f = jax.jit(shard_map(
        epoch, mesh=mesh,
        in_specs=(P("x", None, None), P("x", None), P("x", None, None), P("x", None)),
        out_specs=(P("x", None, None), P("x", None), P("x", None), P("x", None),
                   P("x", None, None), P("x", None)),
        check_vma=False))
    buf, ctrs = jnp.asarray(inp["buf"]), jnp.asarray(inp["ctrs"])
    out = {}
    for e in range(EPOCHS):
        buf, ctrs, acc, inc, items, valid = f(
            buf, ctrs, jnp.asarray(inp["msgs"][e]), jnp.asarray(inp["dest"][e]))
        for k, v in dict(buf=buf, ctrs=ctrs, accepted=acc, incoming=inc,
                         items=items, valid=valid).items():
            out[f"{k}{e}"] = np.asarray(v)
    np.savez(d / "out.npz", **out)


def test_enqueue_dequeue_match_reference_across_wrap(tmp_path):
    inp = _queue_inputs()
    np.savez(tmp_path / "in.npz", **inp)
    ref = _run_jax_child("queue", tmp_path)

    mesh = Mesh(P_RANKS, "x", device="cpu")
    desc, _ = tq.queue_allocate(mesh, CAP, (Q_W,), torch.float32)
    st = tq.QueueState(torch.from_numpy(inp["buf"].copy()),
                       torch.from_numpy(inp["ctrs"].astype(np.int64)))
    wrapped = False
    for e in range(EPOCHS):
        st, rec, _ = tq.enqueue_epoch(desc, st, torch.from_numpy(inp["msgs"][e]),
                                      torch.from_numpy(inp["dest"][e]))
        st, items, valid = tq.dequeue(desc, st, Q_DRAIN)
        np.testing.assert_array_equal(_bits(st.buf.numpy()), _bits(ref[f"buf{e}"]))
        np.testing.assert_array_equal(st.ctrs.numpy(), ref[f"ctrs{e}"].astype(np.int64))
        np.testing.assert_array_equal(rec.accepted.numpy(), ref[f"accepted{e}"])
        np.testing.assert_array_equal(rec.incoming.numpy(), ref[f"incoming{e}"])
        np.testing.assert_array_equal(_bits(items.numpy()), _bits(ref[f"items{e}"]))
        np.testing.assert_array_equal(valid.numpy(), ref[f"valid{e}"])
        wrapped |= bool((st.ctrs[:, tq.TAIL] < START).any())
    assert wrapped, "the tails never wrapped past 2**32"
    assert not ref["accepted3"].all()      # some sends were rejected or invalid


def _flow_lanes(dtype):
    return [("a", (F_WORDS,), dtype), ("b", (F_WORDS,), dtype)]


def _flow_inputs():
    rng = np.random.default_rng(5)
    g = tfl.initial_grants(P_RANKS, 2, CAP, F_PRODUCERS).astype(np.uint64)
    wrap = lambda a: ((a + START) % 2**32).astype(np.uint32)  # noqa: E731
    return {
        "buf": np.zeros((P_RANKS, CAP, tch.HDR + F_WORDS), np.float32),
        "ctrs": np.full((P_RANKS, tq.N_CTRS), START, np.uint32),
        "sent": wrap(np.zeros((P_RANKS, P_RANKS, 2), np.uint64)),
        "limit": wrap(np.broadcast_to(g[:, None, :], (P_RANKS, P_RANKS, 2))),
        "granted": wrap(np.broadcast_to(g[None], (P_RANKS, P_RANKS, 2))),
        "payload": rng.integers(-2**31, 2**31, (EPOCHS, P_RANKS, F_K, F_WORDS),
                                dtype=np.int64).astype(np.int32),
        "tag": rng.integers(0, 1000, (EPOCHS, P_RANKS, F_K)).astype(np.int32),
        "dest": rng.integers(-1, P_RANKS + 1, (EPOCHS, P_RANKS, F_K)).astype(np.int32),
        "lane": rng.integers(-1, 3, (EPOCHS, P_RANKS, F_K)).astype(np.int32),
    }


def _flow_child(d: pathlib.Path) -> None:
    inp = np.load(d / "in.npz")
    mesh = jax.make_mesh((P_RANKS,), ("x",))
    lanes = [jch.Lane(n, s, jnp.int32) for n, s, _ in _flow_lanes(None)]
    ch, _, _ = jfl.flow_allocate(mesh, "x", CAP, lanes, n_producers=F_PRODUCERS)

    def epoch(buf, ctrs, sent, limit, granted, payload, tag, dest, lane):
        q = jq.QueueState(buf[0], ctrs[0])
        f = jfl.FlowState(sent[0], limit[0], granted[0])
        q, f, rec = jfl.send(ch, q, f, "a", payload[0], tag[0], dest[0], lane[0])
        q, f, b = jfl.recv(ch, q, f, F_DRAIN)
        return (q.buf[None], q.ctrs[None], f.sent[None], f.limit[None],
                f.granted[None], rec.accepted[None], rec.deferred[None],
                rec.rejected[None], b.lane_id[None], b.src[None], b.tag[None],
                b.words[None], b.valid[None])

    s3, s2, s1 = P("x", None, None), P("x", None), P("x")
    f = jax.jit(shard_map(
        epoch, mesh=mesh,
        in_specs=(s3, s2, s3, s3, s3, s3, s2, s2, s2),
        out_specs=(s3, s2, s3, s3, s3, s2, s2, s1, s2, s2, s2, s3, s2),
        check_vma=False))
    state = [jnp.asarray(inp[k]) for k in ("buf", "ctrs", "sent", "limit", "granted")]
    names = ("buf", "ctrs", "sent", "limit", "granted", "accepted", "deferred",
             "rejected", "lane_id", "src", "tag", "words", "valid")
    out = {}
    for e in range(EPOCHS):
        res = f(*state, *(jnp.asarray(inp[k][e]) for k in ("payload", "tag", "dest", "lane")))
        state = list(res[:5])
        out.update({f"{n}{e}": np.asarray(v) for n, v in zip(names, res)})
    np.savez(d / "out.npz", **out)


def test_flow_send_recv_match_reference_across_wrap(tmp_path):
    inp = _flow_inputs()
    np.savez(tmp_path / "in.npz", **inp)
    ref = _run_jax_child("flow", tmp_path)

    mesh = Mesh(P_RANKS, "x", device="cpu")
    lanes = [tch.Lane(n, s, torch.int32) for n, s, _ in _flow_lanes(None)]
    ch, _, _ = tfl.flow_allocate(mesh, CAP, lanes, n_producers=F_PRODUCERS)
    t = lambda k: torch.from_numpy(inp[k].astype(np.int64))  # noqa: E731
    qs = tq.QueueState(torch.from_numpy(inp["buf"].copy()), t("ctrs"))
    fs = tfl.FlowState(t("sent"), t("limit"), t("granted"))
    delivered = 0
    for e in range(EPOCHS):
        step_in = {k: torch.from_numpy(inp[k][e]) for k in ("payload", "tag", "dest", "lane")}
        qs, fs, rec = tfl.send(ch, qs, fs, "a", step_in["payload"], step_in["tag"],
                               step_in["dest"], step_in["lane"])
        qs, fs, b = tfl.recv(ch, qs, fs, F_DRAIN)
        got = dict(buf=_bits(qs.buf.numpy()), ctrs=qs.ctrs.numpy(), sent=fs.sent.numpy(),
                   limit=fs.limit.numpy(), granted=fs.granted.numpy(),
                   accepted=rec.accepted.numpy(), deferred=rec.deferred.numpy(),
                   rejected=rec.rejected.numpy(), lane_id=b.lane_id.numpy(),
                   src=b.src.numpy(), tag=b.tag.numpy(), words=_bits(b.words.numpy()),
                   valid=b.valid.numpy())
        for n, v in got.items():
            want = ref[f"{n}{e}"]
            want = _bits(want) if n in ("buf", "words") else want
            np.testing.assert_array_equal(v, want.astype(v.dtype), err_msg=f"{n} epoch {e}")
        delivered += int(rec.accepted.sum())
        assert int(rec.rejected.sum()) == 0
    assert delivered > 0 and bool(ref["deferred1"].any() or ref["deferred2"].any())
    assert bool((fs.granted < START).any() and (fs.limit < START).any()), \
        "the grant and limit counters never wrapped"



# ------------------------------------------- metadata and the typed send
def _one_rank_meshes():
    return jax.make_mesh((1,), ("w",)), Mesh(1, "w", device="cpu")


@pytest.mark.parametrize("cap, item", [(8, (4,)), (512, (256,))])
def test_queue_metadata_nbytes_matches_reference(cap, item):
    """O(1): the queue's metadata is the reference's count, whatever the
    capacity and item size (the ring is window payload, not metadata)."""
    jmesh, tmesh = _one_rank_meshes()
    jdesc, _ = jq.queue_allocate(jmesh, "w", cap, item)
    tdesc, _ = tq.queue_allocate(tmesh, cap, item)
    small, _ = tq.queue_allocate(tmesh, 8, (4,))
    assert tdesc.metadata_nbytes() == jdesc.metadata_nbytes() == small.metadata_nbytes()
    assert tdesc.metadata_nbytes() == 48 + tdesc.window.metadata_nbytes()


@pytest.mark.parametrize("cap", [8, 1024])
def test_channel_metadata_counts_lanes_not_capacity(cap):
    jmesh, tmesh = _one_rank_meshes()
    jch_, _ = jch.channel_allocate(jmesh, "w", cap, [jch.Lane("a", (4,)), jch.Lane("b", (2,))])
    tlanes = [tch.Lane("a", (4,)), tch.Lane("b", (2,))]
    tch_, _ = tch.channel_allocate(tmesh, cap, tlanes)
    small, _ = tch.channel_allocate(tmesh, 8, tlanes)
    assert tch_.metadata_nbytes() == jch_.metadata_nbytes() == small.metadata_nbytes()
    assert tch_.metadata_nbytes() == 2 * 32 + tch_.desc.metadata_nbytes()


SEND_CAP, SEND_K, SEND_DRAIN = 4, 3, 4


def _send_inputs():
    """Two epochs on one rank: lane "a" (f32 [4]), then lane "b" (int32
    [2]); the second overfills the 4-slot ring, and one message skips."""
    rng = np.random.default_rng(7)
    return [
        ("a", rng.standard_normal((SEND_K, 4)).astype(np.float32),
         np.array([5, 6, 7], np.int32), np.array([0, -1, 0], np.int32)),
        ("b", rng.integers(-2**31, 2**31, (SEND_K, 2), dtype=np.int64).astype(np.int32),
         np.array([8, 9, 10], np.int32), np.array([0, 0, 0], np.int32)),
    ]


def test_channel_send_recv_payload_match_reference():
    """`Channel.send` + `recv` + `payload` against the reference's on a
    one-device mesh, with a full ring: receipts, ring, decoded lanes."""
    jmesh, tmesh = _one_rank_meshes()
    jlanes = [jch.Lane("a", (4,), jnp.float32), jch.Lane("b", (2,), jnp.int32)]
    tlanes = [tch.Lane("a", (4,), torch.float32), tch.Lane("b", (2,), torch.int32)]
    jc, jst = jch.channel_allocate(jmesh, "w", SEND_CAP, jlanes)
    tc, tst = tch.channel_allocate(tmesh, SEND_CAP, tlanes)
    specs = jq.state_specs("w")
    s1, s2, s3 = P("w"), P("w", None), P("w", None, None)
    rejected = 0
    for name, payload, tag, dest in _send_inputs():
        def body(st, pl, tg, ds, name=name):
            st, r = jc.send(jq.to_local(st), name, pl[0], tg[0], ds[0])
            return (jq.to_global(st), r.accepted[None], r.n_sent[None],
                    r.n_dropped[None], r.incoming[None], r.notifications[None])

        f = jax.jit(shard_map(body, mesh=jmesh, in_specs=(specs, s3, s2, s2),
                              out_specs=(specs, s2, s1, s1, s2, s1), check_vma=False))
        jst, *jrec = f(jst, payload[None], tag[None], dest[None])
        tst, trec = tc.send(tst, name, torch.from_numpy(payload)[None],
                            torch.from_numpy(tag)[None], torch.from_numpy(dest)[None])
        for got, want in zip(trec, jrec):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
        np.testing.assert_array_equal(_bits(tst.buf.numpy()), _bits(jst.buf))
        np.testing.assert_array_equal(tst.ctrs.numpy(), np.asarray(jst.ctrs).astype(np.int64))
        rejected += int(trec.n_dropped.sum())
    assert rejected > 0, "the ring never ran full"

    def rbody(st):
        st, b = jc.recv(jq.to_local(st), SEND_DRAIN)
        pa, ma = jc.payload(b, "a")
        pb, mb = jc.payload(b, "b")
        return (jq.to_global(st), b.lane_id[None], b.src[None], b.tag[None],
                pa[None], ma[None], pb[None], mb[None])

    f = jax.jit(shard_map(rbody, mesh=jmesh, in_specs=(specs,),
                          out_specs=(specs, s2, s2, s2, s3, s2, s3, s2), check_vma=False))
    jst, *jout = f(jst)
    tst, batch = tc.recv(tst, SEND_DRAIN)
    pa, ma = tc.payload(batch, "a")
    pb, mb = tc.payload(batch, "b")
    assert pa.dtype == torch.float32 and pb.dtype == torch.int32
    for got, want in zip((batch.lane_id, batch.src, batch.tag, pa, ma, pb, mb), jout):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(tst.ctrs.numpy(), np.asarray(jst.ctrs).astype(np.int64))
    assert bool(ma.any()) and bool(mb.any()) and not bool((ma & mb).any())


def test_channel_send_is_enqueue_of_packed_across_ranks():
    """At p = 4, `Channel.send` is `enqueue` of `packed`, bit for bit: the
    source stamped, -1 skipped, a full ring rejecting."""
    mesh = Mesh(P_RANKS, "x", device="cpu")
    lanes = [tch.Lane("a", (3,), torch.int32), tch.Lane("b", (2,), torch.float32)]
    ch, st = tch.channel_allocate(mesh, CAP, lanes)
    ch2, st2 = tch.channel_allocate(mesh, CAP, lanes)
    rng = np.random.default_rng(3)
    dropped = 0
    for e in range(EPOCHS):
        payload = torch.from_numpy(rng.integers(-2**31, 2**31, (P_RANKS, 5, 3),
                                                dtype=np.int64).astype(np.int32))
        tag = torch.from_numpy(rng.integers(0, 100, (P_RANKS, 5)).astype(np.int32))
        dest = torch.from_numpy(rng.integers(-1, P_RANKS, (P_RANKS, 5)).astype(np.int32))
        st, rec = ch.send(st, "a", payload, tag, dest)
        st2, rec2 = tq.enqueue(ch2.desc, st2, ch2.packed("a", payload, tag), dest)
        for got, want in zip(rec, rec2):
            assert torch.equal(got, want)
        assert torch.equal(st.buf.view(torch.int32), st2.buf.view(torch.int32))
        assert torch.equal(st.ctrs, st2.ctrs)
        dropped += int(rec.n_dropped.sum())
        st, b = ch.recv(st, 1)
        st2, _ = ch2.recv(st2, 1)
    assert dropped > 0
    srcs = b.src[b.valid]
    assert bool((srcs >= 0).all() and (srcs < P_RANKS).all())

if __name__ == "__main__":
    {"queue": _queue_child, "flow": _flow_child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
