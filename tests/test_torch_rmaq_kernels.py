"""The rmaq kernel trio's plain path in the PyTorch port (what a CPU tensor
takes in `repro_torch.kernels.rmaq.ops`) against the JAX reference's Pallas
kernels in interpret mode, bit for bit, at p = 4:

  * `notified_put` and `notify_accumulate` at shifts 1, -1 and 0;
  * `queue_push` into an empty ring, then a second round that backpressures
    (3 slots free), and a round whose slots wrap past the ring's end, at
    shifts 1, -1 and 0;
  * shift p + 1 and counters past 2**31 against the reference's `ref.py`
    oracles only: the Pallas kernels index with a signed `rem`, which goes
    negative there.

Also `queue_push` against the port's own `queue.enqueue_shift` on the same
state.  The reference needs a 4-device mesh, which the main test process
must not have, so this file's own ``__main__`` branch runs the JAX side in
a child process with forced host devices.
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
from repro_torch.core.plan import u32_to_wire  # noqa: E402
from repro_torch.kernels.rmaq import ops as tops  # noqa: E402
from repro_torch.kernels.rmaq import ref as tref  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmaq import queue as tq  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NK = 4
ROWS, W = 8, 128                 # notified_put payload: a rank's block
CAP, QW, QK = 8, 4, 5            # queue_push ring, row words, messages a rank
SHIFTS = (1, -1, 0)
BIG = NK + 1                     # a shift past p: oracle only
# queue_push rounds: (name, shift, start counters (head, tail) of every rank
# or "chain" = the end state of the empty round at the same shift)
ROUNDS = [(f"{kind}{s:+d}", s) for kind in ("empty", "backpressure", "wrap") for s in SHIFTS]


def _inputs() -> dict:
    rng = np.random.default_rng(41)
    return {
        "x": rng.standard_normal((NK, ROWS, W)).astype(np.float32),
        "cnt": np.arange(1, NK + 1, dtype=np.int32),
        "local": np.array([2**31 - 2, -5, 0, 17], np.int32),   # wraps at rank 0
        "buf": np.zeros((NK, CAP, QW), np.float32),
        "wbuf": rng.standard_normal((NK, CAP, QW)).astype(np.float32),
        "ctr0": np.zeros((NK, 2), np.int32),
        "ctr_wrap": np.full((NK, 2), 6, np.int32),            # slots 6, 7, 0, 1, 2
        "ctr_high": np.full((NK, 2), -3, np.int32),           # uint32 2**32 - 3
        "msgs": rng.standard_normal((NK, QK, QW)).astype(np.float32),
    }


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    from repro.kernels.rmaq import ops as kops
    from repro.kernels.rmaq import ref as kref

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NK,), ("x",))
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    x = j["x"].reshape(NK * ROWS, W)
    out = {}
    for s in SHIFTS:
        y, c = kops.notified_put(x, j["cnt"], s, mesh, "x", interpret=True)
        out[f"notified_put{s}"], out[f"notified_put_cnt{s}"] = y, c
        out[f"notify_accumulate{s}"] = kops.notify_accumulate(
            j["cnt"], j["local"], s, mesh, "x", interpret=True)
        first = kops.queue_push(j["buf"], j["ctr0"], j["msgs"], s, mesh, "x", interpret=True)
        second = kops.queue_push(first[0], first[1], j["msgs"], s, mesh, "x", interpret=True)
        wrap = kops.queue_push(j["wbuf"], j["ctr_wrap"], j["msgs"], s, mesh, "x",
                               interpret=True)
        for name, res in ((f"empty{s:+d}", first), (f"backpressure{s:+d}", second),
                          (f"wrap{s:+d}", wrap)):
            for i, r in enumerate(res):
                out[f"{name}/{i}"] = r

    # the oracles (ref.py) under shard_map, where the Pallas kernels cannot go
    def sm(fn, ins, outs):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=ins, out_specs=outs,
                                 check_vma=False))

    s1, s2, s3 = P("x"), P("x", None), P("x", None, None)
    y, c = sm(lambda a, b: kref.notified_put_ref(a, b, BIG, "x"), (s2, s1), (s2, s1))(x, j["cnt"])
    out["oracle_notified_put"], out["oracle_notified_put_cnt"] = y, c
    out["oracle_notify_accumulate"] = sm(
        lambda a, b: kref.notify_accumulate_ref(a, b, BIG, "x"), (s1, s1), s1)(j["cnt"], j["local"])

    def push(shift):
        def body(b, c, m):
            ob, oc, sent, notif = kref.queue_push_ref(b[0], c[0], m[0], shift, "x", CAP)
            return ob[None], oc[None], sent, notif
        return sm(body, (s3, s2, s3), (s3, s2, s1, s1))

    for name, (ctr, shift) in {"oracle_push_big": ("ctr0", BIG),
                               "oracle_push_high": ("ctr_high", 1)}.items():
        for i, r in enumerate(push(shift)(j["wbuf"], j[ctr], j["msgs"])):
            out[f"{name}/{i}"] = r
    np.savez(d / "out.npz", **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("rmaq_kernels")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NK}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


# ================================================================ helpers
def _t(inputs: dict, name: str) -> torch.Tensor:
    return torch.from_numpy(inputs[name].copy())


def _eq(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    g = got.numpy()
    want = want.reshape(g.shape)
    if g.dtype.kind == "f":
        g, want = g.view(np.uint32), want.astype(np.float32).view(np.uint32)
    np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=what)


def _push(inputs: dict, buf: str, ctr: str, shift: int):
    m = Mesh(NK, "x", device="cpu")
    return tops.queue_push(_t(inputs, buf), _t(inputs, ctr), _t(inputs, "msgs"), shift, m)


# ================================================================ tests
@pytest.mark.parametrize("shift", SHIFTS)
def test_notify_kernels_plain_path_matches_pallas(shift, inputs, jax_ref):
    m = Mesh(NK, "x", device="cpu")
    before = dict(tops.launches)
    y, c = tops.notified_put(_t(inputs, "x"), _t(inputs, "cnt"), shift, m)
    acc = tops.notify_accumulate(_t(inputs, "cnt"), _t(inputs, "local"), shift, m)
    assert tops.launches == before            # CPU tensors never launch
    _eq(y, jax_ref[f"notified_put{shift}"], "payload")
    _eq(c, jax_ref[f"notified_put_cnt{shift}"], "counts")
    _eq(acc, jax_ref[f"notify_accumulate{shift}"], "accumulate")
    assert c.tolist() == np.roll(inputs["cnt"], shift).tolist()


@pytest.mark.parametrize("name,shift", ROUNDS)
def test_queue_push_plain_path_matches_pallas(name, shift, inputs, jax_ref):
    if name.startswith("wrap"):
        got = _push(inputs, "wbuf", "ctr_wrap", shift)
    else:
        got = _push(inputs, "buf", "ctr0", shift)
        if name.startswith("backpressure"):
            m = Mesh(NK, "x", device="cpu")
            got = tops.queue_push(got[0], got[1], _t(inputs, "msgs"), shift, m)
    for i, g in enumerate(got):
        _eq(g, jax_ref[f"{name}/{i}"], f"{name} output {i}")
    sent = got[2].tolist()
    want = {"empty": QK, "backpressure": CAP - QK, "wrap": QK}[name.rstrip("+-01")]
    assert sent == [want] * NK


def test_oracle_only_cases_shift_past_p_and_high_counters(inputs, jax_ref):
    m = Mesh(NK, "x", device="cpu")
    y, c = tref.notified_put_ref(_t(inputs, "x"), _t(inputs, "cnt"), BIG, m)
    _eq(y, jax_ref["oracle_notified_put"], "payload")
    _eq(c, jax_ref["oracle_notified_put_cnt"], "counts")
    _eq(tref.notify_accumulate_ref(_t(inputs, "cnt"), _t(inputs, "local"), BIG, m),
        jax_ref["oracle_notify_accumulate"], "accumulate")
    for name, ctr, shift in (("oracle_push_big", "ctr0", BIG),
                             ("oracle_push_high", "ctr_high", 1)):
        got = tops.queue_push(_t(inputs, "wbuf"), _t(inputs, ctr), _t(inputs, "msgs"), shift, m)
        for i, g in enumerate(got):
            _eq(g, jax_ref[f"{name}/{i}"], f"{name} output {i}")
    # tail 2**32 - 3 + 5 wraps the counter to 2
    assert got[1][:, 1].tolist() == [2] * NK


@pytest.mark.parametrize("shift", [1, -1, 0, BIG])
def test_queue_push_equals_enqueue_shift_on_the_same_state(shift):
    """The kernel's contract is the queue's ring protocol restricted to a
    uniform shift: same slots, same tail, n_sent = the receipt's n_sent and
    n_notif = the NOTIF counter's increment — including backpressure and
    counters that wrap past 2**32."""
    rng = np.random.default_rng(shift + 10)
    m = Mesh(NK, "x", device="cpu")
    desc, _ = tq.queue_allocate(m, CAP, (QW,), torch.float32)
    ring = torch.from_numpy(rng.standard_normal((NK, CAP, QW)).astype(np.float32))
    used = torch.tensor([0, 3, CAP - 2, CAP])              # 5, 5, 2 and 0 admitted
    tail = torch.tensor([2**32 - 2, 5, 2**32 - 1, 9], dtype=torch.int64)
    ctrs = torch.zeros(NK, tq.N_CTRS, dtype=torch.int64)
    ctrs[:, tq.TAIL] = tail
    ctrs[:, tq.HEAD] = (tail - used) & 0xFFFFFFFF
    ctrs[:, tq.NOTIF] = 2**32 - 1
    msgs = torch.from_numpy(rng.standard_normal((NK, QK, QW)).astype(np.float32))

    state = tq.QueueState(ring.clone(), ctrs.clone())
    state, receipt = tq.enqueue_shift(desc, state, msgs, shift)
    ctr = u32_to_wire(ctrs[:, [tq.HEAD, tq.TAIL]]).contiguous()
    buf, ctr, n_sent, n_notif = tops.queue_push(ring.clone(), ctr, msgs, shift, m)

    assert torch.equal(buf, state.buf)
    assert torch.equal(ctr[:, 1], u32_to_wire(state.ctrs[:, tq.TAIL]))
    assert torch.equal(n_sent.long(), receipt.n_sent)
    assert torch.equal(n_notif.long(), (state.ctrs[:, tq.NOTIF] - ctrs[:, tq.NOTIF]) & 0xFFFFFFFF)
    assert sorted(n_notif.tolist()) == [0, 2, 5, 5]


def test_wrappers_check_their_arguments():
    m = Mesh(NK, "x", device="cpu")
    with pytest.raises(ValueError):
        tops.notified_put(torch.ones(NK, 3), torch.ones(NK + 1, dtype=torch.int32), 1, m)
    with pytest.raises(ValueError):
        tops.notify_accumulate(torch.ones(NK, 2, dtype=torch.int32),
                               torch.ones(NK, dtype=torch.int32), 1, m)
    buf, ctr = torch.zeros(NK, 6, 2), torch.zeros(NK, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        tops.queue_push(buf, ctr, torch.zeros(NK, 1, 2), 1, m)
    with pytest.raises(TypeError):
        tops.queue_push(torch.zeros(NK, 8, 2), ctr.long(), torch.zeros(NK, 1, 2), 1, m)
    with pytest.raises(ValueError, match="do not fit"):
        tops.queue_push(torch.zeros(NK, 8, 2), ctr, torch.zeros(NK, 1, 3), 1, m)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
