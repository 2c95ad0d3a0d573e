"""DSDE, the MoE dispatch, the hashtable and the 3-D FFT with one rank a
process (`procmesh.ProcMesh`), against the stacked `Mesh(4)` run and the
JAX reference.

Four CPU processes are spawned once for the whole file (`procmesh.run`:
gloo over a `FileStore`, windows as shared files); every rank runs, on its
row of the same seeded numpy inputs:

  * the four `core.dsde` protocols on a uniform draw and on a skewed one
    that overflows a pair's slots and the queue's ring;
  * `moe_dispatch` / `moe_combine` at qwen3-moe-30b-a3b's SMOKE widths
    (d 64, 8 experts, top-2, bf16), a per-expert scale as the experts;
  * two `hashtable.insert_epoch`s and a `lookup_epoch` of present and
    absent keys;
  * `apps.fft.fft3d` / `fft3d_slabs` at 16³ and 32³;
  * one all-to-all of each payload dtype through a plan forced onto the
    put kernel's route ("cuda": on CPU tensors its plain stores) and onto
    the mesh's ("torch").

Each rank's outputs and `OpCounter` ledgers (by kind, raw and wire, and
the plans) must equal its row of the stacked run in the test process, bit
for bit; the FFT is held to `numpy.fft.fftn` within 1e-5 of its max abs.
One JAX child on 4 forced host devices (this file's ``__main__`` branch)
runs the reference's `exchange_accumulate` on the uniform draw (no drops:
the reference overwrites slot 0 when one occurs) and its hashtable epochs
under `shard_map`, and every rank is held to it too.  The routing rule
that sends an all-to-all group to the kernel is tested on its own with
`FakeTensorMode`'s CUDA tensors.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import procmesh  # noqa: E402
from repro_torch.apps import fft as tfft  # noqa: E402
from repro_torch.core import dsde as tdsde  # noqa: E402
from repro_torch.core import hashtable as tht  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import rma as trma  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.kernels.rma import ops as rma_ops  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, AXIS = 4, "x"
TIMEOUT = 240.0         # s: the ranks' join; a hung rank is killed and fails the test
K, D = 6, 2                     # DSDE items a rank, words an item
CAP_PAIR, CAP_SKEW = 8, 2       # slots a pair: roomy, and overflowing
SKEW = np.array([[1, 1, 1, 2, 3, 3], [2, 2, 2, 2, 3, 1],
                 [0, 0, 1, 3, 3, 2], [3, 3, 3, 3, 3, 3]], np.int32)
PROTOCOLS = ("exchange_accumulate", "exchange_alltoall_baseline",
             "exchange_reduce_scatter_baseline", "exchange_queue")
DSDE_NAMES = [f"{p}/{t}" for p in PROTOCOLS for t in ("tg", "skew")]
# qwen3-moe-30b-a3b SMOKE: d_model 64, 8 experts, top-2 (2 experts a rank)
MOE_TOK, MOE_D, MOE_E, MOE_K, MOE_CF = 16, 64, 8, 2, 1.25
TABLE, HEAP, HT_CAP, HT_N, HT_Q = 64, 64, 32, 24, 48
FFT_NS = (16, 32)
FFT_TOL = 1e-5
# one all-to-all of each payload dtype: [p, block] a rank; uint8 [3] is a
# 3-byte block, which the kernel cannot carry as words
A2A = {"float32": (torch.float32, (3,)), "int32": (torch.int32, (5,)),
       "int32x1": (torch.int32, ()),
       "bool": (torch.bool, (4,)), "bfloat16": (torch.bfloat16, (6,)),
       "int64": (torch.int64, (3,)), "complex64": (torch.complex64, (2,)),
       "uint8x3": (torch.uint8, (3,))}


def _inputs() -> dict:
    rng = np.random.default_rng(31)
    k1 = rng.choice(10_000, NP * HT_N, replace=False)
    fresh = rng.choice(np.arange(10_000, 20_000), NP * HT_N // 2, replace=False)
    first = np.concatenate([rng.choice(k1, NP * HT_N // 4, replace=False), fresh])
    k2 = rng.permutation(np.concatenate(
        [first, rng.choice(first, NP * HT_N - first.size, replace=False)]))
    absent = np.arange(500_000, 500_000 + NP * HT_Q)
    q = rng.permutation(np.concatenate([rng.choice(np.union1d(k1, k2), NP * HT_Q // 2,
                                                   replace=False),
                                        rng.choice(absent, NP * HT_Q // 2, replace=False)]))
    out = {
        "data": rng.standard_normal((NP, K, D)).astype(np.float32),
        "tg": rng.integers(0, NP, (NP, K)).astype(np.int32),
        "skew": SKEW,
        "moe_tok": rng.standard_normal((NP, MOE_TOK, MOE_D)).astype(np.float32),
        "moe_logits": rng.standard_normal((NP, MOE_TOK, MOE_E)).astype(np.float32),
        "moe_scale": rng.uniform(0.5, 2.0, MOE_E).astype(np.float32),
        "k1": k1.reshape(NP, HT_N), "v1": rng.integers(0, 1_000_000, (NP, HT_N)),
        "k2": k2.reshape(NP, HT_N), "v2": rng.integers(0, 1_000_000, (NP, HT_N)),
        "q": q.reshape(NP, HT_Q),
    }
    for n in FFT_NS:
        g = rng.standard_normal((2, n, n, n)).astype(np.float32)
        out[f"grid{n}"] = (g[0] + 1j * g[1]).astype(np.complex64)
    for name, (dtype, shape) in A2A.items():
        raw = rng.integers(0, 256, (NP, NP) + shape + (8,), dtype=np.uint8)
        out[f"a2a/{name}"] = raw     # viewed as `dtype` on the torch side
    return out


def _a2a_payload(raw: np.ndarray, dtype) -> torch.Tensor:
    """A raw byte draw as `dtype` (bool from the low bit, every other dtype
    from the bytes of each element)."""
    t = torch.from_numpy(raw.copy())
    if dtype == torch.bool:
        return (t[..., 0] & 1).bool()
    return t[..., :dtype.itemsize].contiguous().view(dtype)[..., 0]


# ================================================================ the cases
def _mine(a, mesh) -> torch.Tensor:
    """The rows this process holds of a stacked [p, ...] array or tensor."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a).copy())
    if isinstance(mesh, procmesh.ProcMesh):
        return t[mesh.rank:mesh.rank + 1]
    return t


def _ledger(c: OpCounter) -> dict:
    return {"ops": c.snapshot(), "plans": c.plans}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A result on the host, bf16 as its raw 16 bits."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _dsde(mesh, inp: dict) -> dict:
    out = {}
    for name in DSDE_NAMES:
        proto, tgt = name.split("/")
        cap = CAP_PAIR if tgt == "tg" else CAP_SKEW
        with OpCounter() as c:
            res = getattr(tdsde, proto)(_mine(inp["data"], mesh), _mine(inp[tgt], mesh),
                                        mesh, cap)
        out[name] = ([_numpy(x) for x in res], _ledger(c))
    return out


def _moe(mesh, inp: dict) -> dict:
    tokens = _mine(inp["moe_tok"], mesh).to(torch.bfloat16)
    logits = _mine(inp["moe_logits"], mesh)
    gate, idx = torch.topk(torch.softmax(logits, dim=-1), MOE_K)
    gate = (gate / gate.sum(-1, keepdim=True)).to(torch.bfloat16)
    with OpCounter() as c:
        disp = tdsde.moe_dispatch(tokens, idx, gate, MOE_E, mesh, capacity_factor=MOE_CF)
    led_d = _ledger(c)
    local_e = MOE_E // mesh.p
    ids = mesh.axis_index()[:, None] * local_e + torch.arange(local_e)     # my experts
    scale = torch.from_numpy(inp["moe_scale"]).to(torch.bfloat16)[ids]
    with OpCounter() as c:
        comb = tdsde.moe_combine(disp.expert_inputs * scale[..., None, None], disp,
                                 MOE_TOK, mesh)
    return {"dispatch": ([_numpy(x) for x in disp], led_d),
            "combine": ([_numpy(comb)], _ledger(c))}


def _hashtable(mesh, inp: dict) -> dict:
    out = {}
    vol = tht.make_volume(TABLE, HEAP, mesh.local_ranks, device="cpu")
    for e in (1, 2):
        with OpCounter() as c:
            vol, dropped = tht.insert_epoch(vol, _mine(inp[f"k{e}"], mesh),
                                            _mine(inp[f"v{e}"], mesh), mesh, HT_CAP)
        out[f"e{e}"] = ([_numpy(x) for x in vol] + [_numpy(dropped)], _ledger(c))
    with OpCounter() as c:
        vals, found = tht.lookup_epoch(vol, _mine(inp["q"], mesh), mesh, HT_CAP)
    out["lookup"] = ([_numpy(vals), _numpy(found)], _ledger(c))
    return out


def _fft(mesh, inp: dict) -> dict:
    out = {}
    for n in FFT_NS:
        slabs = inp[f"grid{n}"].reshape(NP, n // NP, n, n)
        for fn in ("fft3d", "fft3d_slabs"):
            with OpCounter() as c:
                got = getattr(tfft, fn)(_mine(slabs, mesh), mesh)
            out[f"{fn}/{n}"] = ([_numpy(got)], _ledger(c))
    return out


def _routes(mesh, inp: dict) -> dict:
    """Each dtype's all-to-all through a one-op plan forced onto each
    backend, and a packed pair with a 3-byte block under "cuda": results,
    `PlanStats.backends`, and the host barriers each group took."""
    out = {}
    for name, (dtype, _) in A2A.items():
        x = _mine(_a2a_payload(inp[f"a2a/{name}"], dtype), mesh)
        row = {"want": _numpy(mesh.all_to_all(x))}
        for backend in ("cuda", "torch"):
            pl = tplan.RmaPlan(mesh)
            h = pl.put_all_to_all(x)
            held = getattr(mesh, "barriers", 0)
            stats = pl.flush(aggregate=False, backend=backend)
            row[backend] = (_numpy(h.result()), stats.backends,
                            getattr(mesh, "barriers", 0) - held)
        out[name] = row
    pl = tplan.RmaPlan(mesh)
    a = _mine(_a2a_payload(inp["a2a/uint8x3"], torch.uint8), mesh)
    b = _mine(_a2a_payload(inp["a2a/float32"], torch.float32), mesh)
    ha, hb = pl.put_all_to_all(a), pl.put_all_to_all(b)
    stats = pl.flush(aggregate=True, backend="cuda")
    out["packed"] = (_numpy(ha.result()), _numpy(hb.result()), stats.backends)
    tiled = _mine(_a2a_payload(inp["a2a/int32"], torch.int32), mesh)
    out["tiled"] = _numpy(trma.put_all_to_all(tiled.reshape(tiled.shape[0], -1), mesh,
                                              tiled=True))
    return out


def _all_cases(mesh, inp: dict) -> dict:
    return {"dsde": _dsde(mesh, inp), "moe": _moe(mesh, inp), "ht": _hashtable(mesh, inp),
            "fft": _fft(mesh, inp), "routes": _routes(mesh, inp)}


def _rank_main(mesh, d: str) -> dict:
    inp = dict(np.load(pathlib.Path(d) / "in.npz"))
    return _all_cases(mesh, inp)


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import dsde as jdsde
    from repro.core import hashtable as jht
    from repro.core.rma import OpCounter as JOpCounter

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NP,), (AXIS,))
    sm = lambda f, n_in, n_out: jax.jit(shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=(P(AXIS),) * n_in, out_specs=(P(AXIS),) * n_out,
        check_vma=False))
    out, snaps = {}, {}

    def accumulate(x, t):
        r = jdsde.exchange_accumulate(x[0], t[0], AXIS, CAP_PAIR)
        return tuple(jnp.asarray(a)[None] for a in r)

    with JOpCounter() as c:
        res = sm(accumulate, 2, 4)(inp["data"], inp["tg"])
    for i, a in enumerate(res):
        out[f"acc/{i}"] = np.asarray(a)
    snaps["acc"] = c.snapshot()

    def insert(vols, k, v):
        vol, dropped = jht.insert_epoch(jax.tree.map(lambda a: a[0], vols), k[0], v[0],
                                        AXIS, HT_CAP)
        return jax.tree.map(lambda a: a[None], vol), dropped[None]

    def lookup(vols, k):
        v, f = jht.lookup_epoch(jax.tree.map(lambda a: a[0], vols), k[0], AXIS, HT_CAP)
        return v[None], f[None]

    vols = jax.vmap(lambda _: jht.make_volume(TABLE, HEAP))(jnp.arange(NP))
    for e in (1, 2):
        with JOpCounter() as c:     # each call its own jit: ops are counted while tracing
            vols, dropped = sm(insert, 3, 2)(vols, inp[f"k{e}"].astype(np.int32),
                                             inp[f"v{e}"].astype(np.int32))
        for i, a in enumerate(vols):
            out[f"e{e}/{i}"] = np.asarray(a)
        out[f"e{e}/dropped"] = np.asarray(dropped)
        snaps[f"e{e}"] = c.snapshot()
    with JOpCounter() as c:
        v, f = sm(lookup, 2, 2)(vols, inp["q"].astype(np.int32))
    out["lookup/0"], out["lookup/1"] = np.asarray(v), np.asarray(f)
    snaps["lookup"] = c.snapshot()
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


# ================================================================ fixtures
@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """(the JAX child's outputs and ledgers, every rank's results): the rank
    pool runs while the child does."""
    d = tmp_path_factory.mktemp("procmesh_apps")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, __file__, "child", str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = procmesh.run(_rank_main, NP, device="cpu", args=(str(d),), axis=AXIS,
                             timeout=TIMEOUT)
        stdout, stderr = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, stdout[-2000:] + stderr[-4000:]
    ref = dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())
    return ref, ranks


@pytest.fixture(scope="module")
def stacked(inputs):
    """Every case on the stacked Mesh(4), in this process."""
    return _all_cases(Mesh(NP, AXIS, device="cpu"), inputs)


def _same_rows(got: tuple, want: tuple, r: int, what: str) -> None:
    """Rank r's outputs bit-equal to row r of the stacked outputs, and the
    ledgers equal."""
    g_out, g_led = got
    w_out, w_led = want
    assert len(g_out) == len(w_out), what
    for i, (g, w) in enumerate(zip(g_out, w_out)):
        assert g.shape == (1,) + w.shape[1:], (what, i, g.shape, w.shape)
        np.testing.assert_array_equal(g[0], w[r], err_msg=f"{what} output {i} rank {r}")
    assert g_led == w_led, what


# ================================================================ tests
@pytest.mark.parametrize("name", DSDE_NAMES)
def test_each_rank_exchanges_as_the_stacked_run(name, runs, stacked):
    """Payloads, validity, counts and drops, and the ledgers by kind, raw,
    wire and plans: every rank's equal its row of the stacked run."""
    _, ranks = runs
    want = stacked["dsde"][name]
    for r, res in enumerate(ranks):
        _same_rows(res["dsde"][name], want, r, name)
    recv_valid, dropped = want[0][1], want[0][3]
    assert recv_valid.sum() + dropped.sum() == NP * K               # conserved
    assert (dropped.sum() > 0) == name.endswith("/skew")


@pytest.mark.parametrize("step", ("dispatch", "combine"))
def test_each_rank_dispatches_and_combines_as_the_stacked_run(step, runs, stacked):
    _, ranks = runs
    want = stacked["moe"][step]
    for r, res in enumerate(ranks):
        _same_rows(res["moe"][step], want, r, step)
    if step == "dispatch":
        routed = int(want[0][2].sum())
        assert 0 < routed <= NP * MOE_TOK * MOE_K


@pytest.mark.parametrize("epoch", ("e1", "e2", "lookup"))
def test_each_rank_holds_the_stacked_runs_volume_and_answers(epoch, runs, stacked):
    _, ranks = runs
    want = stacked["ht"][epoch]
    for r, res in enumerate(ranks):
        _same_rows(res["ht"][epoch], want, r, epoch)
    if epoch == "lookup":
        found = want[0][1]
        assert 0 < found.sum() < found.size          # present and absent keys


@pytest.mark.parametrize("n", FFT_NS)
@pytest.mark.parametrize("fn", ("fft3d", "fft3d_slabs"))
def test_each_ranks_slab_is_the_spectrum(fn, n, inputs, runs, stacked):
    """Each rank's slab within 1e-5 of numpy's fftn (of its max abs), and
    the ledgers the stacked run's."""
    _, ranks = runs
    spec = np.fft.fftn(inputs[f"grid{n}"].astype(np.complex128))
    want = spec.reshape(NP, n // NP, n, n)
    scale = np.abs(spec).max()
    for r, res in enumerate(ranks):
        (got,), led = res["fft"][f"{fn}/{n}"]
        assert got.shape == (1, n // NP, n, n) and got.dtype == np.complex64
        assert np.abs(got[0] - want[r]).max() <= FFT_TOL * scale, (fn, n, r)
        assert led == stacked["fft"][f"{fn}/{n}"][1]


def test_exchange_accumulate_equals_the_reference(runs):
    (ref, snaps), ranks = runs
    for r, res in enumerate(ranks):
        got, led = res["dsde"]["exchange_accumulate/tg"]
        for i, g in enumerate(got):
            w = ref[f"acc/{i}"][r:r + 1]
            if g.dtype.kind == "f":
                np.testing.assert_array_equal(g.view(np.uint32), w.astype(g.dtype).view(np.uint32))
            else:
                np.testing.assert_array_equal(g, w.reshape(g.shape).astype(g.dtype))
        assert got[3].sum() == 0                     # no drops: the reference's slot 0 holds
        for k in ("puts", "gets", "accs", "colls", "raw_msgs", "by_axis"):
            assert led["ops"][k] == snaps["acc"][k], k


@pytest.mark.parametrize("epoch", ("e1", "e2", "lookup"))
def test_hashtable_equals_the_reference(epoch, runs):
    """Volumes (the reference's are int32 without x64), drops and answers
    bit-equal, the ledgers by kind."""
    (ref, snaps), ranks = runs
    n_out = 2 if epoch == "lookup" else len(tht.LocalVolume._fields)
    for r, res in enumerate(ranks):
        got, led = res["ht"][epoch]
        for i in range(n_out):
            np.testing.assert_array_equal(got[i], ref[f"{epoch}/{i}"][r:r + 1].astype(got[i].dtype),
                                          err_msg=f"{epoch} output {i} rank {r}")
        if epoch != "lookup":
            np.testing.assert_array_equal(got[-1], ref[f"{epoch}/dropped"][r:r + 1])
            assert got[-1].sum() == 0
        for k in ("puts", "gets", "accs", "colls", "raw_msgs", "by_axis"):
            assert led["ops"][k] == snaps[epoch][k], (epoch, k)


@pytest.mark.parametrize("name", sorted(A2A))
def test_the_kernel_route_moves_what_the_mesh_moves(name, runs):
    """A one-op all-to-all forced onto "cuda" (the put kernel's stores; on
    CPU tensors its plain version) and onto "torch": both equal
    `ProcMesh.all_to_all`, each one fence, and `PlanStats.backends` names
    the route taken; a 3-byte block goes to "torch" by the rule."""
    _, ranks = runs
    words = name != "uint8x3"
    for res in ranks:
        row = res["routes"][name]
        for backend in ("cuda", "torch"):
            got, backends, fences = row[backend]
            np.testing.assert_array_equal(got, row["want"])
            assert backends == {("cuda" if backend == "cuda" and words else "torch"): 1}
            assert fences == 1


def test_a_packed_group_is_words_and_takes_the_kernel(runs):
    _, ranks = runs
    for res in ranks:
        a, b, backends = res["routes"]["packed"]
        assert backends == {"cuda": 1}
        np.testing.assert_array_equal(a, res["routes"]["uint8x3"]["want"])
        np.testing.assert_array_equal(b, res["routes"]["float32"]["want"])


def test_the_tiled_all_to_all_takes_the_same_route(runs, stacked):
    _, ranks = runs
    want = stacked["routes"]["tiled"]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["routes"]["tiled"][0], want[r])


def test_a_slab_of_another_shape_is_refused():
    mesh = procmesh.ProcMesh(1, 0, device="cpu")
    try:
        with pytest.raises(MeshError, match=r"grid must be \[1, N/1, N, N\]"):
            tfft.fft3d(torch.zeros(2, 4, 4, 4, dtype=torch.complex64), mesh)
        got = tfft.fft3d(torch.ones(1, 4, 4, 4, dtype=torch.complex64), mesh)
        assert torch.equal(got, torch.fft.fftn(torch.ones(1, 4, 4, 4, dtype=torch.complex64),
                                               dim=(1, 2, 3)))
    finally:
        mesh.close()


# ------------------------------------------------------- the routing rule
def _fake_ops(dtype, block) -> list:
    with FakeTensorMode():
        x = torch.empty((1, NP) + block, dtype=dtype, device="cuda")
    return [type("Op", (), {"payload": x, "shift": None})()]


@pytest.mark.parametrize("dtype,block", [
    (torch.float32, (3,)), (torch.int32, (1,)), (torch.bool, (4,)), (torch.bool, (2048,)),
    (torch.bfloat16, (2, 5)), (torch.bfloat16, (2048,)), (torch.int64, (7, 3)),
    (torch.complex64, (1,)), (torch.uint8, (12,)), (torch.float64, ()),
])
def test_whole_word_blocks_on_the_card_take_the_kernel(dtype, block):
    ops = _fake_ops(dtype, block)
    assert tplan._route(("all_to_all",), ops, False, "auto", procs=True) == "cuda"
    assert tplan._route(("all_to_all",), ops, False, "cuda", procs=True) == "cuda"
    assert tplan._route(("all_to_all",), ops, False, "torch", procs=True) == "torch"
    # the stacked mesh's all-to-all stays its transpose view
    assert tplan._route(("all_to_all",), ops, False, "auto") == "torch"
    assert tplan.choose_backend(tplan.DEFAULT_MODEL, 1e9, True) == "cuda"


@pytest.mark.parametrize("dtype,block", [
    (torch.uint8, (3,)), (torch.bool, (2,)), (torch.bool, (81,)), (torch.bfloat16, (3,)),
    (torch.int16, (1,)),
])
def test_a_block_that_is_not_whole_words_goes_to_torch(dtype, block):
    ops = _fake_ops(dtype, block)
    for backend in ("auto", "cuda"):
        assert tplan._route(("all_to_all",), ops, False, backend, procs=True) == "torch"
    # packed, the group is one word buffer
    assert tplan._route(("all_to_all",), ops, True, "auto", procs=True) == "cuda"
    assert not rma_ops.block_words(ops[0].payload)


def test_cpu_payloads_stay_on_the_mesh_under_auto():
    ops = [type("Op", (), {"payload": torch.zeros(1, NP, 4), "shift": None})()]
    assert tplan._route(("all_to_all",), ops, False, "auto", procs=True) == "torch"
    assert tplan._route(("all_to_all",), ops, False, "cuda", procs=True) == "cuda"


@pytest.mark.parametrize("dtype", (torch.bool, torch.bfloat16, torch.int64,
                                   torch.complex64))
def test_the_word_view_round_trips(dtype):
    g = torch.Generator().manual_seed(5)
    raw = torch.randint(0, 256, (NP, 8 * dtype.itemsize), dtype=torch.uint8, generator=g)
    x = (raw & 1).bool() if dtype == torch.bool else raw.view(dtype)
    for blk in x:
        w = rma_ops.word_view(blk)
        assert w.dtype == torch.int32 and w.numel() * 4 == blk.nbytes
        assert w.data_ptr() == blk.data_ptr()        # a view, no copy
        back = w.view(torch.uint8).view(dtype).reshape(blk.shape)
        assert torch.equal(back.view(torch.uint8) if dtype != torch.bool else back,
                           blk.view(torch.uint8) if dtype != torch.bool else blk)


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
