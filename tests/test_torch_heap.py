"""The device page pool of the PyTorch port against the JAX reference.

Across ranks: this file's own ``__main__`` branch runs the reference's
pool (`repro.rmem.heap`) under a test-side `shard_map` on 4 forced host
devices, in scripted epochs — alloc with demand above capacity (grants
clamp), a grant above ``kmax``, share, two releases, a share of dead pages,
ABA tags across free and realloc, 12 seeded random alloc/free epochs, a
piggybacked alloc, malformed refcount rows, grow and shrink — and saves
every epoch's state, ids, grants, freed counts and `OpCounter` ledger.  The
port replays the same epochs on the stacked rank axis (``device="cpu"``)
and must match all of it bit for bit.

In-process (one host device): the dynamic-window cases of
`tests/test_rmem.py` and the SPMD `HeapError` cases of
`tests/test_error_paths.py`, both packages on the same states
(`pool_state_from_numpy`), and a port-only generation wrap at 2**32.
"""

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
from repro.core import window as jwindow  # noqa: E402
from repro.rmem import heap as jheap  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import window as twindow  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmem import heap as theap  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, N_PAGES, KMAX, PS = 4, 16, 4, (2,)
N_RANDOM, GROW = 12, 4
# the first epoch leaves target 3 full and target 0 with 4 free pages, so
# the second's demand (2 from every origin) clamps at both
WANT_1 = np.array([[3, 1, 2, 4], [3, 2, 0, 4], [3, 1, 4, 4], [3, 0, 1, 4]], np.int32)
WANT_2 = np.full((NP, NP), 2, np.int32)
WANT_OVER = np.zeros((NP, NP), np.int32)
WANT_OVER[1, 2] = KMAX + 2              # a grant above kmax
OTHER = np.arange(NP * 4, dtype=np.int32).reshape(NP, 4)


def _flat_release(ids):
    """[p, p, kmax] granted ids -> ([p, p*kmax] ids, owners; -1 = no-op)."""
    own = np.broadcast_to(np.arange(NP, dtype=np.int32)[None, :, None], ids.shape)
    flat = ids.reshape(NP, -1)
    return flat, np.where(flat >= 0, own.reshape(NP, -1), -1).astype(np.int32)


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    from repro.core import plan as jplan
    from repro.core.rma import OpCounter as JOpCounter

    mesh = jax.make_mesh((NP,), ("x",))
    desc, st0 = jheap.pool_allocate(mesh, "x", N_PAGES, PS)
    specs = jheap.state_specs("x", len(PS))
    sm = lambda f, i, o: jax.jit(shard_map(f, mesh=mesh, in_specs=i, out_specs=o,  # noqa: E731
                                           check_vma=False))

    def alloc_body(s, want):
        s, ids, granted = jheap.alloc(desc, jheap.to_local(s), want[0], KMAX)
        return jheap.to_global(s), ids[None], granted[None]

    def ref_body(s, ids, owner, delta):
        s, nf = jheap.ref_update(desc, jheap.to_local(s), ids[0], owner[0], delta[0])
        return jheap.to_global(s), nf[None]                  # rank 1: spec P("x")

    def tag_body(s, ids, gens):
        return jheap.tag_valid(jheap.to_local(s), ids[0], gens[0])[None]

    def piggy_body(s, want, other):
        pl = jplan.RmaPlan("x")
        h_other = pl.all_gather(other[0], kind="gets")
        handles = jheap.alloc_record(pl, jheap.to_local(s), want[0])
        pl.flush(aggregate=True)
        s, ids, granted = jheap.alloc_apply(desc, jheap.to_local(s), KMAX, handles)
        return jheap.to_global(s), ids[None], granted[None], h_other.result()[None]

    x2, x3 = P("x", None), P("x", None, None)
    f_alloc = sm(alloc_body, (specs, x2), (specs, x3, x2))
    f_ref = sm(ref_body, (specs, x2, x2, x2), (specs, P("x")))
    f_tag = sm(tag_body, (specs, x2, x2), x2)
    f_piggy = sm(piggy_body, (specs, x2, x2), (specs, x3, x2, x3))

    out, snaps = {}, {}

    def save(name, st, **arrays):
        out[f"{name}/meta"] = np.asarray(st.meta)
        out[f"{name}/stack"] = np.asarray(st.free_stack)
        out[f"{name}/head"] = np.asarray(st.head)
        out[f"{name}/pages"] = np.asarray(st.pages)
        for k, v in arrays.items():
            out[f"{name}/{k}"] = np.asarray(v)

    def run(kind, fn, *args):
        # the reference counts while tracing: keep the ledger of a trace
        with JOpCounter() as c:
            res = fn(*[a if isinstance(a, jheap.PoolState) else jnp.asarray(a)
                       for a in args])
        if c.raw_msgs or kind not in snaps:
            snaps[kind] = c.snapshot()
        return res

    def alloc(name, st, want):
        st, ids, granted = run("alloc", f_alloc, st, want)
        save(name, st, want=want, ids=ids, granted=granted)
        return st, np.asarray(ids)

    def ref_update(name, st, ids, owner, delta):
        st, nf = run("ref_update", f_ref, st, ids, owner, delta)
        save(name, st, in_ids=ids, in_owner=owner, in_delta=delta, freed=nf)
        return st, np.asarray(nf)

    st, ids1 = alloc("alloc", st0, WANT_1)
    st, _ = alloc("alloc_clamp", st, WANT_2)
    flat, own = _flat_release(ids1)
    ones = np.ones_like(flat)
    st, _ = ref_update("share", st, flat, own, ones)
    st, _ = ref_update("release_1", st, flat, own, -ones)
    st, _ = ref_update("release_2", st, flat, own, -ones)
    st_dead, _ = ref_update("share_dead", st, flat, own, ones)
    st, ids_re = alloc("realloc", st, WANT_1)
    # ABA: every rank checks one page id of its own pool against its
    # current generation and the one two bumps before (free, realloc)
    pid = np.full((NP, 1), int(ids1[0, 0, 0]), np.int32)
    gen_now = np.asarray(st.meta)[:, :, jheap.GEN][np.arange(NP), pid[:, 0]][:, None]
    stale = (gen_now.astype(np.int64) - 2).astype(np.uint32)   # before free + realloc
    out["tag/pid"], out["tag/fresh_gens"], out["tag/stale_gens"] = pid, gen_now, stale
    out["tag/fresh"] = np.asarray(run("tag", f_tag, st, pid, gen_now))
    out["tag/stale"] = np.asarray(run("tag", f_tag, st, pid, stale))

    # 12 seeded random epochs, from the pool as the scripted epochs left it
    rng = np.random.RandomState(0)
    held = [(t, int(i)) for o in range(NP) for t in range(NP)
            for i in ids_re[o, t] if i >= 0]
    held += [(t, int(i)) for o in range(NP) for t in range(NP)
             for i in np.asarray(out["alloc_clamp/ids"])[o, t] if i >= 0]
    for e in range(N_RANDOM):
        w = rng.randint(0, 3, size=(NP, NP)).astype(np.int32)
        st, ids_e = alloc(f"random_{e}/alloc", st, w)
        held += [(t, int(i)) for o in range(NP) for t in range(NP)
                 for i in ids_e[o, t] if i >= 0]
        rng.shuffle(held)
        n_rel = len(held) // 2
        rel, held = held[:n_rel], held[n_rel:]
        rel_ids = np.full((NP, NP * KMAX), -1, np.int32)
        rel_own = np.full((NP, NP * KMAX), -1, np.int32)
        for j, (t, i) in enumerate(rel):
            rel_ids[j % NP, j // NP] = i
            rel_own[j % NP, j // NP] = t
        st, _ = ref_update(f"random_{e}/release", st, rel_ids, rel_own,
                           -np.ones_like(rel_ids))
    out["random/held"] = np.asarray(sorted(held), np.int32).reshape(-1, 2)

    # malformed rows: ids past the pool, owners out of range, and one
    # decrement below zero on a live page (a row of -2 on refcount 1)
    t0, i0 = held[0]
    bad_ids = np.full((NP, 4), -1, np.int32)
    bad_own = np.full((NP, 4), -1, np.int32)
    bad_dl = np.zeros((NP, 4), np.int32)
    bad_ids[0], bad_own[0], bad_dl[0] = [N_PAGES + 3, 2, i0, 1], [1, NP, t0, -1], [1, 1, -2, 1]
    st, _ = ref_update("malformed", st, bad_ids, bad_own, bad_dl)

    # grow by 4 pages and shrink back (jheap's numpy path, outside shard_map)
    desc_g, st_g = jheap.pool_grow(mesh, desc, st, GROW)
    save("grow", st_g)
    _, st_s = jheap.pool_shrink(mesh, desc_g, st_g, GROW)
    save("shrink", st_s)

    # a grant above kmax, and a piggybacked alloc, each on a fresh pool
    _, st_over = jheap.pool_allocate(mesh, "x", N_PAGES, PS)
    alloc("over_kmax", st_over, WANT_OVER)
    _, st_p = jheap.pool_allocate(mesh, "x", N_PAGES, PS)
    st_p, ids_p, g_p, oth = run("piggyback", f_piggy, st_p, WANT_1, OTHER)
    save("piggyback", st_p, want=WANT_1, ids=ids_p, granted=g_p, other=oth)
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("heap")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


# ================================================================ the port
def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


@pytest.fixture(scope="module")
def port_run(jax_ref):
    """The child's epochs replayed on the port, inputs taken from the
    child's record; every result kept as numpy, ledgers by step."""
    ref, _ = jax_ref
    mesh = Mesh(NP, "x", device="cpu")
    desc, st0 = theap.pool_allocate(mesh, N_PAGES, PS)
    out, snaps, states = {}, {}, {}
    attach_ids = [desc.window.attach_id]

    def save(name, st, **arrays):
        states[name] = st
        out[f"{name}/meta"] = st.meta.numpy()
        out[f"{name}/stack"] = st.free_stack.numpy()
        out[f"{name}/head"] = st.head.numpy()
        out[f"{name}/pages"] = st.pages.numpy()
        for k, v in arrays.items():
            out[f"{name}/{k}"] = v.numpy()

    def alloc(name, st, d=desc):
        with OpCounter() as c:
            st, ids, granted = theap.alloc(d, st, _t(ref[f"{name}/want"]), KMAX)
        snaps[name] = c.snapshot()
        save(name, st, ids=ids, granted=granted)
        return st

    def ref_update(name, st):
        args = [_t(ref[f"{name}/in_{k}"]) for k in ("ids", "owner", "delta")]
        with OpCounter() as c:
            st, nf = theap.ref_update(desc, st, *args)
        snaps[name] = c.snapshot()
        save(name, st, freed=nf)
        return st

    st = alloc("alloc", st0)
    st = alloc("alloc_clamp", st)
    for name in ("share", "release_1", "release_2"):
        st = ref_update(name, st)
    ref_update("share_dead", st)
    st = alloc("realloc", st)
    for kind in ("fresh", "stale"):
        with OpCounter() as c:
            out[f"tag/{kind}"] = theap.tag_valid(
                st, _t(ref["tag/pid"]), _t(ref[f"tag/{kind}_gens"], torch.int64)).numpy()
        snaps[f"tag_{kind}"] = c.snapshot()
    for e in range(N_RANDOM):
        st = alloc(f"random_{e}/alloc", st)
        st = ref_update(f"random_{e}/release", st)
    st = ref_update("malformed", st)
    desc_g, st_g = theap.pool_grow(mesh, desc, st, GROW)
    save("grow", st_g)
    attach_ids.append(desc_g.window.attach_id)
    desc_s, st_s = theap.pool_shrink(mesh, desc_g, st_g, GROW)
    save("shrink", st_s)
    attach_ids.append(desc_s.window.attach_id)

    d_over, st_over = theap.pool_allocate(mesh, N_PAGES, PS)
    alloc("over_kmax", st_over, d_over)
    d_p, st_p = theap.pool_allocate(mesh, N_PAGES, PS)
    with OpCounter() as c:
        pl = tplan.RmaPlan(mesh)
        h_other = pl.all_gather(_t(OTHER), kind="gets")
        handles = theap.alloc_record(pl, st_p, _t(WANT_1))
        pl.flush(aggregate=True)
        st_p, ids, granted = theap.alloc_apply(d_p, st_p, KMAX, handles)
    snaps["piggyback"] = c.snapshot()
    save("piggyback", st_p, ids=ids, granted=granted, other=h_other.result())
    return {"out": out, "snaps": snaps, "states": states,
            "descs": {"base": desc, "grow": desc_g, "shrink": desc_s},
            "attach_ids": attach_ids}


EPOCHS = (["alloc", "alloc_clamp", "share", "release_1", "release_2", "share_dead",
           "realloc"]
          + [f"random_{e}/{k}" for e in range(N_RANDOM) for k in ("alloc", "release")]
          + ["malformed", "grow", "shrink", "over_kmax", "piggyback"])


def _result_keys(ref: dict, name: str) -> list:
    return [k for k in ref if k.startswith(name + "/")
            and k.rsplit("/", 1)[1] not in ("want", "in_ids", "in_owner", "in_delta")]


@pytest.mark.parametrize("name", EPOCHS)
def test_epoch_matches_reference_bit_for_bit(jax_ref, port_run, name):
    """State (pages, meta, free stack, head), ids, grants and freed counts
    of each epoch equal the reference's, and so does its ledger."""
    ref, ref_snaps = jax_ref
    got = port_run["out"]
    keys = _result_keys(ref, name)
    assert {k.rsplit("/", 1)[1] for k in keys} >= {"meta", "stack", "head", "pages"}
    for k in keys:
        want, have = ref[k], got[k]
        assert want.shape == have.shape, k
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(have, want, err_msg=k)
        else:
            np.testing.assert_array_equal(have.astype(np.int64), want.astype(np.int64),
                                          err_msg=k)
    if name in port_run["snaps"]:
        kind = ("alloc" if name.endswith("alloc") or name in ("alloc_clamp", "over_kmax")
                else "piggyback" if name == "piggyback" else "ref_update")
        assert port_run["snaps"][name] == ref_snaps[kind]


def test_tag_valid_matches_reference(jax_ref, port_run):
    """A tag cached before free and realloc is invalid; the fresh one valid."""
    ref, ref_snaps = jax_ref
    got = port_run["out"]
    for kind in ("fresh", "stale"):
        np.testing.assert_array_equal(got[f"tag/{kind}"], ref[f"tag/{kind}"])
        assert port_run["snaps"][f"tag_{kind}"] == ref_snaps["tag"]
    assert got["tag/fresh"].all() and not got["tag/stale"].any()


def test_epoch_ledgers_are_the_reference_fingerprints(jax_ref, port_run):
    """alloc: raw 3 -> 1 wire, gets 1 + accs 1 (the stack rides kind-less);
    ref_update: raw 2 -> 1 wire, accs 1; piggyback: raw 4 -> 1 wire."""
    snaps = port_run["snaps"]
    assert snaps["alloc"]["by_axis"] == {"x": {"accs": 1, "gets": 1}}
    assert (snaps["alloc"]["raw_msgs"], snaps["alloc"]["coalesced_msgs"]) == (3, 1)
    assert snaps["share"]["by_axis"] == {"x": {"accs": 1}}
    assert (snaps["share"]["raw_msgs"], snaps["share"]["coalesced_msgs"]) == (2, 1)
    assert (snaps["piggyback"]["raw_msgs"], snaps["piggyback"]["coalesced_msgs"]) == (4, 1)
    assert snaps["piggyback"]["by_axis"] == {"x": {"accs": 1, "gets": 2}}
    np.testing.assert_array_equal(port_run["out"]["piggyback/other"][0], OTHER)


def test_conservation_after_every_epoch(port_run):
    """free + live == capacity and the free stack is the dead set, after
    every epoch; the share of dead pages is dropped whole into ERRS."""
    for name, st in port_run["states"].items():
        desc = port_run["descs"]["grow" if name == "grow" else "base"]
        cons = theap.conservation(desc, st)
        assert (cons["free_plus_live"] == desc.n_pages).all(), name
        assert cons["stack_consistent"].all(), name
    dead = theap.conservation(port_run["descs"]["base"], port_run["states"]["share_dead"])
    assert (dead["protocol_errors"] > 0).any()
    assert (theap.conservation(port_run["descs"]["base"],
                               port_run["states"]["release_2"])["protocol_errors"] == 0).all()


def test_clamped_grants_and_kmax_overflow(port_run):
    """Demand above capacity clamps in rank order; a grant above kmax pops
    and marks live more pages than it returns ids for (as the reference)."""
    out = port_run["out"]
    np.testing.assert_array_equal(out["alloc_clamp/granted"][:, 3], 0)   # target 3 full
    np.testing.assert_array_equal(out["alloc_clamp/granted"][:, 0], [2, 2, 0, 0])
    assert out["over_kmax/granted"][1, 2] == KMAX + 2
    assert (out["over_kmax/ids"][1, 2] >= 0).sum() == KMAX
    assert (out["over_kmax/meta"][2, :, theap.REF] > 0).sum() == KMAX + 2


def test_grow_and_shrink_move_attach_id(port_run):
    """Grow and shrink each detach and re-attach the three regions (six
    bumps each), in the one window the descriptors share."""
    d = port_run["descs"]
    assert port_run["attach_ids"] == [3, 9, 15]
    assert d["base"].window is d["grow"].window is d["shrink"].window
    assert (d["grow"].n_pages, d["shrink"].n_pages) == (N_PAGES + GROW, N_PAGES)
    assert d["shrink"].regions == (6, 7, 8)


# ================================================= in-process: one device
def _jmesh():
    return jax.make_mesh((1,), ("w",))


def _tmesh():
    return Mesh(1, "w", device="cpu")


def _np_state(s):
    return tuple(np.asarray(x) for x in s)


class TestPoolDynamicWindow:
    """`tests/test_rmem.py`'s dynamic-window cases on both packages."""

    def _caches(self):
        out = []
        for heap, window, mesh, args in (
                (jheap, jwindow, _jmesh(), ("w", 8, (2,))),
                (theap, twindow, _tmesh(), (8, (2,)))):
            desc, state = heap.pool_allocate(mesh, *args)
            out.append((heap, window, mesh, desc, state, window.DescriptorCache()))
        return out

    def test_grow_invalidates_remote_descriptor_caches(self):
        trace = []
        for heap, window, mesh, desc, state, cache in self._caches():
            log = [cache.lookup(desc.window, desc.regions[0])[1], cache.remote_ops]
            cache.lookup(desc.window, desc.regions[0])
            log.append(cache.remote_ops)
            desc2, state2 = heap.pool_grow(mesh, desc, state, extra=8)
            with pytest.raises(window.WindowError):
                cache.lookup(desc2.window, desc.regions[0])
            log += [cache.lookup(desc2.window, desc2.regions[0])[1], cache.remote_ops,
                    desc2.window.attach_id, desc2.metadata_nbytes()]
            desc3, _ = heap.pool_shrink(mesh, desc2, state2, remove=8)
            with pytest.raises(window.WindowError):
                cache.lookup(desc3.window, desc2.regions[0])
            log += [cache.lookup(desc3.window, desc3.regions[0])[1], cache.remote_ops,
                    desc3.window.attach_id]
            trace.append(log)
        assert trace[0] == trace[1]
        assert trace[1][0] == (8, 2) and trace[1][3] == (16, 2)

    def test_grow_preserves_state_and_conservation(self):
        """`pool_grow` on the reference's mid-run state: bit-equal."""
        desc, state = jheap.pool_allocate(_jmesh(), "w", 4, (2,))
        meta = np.asarray(state.meta).copy()
        meta[0, 1, jheap.REF] = 1
        stack = np.asarray(state.free_stack).copy()
        stack[0] = [0, 2, 3, 1]
        head = np.asarray(state.head).copy()
        head[0, jheap.FREE_TOP] = 3
        pages = np.arange(8, dtype=np.float32).reshape(1, 4, 2)
        state = jheap.PoolState(jnp.asarray(pages), meta, stack, head)
        _, want = jheap.pool_grow(_jmesh(), desc, state, extra=4)

        tdesc, _ = theap.pool_allocate(_tmesh(), 4, (2,))
        tstate = theap.pool_state_from_numpy(tdesc, pages, meta, stack, head, device="cpu")
        tdesc2, got = theap.pool_grow(_tmesh(), tdesc, tstate, extra=4)
        for a, b in zip(_np_state(got), _np_state(want)):
            np.testing.assert_array_equal(a, b.astype(a.dtype))
        cons = theap.conservation(tdesc2, got)
        assert (cons["free_plus_live"] == 8).all() and cons["stack_consistent"].all()

    def test_shrink_compacts_the_stack_as_the_reference(self):
        """Free ids past the new size leave the stack; the rest keep order."""
        desc, _ = jheap.pool_allocate(_jmesh(), "w", 8, ())
        meta = np.zeros((1, 8, 2), np.uint32)
        meta[0, [1, 4], jheap.REF] = [2, 1]
        meta[0, :, jheap.GEN] = np.arange(8) * 3
        stack = np.array([[6, 0, 7, 3, 2, 5, 1, 4]], np.int32)   # 1, 4 are live
        head = np.array([[6, 9, 5, 3, 0]], np.uint32)
        pages = np.zeros((1, 8), np.float32)
        state = jheap.PoolState(jnp.asarray(pages), meta, stack, head)
        _, want = jheap.pool_shrink(_jmesh(), desc, state, remove=2)
        tdesc, _ = theap.pool_allocate(_tmesh(), 8, ())
        tstate = theap.pool_state_from_numpy(tdesc, pages, meta, stack, head, device="cpu")
        _, got = theap.pool_shrink(_tmesh(), tdesc, tstate, remove=2)
        for a, b in zip(_np_state(got), _np_state(want)):
            np.testing.assert_array_equal(a, b.astype(a.dtype))
        np.testing.assert_array_equal(got.free_stack[0, :4].numpy(), [0, 3, 2, 5])

    def test_shrink_refuses_live_high_pages(self):
        meta = np.zeros((1, 4, 2), np.uint32)
        meta[0, 3, jheap.REF] = 2                     # highest page live
        for heap, mesh, args in ((jheap, _jmesh(), ("w", 4, ())), (theap, _tmesh(), (4, ()))):
            desc, state = heap.pool_allocate(mesh, *args)
            if heap is theap:
                state = theap.pool_state_from_numpy(
                    desc, np.zeros((1, 4), np.float32), meta, _np_state(state)[2],
                    _np_state(state)[3], device="cpu")
            else:
                state = jheap.PoolState(state.pages, meta, state.free_stack, state.head)
            with pytest.raises(heap.HeapError, match="still live on ranks \\[0\\]"):
                heap.pool_shrink(mesh, desc, state, remove=2)
            assert desc.window.attach_id == 3         # refused before any detach

    def test_metadata_o1(self):
        sizes = []
        for heap, mesh, a, b in ((jheap, _jmesh(), ("w", 4, (2,)), ("w", 512, (64,))),
                                 (theap, _tmesh(), (4, (2,)), (512, (64,)))):
            d1, _ = heap.pool_allocate(mesh, *a)
            d2, _ = heap.pool_allocate(mesh, *b)
            assert d1.metadata_nbytes() == d2.metadata_nbytes()
            sizes.append((d1.metadata_nbytes(), d2.page_words, d2.page_nbytes))
        assert sizes[0] == sizes[1] == (64 + 64 + 3 * 48, 64, 256)


class TestSpmdHeapErrorSurface:
    """`tests/test_error_paths.py`'s SPMD `HeapError` cases: the reference
    under single-device `shard_map`, the port on the same state."""

    def _jax_epochs(self, desc, state, steps):
        specs = jheap.state_specs("w")
        heads = []
        for kind, pid in steps:
            def body(st, ids, kind=kind):
                st = jheap.to_local(st)
                if kind == "alloc":
                    st, _, _ = jheap.alloc(desc, st, jnp.ones((1,), jnp.int32), 1)
                else:
                    st, _ = jheap.ref_update(desc, st, ids[0], jnp.zeros((1,), jnp.int32),
                                             jnp.full((1,), -1 if kind == "release" else 1,
                                                      jnp.int32))
                return jheap.to_global(st)

            f = jax.jit(shard_map(body, mesh=_jmesh(), in_specs=(specs, P("w", None)),
                                  out_specs=specs, check_vma=False))
            state = f(state, jnp.full((1, 1), pid, jnp.int32))
            heads.append(np.asarray(state.head).copy())
        return state, heads

    def _port_epochs(self, desc, state, steps):
        heads = []
        for kind, pid in steps:
            if kind == "alloc":
                state, _, _ = theap.alloc(desc, state, torch.ones((1, 1), dtype=torch.int32), 1)
            else:
                state, _ = theap.ref_update(
                    desc, state, torch.full((1, 1), pid),
                    torch.zeros((1, 1), dtype=torch.int64),
                    torch.full((1, 1), -1 if kind == "release" else 1))
            heads.append(state.head.numpy().copy())
        return state, heads

    def _both(self, steps):
        jdesc, jstate = jheap.pool_allocate(_jmesh(), "w", 4)
        tdesc, tstate = theap.pool_allocate(_tmesh(), 4)
        tstate = theap.pool_state_from_numpy(tdesc, *_np_state(jstate), device="cpu")
        jstate, jheads = self._jax_epochs(jdesc, jstate, steps)
        tstate, theads = self._port_epochs(tdesc, tstate, steps)
        for a, b in zip(theads, jheads):
            np.testing.assert_array_equal(a, b.astype(np.int64))
        for a, b in zip(_np_state(tstate), _np_state(jstate)):
            np.testing.assert_array_equal(a, b.astype(a.dtype))
        return (jdesc, jstate), (tdesc, tstate)

    def test_double_free_raises_through_check_errors(self):
        steps = [("alloc", 0), ("release", 3), ("release", 3)]   # the page popped: 3
        (jdesc, jstate), (tdesc, tstate) = self._both(steps)
        assert int(tstate.head[0, theap.ERRS]) == 1
        for heap, desc, state in ((jheap, jdesc, jstate), (theap, tdesc, tstate)):
            with pytest.raises(heap.HeapError, match="rank 0: 1"):
                heap.check_errors(desc, state)
        assert (theap.conservation(tdesc, tstate)["free_plus_live"] == 4).all()

    def test_share_dead_raises_through_check_errors(self):
        (jdesc, jstate), (tdesc, tstate) = self._both([("share", 0)])
        assert int(tstate.head[0, theap.ERRS]) == 1
        with pytest.raises(theap.HeapError, match="share-dead|double-free"):
            theap.check_errors(tdesc, tstate)
        assert theap.conservation(tdesc, tstate)["stack_consistent"].all()

    def test_clean_pool_passes_check_errors(self):
        (_, _), (tdesc, tstate) = self._both([("alloc", 0)])
        theap.check_errors(tdesc, tstate)                  # no raise


def test_generation_wraps_at_2_32():
    """Port-only: a page whose generation is 2**32 - 1 wraps to 0 at alloc
    and to 1 at free, and `tag_valid` compares in uint32."""
    mesh = _tmesh()
    desc, st = theap.pool_allocate(mesh, 2)
    meta = st.meta.clone()
    meta[0, :, theap.GEN] = 2**32 - 1
    st = st._replace(meta=meta)
    st, ids, granted = theap.alloc(desc, st, torch.full((1, 1), 2), 2)
    assert granted.tolist() == [[2]]
    assert st.meta[0, :, theap.GEN].tolist() == [0, 0]
    ids = ids[0, 0].view(1, 2)
    assert theap.tag_valid(st, ids, torch.zeros(1, 2, dtype=torch.int64)).all()
    assert theap.tag_valid(st, ids, torch.full((1, 2), 2**32)).all()      # == 0 mod 2**32
    assert not theap.tag_valid(st, ids, torch.full((1, 2), 2**32 - 1)).any()
    st, freed = theap.release(desc, st, ids, torch.zeros(1, 2, dtype=torch.int64))
    assert freed.tolist() == [2]
    assert st.meta[0, :, theap.GEN].tolist() == [1, 1]
    assert int(st.head[0, theap.EPOCH]) == 2 and int(st.head[0, theap.FREES]) == 2


def test_pool_state_from_numpy_places_on_the_mesh_device():
    """A state carried over from numpy lands on the pool's own device
    unless told otherwise, and asking for a card without one raises (no
    silent fallback to the CPU)."""
    desc, st = theap.pool_allocate(_tmesh(), 4, (2,))
    got = theap.pool_state_from_numpy(desc, *_np_state(st))
    assert all(x.device.type == "cpu" for x in got)
    assert [x.dtype for x in got] == [torch.float32, torch.int64, torch.int32, torch.int64]
    if not torch.cuda.is_available():
        from repro_torch.mesh import MeshError

        with pytest.raises(MeshError, match="device='cpu'"):
            theap.pool_state_from_numpy(desc, *_np_state(st), device="cuda")


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
