"""Remote page pool and paged KV: the PyTorch port against the JAX reference.

In-process: the host free-list (`HostPagePool`), the prefix-sharing
`PagedKVPool` (the same page ids, hits and misses for one acquire/release
sequence), routing, and `gather_local`.  Across ranks: `scatter_pages`
under a test-side `shard_map` on 4 forced host devices, run by this file's
own ``__main__`` branch in a child process.
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
from repro.rmem import heap as jheap  # noqa: E402
from repro.rmem import pages as jpg  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmem import heap as theap  # noqa: E402
from repro_torch.rmem import pages as tpg  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
P_RANKS = 4
N_PAGES, PT, D, S = 6, 2, 4, 3


def _run_jax_child(case: str, workdir: pathlib.Path) -> dict:
    """Run `case` of this file's __main__ branch on 4 forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={P_RANKS}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, case, str(workdir)],
                          capture_output=True, text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(workdir / "out.npz"))


# ---------------------------------------------------------------- in-process
def test_host_page_pool_matches_reference():
    ref, port = jheap.HostPagePool(5), theap.HostPagePool(5)
    trace_ref, trace_port = [], []
    for pool, log in ((ref, trace_ref), (port, trace_port)):
        a = [pool.alloc() for _ in range(4)]
        pool.ref_add(a[1], 2)
        log += [a, pool.release(a[1]), pool.release(a[0]), pool.alloc(),
                pool.alloc(), pool.alloc(), pool.release(a[2]),
                [pool.tag(i) for i in range(5)], pool.conservation(),
                pool.total_amos, pool.allocs, pool.frees]
        tag = pool.pin(a[3])                       # pull pin on a live page
        log += [tag, pool.tag_valid(a[3], tag), pool.release(a[3]),
                pool.unpin(a[3], tag), pool.tag_valid(a[3], tag),
                pool.conservation(), pool.total_amos]
    assert trace_port == trace_ref
    with pytest.raises(theap.HeapError, match="stale tag"):
        port.unpin(0, port.tag(0) + 1)
    dead = next(i for i in range(5) if port.ref[i].v == 0)
    with pytest.raises(theap.HeapError, match="double free"):
        port.release(dead)
    live = next(i for i in range(5) if port.ref[i].v > 0)
    with pytest.raises(theap.HeapError, match="live page"):
        port.free(live)
    assert theap.head_unpack(theap.head_pack(7, 3)) == jheap.head_unpack(jheap.head_pack(7, 3))


def _kv_sequence(mod):
    """One acquire/release sequence with shared prefixes and a dry pool."""
    kv = mod.PagedKVPool(owners=[2, 3], n_pages=4, page_words=8)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 50, 4)
    log = []
    for rid in range(5):
        toks = np.concatenate([prefix, rng.integers(0, 50, 4)])
        pages = mod.split_pages(toks, 2)
        dest = kv.route(mod.page_key(pages[0]))
        refs = []
        for pt in pages:
            res = kv.acquire(dest, mod.page_key(pt))
            if res is None:
                log.append(("dry", rid))
                break
            refs.append(res[0])
            log.append((tuple(res[0]), res[1]))
        else:
            kv.table_set(rid, refs)
            log.append(kv.table_entries(rid).tolist())
        if rid == 2:
            log.append([tuple(r) for r in kv.table_release(0)])
    log.append(kv.stats())
    log.append(kv.conservation()["ok"])
    return log


def test_paged_kv_pool_matches_reference():
    assert _kv_sequence(tpg) == _kv_sequence(jpg)


def test_routing_and_page_keys_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        toks = rng.integers(0, 1000, 8)
        assert tpg.page_key(toks) == jpg.page_key(toks)
        assert tpg.route_owner(tpg.page_key(toks), [2, 3, 5]) == \
            jpg.route_owner(jpg.page_key(toks), [2, 3, 5])
    with pytest.raises(theap.HeapError):
        tpg.split_pages(np.arange(5), 2)


def test_gather_local_matches_reference():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((N_PAGES, PT, 2, D)).astype(np.float32)
    ids = rng.integers(-1, N_PAGES + 2, (3, 5)).astype(np.int32)
    want = np.asarray(jpg.gather_local(jnp.asarray(pool), jnp.asarray(ids)))
    got = tpg.gather_local(torch.from_numpy(pool), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- across 4 ranks
def _scatter_inputs():
    rng = np.random.default_rng(9)
    dest = np.full((P_RANKS, S), -1, np.int32)
    slot = np.full((P_RANKS, S), -1, np.int32)
    free = {t: list(rng.permutation(N_PAGES)) for t in range(P_RANKS)}
    for r in range(P_RANKS):
        for s in range(S):
            t = int(rng.integers(-1, P_RANKS))
            if t >= 0:                        # unique (dest, slot) pairs
                dest[r, s], slot[r, s] = t, free[t].pop()
    slot[0, 0], dest[0, 0] = N_PAGES + 1, 1   # slot past the pool: dropped
    return {
        "pool": rng.standard_normal((P_RANKS, N_PAGES, PT, 2, D)).astype(np.float32),
        "payload": rng.standard_normal((P_RANKS, S, PT, 2, D)).astype(np.float32),
        "slot": slot,
        "dest": dest,
    }


def _scatter_child(d: pathlib.Path) -> None:
    inp = np.load(d / "in.npz")
    mesh = jax.make_mesh((P_RANKS,), ("x",))
    p5, p2 = P("x", None, None, None, None), P("x", None)
    f = jax.jit(shard_map(
        lambda pool, pay, slot, dest: jpg.scatter_pages(
            "x", pool[0], pay[0], slot[0], dest[0])[None],
        mesh=mesh, in_specs=(p5, p5, p2, p2), out_specs=p5, check_vma=False))
    out = f(*(jnp.asarray(inp[k]) for k in ("pool", "payload", "slot", "dest")))
    np.savez(d / "out.npz", pool=np.asarray(out))


def test_scatter_pages_matches_reference(tmp_path):
    inp = _scatter_inputs()
    np.savez(tmp_path / "in.npz", **inp)
    ref = _run_jax_child("scatter", tmp_path)

    mesh = Mesh(P_RANKS, "x", device="cpu")
    pool = torch.from_numpy(inp["pool"].copy())
    with OpCounter() as c:
        out = tpg.scatter_pages(mesh, pool, torch.from_numpy(inp["payload"]),
                                torch.from_numpy(inp["slot"]),
                                torch.from_numpy(inp["dest"]))
    np.testing.assert_array_equal(out.numpy(), ref["pool"])
    assert not np.array_equal(ref["pool"], inp["pool"])     # pages did land
    # payload + slot ids ride one fused all-to-all: 2 raw -> 1 wire
    assert (c.raw_msgs, c.coalesced_msgs, c.puts) == (2, 1, 1)
    assert c.plans[0]["bytes_wire"] == P_RANKS * S * (PT * 2 * D + 1) * 4


if __name__ == "__main__":
    {"scatter": _scatter_child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
