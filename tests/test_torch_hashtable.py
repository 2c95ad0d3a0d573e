"""The distributed hashtable of the PyTorch port against the JAX reference,
and the DSDE send-count repair it needs at scale.

Across ranks: this file's own ``__main__`` branch runs the reference's
`insert_epoch` and `lookup_epoch` under a test-side `shard_map` on 4 forced
host devices at `tests/subtests/hashtable_sub.py`'s sizes (table 64, heap
64, 32 slots a pair), and saves every volume, every lookup and every
`OpCounter` ledger.  Three insert epochs: distinct keys; keys inserted
before and keys repeated within the epoch; then, from the second epoch's
volume, keys that collide on three slots of every owner until its heap is
full.  A lookup of present and absent keys follows the second and third.
The port replays them on the stacked rank axis (``device="cpu"``), the
third from the reference's own volume (`volume_from_numpy`).  Volumes and
lookups must be bit-equal, ledgers equal by kind and count.

The reference runs without JAX's x64 mode, so its volume, keys and wire
items are int32 (the port keeps the declared int64): inputs stay in
[0, 2**31), and the plans' bytes are held each to its own width.  Nothing
is dropped to the capacity in the parity cases: there the reference's DSDE
overwrites a valid slot (ROADMAP §3), so the drop case is port-only.
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
from repro.core import hashtable as jht  # noqa: E402
from repro.core.perfmodel import DEFAULT_MODEL as JAX_MODEL  # noqa: E402
from repro_torch.core import dsde as tdsde  # noqa: E402
from repro_torch.core import hashtable as tht  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402

try:
    from .helpers import given, settings, st
except ImportError:             # run as a script: the JAX child
    from helpers import given, settings, st

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
NP, TABLE, HEAP, CAP = 4, 64, 64, 32
N1, N2, N3, NQ = 24, 24, 64, 48         # keys a rank: epochs 1-3, lookups
HOT_SLOTS = 3                           # epoch 3 aims at slots 0-2 of every owner
FIELDS = tht.LocalVolume._fields


def _inputs() -> dict:
    rng = np.random.default_rng(24)
    k1 = rng.choice(10_000, NP * N1, replace=False)
    v1 = rng.integers(0, 1_000_000, NP * N1)
    # epoch 2: 24 keys of epoch 1, 48 new, 24 repeats of those 72 (a repeat
    # may land on the same rank as its first copy or another)
    fresh = rng.choice(np.arange(10_000, 20_000), 48, replace=False)
    first = np.concatenate([rng.choice(k1, 24, replace=False), fresh])
    k2 = rng.permutation(np.concatenate([first, rng.choice(first, 24, replace=False)]))
    v2 = rng.integers(0, 1_000_000, NP * N2)
    # epoch 3: 16 keys a rank for each owner, all on its first HOT_SLOTS slots
    cand = np.arange(20_000, 400_000)
    own = np.asarray(tht.hash_owner(torch.from_numpy(cand), NP))
    slot = np.asarray(tht.hash_slot(torch.from_numpy(cand), TABLE))
    per = N3 // NP
    k3 = np.stack([rng.permutation(np.concatenate(
        [cand[(own == o) & (slot < HOT_SLOTS)][r * per:(r + 1) * per] for o in range(NP)]))
        for r in range(NP)])
    v3 = rng.integers(0, 1_000_000, (NP, N3))

    def queries(pools):
        q = np.concatenate([rng.choice(pl, c, replace=False) for pl, c in pools])
        return rng.permutation(q).reshape(NP, NQ)

    absent = np.arange(500_000, 500_000 + NP * NQ)
    q2 = queries([(np.union1d(k1, k2), NP * 32), (absent, NP * 16)])
    q3 = queries([(np.union1d(k1, k2), NP * 16), (k3.reshape(-1), NP * 24),
                  (absent, NP * 8)])
    i32 = lambda a: np.asarray(a, np.int32).reshape(NP, -1)   # noqa: E731
    return {"k1": i32(k1), "v1": i32(v1), "k2": i32(k2), "v2": i32(v2),
            "k3": i32(k3), "v3": i32(v3), "q2": i32(q2), "q3": i32(q3)}


# ================================================================ JAX child
def _child(d: pathlib.Path) -> None:
    from repro.core.rma import OpCounter as JOpCounter

    inp = dict(np.load(d / "in.npz"))
    mesh = jax.make_mesh((NP,), ("x",))
    sm = lambda f, n_in, n_out: jax.jit(shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=(P("x"),) * n_in, out_specs=(P("x"),) * n_out,
        check_vma=False))

    def insert(vols, k, v):
        vol, dropped = jht.insert_epoch(jax.tree.map(lambda a: a[0], vols), k[0], v[0],
                                        "x", CAP)
        return jax.tree.map(lambda a: a[None], vol), dropped[None]

    def lookup(vols, k):
        v, f = jht.lookup_epoch(jax.tree.map(lambda a: a[0], vols), k[0], "x", CAP)
        return v[None], f[None]

    out, snaps = {}, {}
    vols = jax.vmap(lambda _: jht.make_volume(TABLE, HEAP))(jnp.arange(NP))
    for e in (1, 2, 3):
        # each call is its own jit: the reference counts ops while tracing
        with JOpCounter() as c:
            vols, dropped = sm(insert, 3, 2)(vols, inp[f"k{e}"], inp[f"v{e}"])
        out.update({f"e{e}/{f}": np.asarray(a) for f, a in zip(FIELDS, vols)})
        out[f"e{e}/dropped"] = np.asarray(dropped)
        snaps[f"e{e}"] = {"ops": c.snapshot(), "plans": c.plans}
        if e > 1:
            with JOpCounter() as c:
                v, f = sm(lookup, 2, 2)(vols, inp[f"q{e}"])
            out[f"q{e}/vals"], out[f"q{e}/found"] = np.asarray(v), np.asarray(f)
            snaps[f"q{e}"] = {"ops": c.snapshot(), "plans": c.plans}
    np.savez(d / "out.npz", **out)
    (d / "snaps.json").write_text(json.dumps(snaps))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("hashtable")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={NP}")
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, "child", str(d)],
                          capture_output=True, text=True, timeout=90, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(d / "out.npz")), json.loads((d / "snaps.json").read_text())


@pytest.fixture(scope="module")
def port_run(inputs, jax_ref):
    """The port's epochs on the same inputs; epoch 3 starts from the
    reference's epoch-2 volume."""
    ref_out = jax_ref[0]
    m = Mesh(NP, "x", device="cpu")
    t = {k: torch.from_numpy(v.astype(np.int64)) for k, v in inputs.items()}
    out, snaps = {}, {}
    vol = tht.make_volume(TABLE, HEAP, NP, device="cpu")
    for e in (1, 2, 3):
        if e == 3:
            vol = tht.volume_from_numpy([ref_out[f"e2/{f}"] for f in FIELDS], device="cpu")
        with OpCounter() as c:
            vol, dropped = tht.insert_epoch(vol, t[f"k{e}"], t[f"v{e}"], m, CAP)
        out[f"e{e}"], out[f"e{e}/dropped"] = vol, dropped
        snaps[f"e{e}"] = {"ops": c.snapshot(), "plans": c.plans}
        if e > 1:
            with OpCounter() as c:
                out[f"q{e}"] = tht.lookup_epoch(vol, t[f"q{e}"], m, CAP)
            snaps[f"q{e}"] = {"ops": c.snapshot(), "plans": c.plans}
    return out, snaps


# ================================================================ parity
@pytest.mark.parametrize("epoch", [1, 2, 3])
def test_insert_epoch_volume_matches_reference(epoch, jax_ref, port_run):
    ref_out = jax_ref[0]
    vol = port_run[0][f"e{epoch}"]
    for f, got in zip(FIELDS, vol):
        want = ref_out[f"e{epoch}/{f}"]
        assert got.dtype == tht.make_volume(1, 1, 1, "cpu")._asdict()[f].dtype, f
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64), err_msg=f)
    assert port_run[0][f"e{epoch}/dropped"].tolist() == [0] * NP
    assert ref_out[f"e{epoch}/dropped"].tolist() == [0] * NP


def test_epochs_exercise_every_path(inputs, port_run):
    """The inputs do what the module docstring says: chains after epoch 1,
    overwrites and heap duplicates in epoch 2, a full heap in epoch 3
    with items that vanished."""
    e1, e2, e3 = (port_run[0][f"e{e}"] for e in (1, 2, 3))
    assert int(e1.next_free.min()) > 0
    tk, hk = e2.table_key.numpy(), e2.heap_key.numpy()
    k2 = inputs["k2"].reshape(-1)
    in_heap = [k for k in np.unique(k2) if (hk == k).sum() > 1]
    assert in_heap, "no key went into the heap twice"
    assert np.isin(np.intersect1d(inputs["k1"], k2), tk).any(), "no overwrite in the table"
    assert e3.next_free.tolist() == [HEAP] * NP
    placed = np.isin(inputs["k3"], np.concatenate([e3.table_key.numpy().reshape(-1),
                                                   e3.heap_key.numpy().reshape(-1)]))
    assert 0 < placed.sum() < inputs["k3"].size
    for name in ("q2", "q3"):               # no lookup is dropped to the capacity either
        own = tht.hash_owner(torch.from_numpy(inputs[name]), NP).long()
        per_pair = torch.zeros(NP, NP, dtype=torch.int64).scatter_add_(1, own, torch.ones_like(own))
        assert int(per_pair.max()) <= CAP


@pytest.mark.parametrize("epoch", [2, 3])
def test_lookup_epoch_matches_reference(epoch, inputs, jax_ref, port_run):
    ref_out = jax_ref[0]
    vals, found = port_run[0][f"q{epoch}"]
    np.testing.assert_array_equal(found.numpy(), ref_out[f"q{epoch}/found"])
    np.testing.assert_array_equal(vals.numpy(), ref_out[f"q{epoch}/vals"].astype(np.int64))
    assert 0 < int(found.sum()) < found.numel()


def _plan_bytes(width: int, epoch: str) -> list:
    """bytes_logical of each plan of an epoch with `width`-byte items (per
    rank): counts [p] int32, the slot ranges, the validity mask; a lookup's
    answers and their validity."""
    dsde_plan = 4 * NP + NP * CAP * 2 * width + NP * CAP
    return [dsde_plan] if epoch.startswith("e") else [dsde_plan, NP * CAP * 3 * width + NP * CAP]


@pytest.mark.parametrize("name", ["e1", "e2", "e3", "q2", "q3"])
def test_ledgers_match_reference(name, jax_ref, port_run):
    ref, got = jax_ref[1][name], port_run[1][name]
    for k in ("puts", "gets", "accs", "colls", "raw_msgs", "by_axis"):
        assert got["ops"][k] == ref["ops"][k], k
    assert [pl["raw"] for pl in got["plans"]] == [pl["raw"] for pl in ref["plans"]]
    assert [pl["groups"] for pl in got["plans"]] == [pl["groups"] for pl in ref["plans"]]
    # bytes each to its own width: the port's items are int64, the reference's int32
    assert [pl["bytes_logical"] for pl in got["plans"]] == _plan_bytes(8, name)
    assert [pl["bytes_logical"] for pl in ref["plans"]] == _plan_bytes(4, name)
    # wire counts each to its own package's aggregation model
    for model, snap in ((tperf.DEFAULT_MODEL, got), (JAX_MODEL, ref)):
        for pl in snap["plans"]:
            n = pl["raw"]
            pack = model.select_aggregation(n, NP * pl["bytes_logical"] / n) == "pack"
            assert pl["coalesced"] == (1 if pack else n)
        assert snap["ops"]["coalesced_msgs"] == sum(pl["coalesced"] for pl in snap["plans"])


def test_hashes_match_reference():
    keys = np.array([0, 1, 7, 12345, 2**31 - 1, -1, -2, -2**31, 999_999_937], np.int32)
    for p in (1, 3, 4, 1024):
        np.testing.assert_array_equal(tht.hash_owner(torch.from_numpy(keys), p).numpy(),
                                      np.asarray(jht.hash_owner(jnp.asarray(keys), p)))
    for t in (1, 64, 65536):
        np.testing.assert_array_equal(tht.hash_slot(torch.from_numpy(keys), t).numpy(),
                                      np.asarray(jht.hash_slot(jnp.asarray(keys), t)))
    # int64 keys hash by their low 32 bits, as the reference's uint32 cast
    k = torch.from_numpy(keys.astype(np.int64))
    for big in (k + 2**32, k - 2**40, k | (2**62)):
        assert torch.equal(tht.hash_owner(big, 1024), tht.hash_owner(k, 1024))
        assert torch.equal(tht.hash_slot(big, 65536), tht.hash_slot(k, 65536))


# ================================================================ port only
def _random_volume(rng, p: int, table: int, heap: int, pool) -> tht.LocalVolume:
    vol = tht.make_volume(table, heap, p, device="cpu")
    for _ in range(int(rng.integers(0, 4))):
        m = int(rng.integers(1, 3 * heap))
        vol = tht.owner_insert_plain(vol, torch.from_numpy(rng.choice(pool, (p, m))),
                                     torch.from_numpy(rng.integers(0, 100, (p, m))),
                                     torch.from_numpy(rng.random((p, m)) < 0.8))
    return vol


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_owner_insert_equals_the_loop(seed):
    """The tensor owner insert against the reference's loop: slot
    collisions (tables of 1-8 slots), duplicates (keys from a small pool,
    `EMPTY` and 64-bit keys among them), heaps that fill (1-8 cells) and
    invalid items, on every rank of a random volume."""
    rng = np.random.default_rng(seed)
    p, table, heap = (int(rng.integers(1, 4)), int(rng.integers(1, 9)),
                      int(rng.integers(1, 9)))
    pool = np.concatenate([rng.integers(-1, 30, 12), [tht.EMPTY, 2**40 + 3, -2**63]])
    vol = _random_volume(rng, p, table, heap, pool)
    m = int(rng.integers(0, 4 * heap + 4))
    keys = torch.from_numpy(rng.choice(pool, (p, m)).astype(np.int64))
    vals = torch.from_numpy(rng.integers(-2**62, 2**62, (p, m)))
    valid = torch.from_numpy(rng.random((p, m)) < 0.8)
    got = tht.owner_insert(vol, keys, vals, valid)
    want = tht.owner_insert_plain(vol, keys, vals, valid)
    for f, g, w in zip(FIELDS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f


def test_capacity_drops_are_exact_and_never_found():
    """Past `capacity_per_pair` an item is dropped at its origin and
    counted: every admitted key is found with its value, no dropped key is
    found, and the volume is the loop's over what was admitted."""
    m = Mesh(NP, "x", device="cpu")
    rng = np.random.default_rng(5)
    cap, n = 3, 10
    keys = rng.choice(100_000, NP * n, replace=False).reshape(NP, n)
    vals = rng.integers(0, 10**9, (NP, n))
    owner = np.asarray(tht.hash_owner(torch.from_numpy(keys), NP))
    # the first `cap` items of each (origin, owner) pair in program order
    admitted = np.zeros_like(keys, bool)
    for r in range(NP):
        for o in range(NP):
            admitted[r, np.flatnonzero(owner[r] == o)[:cap]] = True
    vol, dropped = tht.insert_epoch(tht.make_volume(TABLE, HEAP, NP, device="cpu"),
                                    torch.from_numpy(keys), torch.from_numpy(vals), m, cap)
    assert dropped.tolist() == (~admitted).sum(1).tolist()
    assert int(dropped.sum()) > 0
    got_v, got_f = tht.lookup_epoch(vol, torch.from_numpy(keys), m, n)
    assert got_f.numpy().tolist() == admitted.tolist()
    assert np.array_equal(got_v.numpy()[admitted], vals[admitted])


@pytest.mark.parametrize("p,n", [(4, 6), (256, 64)])
def test_send_counts_equal_the_one_hot_form(p, n):
    """`dsde._send_counts` counts by one scatter-add into [p, p] int32: the
    one-hot form's [p, n, p] int64 (32 MiB at p = 256, n = 64; 128 GiB at
    the hashtable's p = 1024, n = 16,384) is never made."""
    from torch.utils._python_dispatch import TorchDispatchMode

    g = torch.Generator().manual_seed(p)
    targets = torch.randint(0, p, (p, n), generator=g, dtype=torch.int32)
    targets[0] = p - 1                       # one rank sends everything to one target

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(o, torch.Tensor):
                    self.numel = max(self.numel, o.numel())
            return out

    with Largest() as mode:
        got = tdsde._send_counts(targets, p)
    want = torch.nn.functional.one_hot(targets.long(), p).sum(dim=1, dtype=torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert mode.numel <= max(p * p, p * n) < p * n * p


def test_volume_from_numpy_takes_declared_dtypes():
    leaves = [np.arange(4, dtype=np.int32).reshape(2, 2)] * 6 + [np.zeros(2, np.int64)] * 2
    vol = tht.volume_from_numpy(leaves, device="cpu")
    fresh = tht.make_volume(2, 2, 2, device="cpu")
    assert [a.dtype for a in vol] == [a.dtype for a in fresh]
    assert [a.shape for a in vol] == [a.shape for a in fresh]
    with pytest.raises(ValueError):
        tht.volume_from_numpy(leaves[:7], device="cpu")


if __name__ == "__main__":
    {"child": _child}[sys.argv[1]](pathlib.Path(sys.argv[2]))
