"""RMA windows (paper §2.2) of the PyTorch port against the JAX reference,
in-process on one host device.

The reference's `TestWindows` (`tests/test_core_protocols.py`) replayed on
both packages: the four creation modes, the same `metadata_nbytes` for the
same arguments, one scripted attach / detach / lookup sequence with equal
`attach_id`, `DescriptorCache.remote_ops` and `WindowError`s, and the
descriptor cache's charge to a host fabric (`tests/test_sim.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fabric as jfabric  # noqa: E402
from repro.core import window as jwin  # noqa: E402
from repro_torch.core import fabric as tfabric  # noqa: E402
from repro_torch.core import window as twin  # noqa: E402
from repro_torch.core.epoch import SyncStats  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402


class _Ref:
    """The reference's creation calls, shaped like the port's."""

    win, f32, i32 = jwin, jnp.float32, jnp.int32

    def __init__(self):
        self.mesh = jax.make_mesh((1,), ("w",))

    def allocate(self, shape, dtype=jnp.float32):
        return jwin.win_allocate(self.mesh, "w", shape, dtype)

    def create(self, offsets, shape):
        return jwin.win_create(offsets, self.mesh, "w", shape)

    def dynamic(self):
        return jwin.win_create_dynamic(self.mesh, "w")

    def shared(self, shape):
        return jwin.win_allocate_shared(self.mesh, "w", shape)


class _Port:
    win, f32, i32 = twin, torch.float32, torch.int32

    def __init__(self, p=1):
        self.mesh = Mesh(p, "w", device="cpu")

    def allocate(self, shape, dtype=torch.float32):
        return twin.win_allocate(self.mesh, shape, dtype)

    def create(self, offsets, shape):
        return twin.win_create(offsets, self.mesh, shape)

    def dynamic(self):
        return twin.win_create_dynamic(self.mesh)

    def shared(self, shape):
        return twin.win_allocate_shared(self.mesh, shape)


BOTH = [_Ref, _Port]


def _both(fn):
    """fn(api) for each package; returns the two results."""
    return [fn(cls()) for cls in BOTH]


@pytest.mark.parametrize("shape", [(8, 8), (512, 512), (3,)])
def test_allocated_window_metadata_is_o1(shape):
    ref, port = _both(lambda a: (a.allocate(shape)[0].metadata_nbytes(),
                                 a.allocate((4,))[0].metadata_nbytes()))
    assert ref == port == (64, 64)


def test_traditional_window_metadata_is_omega_p():
    """win_create stores the per-rank offset table: 8 bytes a rank."""
    ref, port = _both(lambda a: (a.create(np.zeros(1, np.int64), (4,))[0].metadata_nbytes(),
                                 a.create(np.zeros(1, np.int64), (4,))[0].base_offsets.nbytes))
    assert ref == port == (72, 8)
    wide = _Port(p=4)
    win, buf = wide.create([0, 64, 128, 192], (4,))
    assert win.metadata_nbytes() == 64 + 8 * 4 and win.kind == "create"
    assert tuple(buf.shape) == (4, 4) and not buf.any()


def test_win_create_needs_one_offset_per_rank():
    for a in (_Ref(), _Port()):
        with pytest.raises(a.win.WindowError, match="one base offset per rank"):
            a.create(np.zeros(2, np.int64), (4,))


def test_dynamic_window_scripted_sequence():
    """One attach / detach / lookup script on both packages: equal
    attach_id, remote_ops, metadata bytes and errors after every step."""

    def script(a):
        win = a.dynamic()
        cache = a.win.DescriptorCache()
        log = [win.metadata_nbytes()]

        def step(fn):
            try:
                res = fn()
                res = res[1] if isinstance(res, tuple) else res
            except a.win.WindowError as e:
                res = f"WindowError: {e}"
            log.append((res, win.attach_id, cache.remote_ops, win.metadata_nbytes()))

        r1 = win.attach("kv", (8,), a.f32)
        r2 = win.attach("grads", (4, 4), a.f32)
        step(lambda: cache.lookup(win, r1))         # cold: id check + 2 regions
        step(lambda: cache.lookup(win, r2))         # warm: id check only
        r3 = win.attach("acts", (2,), a.i32)
        step(lambda: cache.lookup(win, r3))         # refetch all 3
        step(lambda: cache.lookup(win, r1))
        step(lambda: win.detach(r2))
        step(lambda: cache.lookup(win, r1))         # refetch 2
        step(lambda: cache.lookup(win, r2))         # detached: refused
        step(lambda: win.detach(r2))                # unknown region
        step(lambda: win.detach(7))
        for _ in range(3):
            win.attach_id += 1                      # remote attaches elsewhere
            step(lambda: cache.lookup(win, r3))
        for _ in range(4):
            step(lambda: cache.lookup(win, r3))
        return log

    ref, port = _both(script)
    assert ref == port
    assert [entry[2] for entry in port[1:4]] == [3, 4, 8]


def test_attach_id_monotone_and_metadata_o1_per_region():
    def script(a):
        win = a.dynamic()
        base = win.metadata_nbytes()
        ids = []
        for i in range(4):
            win.attach(f"r{i}", (2,), a.f32)
            ids.append(win.attach_id)
        return base, ids, win.metadata_nbytes(), sorted(win.regions)

    ref, port = _both(script)
    assert ref == port == (64, [1, 2, 3, 4], 64 + 4 * 48, [0, 1, 2, 3])


@pytest.mark.parametrize("mode", ["allocate", "create", "shared"])
def test_attach_and_detach_need_a_dynamic_window(mode):
    for a in (_Ref(), _Port()):
        win = (a.create(np.zeros(1, np.int64), (4,)) if mode == "create"
               else getattr(a, mode)((4,)))[0]
        with pytest.raises(a.win.WindowError, match="attach requires a dynamic window"):
            win.attach("x", (2,), a.f32)
        with pytest.raises(a.win.WindowError, match="detach requires a dynamic window"):
            win.detach(0)


def test_shared_window_same_layout_as_allocated():
    ref, port = _both(lambda a: (a.allocate((4, 4))[0].global_shape(),
                                 a.shared((4, 4))[0].global_shape(),
                                 a.shared((4, 4))[0].kind,
                                 a.shared((4, 4))[0].metadata_nbytes()))
    assert ref == port == ((1, 4, 4), (1, 4, 4), "shared", 64)
    wa, ba = _Port(p=3).allocate((4, 4))
    ws, bs = _Port(p=3).shared((4, 4))
    assert ba.shape == bs.shape == (3, 4, 4) and wa.axis == ws.axis == "w"


def test_win_allocate_zeroes_on_the_mesh_device():
    win, buf = _Port(p=2).allocate((3, 5), torch.int32)
    assert buf.device.type == "cpu" and buf.dtype == torch.int32
    assert tuple(buf.shape) == win.global_shape() == (2, 3, 5) and not buf.any()
    assert (win.kind, win.n_ranks, win.disp_unit) == ("allocate", 2, 1)


def test_descriptor_cache_charges_fabric():
    """`tests/test_sim.py`'s case on both packages: a window used as a
    descriptor only (no mesh), lookups charged to the fabric as gets."""
    out = []
    for win_mod, fab_mod, dtype in ((jwin, jfabric, jnp.dtype(jnp.float32)),
                                    (twin, tfabric, torch.float32)):
        if win_mod is jwin:
            win = win_mod.Window("dynamic", None, "x", (), dtype)
        else:
            win = win_mod.Window("dynamic", None, (), dtype)
        fab = fab_mod.LocalFabric()
        cache = win_mod.DescriptorCache(fabric=fab)
        rid = win.attach("a", (4,), dtype)
        cache.lookup(win, rid)
        cache.lookup(win, rid)                     # warm: 1 op, not a refetch
        out.append((cache.remote_ops, fab.ops.gets, fab.ops.snapshot()))
    assert out[0] == out[1]
    assert out[1][0] == out[1][1] == 3
    assert twin.win_create_dynamic(None).axis is None


def test_fabric_ledger_is_private_and_diffs():
    """The fabric's op ledger counts apart from the active `OpCounter`s;
    `delta` diffs two snapshots."""
    fab = tfabric.LocalFabric()
    cache = twin.DescriptorCache(fabric=fab)
    win = twin.win_create_dynamic(None)
    rid = win.attach("a", (4,), torch.float32)
    with OpCounter() as c:
        cache.lookup(win, rid)
    before = fab.snapshot()
    cache.lookup(win, rid)
    assert c.snapshot()["raw_msgs"] == 0
    assert before["gets"] == before["raw_msgs"] == before["coalesced_msgs"] == 2
    sync0 = {f"sync_{k}": 0 for k in SyncStats().snapshot()}
    assert fab.delta(before) == {"puts": 0, "gets": 1, "accs": 0, "colls": 0,
                                 "raw_msgs": 1, "coalesced_msgs": 1, "by_axis": {},
                                 **sync0, "epoch": 0}
    assert not any(v for v in fab.delta(fab).values() if not isinstance(v, dict))
