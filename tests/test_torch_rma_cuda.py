"""The four one-sided RMA CUDA kernels against their plain PyTorch versions,
and the plan's dispatch to them, on the card.  These tests carry the `cuda`
marker and skip where no card is present; the file imports no JAX, so it
runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rma_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collectives, plan  # noqa: E402
from repro_torch.core.rma import OpCounter  # noqa: E402
from repro_torch.kernels.rma import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

# (shape, dtype): whole 16-byte rows, rows of odd words, int32 words, p = 1,
# a view whose rank block is not contiguous (the wrapper copies it), and
# two halo slices read in place at their rank stride (16-byte rows and
# 5-word rows)
SHAPES = [((8, 4, 32), torch.float32), ((5, 3, 7), torch.float32),
          ((6, 8), torch.int32), ((1, 4, 3), torch.float32),
          ((16, 6, 2, 4), torch.float32), ((16, 6, 2, 4, 4), torch.float32),
          ((6, 3, 5, 1, 1), torch.float32)]
SHIFTS = [0, 1, -1, 3, 17]       # 17 >= p for every shape above


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _tensor(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g, device="cuda",
                             dtype=torch.int32)
    x = torch.randn(shape, generator=g, device="cuda")
    if len(shape) == 4:
        return x[:, :, -1:]                 # block not contiguous
    return x[:, -1:] if len(shape) == 5 else x          # rank-strided halo


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_copy_kernels_are_bit_equal_to_plain(card, shape, dtype, shift):
    x = _tensor(shape, dtype, seed=shift + 100)
    mesh = Mesh(x.shape[0], "x", device="cuda")
    before = dict(ops.launches)
    put, get = ops.put_shift(x, shift, mesh), ops.get_shift(x, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches["put_shift"] == before["put_shift"] + 1
    assert ops.launches["get_shift"] == before["get_shift"] + 1
    assert torch.equal(put, ref.put_shift_ref(x, shift, mesh))
    assert torch.equal(get, ref.get_shift_ref(x, shift, mesh))
    assert put.data_ptr() != x.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,dtype", [s for s in SHAPES if s[1] == torch.float32])
def test_accumulate_kernel_is_bit_equal_to_plain(card, shape, dtype, shift):
    x = _tensor(shape, dtype, seed=shift)
    acc = torch.randn(x.shape, device="cuda")
    mesh = Mesh(x.shape[0], "x", device="cuda")
    out = ops.accumulate_shift(x, acc, shift, mesh)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.accumulate_shift_ref(x, acc, shift, mesh))   # one f32 add


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_ring_all_gather_kernel_gives_every_receiver_every_block(card, shape, dtype):
    x = _tensor(shape, dtype, seed=7)
    mesh = Mesh(x.shape[0], "x", device="cuda")
    out = ops.ring_all_gather(x, mesh)
    torch.cuda.synchronize()
    assert out.shape == (mesh.p,) + tuple(x.shape)
    for receiver in range(mesh.p):
        assert torch.equal(out[receiver], x)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    mesh = Mesh(4, "x", device="cuda")
    with pytest.raises(TypeError):
        ops.put_shift(torch.ones(4, 3, device="cuda", dtype=torch.float64), 1, mesh)
    with pytest.raises(TypeError):
        ops.accumulate_shift(torch.ones(4, 3, device="cuda", dtype=torch.int32),
                             torch.ones(4, 3, device="cuda", dtype=torch.int32), 1, mesh)
    with pytest.raises(MeshError):
        ops.put_shift(torch.ones(4, 3, device="cuda"), 1, Mesh(5, "x", device="cuda"))
    with pytest.raises(ValueError):
        ops.accumulate_shift(torch.ones(4, 3, device="cuda"), torch.ones(4, 3), 1, mesh)


@pytest.mark.cuda
def test_plan_dispatches_shift_groups_to_the_kernel(card):
    mesh = Mesh(8, "x", device="cuda")
    x = torch.randn(8, 64, device="cuda")
    pl = plan.RmaPlan(mesh)
    hs = [pl.put_shift(x, 1), pl.get_shift(x, 2), pl.put_perm(x, [(0, 1), (1, 0)])]
    before = ops.launches["put_shift"]
    stats = pl.flush(aggregate=False, backend="cuda")
    torch.cuda.synchronize()
    assert ops.launches["put_shift"] - before == 2       # the perm takes the mesh
    assert stats.backends == {"cuda": 2, "torch": 1}
    assert torch.equal(hs[0].result(), torch.roll(x, 1, 0))
    assert torch.equal(hs[1].result(), torch.roll(x, -2, 0))
    assert torch.equal(hs[2].result()[1], x[0])
    # a packed group is 32-bit words: a forced kernel carries it too
    pl = plan.RmaPlan(mesh)
    h1, h2 = pl.put_shift(x, 3), pl.put_shift(x.double(), 3)
    stats = pl.flush(aggregate=True, backend="cuda")
    assert (stats.coalesced, stats.packed_groups) == (1, 1)
    assert torch.equal(h2.result(), torch.roll(x.double(), 3, 0))
    # unpacked, a 64-bit payload is not the kernel's to take
    pl = plan.RmaPlan(mesh)
    pl.put_shift(x.double(), 1)
    with pytest.raises(TypeError):
        pl.flush(aggregate=False, backend="cuda")


@pytest.mark.cuda
def test_auto_dispatch_takes_the_kernel_for_every_eligible_shift_group(card):
    mesh = Mesh(8, "x", device="cuda")
    x = torch.randn(8, 16, device="cuda")
    pl = plan.RmaPlan(mesh)
    hs = [pl.put_shift(x, 1), pl.put_shift(x.double(), 2), pl.put_perm(x, [(0, 1)])]
    before = ops.launches["put_shift"]
    stats = pl.flush()
    torch.cuda.synchronize()
    # the f32 shift takes the kernel; the 64-bit shift and the perm the mesh
    assert ops.launches["put_shift"] - before == 1
    assert stats.backends == {"cuda": 1, "torch": 2}
    assert torch.equal(hs[0].result(), torch.roll(x, 1, 0))
    assert torch.equal(hs[1].result(), torch.roll(x.double(), 2, 0))


@pytest.mark.cuda
def test_collectives_launch_the_put_kernel_as_counted(card):
    mesh = Mesh(8, "x", device="cuda")
    x = torch.randn(8, 1000, device="cuda")
    before = ops.launches["put_shift"]
    with OpCounter() as c:
        out = collectives.all_reduce(x, mesh)
    torch.cuda.synchronize()
    launched = ops.launches["put_shift"] - before
    assert launched == c.puts == (8 - 1) + 2 * 4
    torch.testing.assert_close(out, x.sum(0, keepdim=True).expand_as(x), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_milc_step_launches_two_puts_on_the_halo_views(card):
    from repro_torch.apps import milc

    mesh = Mesh(64, "t", device="cuda")
    lat = torch.randn(64, 4, 4, 4, 4, 6, device="cuda")
    before = ops.launches["put_shift"]
    out = milc.stencil_step(lat, mesh)
    torch.cuda.synchronize()
    assert ops.launches["put_shift"] - before == 2
    torch.testing.assert_close(out, milc.stencil_reference(lat), rtol=0, atol=1e-5)
