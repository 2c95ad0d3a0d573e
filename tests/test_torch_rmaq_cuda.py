"""The rmaq CUDA kernels (notified_put, notify_accumulate, queue_push)
against their plain PyTorch versions on the card.  These tests carry the
`cuda` marker and skip where no card is present; the file imports no JAX,
so it runs on the GPU host as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rmaq_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmaq import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh, MeshError  # noqa: E402

# payload (shape, dtype): whole 16-byte rows, rows of odd words, int32
# words, p = 1, and a halo slice read in place at its rank stride
SHAPES = [((8, 4, 32), torch.float32), ((5, 3, 7), torch.float32),
          ((6, 8), torch.int32), ((1, 4, 3), torch.float32),
          ((6, 3, 5, 1, 1), torch.float32)]
SHIFTS = [0, 1, -1, 3, 17]       # 17 >= p for every shape above


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _ints(shape, g, lo=-2**31, hi=2**31 - 1):
    return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_notified_put_is_bit_equal_to_plain(card, shape, dtype, shift):
    g = _gen(shift + 3)
    x = (_ints(shape, g) if dtype == torch.int32
         else torch.randn(shape, generator=g, device="cuda"))
    if len(shape) == 5:
        x = x[:, -1:]                        # rank-strided halo, read in place
    mesh = Mesh(x.shape[0], "x", device="cuda")
    cnt = _ints((mesh.p,), g)
    before = ops.launches["notified_put"]
    y, c = ops.notified_put(x, cnt, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches["notified_put"] == before + 1
    want_y, want_c = ref.notified_put_ref(x, cnt, shift, mesh)
    assert torch.equal(y, want_y) and torch.equal(c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("p", [1, 5, 4096])
def test_notify_accumulate_wraps_like_int32(card, p, shift):
    g = _gen(p + shift)
    mesh = Mesh(p, "x", device="cuda")
    cnt = _ints((p,), g, 2**10, 2**20)
    local = _ints((p,), g, 2**31 - 2**10, 2**31 - 1)    # every sum passes 2**31
    before = ops.launches["notify_accumulate"]
    out = ops.notify_accumulate(cnt, local, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches["notify_accumulate"] == before + 1
    assert torch.equal(out, ref.notify_accumulate_ref(cnt, local, shift, mesh))
    assert bool((out < 0).all())


def _push_case(p, cap, w, k, used, tail, seed):
    g = _gen(seed)
    buf = torch.randn(p, cap, w, generator=g, device="cuda")
    tail = torch.as_tensor(tail, dtype=torch.int64, device="cuda").expand(p)
    used = torch.as_tensor(used, dtype=torch.int64, device="cuda").expand(p)
    ctr = torch.stack([(tail - used) & 0xFFFFFFFF, tail & 0xFFFFFFFF], 1)
    ctr = ctr.to(torch.int32).contiguous()
    msgs = torch.randn(p, k, w, generator=g, device="cuda")
    return buf, ctr, msgs


def _push_both(buf, ctr, msgs, shift, mesh):
    before = ops.launches["queue_push"]
    got = ops.queue_push(buf.clone(), ctr.clone(), msgs, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches["queue_push"] == before + 1
    want = ref.queue_push_ref(buf.clone(), ctr.clone(), msgs, shift, mesh, buf.shape[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("p,cap,w,k,used,tail", [
    (4, 8, 4, 5, 0, 0),                       # empty ring
    (4, 8, 4, 5, 5, 5),                       # 3 free: backpressure
    (4, 8, 3, 5, 0, 6),                       # slots wrap past the ring's end
    (8, 16, 2, 6, [0, 3, 10, 16, 15, 1, 2, 12], 2**32 - 3),   # counters wrap 2**32
    (3, 8, 5, 4, 0, 2**31 - 2),               # tail crosses 2**31
    (1, 4, 7, 6, 1, 2**32 - 1),               # p = 1, more messages than room
    (4096, 131072, 2, 6, 0, 0),               # the DSDE queue's ring
])
def test_queue_push_is_bit_equal_to_plain(card, p, cap, w, k, used, tail, shift):
    mesh = Mesh(p, "x", device="cuda")
    buf, ctr, msgs = _push_case(p, cap, w, k, used, tail, seed=p + k + shift)
    _, ctr2, n_sent, n_notif = _push_both(buf, ctr, msgs, shift, mesh)
    src = (torch.arange(p, device="cuda") - shift) % p
    assert torch.equal(n_notif, n_sent[src])           # one producer a target
    free = cap - torch.as_tensor(used, device="cuda").expand(p)
    assert torch.equal(n_notif.long(), torch.clamp(free, max=k))


@pytest.mark.cuda
def test_queue_push_never_writes_a_rejected_row(card):
    """The reference routes rejected rows to a trash row; here they are not
    written at all: a full ring stays bit-identical, its tail unmoved."""
    mesh = Mesh(4, "x", device="cuda")
    buf, ctr, msgs = _push_case(4, 8, 4, 5, 8, 2**32 - 1, seed=9)
    out, ctr2, n_sent, n_notif = _push_both(buf, ctr, msgs, 1, mesh)
    assert torch.equal(out, buf) and torch.equal(ctr2, ctr)
    assert n_sent.tolist() == n_notif.tolist() == [0] * 4


@pytest.mark.cuda
def test_queue_push_updates_the_ring_in_place(card):
    mesh = Mesh(4, "x", device="cuda")
    buf, ctr, msgs = _push_case(4, 8, 4, 2, 0, 0, seed=1)
    out, ctr2, _, _ = ops.queue_push(buf, ctr, msgs, 1, mesh)
    assert out.data_ptr() == buf.data_ptr() and ctr2.data_ptr() == ctr.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(buf[1, :2], msgs[0]) and ctr[:, 1].tolist() == [2] * 4


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    mesh = Mesh(4, "x", device="cuda")
    cnt = torch.ones(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ops.notified_put(torch.ones(4, 3, dtype=torch.float64, device="cuda"), cnt, 1, mesh)
    with pytest.raises(TypeError):
        ops.notified_put(torch.ones(4, 3, device="cuda"), cnt.long(), 1, mesh)
    with pytest.raises(TypeError):
        ops.notify_accumulate(cnt.float(), cnt, 1, mesh)
    with pytest.raises(ValueError):
        ops.notify_accumulate(cnt, cnt.cpu(), 1, mesh)
    with pytest.raises(MeshError):
        ops.notified_put(torch.ones(5, 3, device="cuda"), cnt, 1, mesh)
    ctr = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
    ring = torch.zeros(4, 8, 2, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        ops.queue_push(ring, ctr, torch.zeros(4, 1, 2, dtype=torch.float64, device="cuda"),
                       1, mesh)
    ring = torch.zeros(4, 2, 8, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="in place"):
        ops.queue_push(ring, ctr, torch.zeros(4, 1, 2, device="cuda"), 1, mesh)
