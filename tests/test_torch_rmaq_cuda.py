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
@pytest.mark.parametrize("shift", [0, 1, -1, 17])
@pytest.mark.parametrize("p,cap,w,k,used,tail", [
    (6, 16, 1, 5, 0, 2**32 - 2),              # one word a row
    (6, 16, 4, 5, 3, 7),                      # one 16-byte vector a row
    (6, 16, 8, 5, 0, 14),                     # two vectors a row
    (5, 8, 64, 3, 2, 2**31 - 1),              # 16 vectors a row, two rows a pass
    (3, 8, 130, 4, 0, 6),                     # 65 8-byte vectors: three passes a row
    (4, 8, 4, 0, 0, 0),                       # k = 0
    (4, 64, 3, 40, 10, 2**32 - 20),           # more rows than lanes, all admitted
    (4, 64, 2, 40, [30, 60, 64, 0], 5),       # more rows than lanes, backpressured
    (4, 8, 4, 5, [11, 9, 2**31, 8], 3),       # over-full rings: accept <= 0
    (4, 8, 4, 5, 2**32 - 1, 3),               # head one past tail: free 9, accept k
    (6, 16, 2, 1, 0, 2**32 - 1),              # one lane a producer
    (6, 16, 4, 3, [0, 14, 15, 16, 2, 7], 9),  # four lanes a producer
    (4097, 16, 2, 6, 0, 0),                   # not a multiple of a block's producers
    (9000, 8, 3, 12, 5, 2**31 + 3),           # more producers than one wave's warps
])
def test_queue_push_rows_and_vectors_are_bit_equal(card, p, cap, w, k, used, tail, shift):
    """Word, 8- and 16-byte copies, rows over several passes, k = 0, more
    rows than lanes, over-full rings (the reference's accept <= 0: nothing
    written, tail + accept published), groups of 1 to 32 lanes a producer,
    a ragged last block and a grid-stride loop."""
    mesh = Mesh(p, "x", device="cuda")
    buf, ctr, msgs = _push_case(p, cap, w, k, used, tail, seed=3 * p + w + k + shift)
    _push_both(buf, ctr, msgs, shift, mesh)


def _at(t, words):
    """A contiguous copy of t whose data pointer is `words` 32-bit words past
    a 16-byte boundary (a fresh buffer also at words = 0)."""
    flat = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)[words:]
    flat.copy_(t.flatten())
    return flat.view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("layout", ["msgs 1 word off", "msgs 2 words off", "ring 2 words off",
                                    "ring and msgs 1 word off", "ctr 1 word off"])
@pytest.mark.parametrize("w", [2, 4, 8])
def test_queue_push_unaligned_views_are_bit_equal(card, w, layout, shift):
    """Inputs at pointers that are not 16-byte aligned: the copy falls back
    to 8-byte vectors or words, and a counter pair that is not 8-byte
    aligned is read as two words."""
    p, cap, k = 6, 16, 5
    mesh = Mesh(p, "x", device="cuda")
    buf, ctr, msgs = _push_case(p, cap, w, k, [0, 3, 12, 16, 1, 9], 2**32 - 2, seed=w + shift)
    ring_off = {"ring 2 words off": 2, "ring and msgs 1 word off": 1}.get(layout, 0)
    msgs_off = {"msgs 1 word off": 1, "msgs 2 words off": 2,
                "ring and msgs 1 word off": 1}.get(layout, 0)
    k_buf, k_ctr = _at(buf, ring_off), _at(ctr, 1 if layout == "ctr 1 word off" else 0)
    k_msgs = _at(msgs, msgs_off)
    assert k_buf.is_contiguous() and k_ctr.is_contiguous() and k_msgs.is_contiguous()
    assert (k_buf.data_ptr() % 16, k_msgs.data_ptr() % 16) == (4 * ring_off, 4 * msgs_off)
    before = ops.launches["queue_push"]
    got = ops.queue_push(k_buf, k_ctr, k_msgs, shift, mesh)
    torch.cuda.synchronize()
    assert ops.launches["queue_push"] == before + 1
    want = ref.queue_push_ref(buf.clone(), ctr.clone(), msgs, shift, mesh, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_queue_push_twice_on_copies_is_bit_equal(card):
    """The same push on two copies of one state: rings, counters and counts
    bit-equal (each warp owns its target; no order between warps shows)."""
    p, cap, w, k = 4096, 64, 2, 6
    g = _gen(21)
    mesh = Mesh(p, "x", device="cuda")
    used = torch.randint(0, cap + 1, (p,), generator=g, device="cuda").tolist()
    buf, ctr, msgs = _push_case(p, cap, w, k, used, 2**32 - 3, seed=22)
    first = ops.queue_push(buf.clone(), ctr.clone(), msgs, 7, mesh)
    second = ops.queue_push(buf.clone(), ctr.clone(), msgs, 7, mesh)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert bool((first[2] < k).any()) and bool((first[2] == k).any())


@pytest.mark.cuda
def test_queue_push_counts_are_two_rows_of_one_buffer(card):
    """n_sent and n_notif are the rows of one [2, p] int32 tensor: distinct
    storage offsets, each a contiguous [p] row, each holding its own counts."""
    p, cap, w, k, shift = 8, 16, 2, 6, 3
    mesh = Mesh(p, "x", device="cuda")
    buf, ctr, msgs = _push_case(p, cap, w, k, [0, 11, 16, 12, 10, 14, 15, 13], 9, seed=5)
    _, _, n_sent, n_notif = _push_both(buf, ctr, msgs, shift, mesh)
    assert n_sent._base is not None and n_sent._base is n_notif._base
    assert n_sent._base.shape == (2, p) and n_sent._base.dtype == torch.int32
    assert n_notif.data_ptr() == n_sent.data_ptr() + 4 * p
    assert n_sent.is_contiguous() and n_notif.is_contiguous()
    src = (torch.arange(p, device="cuda") - shift) % p
    assert torch.equal(n_notif, n_sent[src]) and not torch.equal(n_notif, n_sent)


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


def _offset(t, words):
    """t's values at a data pointer `words` 32-bit words past a 16-byte
    boundary (words = 0: t itself)."""
    if not words:
        return t
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    out = buf[words:]
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "cnt offset", "all offset"])
@pytest.mark.parametrize("shift", [0, 1, -1, 4, -8, 4103])
@pytest.mark.parametrize("p", [1, 4, 5, 4096, 4099])
def test_notify_accumulate_runs_and_vectors_are_bit_equal(card, p, shift, layout):
    """The two runs of the rotation with 16-byte vectors of local and out
    (and of cnt where off and p are multiples of 4), single words where a
    pointer is not 16-byte aligned; sums past 2**31 wrap."""
    g = _gen(7 * p + shift)
    mesh = Mesh(p, "x", device="cuda")
    cnt = _offset(_ints((p,), g), 1 if layout != "aligned" else 0)
    local = _offset(_ints((p,), g), 3 if layout == "all offset" else 0)
    out = ops.notify_accumulate(cnt, local, shift, mesh)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.notify_accumulate_ref(cnt, local, shift, mesh))


@pytest.mark.cuda
def test_notify_accumulate_three_calls_one_launch_each(card):
    g = _gen(11)
    mesh = Mesh(4096, "x", device="cuda")
    cnt, local = _ints((4096,), g), _ints((4096,), g)
    before = ops.launches["notify_accumulate"]
    outs = [ops.notify_accumulate(cnt, local, 1, mesh) for _ in range(3)]
    torch.cuda.synchronize()
    assert ops.launches["notify_accumulate"] == before + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], ref.notify_accumulate_ref(cnt, local, 1, mesh))


@pytest.mark.cuda
def test_notify_accumulate_launches_on_the_callers_stream(card):
    """Launched on a side stream right after work queued there that makes
    its input: the kernel must run on that stream, after the work."""
    from repro_torch.kernels import common

    g = _gen(12)
    mesh = Mesh(4096, "x", device="cuda")
    base, local = _ints((4096,), g, 0, 2**20), _ints((4096,), g, 0, 2**20)
    a = torch.randn(4096, 4096, generator=g, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert common.current_stream(torch.cuda.current_device()) == side.cuda_stream
        b = a
        for _ in range(8):
            b = b @ a * 1e-3                       # milliseconds of work on `side`
        cnt = base + (b[0, 0] * 0).to(torch.int32)  # the input, made after it
        out = ops.notify_accumulate(cnt, local, 1, mesh)
    side.synchronize()
    assert torch.equal(out, ref.notify_accumulate_ref(base, local, 1, mesh))
