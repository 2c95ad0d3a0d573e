"""The kernels' one launch path (`kernels.common.Entry`), on the CPU.

Every C entry of ``src/repro_torch/csrc/*.cu`` is bound by exactly one
`Entry`, whose ``argtypes`` match its ``extern "C"`` declaration (the number
of arguments; a pointer, ``long long``, ``int`` or ``float`` at each place;
the stream last).  A binding is made once, on the first launch, and a
refused launch raises.  A CUDA tensor on a machine without a card goes to
the launch path and raises there; it is never computed on the CPU.  The
CUDA tensors here are `FakeTensorMode`'s: they carry a CUDA device and a
shape but no storage, so this needs neither a card nor JAX.
"""

import ctypes
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paops  # noqa: E402
from repro_torch.kernels.paged_gather import ops as pgops  # noqa: E402
from repro_torch.kernels.ring_matmul import ops as rmops  # noqa: E402
from repro_torch.kernels.rma import ops as rmaops  # noqa: E402
from repro_torch.kernels.rmaq import ops as rmaqops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as sops  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.rmem import pages as tpg  # noqa: E402

CSRC = pathlib.Path(common.CSRC)
_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _declarations() -> dict:
    """symbol -> (source, ctypes type of each parameter) from the .cu files."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for sym, params in _DECL.findall(path.read_text()):
            types = []
            for param in params.split(","):
                param = " ".join(param.split())
                if "*" in param:
                    types.append(ctypes.c_void_p)
                elif param.startswith("long long "):
                    types.append(ctypes.c_longlong)
                elif param.startswith("int "):
                    types.append(ctypes.c_int)
                elif param.startswith("float "):
                    types.append(ctypes.c_float)
                else:
                    raise AssertionError(f"{path.name}: {sym}: unknown parameter {param!r}")
            out[sym] = (path.stem, types)
    return out


DECLS = _declarations()


def test_every_c_entry_has_one_binding():
    assert len(DECLS) == 28
    assert set(common.ENTRIES) == set(DECLS)


@pytest.mark.parametrize("symbol", sorted(DECLS))
def test_bound_argtypes_match_the_declaration(symbol):
    source, types = DECLS[symbol]
    entry = common.ENTRIES[symbol]
    assert entry.source == source
    assert len(entry.argtypes) == len(types), (symbol, entry.argtypes, types)
    assert list(entry.argtypes) == types
    assert entry.argtypes[-1] is ctypes.c_void_p            # the stream, last


class _FakeFn:
    def __init__(self, rc: int = 0):
        self.argtypes = self.restype = None
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _fake_library(monkeypatch, fn) -> dict:
    counts = {"load": 0, "lookup": 0}

    class Lib:
        def __getattr__(self, name):
            counts["lookup"] += 1
            return fn

    def load(name):
        counts["load"] += 1
        return Lib()

    monkeypatch.setattr(common, "load", load)
    return counts


@pytest.mark.parametrize("symbol", ["rmaq_notify_accumulate", "paged_gather_shift", "rma_put_shift"])
def test_a_binding_is_made_once(monkeypatch, symbol):
    entry = common.ENTRIES[symbol]
    monkeypatch.setattr(entry, "fn", None)
    fn = _FakeFn()
    counts = _fake_library(monkeypatch, fn)
    args = tuple(range(len(entry.argtypes)))
    for _ in range(3):
        entry(*args)
    assert counts == {"load": 1, "lookup": 1}
    assert fn.calls == [args] * 3
    assert fn.argtypes == entry.argtypes and fn.restype is ctypes.c_int
    assert entry.fn is fn


def test_a_refused_launch_raises(monkeypatch):
    entry = common.ENTRIES["rmaq_notify_accumulate"]
    monkeypatch.setattr(entry, "fn", None)
    _fake_library(monkeypatch, _FakeFn(rc=1))
    with pytest.raises(RuntimeError, match="rmaq.rmaq_notify_accumulate failed: cudaError 1"):
        entry(*range(len(entry.argtypes)))


def test_an_entry_is_bound_to_one_symbol_only():
    with pytest.raises(ValueError, match="bound twice"):
        common.Entry("rmaq", "rmaq_notify_accumulate", [])


def test_the_stream_lookup_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the lookup succeeds")
    with pytest.raises(RuntimeError):
        common.current_stream(0)


class _Reached(Exception):
    """Raised by the stand-in stream lookup: the launch path was taken."""


def _boom(*a, **k):
    raise AssertionError("a CUDA tensor was computed on the CPU")


def _card_calls():
    """(name, plain functions that must not run, call on fake CUDA tensors)."""
    m4 = Mesh(4, "x", device="cpu")
    cuda = dict(device="cuda")

    def f32(*shape):
        return torch.empty(*shape, **cuda)

    def i32(*shape):
        return torch.empty(*shape, dtype=torch.int32, **cuda)

    rma, rmaq = rmaops.ref, rmaqops.ref
    return [
        ("put_shift", [(rma, "put_shift_ref")],        # a halo view at rank stride 24
         lambda: rmaops.put_shift(torch.empty_strided((4, 2, 8), (24, 8, 1), **cuda), 1, m4)),
        ("get_shift", [(rma, "get_shift_ref")], lambda: rmaops.get_shift(f32(4, 6), 1, m4)),
        ("accumulate_shift", [(rma, "accumulate_shift_ref")],
         lambda: rmaops.accumulate_shift(f32(4, 6), f32(4, 6), 1, m4)),
        ("ring_all_gather", [(rma, "ring_all_gather_ref")],
         lambda: rmaops.ring_all_gather(f32(4, 6), m4)),
        ("notified_put", [(rmaq, "notified_put_ref")],
         lambda: rmaqops.notified_put(f32(4, 6), i32(4), 1, m4)),
        ("notify_accumulate", [(rmaq, "notify_accumulate_ref")],
         lambda: rmaqops.notify_accumulate(i32(4), i32(4), 1, m4)),
        ("queue_push", [(rmaq, "queue_push_ref")],
         lambda: rmaqops.queue_push(f32(4, 8, 3), i32(4, 2), f32(4, 2, 3), 1, m4)),
        ("paged_gather", [(pgops.ref, "paged_gather_ref"), (pgops.ref, "paged_gather_holes_ref")],
         lambda: pgops.paged_gather(f32(4, 6, 8), i32(4, 5), 1, m4)),
        ("gather_shift", [(pgops.ref, "paged_gather_ref"), (pgops.ref, "paged_gather_holes_ref")],
         lambda: tpg.gather_shift(m4, f32(4, 6, 8), i32(4, 5), 1)),
        ("paged_attention", [(paops.ref, "paged_attention_ref")],
         lambda: paops.paged_attention(f32(3, 1, 32), f32(10, 4, 2, 32), i32(3, 5))),
        ("paged_attention_shift", [(paops.ref, "paged_attention_shift_ref")],
         lambda: paops.paged_attention_shift(f32(4, 1, 32), f32(4, 10, 4, 2, 32), i32(4, 5), 1, m4)),
        ("flash_attention", [(fops, "attention_ref")],
         lambda: fops.flash_attention(f32(1, 2, 8, 16), f32(1, 2, 8, 16), f32(1, 2, 8, 16))),
        ("ssm_scan", [(sops, "ssm_scan_ref")],
         lambda: sops.ssm_scan(f32(1, 4, 8, 4), f32(1, 4, 8, 4), f32(1, 4, 4))),
        ("ring_matmul", [(rmops, "ring_schedule_ref")],
         lambda: rmops.ring_matmul(f32(32, 16), f32(4, 8, 16), m4)),
    ]


CARD_CALLS = {name: (plain, call) for name, plain, call in _card_calls()}


@pytest.mark.parametrize("name", sorted(CARD_CALLS))
def test_a_cuda_tensor_goes_to_the_launch_and_never_to_the_cpu(monkeypatch, name):
    """Every ops entry point, given CUDA tensors, reaches the stream lookup
    that precedes its launch; the plain version never runs and no launch is
    counted."""
    plain, call = CARD_CALLS[name]
    for mod, fn in plain:
        monkeypatch.setattr(mod, fn, _boom)

    def reached(device):
        assert device == 0
        raise _Reached

    monkeypatch.setattr(common, "current_stream", reached)
    counts = [dict(rmaops.launches), dict(rmaqops.launches), pgops.launches, paops.launches,
              paops.shift_launches, fops.launches, sops.launches, rmops.launches]
    with FakeTensorMode(), pytest.raises(_Reached):
        call()
    assert counts == [dict(rmaops.launches), dict(rmaqops.launches), pgops.launches,
                      paops.launches, paops.shift_launches, fops.launches, sops.launches,
                      rmops.launches]


def test_a_cuda_tensor_without_nvcc_raises_at_the_build(monkeypatch):
    """With a stream to launch on, the first launch builds the library: on a
    machine without nvcc that raises, and the entry stays unbound."""
    entry = common.ENTRIES["rma_put_shift"]
    monkeypatch.setattr(entry, "fn", None)
    monkeypatch.setattr(common, "_LIBS", {})
    monkeypatch.setattr(common, "current_stream", lambda device: 0)
    monkeypatch.setattr(rmaops.ref, "put_shift_ref", _boom)

    def build(name):
        assert name == "rma"
        raise common.KernelBuildError("no nvcc here")

    monkeypatch.setattr(common, "build", build)
    with FakeTensorMode():
        x = torch.empty(4, 6, device="cuda")
        with pytest.raises(common.KernelBuildError, match="no nvcc"):
            rmaops.put_shift(x, 1, Mesh(4, "x", device="cpu"))
    assert entry.fn is None


class _Ops(TorchDispatchMode):
    """Records the ATen ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
           "zeros", "zeros_like", "new_zeros", "ones", "full", "clone", "_to_copy"}


def test_queue_push_allocates_one_output(monkeypatch):
    """On fake CUDA tensors `queue_push` makes one [2, p] int32 tensor, the
    only allocation of the call; n_sent and n_notif are its two rows, and
    the kernel gets their pointers 4p bytes apart.  One launch is counted."""
    fn = _FakeFn()
    monkeypatch.setattr(rmaqops._PUSH, "fn", fn)
    monkeypatch.setattr(common, "current_stream", lambda device: 0)
    monkeypatch.setattr(rmaqops.ref, "queue_push_ref", _boom)
    p = 5
    m5 = Mesh(p, "x", device="cpu")
    before = rmaqops.launches["queue_push"]
    with FakeTensorMode():
        buf = torch.empty(p, 8, 3, device="cuda")
        ctr = torch.empty(p, 2, dtype=torch.int32, device="cuda")
        msgs = torch.empty(p, 2, 3, device="cuda")
        with _Ops() as seen:
            out_buf, out_ctr, n_sent, n_notif = rmaqops.queue_push(buf, ctr, msgs, 1, m5)
    assert [n for n in seen.names if n in _ALLOCS] == ["new_empty"]
    assert out_buf is buf and out_ctr is ctr
    assert n_sent._base is n_notif._base and n_sent._base.shape == (2, p)
    assert (n_sent.storage_offset(), n_notif.storage_offset()) == (0, p)
    for t in (n_sent, n_notif):
        assert t.shape == (p,) and t.dtype == torch.int32 and t.is_cuda and t.is_contiguous()
    assert rmaqops.launches["queue_push"] == before + 1
    (args,) = fn.calls
    assert args[4] - args[3] == 4 * p
    assert args[5:] == (p, 8, 2, 3, 1, 0)            # p, cap, k, w, shift; the stream


def _on(dtype, *shape):
    return torch.empty(*shape, dtype=dtype, device="cuda")


F32, F64, I32, I64 = torch.float32, torch.float64, torch.int32, torch.int64
QUEUE_PUSH_REFUSALS = {    # name -> (error, message, (ring, counters, messages))
    "capacity not a power of two": (ValueError, "power of two", lambda: (
        _on(F32, 4, 6, 2), _on(I32, 4, 2), _on(F32, 4, 1, 2))),
    "int64 counters": (TypeError, "int32", lambda: (
        _on(F32, 4, 8, 2), _on(I64, 4, 2), _on(F32, 4, 1, 2))),
    "rows of another width": (ValueError, "do not fit", lambda: (
        _on(F32, 4, 8, 2), _on(I32, 4, 2), _on(F32, 4, 1, 3))),
    "64-bit words": (TypeError, "32-bit words", lambda: (
        _on(F64, 4, 8, 2), _on(I32, 4, 2), _on(F64, 4, 1, 2))),
    "a ring that is not contiguous": (ValueError, "in place", lambda: (
        _on(F32, 4, 2, 8).transpose(1, 2), _on(I32, 4, 2), _on(F32, 4, 1, 2))),
}


@pytest.mark.parametrize("case", sorted(QUEUE_PUSH_REFUSALS))
def test_queue_push_refusals_allocate_and_launch_nothing(monkeypatch, case):
    """Each refusal of `queue_push` on CUDA tensors raises before the output
    is made and before the launch: nothing allocated, nothing counted."""
    err, match, make = QUEUE_PUSH_REFUSALS[case]
    monkeypatch.setattr(common, "current_stream", _boom)
    m4 = Mesh(4, "x", device="cpu")
    before = dict(rmaqops.launches)
    with FakeTensorMode():
        buf, ctr, msgs = make()
        with _Ops() as seen, pytest.raises(err, match=match):
            rmaqops.queue_push(buf, ctr, msgs, 1, m4)
    assert not [n for n in seen.names if n in _ALLOCS]
    assert rmaqops.launches == before


VIEWS = {
    "contiguous": lambda t: t,
    "halo slice": lambda t: t[:, -1:],
    "inner slice": lambda t: t[:, :, :1],
    "last dim slice": lambda t: t[..., :1],
    "rank slice": lambda t: t[1:3],
    "transposed block": lambda t: t.transpose(1, 2),
    "strided ranks": lambda t: t[::2],
    "one rank": lambda t: t[:1, 2:3],
    "empty block": lambda t: t[:, :0],
    "unit dims": lambda t: t[:, 1:2, 1:2],
    "expanded": lambda t: t[:, :1].expand(4, 5, 3, 2),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_block_contiguity_is_read_from_the_strides(view):
    """`rma.ops.block_contiguous` decides what ``x[0].is_contiguous()``
    does, without making the view."""
    x = VIEWS[view](torch.zeros(4, 5, 3, 2))
    assert rmaops.block_contiguous(x.shape, x.stride()) == x[0].is_contiguous()
    xs, row, stride = rmaops._rows(x)
    assert row == x[0].numel() and torch.equal(xs, x)
    assert xs[0].is_contiguous()


def test_hole_mode_zeroes_only_the_holes():
    """`paged_gather(holes=True)` is the clamp surface on every row whose
    id is >= 0 (ids past the pool clamp) and +0.0 words on every hole."""
    g = torch.Generator().manual_seed(3)
    pool = torch.randn(4, 6, 8, generator=g)
    ids = torch.randint(-3, 9, (4, 5), generator=g, dtype=torch.int32)
    mesh = Mesh(4, "x", device="cpu")
    for shift in (0, -1, 5):
        clamp = pgops.paged_gather(pool, ids, shift, mesh)
        got = pgops.paged_gather(pool, ids, shift, mesh, holes=True)
        hole = ids < 0
        assert torch.equal(got[~hole], clamp[~hole])
        assert torch.equal(got[hole].view(torch.int32), torch.zeros_like(got[hole]).view(torch.int32))
