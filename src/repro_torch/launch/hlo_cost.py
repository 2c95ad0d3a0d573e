"""Cost extraction over torch ops (the counterpart of `repro.launch.hlo_cost`).

The reference parses the XLA HLO of a compiled step.  PyTorch runs
eagerly, so the port counts the step as it runs: `analyze(fn, *args)` calls
``fn(*args)`` once under `CostCounter`, a `TorchDispatchMode` that sees
every ATen op the call dispatches (the backward's too), and returns the
reference's `CostSummary`:

  * FLOPs: a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a
    convolution, SDPA) counts 2 x prod(out) x K; an elementwise op
    prod(out), three times that for a transcendental (the reference's
    weight); a reduction the size of its input, as the reference counts a
    ``reduce``; a sort n log2 n.  Views, reshapes, expands, allocations and
    the reference's ``_FREE`` opcodes are free, and so are the data-movement
    ops (copies, gathers, concatenations): they move bytes, not arithmetic.
  * HBM bytes: every op's operand and result bytes (a broadcast operand at
    the bytes it really spans).  In eager mode every op reads its operands
    from HBM and writes its result there, so this is the program's real
    traffic, not the upper bound it would be under a fusing compiler.
  * Loops: Python loops run, so every trip is counted as it happens; that
    is why nothing like the reference's ``known_trip_count`` exists here.
    The one exception is `obs.cost.repeat`, which folds a loop of
    identical trips on meta tensors (the dry-run's sLSTM over 32k steps) to
    one trip counted n times.
  * Collectives: `repro_torch.mesh.Mesh`'s ``psum``, ``all_gather``,
    ``all_to_all``, ``ppermute``, ``shift`` and ``psum_scatter`` record
    their kind (the reference's HLO names), operand bytes (every rank's
    block on the card) and group size into the active counter
    (`obs.cost.record_collective`); their copies are counted as ops besides.
  * Hand kernels: the port's CUDA kernels launch through ctypes
    (`kernels.common.Entry`), which no dispatch mode sees, so each kernel's
    ``ops`` wrapper reports its own FLOPs and bytes (`obs.cost.report_kernel`), the
    counts its bound in PERF.md uses.  The reference counts a Pallas
    custom-call as free (``_FREE``); the port does not, or a step on backend
    "cuda" would lose its attention.
  * Memory: the bytes of the call's arguments (``mem_args``), of the
    results that are new storage (``mem_out``), and the peak of the bytes
    of storage made during the call and still alive, less ``mem_out``
    (``mem_temp``): ``mem_args + mem_out + mem_temp`` is the call's peak
    footprint.
  * Scopes: ``with obs.cost.scope("attention"):`` attributes the ops inside, the
    same ops in the backward (through their autograd nodes) and the
    recomputation of a checkpointed body to that name, so that
    ``product_flops_by_scope`` can split a step's products.

The same call runs on meta tensors (nothing allocated; `launch.dryrun`),
on the CPU, or on the card.  The hooks the lower layers call live in
`obs.cost`, which imports nothing of the port; the counter here implements
them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..obs import cost

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv",
             "convolution", "_convolution", "_scaled_dot_product_flash_attention",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_attention_math"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "logsumexp",
               "_softmax", "_log_softmax", "cumsum", "cumprod", "argmax", "argmin", "any",
               "all", "count_nonzero", "nansum", "aminmax", "_softmax_backward_data",
               "_log_softmax_backward_data"}
_SORTS = {"sort", "topk", "argsort", "kthvalue", "msort"}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "tanh", "rsqrt", "sqrt", "pow",
                   "sin", "cos", "sigmoid", "expm1", "log1p", "erf", "atan2"}
# moves bytes and does no arithmetic
_MOVES = {"copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "index", "_unsafe_index",
          "index_select", "gather", "scatter", "scatter_", "index_put", "index_put_",
          "_index_put_impl_", "embedding", "embedding_dense_backward", "constant_pad_nd",
          "roll", "repeat", "repeat_interleave", "slice_scatter", "select_scatter",
          "as_strided_scatter", "diagonal_scatter", "flip", "narrow_copy", "expand_copy",
          "permute_copy", "transpose_copy", "unfold_copy", "view_copy", "_unsafe_view",
          "tril", "triu", "masked_select", "take", "index_copy", "index_copy_",
          "index_fill", "index_fill_", "masked_scatter", "unbind_copy", "split_copy",
          "split_with_sizes_copy", "nonzero", "where"}
# allocations and fills: no arithmetic; a fill writes its result
_ALLOCS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
           "resize_", "set_", "_local_scalar_dense", "lift_fresh", "lift_fresh_copy",
           "detach", "alias", "record_stream", "_reshape_alias", "sym_size",
           "sym_stride", "sym_numel", "is_same_size", "_has_same_storage_numel",
           "_to_dense", "_nested_tensor_from_mask_left_aligned", "copy"}
_FILLS = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "fill", "fill_",
          "zero_", "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
          "linspace", "eye", "normal_", "uniform_", "randn", "rand", "randint",
          "randperm", "bernoulli_", "random_", "exponential_", "normal"}


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    nbytes: int                   # per execution (operand bytes)
    trips: int                    # loop multiplier (1: a Python loop records each trip)
    group_size: int               # ranks the collective spans
    groups: int                   # number of groups

    @property
    def total_bytes(self) -> int:
        return self.nbytes * self.trips


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)
    # what the port adds: product FLOPs, their split by scope, the hand
    # kernels' reports, the memory footprint and the number of ops counted
    product_flops: float = 0.0
    product_flops_by_scope: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernel_flops: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    kernel_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    mem_args: int = 0
    mem_out: int = 0
    mem_temp: int = 0
    n_ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return float(sum(c.total_bytes for c in self.collectives))

    def collective_bytes_by_kind(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.total_bytes
        return dict(out)

    def collective_bytes_by_group_size(self) -> dict[int, float]:
        out: dict[int, float] = defaultdict(float)
        for c in self.collectives:
            out[c.group_size] += c.total_bytes
        return dict(out)


def _spanned_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span, a broadcast (stride-0) dim once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_tensors(args, kwargs=None) -> list:
    """The tensors among an ATen op's arguments (or its outputs): tensors,
    and lists or tuples of them, one level deep."""
    out = []
    for a in (args, () if kwargs is None else kwargs.values()):
        for x in a:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _signature(tree):
    """A hashable stand-in for args: a tensor by its metadata."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            raise TypeError("not a meta tensor")
        return ("T", tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    return tree


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _product_flops(name: str, args, out: list) -> float:
    if not out:
        return 0.0
    o = out[0]
    if name in ("mm", "addmm", "bmm", "baddbmm", "addbmm"):
        a = args[1] if name in ("addmm", "baddbmm", "addbmm") else args[0]
        k = a.shape[-1]
        if name == "addbmm":
            return 2.0 * o.numel() * k * a.shape[0]
        return 2.0 * o.numel() * k
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    if name in ("mv", "addmv"):
        a = args[1] if name == "addmv" else args[0]
        return 2.0 * a.numel()
    if name in ("convolution", "_convolution"):
        w, groups = args[1], args[8] if len(args) > 8 else 1
        return 2.0 * o.numel() * (w.shape[1] * math.prod(w.shape[2:]))
    # SDPA: q [.., Sq, hd] x k [.., Sk, hd] and the product with v
    q, k = args[0], args[1]
    return 4.0 * q.numel() * k.shape[-2]


class _Tagger(TorchFunctionMode):
    """Stamps the autograd nodes a scoped call makes with the scope's name,
    so that the backward's ops (which run outside any Python scope) find it
    on the node `torch._C._current_autograd_node()` names."""

    def __init__(self, counter: "CostCounter", trips: Optional[int] = None):
        super().__init__()
        self.counter = counter
        self.trips = trips      # a `repeat`'s first sequence number

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.trips is not None:       # every active `repeat`'s trips, multiplied
            key, value, seq0 = "trips", self.counter.mult, self.trips
        else:
            key = "scope"
            value, seq0 = self.counter.current_scope()
        out = func(*args, **(kwargs or {}))
        if value:
            for t in _tensors(out):
                if t.grad_fn is not None:
                    _stamp(t.grad_fn, key, value, seq0)
        return out


def _stamp(node, key: str, value, seq0: int) -> None:
    """Set `key` on `node` and on the nodes behind it made since `seq0`
    that lack it."""
    todo = [node]
    while todo:
        n = todo.pop()
        if n is None or key in n.metadata:
            continue
        if n._sequence_nr() < seq0 and n is not node:
            continue
        n.metadata[key] = value
        todo.extend(nxt for nxt, _ in n.next_functions)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage of every ATen op it sees; use
    through `analyze`."""

    def __init__(self):
        super().__init__()
        self.summary = CostSummary()
        self.scopes: list[tuple[str, int]] = []
        self.known: set[int] = set()        # storages alive before the call
        self.live = 0
        self.peak = 0
        self.sizes: dict[int, int] = {}
        self.memo: Optional[dict] = None    # set on meta tensors (`_run`)
        self.mult = 1                       # the active `repeat`s' trips
        self.born: Optional[list] = None    # storages made inside a `repeat`
        self.kinds: dict = {}

    # ------------------------------------------------------------ hooks (`obs.cost`)
    def push_scope(self, name: str) -> None:
        self.scopes.append((name, torch._C._autograd._get_sequence_nr()))

    def pop_scope(self) -> None:
        self.scopes.pop()

    def record_collective(self, kind: str, nbytes: int, group_size: int, groups: int) -> None:
        self.summary.collectives.append(
            CollectiveRecord(kind, int(nbytes), 1, int(group_size), int(groups)))

    def begin_repeat(self, n: int) -> tuple:
        """Enter a `cost.repeat(n)`: its ops count n times and the storage
        made inside is noted; returns what `end_repeat` needs."""
        tagger = _Tagger(self, trips=torch._C._autograd._get_sequence_nr())
        tagger.__enter__()
        if self.born is None:
            self.born = []
        self.mult *= n
        token = n, tagger, len(self.born), self.peak
        self.peak = self.live                       # the trip's own peak from here
        return token

    def end_repeat(self, token: tuple, carry: set, exc) -> None:
        """Leave a repeat: the storage made inside and still alive, but
        the `carry`, counts n times; the peak is the last trip's, which
        the n - 1 trips before it leave that storage behind."""
        n, tagger, start, peak = token
        self.mult //= n
        tagger.__exit__(*exc)
        extra = 0
        for key in set(self.born[start:]):          # a freed storage's key is reused
            if key in self.sizes and key not in carry:
                more = (n - 1) * self.sizes[key]
                self.sizes[key] += more
                extra += more
        self.live += extra
        self.peak = max(peak, self.peak + extra)
        if self.mult == 1:
            self.born = None

    # ------------------------------------------------------------ scopes
    def current_scope(self) -> tuple[str, int]:
        if self.scopes:
            return self.scopes[-1]
        node = torch._C._current_autograd_node()
        if node is not None:
            name = node.metadata.get("scope", "")
            if name:
                return name, torch._C._autograd._get_sequence_nr()
        return "", 0

    def add(self, flops: float, nbytes: float, product: bool, kernel: str = "") -> None:
        s = self.summary
        name = self.current_scope()[0]
        mult = self.mult
        if mult == 1:
            node = torch._C._current_autograd_node()
            if node is not None:
                mult = node.metadata.get("trips", 1)
        flops, nbytes = flops * mult, nbytes * mult
        s.flops += flops
        s.hbm_bytes += nbytes
        if product:
            s.product_flops += flops
            s.product_flops_by_scope[name] += flops
        if kernel:
            s.kernel_flops[kernel] += flops
            s.kernel_bytes[kernel] += nbytes

    # ------------------------------------------------------------ memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.sizes:
            return
        n = st.nbytes()
        self.sizes[key] = n
        if self.born is not None:
            self.born.append(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    # ------------------------------------------------------------ ops
    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on meta tensors a functional op's
        output metadata is a function of its inputs' metadata alone, so it
        is made once per signature and then built from the memo (a meta
        kernel in Python costs ~0.3 ms, and a step at published widths
        dispatches millions of ops)."""
        if self.memo is None:
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        spec = self.memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            flat, tree = _pytree.tree_flatten(out)
            if not all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in flat):
                return out
            self.memo[key] = (tree, [(t.shape, t.stride(), t.dtype) for t in flat])
            return out
        tree, metas = spec
        return _pytree.tree_unflatten(
            [torch.empty_strided(shp, st, dtype=dt, device="meta") for shp, st, dt in metas],
            tree)

    def _classify(self, func) -> tuple[str, bool, bool]:
        """(name, free, memoisable) of an op, cached."""
        info = self.kinds.get(func)
        if info is None:
            name = func.overloadpacket.__name__
            view = _is_view(func)
            info = (name, name in _ALLOCS or view, not (view or func._schema.is_mutable))
            self.kinds[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, free, pure = self._classify(func)
        out = self._run(func, args, kwargs) if pure else func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else _op_tensors((out,))
        for t in outs:
            self._track(t)
        if free:
            return out
        self.summary.n_ops += 1
        ins = _op_tensors(args, kwargs)
        if name == "copy_":
            nbytes = sum(_spanned_bytes(t) for t in ins)
        else:
            nbytes = sum(_spanned_bytes(t) for t in ins) + sum(_spanned_bytes(t) for t in outs)
        if name in _FILLS:
            self.add(0.0, sum(_spanned_bytes(t) for t in outs), False)
        elif name in _MOVES:
            self.add(0.0, nbytes, False)
        elif name in _PRODUCTS:
            self.add(_product_flops(name, args, outs), nbytes, True)
        elif name in _REDUCTIONS:
            self.add(float(ins[0].numel()) if ins else 0.0, nbytes, False)
        elif name in _SORTS:
            n = outs[0].numel() if outs else 0
            self.add(float(n * max(n.bit_length(), 1)), nbytes, False)
        else:
            w = 3.0 if name.rstrip("_") in _TRANSCENDENTAL else 1.0
            self.add(w * (outs[0].numel() if outs else 0), nbytes, False)
        return out


def analyze(fn: Callable, *args, scopes: bool = True, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once under a `CostCounter` and return its
    `CostSummary` (the call's result is dropped).  ``scopes=False`` leaves
    the backward's ops unscoped and saves the per-call cost of tagging."""
    counter = CostCounter()
    arg_storages = {}
    for t in _tensors((args, kwargs)):
        st = t.untyped_storage()
        arg_storages.setdefault(st._cdata, st.nbytes())
    counter.known = set(arg_storages)
    if any(t.device.type == "meta" for t in _tensors((args, kwargs))):
        counter.memo = {}
    with cost.running(counter), \
            _Tagger(counter) if scopes else contextlib.nullcontext(), counter:
        out = fn(*args, **kwargs)
    s = counter.summary
    s.mem_args = sum(arg_storages.values())
    outs = {}
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata not in arg_storages:
            outs.setdefault(st._cdata, st.nbytes())
    s.mem_out = sum(outs.values())
    s.mem_temp = max(counter.peak - s.mem_out, 0)
    return s
