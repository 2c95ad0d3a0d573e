"""The fused all-gather matmul (the counterpart of
`repro.kernels.ring_matmul.ops`), on the stacked rank axis.

`ring_matmul(x_t [K, m], w [n, K/n, N], mesh)` returns ``Y = x_t.T @
concat(w[0], ..., w[n-1])`` as ``[m, N]`` f32: rank 0's copy, which is
what `Mesh.replicated` reads of a replicated result.  `ring_matmul_ranks`
gives every rank's copy ``[n, m, N]``: each rank computes its own Y, in its
own shard order, as the reference does on n devices.  The reference shards
``w [K, N]`` on dim 0; here the sharded dim is the leading rank dim.

On CPU tensors both compute the plain ring schedule (`ref.ring_schedule_ref`);
on CUDA tensors they launch the hand-written kernel (``csrc/ring_matmul.cu``)
or raise — there is no fallback.  The kernel has two variants, chosen by
`variant` from the dtype, n and the TMA's preconditions alone: "wgmma" (bf16,
n <= 8, tensors the TMA can load: the whole ring in one clustered launch,
a cluster of n blocks an output tile) and "simt" (everything else: one
launch a ring step, n a call).  `launches` counts the kernel's launches and
nothing else, so a run can show that its path went through it;
`launches_by_variant` splits the same count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...obs import cost
from ...mesh import Mesh
from .. import common
from .ref import ring_schedule_ref

_NAME = "ring_matmul"
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}
MAX_RANKS = 8                   # the portable cluster size: one block a rank
TILE = 128                      # the "wgmma" variant's output rows a tile (columns: 128 or 256)
SMEM_BYTES = 232_448            # dynamic shared memory a block may have on Hopper
CHUNK_ROWS = (64, 48, 32, 16)   # k rows a chunk may have (multiples of wgmma's k = 16)

launches = 0                    # kernel launches ("wgmma": one a call; "simt": one a ring step)
launches_by_variant = {"wgmma": 0, "simt": 0}   # the same launches, by variant


class Plan(NamedTuple):
    """The "wgmma" variant's plan: output tiles of 128 x `bn`; chunks of
    `kc` k-rows; x_t's chunks (kc x 128) in a ring of `stages`, the held
    block's (kc x bn) in a ring of `slots`; a round is `nkr` chunks of
    every shard and `rounds` of them cover ks."""
    bn: int
    kc: int
    stages: int
    slots: int
    nkr: int
    rounds: int

    @property
    def smem(self) -> int:      # csrc/ring_matmul.cu:Plan::bytes
        return (self.stages * self.kc * TILE * 2 + self.slots * self.kc * self.bn * 2
                + 8 * (2 * self.stages + 4 * self.slots) + 1024)


def _room(bn: int, kc: int, stages: int) -> int:
    """The most held-block slots that fit beside `stages` x_t stages
    (`Plan.smem` is linear in the slots)."""
    none, one = (Plan(bn, kc, stages, s, 0, 1).smem for s in (0, 1))
    return (SMEM_BYTES - none) // (one - none)


def plan(n: int, ks: int, N: int) -> Plan:
    """The plan for n ranks of ks rows and N columns.

    Tiles are 256 wide where N >= 512 and the ring fits (x_t, which every
    tile column reads again through L2, is then read half as often), else
    128.  The chunk height pads ks least (the larger on a tie).  For n > 1
    the held-block ring takes as many slots as fit beside two x_t stages,
    up to three steps' worth, and x_t the most stages (up to 4) that leave
    those slots: on the card, ring slots beat x_t stages.  The ring needs
    `slack` slots beyond a step's chunks (a full ring cannot move, and the
    fewer spare slots, the longer each forward waits on a chain of
    neighbours' credits): slack 2 first, then 1.  Where no plan holds a
    whole shard so, the shard's rows go in rounds.  n = 1 forwards
    nothing: four x_t stages and the slots that fit beside them."""
    widths = (256, 128) if N >= 512 else (128,)
    order = sorted(CHUNK_ROWS, key=lambda kc: (-(-ks // kc) * kc, -kc))

    def fit(bn: int, kc: int, nkr: int) -> Plan:
        slots = min(max(3 * nkr, nkr + 4), _room(bn, kc, 2))
        stages = max(st for st in (2, 3, 4) if _room(bn, kc, st) >= slots)
        return Plan(bn, kc, stages, slots, nkr, 1)

    if n == 1:
        kc, nk = order[0], -(-ks // order[0])
        for bn in widths:
            if _room(bn, kc, 4) >= 2:
                return Plan(bn, kc, 4, max(2, min(nk, _room(bn, kc, 4))), nk, 1)
    for slack in (2, 1):
        for bn in widths:
            for kc in order:
                p = fit(bn, kc, -(-ks // kc))
                if p.slots >= p.nkr + slack:
                    return p
    kc = order[0]
    nk = -(-ks // kc)
    rounds = -(-nk // (_room(128, kc, 2) - 2))
    return fit(128, kc, -(-nk // rounds))._replace(rounds=rounds)


def tma_problem(shape, strides, data_ptr: int, itemsize: int) -> str | None:
    """What keeps a [shards, rows, cols] view from the "wgmma" variant's TMA
    maps, or None: the base must be 16-byte aligned, the columns contiguous
    and every other stride of a dim longer than 1 a positive multiple of 16
    bytes (a dim of length 1 is never stepped, so its stride is not read)."""
    if data_ptr % 16:
        return f"base address {data_ptr:#x} is not 16-byte aligned"
    if strides[2] != 1:
        return "the columns are not contiguous"
    for dim, (n, st) in enumerate(zip(shape[:2], strides[:2])):
        if n > 1 and (st <= 0 or st * itemsize % 16):
            return f"stride {st} of dim {dim} is not a positive multiple of 16 bytes"
    return None


def map_strides(shape) -> tuple[int, int]:
    """The shard and row strides, in elements, handed to the TMA map of a
    contiguous [shards, rows, cols] tensor: a dim of length 1 gets a valid
    stride (a multiple of 8 elements) that is never read."""
    shards, rows, cols = shape
    row = cols if rows > 1 else -(-cols // 8) * 8
    return (rows * cols if shards > 1 else rows * row, row)


def _map_views(x_t: torch.Tensor, w: torch.Tensor):
    """(shape, strides, data_ptr) of the [n, ks, m] and [n, ks, N] views the
    kernel's maps read, of the contiguous tensors the wrapper hands over (a
    copy, if the caller's is not contiguous, is freshly allocated and
    aligned)."""
    n, ks, N = w.shape
    out = []
    for t, shape in ((x_t, (n, ks, x_t.shape[1])), (w, (n, ks, N))):
        ptr = t.data_ptr() if t.is_contiguous() else 0
        out.append((shape, (shape[1] * shape[2], shape[2], 1), ptr))
    return out


def variant(dtype: torch.dtype, n: int, x_t: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel variant: "wgmma" iff bf16, 1 <= n <= 8 (one cluster block
    a rank) and x_t's and w's views pass `tma_problem`; else "simt" (f32
    keeps its 1e-4 tolerance, which TF32 tensor cores would break)."""
    if dtype != torch.bfloat16 or not 1 <= n <= MAX_RANKS:
        return "simt"
    ok = all(tma_problem(shape, st, ptr, 2) is None for shape, st, ptr in _map_views(x_t, w))
    return "wgmma" if ok else "simt"


_RING = common.Entry(_NAME, "ring_matmul", [_P] * 4 + [_I] + [_L] * 5 + [_I] + [_L] * 4 + [_I] * 6)


def _check(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> None:
    if x_t.ndim != 2 or w.ndim != 3:
        raise ValueError(f"ring_matmul takes x_t [K, m] and w [n, K/n, N], got "
                         f"{tuple(x_t.shape)}, {tuple(w.shape)}")
    mesh._check(w)
    if w.shape[0] * w.shape[1] != x_t.shape[0]:
        raise ValueError(f"w {tuple(w.shape)} does not shard x_t's K = {x_t.shape[0]} "
                         f"over {mesh.p} ranks")
    if x_t.device != w.device:
        raise ValueError(f"ring_matmul tensors on several devices: {x_t.device}, {w.device}")


def _launch(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh, force: str | None) -> torch.Tensor:
    if x_t.dtype not in _DTYPES or w.dtype != x_t.dtype:
        raise TypeError(f"the ring_matmul kernel takes bf16 or f32 x_t and w of one "
                        f"dtype, got {x_t.dtype}, {w.dtype}")
    n, ks, N = w.shape
    m = x_t.shape[1]
    x_t, w = x_t.contiguous(), w.contiguous()
    kind = force or variant(w.dtype, n, x_t, w)
    if kind == "wgmma":
        if w.dtype != torch.bfloat16 or not 1 <= n <= MAX_RANKS:
            raise ValueError(f"ring_matmul (wgmma variant) takes bf16 at 1 <= n <= {MAX_RANKS}, "
                             f"got {w.dtype} at n = {n}")
        for name, (shape, st, ptr) in zip(("x_t", "w"), _map_views(x_t, w)):
            problem = tma_problem(shape, st, ptr, 2)
            if problem:
                raise ValueError(f"ring_matmul (wgmma variant): {name} {problem}")
    out = torch.empty(n, m, N, dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    if ks == 0:
        return out.zero_()
    stream = common.current_stream(w.get_device())
    # its bound's counts: all n copies' products, x_t and w read, Y written
    cost.report_kernel("ring_matmul", 2 * n * m * n * ks * N,
                       x_t.nbytes + w.nbytes + out.nbytes)
    global launches
    if kind == "wgmma":
        p = plan(n, ks, N)
        _RING(x_t.data_ptr(), w.data_ptr(), None, out.data_ptr(), _DTYPES[w.dtype], n, ks, m,
              N, 0, _VARIANTS[kind], *map_strides((n, ks, m)), *map_strides((n, ks, N)), *p,
              stream)
        launches += 1
        launches_by_variant[kind] += 1
        return out
    # the double-buffered slots; one rank forwards nothing
    buf = torch.empty(n, 2, ks, N, dtype=w.dtype, device=w.device) if n > 1 else None
    for step in range(n):
        _RING(x_t.data_ptr(), w.data_ptr(), None if buf is None else buf.data_ptr(),
              out.data_ptr(), _DTYPES[w.dtype], n, ks, m, N, step, _VARIANTS[kind],
              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, stream)
        launches += 1
        launches_by_variant[kind] += 1
    return out


def ring_matmul_ranks(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                      variant: str | None = None) -> torch.Tensor:
    """x_t [K, m], w [n, K/n, N] -> [n, m, N] f32: every rank's copy of Y.
    `variant` ("wgmma" or "simt") overrides the rule on a CUDA tensor, for
    comparing the two; a "wgmma" that the inputs do not fit raises."""
    if variant not in (None, *_VARIANTS):
        raise ValueError(f"ring_matmul variant must be one of {tuple(_VARIANTS)}, got {variant!r}")
    _check(x_t, w, mesh)
    if w.device.type == "cpu":
        return ring_schedule_ref(x_t, w, mesh)
    if w.device.type != "cuda":
        raise ValueError(f"ring_matmul runs on cpu or cuda, not {w.device}")
    return _launch(x_t, w, mesh, variant)


def ring_matmul(x_t: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x_t [K, m] (replicated), w [n, K/n, N] (rank r's shard at w[r]) ->
    Y [m, N] f32, the one copy every rank holds, through the variant that
    `variant` names."""
    return Mesh.replicated(ring_matmul_ranks(x_t, w, mesh))
