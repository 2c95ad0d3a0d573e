"""Paged attention: the pool-local wrapper the serving path calls, and the
cross-rank `paged_attention_shift`.

On CPU tensors each computes its plain PyTorch version (`ref`); on CUDA
tensors it launches its hand-written kernel (``csrc/paged_attention.cu``)
or raises — there is no fallback.  `launches` and `shift_launches` count
the two entries' launches (and nothing else), so a run can show that its
path went through them.

Both entries launch the same kernel once a call: each row's page walk is
cut into splits that run on many blocks, and the last block of a group of
rows merges the splits' partial softmax states in the same launch.
`plan` chooses the cut from the shapes alone (the ids are never read on
the host).  The wrapper keeps, per (device, stream), a workspace for the
partials (`torch.empty`) and a zeroed ticket buffer, which every launch
leaves at zero again: launches on one stream run in order, and launches
on two streams never share either.

On a `ProcMesh` (one rank a process) `paged_attention_shift` runs its peer
form: q [1, Sq, hd], ids [1, k] and this rank's pool [1, n_pages, pt, 2,
hd], which must be a symmetric tensor (`ProcMesh.symmetric`, a window of
`core.window.win_allocate`); the split walk reads rank (rank + shift)'s
pool in place through the peer mapping (the kernel
``paged_attention_peer_f32``, one launch counted in `shift_launches`;
on the CPU `ref.paged_attention_peer_ref`), between a fence that opens
the epoch and one that closes it.  A pool outside every segment is refused.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...obs import cost
from ...mesh import Mesh
from ...procmesh import ProcMesh
from .. import common
from . import ref

_NAME = "paged_attention"
_MAX_SMEM = 48 * 1024   # the surface's limit: page_tokens * 4 bytes at most

MAX_PAGES = 32          # entries a split: one warp ballot (kMaxPages in the .cu)
MAX_GROUP = 32          # query rows a block (kMaxGroup)
SPLIT_BYTES = 64 * 1024     # pages a split walks, in bytes of K and V
BLOCK_BUDGET = 2 * 132      # blocks a launch aims at: the 2 an SM holds at once

launches = 0            # kernel launches by `paged_attention`
shift_launches = 0      # kernel launches by `paged_attention_shift`

_LOCAL = common.Entry(_NAME, "paged_attention_f32", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10)
_SHIFT = common.Entry(_NAME, "paged_attention_shift_f32",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11)
_PEER = common.Entry(_NAME, "paged_attention_peer_f32",
                     [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 12)
_BUFFERS: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


class Plan(NamedTuple):
    pages: int          # P: consecutive entries of a row's ids a split walks
    splits: int         # S = ceil(k / P)
    group: int          # G = ceil(m * Sq / groups): rows a block serves
    groups: int         # block groups, one ticket each; group g serves rows
                        # g, g + groups, ...
    blocks: int         # groups * S
    workspace: int      # floats: (m, l) of every (row, split), padded to 16
                        # bytes, then acc[hd] of each


@functools.lru_cache(maxsize=256)
def plan(m: int, Sq: int, k: int, pt: int, hd: int) -> Plan:
    """The cut of a launch, from shapes alone: splits of about SPLIT_BYTES of
    pages (at most MAX_PAGES entries), and the fewest rows a block that keep
    the grid within BLOCK_BUDGET (at most MAX_GROUP), then one group more
    where that makes the number of groups odd.  Block group g serves
    rows g, g + groups, ... one after another; `groups` is odd where a
    block serves more than one row, so that rows a power of two apart (a
    rank's neighbouring slots, the same slot of two ranks, a row's Sq
    positions) land in different groups.  At the decode path's shapes
    (k = 128 pages of 16 tokens, hd 128) a row spreads over 32 blocks."""
    if min(m, Sq) < 0 or min(k, pt, hd) < 1:
        raise ValueError(f"plan of m={m}, Sq={Sq}, k={k}, pt={pt}, hd={hd}")
    page_bytes = pt * 2 * hd * 4
    pages = min(MAX_PAGES, k, max(1, SPLIT_BYTES // page_bytes))
    splits = -(-k // pages)
    rows = m * Sq
    group = 1
    while group < min(MAX_GROUP, rows) and -(-rows // group) * splits > BLOCK_BUDGET:
        group *= 2
    groups = -(-rows // group)
    if group > 1 and groups % 2 == 0:
        groups += 1
        group = -(-rows // groups)
    return Plan(pages, splits, group, groups, groups * splits,
                -(-2 * rows * splits // 4) * 4 + rows * splits * hd)


def _buffers(q: torch.Tensor, device: int, stream: int, workspace: int,
             groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The workspace and ticket counters of `stream` on `device` (q's),
    kept between calls and grown when a call needs more.  The tickets are
    zeroed once and reset to zero by each launch's merging blocks, so the
    next launch on the stream finds them at zero; a launch's partials are
    written and read inside it.  Launches on other streams get their own."""
    key = (device, stream)
    ws, tickets = _BUFFERS.get(key, (None, None))
    if ws is None or ws.numel() < workspace:
        ws = torch.empty(max(workspace, 1 << 16), dtype=torch.float32, device=q.device)
    if tickets is None or tickets.numel() < groups:
        tickets = torch.zeros(max(groups, 64), dtype=torch.int32, device=q.device)
    _BUFFERS[key] = ws, tickets
    return ws, tickets


def _launch(entry: common.Entry, q: torch.Tensor, kv_pages, ids: torch.Tensor,
            scale: float, causal: bool, n_pages: int, pt: int, lead: tuple) -> torch.Tensor:
    """One launch of the split kernel; `lead` is the entry's leading ints
    (m, or p and shift); `kv_pages` the pool's pointer arguments: the pool,
    or (the peer form) a segment's table and the pool's offset in it."""
    m, Sq, hd = q.shape
    k = ids.shape[1]
    pl = plan(m, Sq, k, pt, hd)
    # scale in q's dtype, as the TPU kernel; a unit scale is exact, so skipped
    qs = (q if scale == 1.0 else (q * scale).to(q.dtype)).contiguous()
    out = torch.empty_like(qs)
    device = q.get_device()
    stream = common.current_stream(device)
    ws, tickets = _buffers(q, device, stream, pl.workspace, pl.groups)
    pool = (kv_pages.data_ptr(),) if isinstance(kv_pages, torch.Tensor) else kv_pages
    entry(qs.data_ptr(), *pool, ids.data_ptr(), out.data_ptr(),
          ws.data_ptr(), tickets.data_ptr(), *lead, Sq, hd, n_pages, pt, k,
          int(causal), pl.pages, pl.splits, pl.groups, stream)
    if cost.active() is not None:
        # its bound's counts over the pages the ids name (a sync, so only
        # while a cost counter runs): QK^T and PV, the pages, q and out, ids
        valid = int((ids >= 0).sum())
        cost.report_kernel("paged_attention", 4 * valid * pt * hd * Sq,
                           valid * pt * 2 * hd * 4 + 2 * q.nbytes + ids.nbytes)
    return out


def _check_cuda_args(q: torch.Tensor, kv_pages: torch.Tensor,
                     ids: torch.Tensor, ranks: int = 0) -> None:
    """The kernel's checks; a pool of `ranks` leading rank dims (0 or 1) is
    checked as one rank's [n_pages, pt, 2, hd], read from its shape alone."""
    if q.dtype != torch.float32 or kv_pages.dtype != torch.float32:
        raise TypeError(f"paged_attention kernel takes float32 q and pages, "
                        f"got {q.dtype} and {kv_pages.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"page ids must be int32, got {ids.dtype}")
    m, _, hd = q.shape
    kv = kv_pages.shape[ranks:]
    if len(kv) != 4 or kv[2] != 2 or kv[3] != hd:
        raise ValueError(f"kv_pages must be [{'p, ' * ranks}n_pages, pt, 2, {hd}], "
                         f"got {tuple(kv_pages.shape)}")
    if ids.ndim != 2 or ids.shape[0] != m:
        raise ValueError(f"ids must be [{m}, k], got {tuple(ids.shape)}")
    if hd % 32 or not 0 < hd <= 1024:
        raise ValueError(f"head dim must be a multiple of 32 in (0, 1024], got {hd}")
    if kv[1] * 4 > _MAX_SMEM:
        raise ValueError(f"page_tokens {kv[1]} too large")
    if not (kv_pages.is_contiguous() and ids.is_contiguous()):
        raise ValueError("kv_pages and ids must be contiguous")


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor, ids: torch.Tensor,
                    scale: float | None = None, causal: bool = False) -> torch.Tensor:
    """q [m, Sq, hd], kv_pages [n_pages, pt, 2, hd], ids [m, k] int32
    -> [m, Sq, hd].  Row i attends over the tokens of pool pages ids[i];
    negative ids are masked out of the softmax."""
    if q.ndim != 3:
        raise ValueError(f"q must be [m, Sq, hd], got {tuple(q.shape)}")
    devices = {q.device, kv_pages.device, ids.device}
    if len(devices) != 1:
        raise ValueError(f"paged_attention tensors on several devices: {devices}")
    m, Sq, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, kv_pages, ids, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, kv_pages, ids)
    out = _launch(_LOCAL, q, kv_pages, ids, scale, causal,
                  kv_pages.shape[0], kv_pages.shape[1], (m,))
    global launches
    launches += 1
    return out


def paged_attention_shift(q: torch.Tensor, kv_pages: torch.Tensor,
                          ids: torch.Tensor, shift: int, mesh: Mesh,
                          scale: float | None = None,
                          causal: bool = False) -> torch.Tensor:
    """Cross-rank paged attention: q [p, Sq, hd], kv_pages [p, n_pages, pt,
    2, hd], ids [p, k] int32 -> [p, Sq, hd].  Rank r attends over pages
    ``ids[r]`` of rank (r + shift)'s pool, read in place (never gathered
    into a block); negative ids are masked out of the softmax."""
    mesh._check(q)
    mesh._check(kv_pages)
    mesh._check(ids)
    if q.ndim != 3:
        raise ValueError(f"q must be [p, Sq, hd], got {tuple(q.shape)}")
    devices = {q.device, kv_pages.device, ids.device}
    if len(devices) != 1:
        raise ValueError(f"paged_attention_shift tensors on several devices: {devices}")
    p, Sq, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if isinstance(mesh, ProcMesh):
        return _peer_attention(q, kv_pages, ids, shift, mesh, scale, causal)
    if q.device.type == "cpu":
        return ref.paged_attention_shift_ref(q, kv_pages, ids, shift, mesh,
                                             scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_shift runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, kv_pages, ids, ranks=1)
    out = _launch(_SHIFT, q, kv_pages, ids, scale, causal,
                  kv_pages.shape[1], kv_pages.shape[2], (p, int(shift) % p))
    global shift_launches
    shift_launches += 1
    return out


def _peer_attention(q: torch.Tensor, kv_pages: torch.Tensor, ids: torch.Tensor, shift: int,
                    mesh: ProcMesh, scale: float, causal: bool) -> torch.Tensor:
    """The peer form: this rank's rows over pages ``ids[0]`` of rank (rank +
    shift)'s symmetric pool, read in place between the epoch's fences."""
    if q.device.type == "cpu":
        return ref.paged_attention_peer_ref(q, kv_pages, ids, shift, mesh,
                                            scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_shift runs on cpu or cuda, not {q.device}")
    _check_cuda_args(q, kv_pages, ids, ranks=1)
    seg, off = mesh.locate(kv_pages)
    mesh.fence()                    # the owner's writes are visible
    out = _launch(_PEER, q, (seg.table_ptr, off), ids, scale, causal, kv_pages.shape[1],
                  kv_pages.shape[2], (mesh.p, mesh.rank, int(shift) % mesh.p))
    global shift_launches
    shift_launches += 1
    mesh.fence()                    # every read done before an owner writes again
    return out
