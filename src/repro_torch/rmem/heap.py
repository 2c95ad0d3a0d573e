"""Symmetric-heap remote page allocator over a dynamic RMA window (the
`repro.rmem.heap` counterpart, DESIGN.md §10).

Every rank owns one fixed-size page pool living in a dynamic window
(`window.win_create_dynamic` + attach, §2.2): the pool can grow and shrink
at runtime, and each grow/shrink detaches and re-attaches its three regions,
bumping the window's ``attach_id`` so remote descriptor caches refetch
instead of serving stale translations.  Free pages are arbitrated by a
per-rank free stack whose head is one word row, with a wrap-safe uint32
generation tag advanced on every allocate and every free (the ABA
defense).

Two implementations share the protocol:

  * **The device pool** (`pool_allocate` ... `check_errors`).  Every
    function works on all ranks at once on the stacked rank axis: the
    state's leading dimension is the rank, so rank r's pool is row r.  An
    allocation epoch is the rank-ordered fetch-and-op the queue uses: one
    fused gather gives every origin its slot range in each target's free
    stack, and owner t pops ``grant[:, t].sum()`` pages off its own stack.
    Alloc and refcount rounds are recorded on an `RmaPlan`
    (`alloc_record`, `ref_update_record`), so an allocation can ride an
    existing epoch's fused gather at zero marginal wire transfers.  uint32
    protocol values (meta, head) are kept in int64 and wrapped with
    ``& 0xFFFFFFFF`` where the reference's uint32 arithmetic wraps; the
    head row goes on the wire as 4-byte words (`plan.u32_to_wire`).
    Scatters the reference drops out of range are masked into a trash
    column here: a CUDA index out of range is a device assert.
  * **The host pool** (`HostPagePool`): the literal CAS free-list, a 64-bit
    head word packing (generation << 32 | head index), pop/push by
    compare-and-swap loops on `locks_sim._AtomicWord`, per-page refcounts
    by fetch-and-add.  The serving scheduler's allocation mirror.

Refcount protocol: a page is live while its refcount > 0; +1 shares it
(prefix sharing), -1 releases it, and the owner pushes pages reaching zero
back onto its free stack in the same epoch.  Conservation, per rank:
``free_top + #(refcount > 0) == n_pages``, always.  `conservation` and
`check_errors` read the state to the host by contract; nothing else in an
epoch does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import plan as plan_mod
from ..core import window as window_mod
from ..core.fabric import default_fabric
from ..core.locks_sim import _AtomicWord
from ..core.plan import U32_MASK, u32_from_wire, u32_to_wire
from ..mesh import resolve_device
from ..obs import causal as obs_causal
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..rmaq.queue import admission_plan

# head-word columns (one uint32 row of 5 per rank).  ERRS counts refcount
# deltas addressed to dead pages: device code cannot raise, so the protocol
# violation is dropped without corrupting the pool and surfaced here
# (`check_errors` turns it into a HeapError).
FREE_TOP, EPOCH, ALLOCS, FREES, ERRS = range(5)
N_HEAD = 5

# per-page meta columns (uint32 values)
REF, GEN = range(2)
N_META = 2


class HeapError(RuntimeError):
    pass


class PoolState(NamedTuple):
    """Device state of every rank's page pool, rank r in row r:
    pages [p, n_pages, *page_shape], meta [p, n_pages, 2] int64 (refcount,
    generation; uint32 values), free_stack [p, n_pages] int32 (entries
    [0, free_top) are the free set), head [p, N_HEAD] int64 (uint32
    values)."""

    pages: torch.Tensor
    meta: torch.Tensor
    free_stack: torch.Tensor
    head: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PoolDescriptor:
    """O(1) metadata describing every rank's pool (the §2.2 property)."""

    axis: str
    n_pages: int
    page_shape: tuple
    dtype: Any
    window: window_mod.Window
    regions: tuple  # attached region ids: (pages, meta, stack)

    @property
    def mesh(self):
        return self.window.mesh

    @property
    def page_words(self) -> int:
        return int(np.prod(self.page_shape)) if self.page_shape else 1

    @property
    def page_nbytes(self) -> int:
        return self.page_words * self.dtype.itemsize

    def metadata_nbytes(self) -> int:
        """Descriptor constants + the dynamic window's own O(1)-per-region
        metadata; independent of p and of n_pages (pages are payload)."""
        return 64 + self.window.metadata_nbytes()


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & U32_MASK


def _attach_regions(win: window_mod.Window, n_pages: int, page_shape: tuple,
                    dtype) -> tuple:
    return (
        win.attach("pages", (n_pages,) + tuple(page_shape), dtype),
        win.attach("meta", (n_pages, N_META), torch.int64),
        win.attach("stack", (n_pages,), torch.int32),
    )


def _reattach(desc: PoolDescriptor, n_new: int) -> PoolDescriptor:
    """The §2.2 resize protocol: detach the three regions, re-attach them
    at the new size (each step bumps ``attach_id``)."""
    for rid in desc.regions:
        desc.window.detach(rid)
    regions = _attach_regions(desc.window, n_new, desc.page_shape, desc.dtype)
    return dataclasses.replace(desc, n_pages=n_new, regions=regions)


# ------------------------------------------------------------------ creation
def pool_allocate(mesh, n_pages: int, page_shape: tuple = (),
                  dtype: Any = torch.float32) -> tuple[PoolDescriptor, PoolState]:
    """One page pool per rank of `mesh`, inside a dynamic window, on the
    mesh's device.  The pool's three tensors are attached regions of one
    ``win_create_dynamic`` window."""
    if n_pages < 1:
        raise HeapError(f"need n_pages >= 1, got {n_pages}")
    p, dev = mesh.p, mesh.device
    win = window_mod.win_create_dynamic(mesh)
    regions = _attach_regions(win, n_pages, page_shape, dtype)
    desc = PoolDescriptor(mesh.axis, n_pages, tuple(page_shape), dtype, win, regions)
    head = torch.zeros((p, N_HEAD), dtype=torch.int64, device=dev)
    head[:, FREE_TOP] = n_pages
    state = PoolState(
        torch.zeros((p, n_pages) + tuple(page_shape), dtype=dtype, device=dev),
        torch.zeros((p, n_pages, N_META), dtype=torch.int64, device=dev),
        torch.arange(n_pages, dtype=torch.int32, device=dev).repeat(p, 1),
        head)
    return desc, state


def pool_state_from_numpy(desc: PoolDescriptor, pages, meta, stack, head,
                          device=None) -> PoolState:
    """A `PoolState` from numpy arrays laid out as the reference's global
    view (meta and head uint32, stack int32), on `device` (default: the
    descriptor's mesh device)."""
    dev = desc.mesh.device if device is None else resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    return PoolState(put(pages, desc.dtype),
                     put(np.asarray(meta).astype(np.int64), torch.int64),
                     put(np.asarray(stack).astype(np.int32), torch.int32),
                     put(np.asarray(head).astype(np.int64), torch.int64))


def to_local(state: PoolState, r: int) -> PoolState:
    """Rank r's pool: a view of row r of every tensor."""
    return PoolState(*(x[r] for x in state))


def to_global(states: Sequence[PoolState]) -> PoolState:
    """The inverse of `to_local` over every rank: a stack along the rank
    axis."""
    return PoolState(*(torch.stack(xs) for xs in zip(*states)))


# ------------------------------------------------------------------ alloc
def alloc_record(plan: plan_mod.RmaPlan, state: PoolState, want: torch.Tensor):
    """Record the allocation epoch's one-sided reads on an existing plan.

    ``want[o, t]``: pages origin o requests from target t's pool.  The
    round is the rank-ordered fetch-and-op on every target's head word: the
    request-count gather and the head read are the AMO (kind ``accs``, what
    a hardware fetch-and-add would charge), and the stack contents ride the
    same fused gather as a kind-less rider, so an allocation piggybacked on
    another epoch's gather costs zero marginal wire transfers.  Returns
    handles for `alloc_apply` after the caller flushes the plan."""
    want = want.to(device=state.head.device, dtype=torch.int32)
    h_want = plan.all_gather(want, kind="gets")
    h_head = plan.all_gather(u32_to_wire(state.head), kind="accs")
    h_stack = plan.all_gather(state.free_stack, kind=None)     # rider
    return (h_want, h_head, h_stack)


def alloc_apply(desc: PoolDescriptor, state: PoolState, kmax: int, handles
                ) -> tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Resolve a recorded allocation epoch (after the plan's flush).

    Returns (state', ids [p(origin), p(target), kmax] int32 — the page ids
    origin o got in target t's pool, -1 past its grant — and granted
    [p(origin), p(target)] int32).  Origins are served in rank order, so
    the grants are disjoint.  A grant above `kmax` pops and marks live more
    pages than it returns ids for, as the reference does."""
    h_want, h_head, h_stack = handles
    n = desc.n_pages
    mesh = desc.mesh
    C = mesh.replicated(h_want.result()).to(torch.int64)        # [origin, target]
    heads = u32_from_wire(mesh.replicated(h_head.result()))     # [target, N_HEAD]
    stacks = mesh.replicated(h_stack.result())                  # [target, n]
    p = C.shape[0]
    dev = C.device

    free_top = heads[:, FREE_TOP]
    grant, offset = admission_plan(C, n - free_top, n)          # [origin, target]

    # origin o's ids: pop offset .. offset + grant off the top of t's stack
    j = torch.arange(kmax, device=dev)
    idx = free_top[None, :, None] - 1 - offset[..., None] - j   # [o, t, kmax]
    got = j < grant[..., None]
    ids = torch.gather(stacks.unsqueeze(0).expand(p, p, n), 2, idx.clamp(0, n - 1))
    ids = torch.where(got, ids, torch.full_like(ids, -1))

    # owner side: pop the granted top region, mark its pages live (ref 1,
    # gen + 1); the trash column n takes every row that pops nothing
    total = grant.sum(0)                                        # leaving pool t
    i = torch.arange(n, device=dev)
    top = state.head[:, FREE_TOP, None]
    popped = (i >= top - total[:, None]) & (i < top)
    rows = state.free_stack.to(torch.int64)
    rows = torch.where(popped & (rows >= 0) & (rows < n), rows, torch.full_like(rows, n))
    hits = torch.zeros((p, n + 1), dtype=torch.int64, device=dev).scatter_add_(
        1, rows, torch.ones_like(rows))[:, :n]
    ref = torch.where(hits > 0, torch.ones_like(hits), state.meta[..., REF])
    meta = torch.stack((ref, _u32(state.meta[..., GEN] + hits)), dim=-1)
    zero = torch.zeros_like(total)
    head = _u32(state.head + torch.stack(
        (-total, torch.ones_like(total), total, zero, zero), dim=1))
    return (PoolState(state.pages, meta, state.free_stack, head),
            ids.to(torch.int32), grant.to(torch.int32))


def alloc(desc: PoolDescriptor, state: PoolState, want: torch.Tensor, kmax: int
          ) -> tuple[PoolState, torch.Tensor, torch.Tensor]:
    """A standalone allocation epoch: one fused gather (collective).
    ``want[o, t]`` pages from target t, at most `kmax` ids returned a
    target."""
    tr = obs_trace.TRACER
    if tr.enabled:
        tr.event("heap.alloc_epoch", axis=desc.axis, kmax=int(kmax))
    plan = plan_mod.RmaPlan(desc.mesh)
    handles = alloc_record(plan, state, want)
    plan.flush(aggregate=True)
    return alloc_apply(desc, state, kmax, handles)


# ------------------------------------------------------- refcount / release
def ref_update_record(plan: plan_mod.RmaPlan, ids: torch.Tensor,
                      owner: torch.Tensor, delta: torch.Tensor):
    """Record one refcount round: ids / owner / delta [p, k] (owner -1 = a
    no-op slot).  The (page id, delta) pairs fly to their owners as ONE
    fused all-to-all (the §2.4 slotted accumulate; kind ``accs``)."""
    p = plan.mesh.p
    ids, owner, delta = (t.to(torch.int64) for t in (ids, owner, delta))
    valid = (owner >= 0) & (owner < p) & (ids >= 0)
    rows = torch.where(valid, owner, torch.zeros_like(owner))[:, None, :]
    k = ids.shape[1]
    send_id = torch.full((p, p, k), -1, dtype=torch.int32, device=ids.device)
    send_id.scatter_(1, rows, torch.where(valid, ids, -1).to(torch.int32)[:, None, :])
    send_dl = torch.zeros((p, p, k), dtype=torch.int32, device=ids.device)
    send_dl.scatter_(1, rows, torch.where(valid, delta, 0).to(torch.int32)[:, None, :])
    h_id = plan.put_all_to_all(send_id, kind="accs")
    h_dl = plan.put_all_to_all(send_dl, kind=None)           # rides the same wire
    return (h_id, h_dl)


def ref_update_apply(desc: PoolDescriptor, state: PoolState, handles
                     ) -> tuple[PoolState, torch.Tensor]:
    """Owner side: apply the refcount deltas; pages reaching zero return to
    the free stack in the same epoch.  Returns (state', n_freed [p] int32).
    Deltas addressed to dead pages (a stale ref shared after free, a double
    free) are dropped whole, so a dead page is never resurrected while its
    id sits in the free stack; a decrement below zero clamps.  ERRS counts
    the pages each violation hit."""
    h_id, h_dl = handles
    n = desc.n_pages
    p = state.head.shape[0]
    recv_id = h_id.result().reshape(p, -1).to(torch.int64)     # [owner, p*k]
    recv_dl = h_dl.result().reshape(p, -1).to(torch.int64)
    ok = (recv_id >= 0) & (recv_id < n)
    rows = torch.where(ok, recv_id, torch.full_like(recv_id, n))
    dsum = torch.zeros((p, n + 1), dtype=torch.int64, device=rows.device).scatter_add_(
        1, rows, torch.where(ok, recv_dl, torch.zeros_like(recv_dl)))[:, :n]

    old_ref = state.meta[..., REF]
    bad = (old_ref == 0) & (dsum != 0)
    dsum = torch.where(bad, torch.zeros_like(dsum), dsum)
    raw = old_ref + dsum
    new_ref = raw.clamp(min=0)
    bad_n = bad.sum(1) + (raw < 0).sum(1)
    freed = (old_ref > 0) & (new_ref == 0)
    f = freed.to(torch.int64)
    n_freed = f.sum(1)
    meta = torch.stack((new_ref, _u32(state.meta[..., GEN] + f)), dim=-1)

    # push the freed ids at [free_top, free_top + n_freed), in id order
    slot = state.head[:, FREE_TOP, None] + torch.cumsum(f, 1) - f
    slot = torch.where(freed & (slot < n), slot, torch.full_like(slot, n))
    ids = torch.arange(n, dtype=torch.int32, device=slot.device).expand(p, n)
    stack = torch.cat((state.free_stack, state.free_stack[:, :1]), dim=1)
    stack = stack.scatter_(1, slot, ids)[:, :n]
    head = _u32(state.head + torch.stack(
        (n_freed, torch.ones_like(n_freed), torch.zeros_like(n_freed), n_freed, bad_n),
        dim=1))
    return PoolState(state.pages, meta, stack, head), n_freed.to(torch.int32)


def ref_update(desc: PoolDescriptor, state: PoolState, ids: torch.Tensor,
               owner: torch.Tensor, delta: torch.Tensor
               ) -> tuple[PoolState, torch.Tensor]:
    """A standalone refcount epoch (collective).  ids / owner / delta
    [p, k]; owner -1 = a no-op slot; +1 shares a page, -1 releases it, and
    the owner frees at zero."""
    plan = plan_mod.RmaPlan(desc.mesh)
    handles = ref_update_record(plan, ids, owner, delta)
    plan.flush(aggregate=True)
    return ref_update_apply(desc, state, handles)


def release(desc: PoolDescriptor, state: PoolState, ids: torch.Tensor,
            owner: torch.Tensor) -> tuple[PoolState, torch.Tensor]:
    """`ref_update` with delta -1 in every slot."""
    return ref_update(desc, state, ids, owner, torch.full_like(ids, -1))


def tag_valid(state: PoolState, ids: torch.Tensor, gens: torch.Tensor) -> torch.Tensor:
    """ABA check, ids / gens [p, k] against each rank's own pool: a cached
    (page, generation) descriptor is valid iff the page's generation still
    matches (uint32 equality: wrap-safe)."""
    n = state.meta.shape[1]
    ids = ids.to(torch.int64)
    cur = torch.gather(state.meta[..., GEN], 1, ids.clamp(0, n - 1))
    return (cur == _u32(gens.to(torch.int64))) & (ids >= 0)


# ------------------------------------------------------------- grow / shrink
def pool_grow(mesh, desc: PoolDescriptor, state: PoolState, extra: int
              ) -> tuple[PoolDescriptor, PoolState]:
    """Grow every rank's pool by `extra` pages, on the mesh device.

    The §2.2 dynamic-window protocol: detach the three regions, re-attach
    them at the new size, so every remote `DescriptorCache` refetches.  Per
    rank the new stack is the kept free prefix, then the new page ids."""
    if extra < 1:
        raise HeapError(f"need extra >= 1, got {extra}")
    n = desc.n_pages
    new_desc = _reattach(desc, n + extra)
    p = mesh.p
    pages = state.pages.new_empty((p, n + extra) + desc.page_shape)
    pages[:, :n] = state.pages
    pages[:, n:] = 0
    meta = state.meta.new_zeros((p, n + extra, N_META))
    meta[:, :n] = state.meta
    top = state.head[:, FREE_TOP, None]
    i = torch.arange(n + extra, device=top.device)
    kept = torch.gather(state.free_stack, 1, i.clamp(max=n - 1).expand(p, -1))
    fresh = torch.where(i < top + extra, n + i - top, torch.zeros_like(i))
    stack = torch.where(i < top, kept.to(torch.int64), fresh).to(torch.int32)
    head = _u32(state.head + torch.tensor([extra, 1, 0, 0, 0], device=top.device))
    return new_desc, PoolState(pages, meta, stack, head)


def pool_shrink(mesh, desc: PoolDescriptor, state: PoolState, remove: int
                ) -> tuple[PoolDescriptor, PoolState]:
    """Shrink every rank's pool by its `remove` highest page ids, on the
    mesh device.  Refuses unless those pages are free on every rank (live
    pages cannot be deregistered under their references).  The free stack
    keeps its entries below the new size, in order."""
    n = desc.n_pages
    n_new = n - remove
    if remove < 1 or n_new < 1:
        raise HeapError(f"cannot shrink {n} pages by {remove}")
    live = (state.meta[:, n_new:, REF] > 0).any(dim=1)
    if bool(live.any()):
        ranks = live.nonzero().flatten().tolist()
        raise HeapError(
            f"pages >= {n_new} still live on ranks {ranks}: release before shrink")
    new_desc = _reattach(desc, n_new)
    p = mesh.p
    old = state.free_stack.to(torch.int64)
    i = torch.arange(n, device=old.device)
    keep = (i < state.head[:, FREE_TOP, None]) & (old < n_new)
    k = keep.to(torch.int64)
    slot = torch.cumsum(k, 1) - k
    slot = torch.where(keep & (slot < n_new), slot, torch.full_like(slot, n_new))
    stack = torch.zeros((p, n_new + 1), dtype=torch.int32, device=old.device)
    stack = stack.scatter_(1, slot, state.free_stack)[:, :n_new]
    head = state.head.clone()
    head[:, FREE_TOP] = k.sum(1)
    head[:, EPOCH] = _u32(head[:, EPOCH] + 1)
    return new_desc, PoolState(state.pages[:, :n_new].clone(),
                               state.meta[:, :n_new].clone(), stack, head)


# ---------------------------------------------------------------- invariants
def conservation(desc: PoolDescriptor, state: PoolState) -> dict:
    """Conservation check, read to the host.  Per rank: free_top +
    #(refcount > 0) == n_pages, and the free stack's first free_top entries
    are exactly the dead pages (set equality)."""
    meta = state.meta.cpu().numpy()
    head = state.head.cpu().numpy()
    stack = state.free_stack.cpu().numpy()
    p = meta.shape[0]
    free = head[:, FREE_TOP].astype(np.int64)
    live = (meta[:, :, REF] > 0).sum(axis=1).astype(np.int64)
    stack_ok = np.zeros((p,), bool)
    for r in range(p):
        free_set = np.unique(stack[r, : int(free[r])])
        dead = np.nonzero(meta[r, :, REF] == 0)[0]
        stack_ok[r] = free_set.size == int(free[r]) and np.array_equal(free_set, dead)
    return {
        "free_plus_live": free + live,
        "capacity": desc.n_pages,
        "free": free,
        "live": live,
        "stack_consistent": stack_ok,
        "protocol_errors": head[:, ERRS].astype(np.int64),
    }


def check_errors(desc: PoolDescriptor, state: PoolState) -> None:
    """The host surface of the device pool's protocol violations: device
    code cannot raise, so double-free / share-dead deltas are dropped whole
    and counted in the ERRS head column; a nonzero count becomes the same
    `HeapError` the host pool raises, naming the ranks."""
    errs = state.head[..., ERRS].reshape(-1).cpu().numpy().astype(np.int64)
    bad = np.nonzero(errs)[0]
    if bad.size:
        detail = ", ".join(f"rank {int(r)}: {int(errs[r])}" for r in bad)
        raise HeapError(
            f"SPMD refcount protocol violations (double-free or share-dead "
            f"deltas dropped at the owner) — {detail}")


# ----------------------------------------------------------- host simulation
# 64-bit free-list head word: (generation << 32) | head-page-index.
_IDX_MASK = (1 << 32) - 1
_EMPTY = _IDX_MASK          # index sentinel: empty list


def head_pack(gen: int, idx: int) -> int:
    return ((gen & _IDX_MASK) << 32) | (idx & _IDX_MASK)


def head_unpack(word: int) -> tuple[int, int]:
    return (word >> 32) & _IDX_MASK, word & _IDX_MASK


class HostPagePool:
    """The literal remote free-list: CAS on a (generation, head) word.
    AMO counts (`total_amos`) let tests assert the O(1)-expected-steps claim."""

    def __init__(self, n_pages: int, page_words: int = 1, dtype=np.float32,
                 fabric=None, name: str = "heap", owner: int = 0):
        if n_pages < 1 or n_pages >= _EMPTY:
            raise HeapError(f"bad n_pages {n_pages}")
        self.n_pages = n_pages
        self.pages = np.zeros((n_pages, page_words), dtype)
        self.next = np.full((n_pages,), _EMPTY, np.int64)
        self.gen = np.zeros((n_pages,), np.uint32)        # per-page ABA tag
        self.ref = [_AtomicWord() for _ in range(n_pages)]
        self.head = _AtomicWord()
        self.owner = owner
        self.name = name
        self.fabric = default_fabric(fabric)
        self._bank_head = f"{name}.head"
        self._bank_ref = f"{name}.ref"
        self.fabric.register_words(self._bank_head, [self.head], owner=owner)
        self.fabric.register_words(self._bank_ref, self.ref, owner=owner)
        # the initial list: 0 -> 1 -> ... -> n-1
        self.next[: n_pages - 1] = np.arange(1, n_pages)
        self.head.v = head_pack(0, 0)
        self.allocs = 0
        self.frees = 0

    @property
    def total_amos(self) -> int:
        return self.head.amo_count + sum(w.amo_count for w in self.ref)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, origin: int = 0) -> Optional[int]:
        """Pop the head page (CAS loop); None when the pool is dry."""
        fab = self.fabric
        while True:
            old = fab.read_word(origin, self._bank_head, 0)
            gen, idx = head_unpack(old)
            if idx == _EMPTY:
                return None
            nxt = int(self.next[idx])
            new = head_pack(gen + 1, nxt)
            if fab.cas(origin, self._bank_head, 0, old, new) == old:
                self.gen[idx] += np.uint32(1)             # alloc bump
                self.ref[idx].v = 1
                self.allocs += 1
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("heap.alloc", rank=origin, pool=self.name,
                             page=idx, gen=int(self.gen[idx]),
                             rid=obs_causal.current_rid())
                return idx

    def free(self, idx: int, origin: int = 0) -> None:
        """Push a dead page back (CAS loop); generation advances again."""
        fab = self.fabric
        if not 0 <= idx < self.n_pages:
            raise HeapError(f"free of page {idx} outside pool")
        if fab.read_word(origin, self._bank_ref, idx) != 0:
            err = HeapError(f"free of live page {idx} (refcount > 0)")
            obs_flight.on_error(err, tag=self.name)
            raise err
        self.gen[idx] += np.uint32(1)                     # free bump
        while True:
            old = fab.read_word(origin, self._bank_head, 0)
            gen, head_idx = head_unpack(old)
            # next[idx] is single-writer: only the 1->0 release winner can
            # push idx, so a failed CAS simply re-reads the head and re-links
            self.next[idx] = head_idx
            new = head_pack(gen + 1, idx)
            if fab.cas(origin, self._bank_head, 0, old, new) == old:
                self.frees += 1
                tr = obs_trace.TRACER
                if tr.enabled:
                    tr.event("heap.free", rank=origin, pool=self.name,
                             page=idx, gen=int(self.gen[idx]),
                             rid=obs_causal.current_rid())
                return

    # -------------------------------------------------------------- refcount
    def ref_add(self, idx: int, delta: int = 1, origin: int = 0) -> int:
        """Fetch-and-add on the page's refcount word; returns the old count.
        Sharing a dead page is a protocol bug and raises."""
        fab = self.fabric
        old = fab.fetch_add(origin, self._bank_ref, idx, delta)
        if delta > 0 and old == 0:
            fab.fetch_add(origin, self._bank_ref, idx, -delta)
            err = HeapError(f"ref_add on dead page {idx} (ABA hazard)")
            obs_flight.on_error(err, tag=self.name)
            raise err
        return old

    def release(self, idx: int, origin: int = 0) -> bool:
        """Decrement; the 1 -> 0 winner pushes the page back.  True if freed."""
        fab = self.fabric
        old = fab.fetch_add(origin, self._bank_ref, idx, -1)
        if old <= 0:
            fab.fetch_add(origin, self._bank_ref, idx, 1)
            err = HeapError(f"release of dead page {idx} (double free)")
            obs_flight.on_error(err, tag=self.name)
            raise err
        if old == 1:
            self.free(idx, origin=origin)
            return True
        return False

    def pin(self, idx: int, origin: int = 0) -> int:
        """Pull-side liveness pin: a refcount bump before a puller reads the
        page, so it cannot be freed and reallocated mid-pull.  Returns the
        page's generation tag for `unpin`.  Raises on a dead page."""
        self.ref_add(idx, 1, origin=origin)
        return self.tag(idx)

    def unpin(self, idx: int, tag: int, origin: int = 0) -> bool:
        """Drop a pin; `tag` must be the one `pin` returned (a generation
        change means the pin never covered the page read).  True if this
        freed the page."""
        if not self.tag_valid(idx, tag):
            err = HeapError(
                f"unpin of page {idx} with stale tag {tag} "
                f"(now {self.tag(idx)})")
            obs_flight.on_error(err, tag=self.name)
            raise err
        return self.release(idx, origin=origin)

    def tag(self, idx: int) -> int:
        """Current generation of a page — cache alongside the id."""
        return int(self.gen[idx])

    def tag_valid(self, idx: int, tag: int) -> bool:
        return 0 <= idx < self.n_pages and int(self.gen[idx]) == (tag & 0xFFFFFFFF)

    # ------------------------------------------------------------ inspection
    def free_count(self) -> int:
        """Walk the list (quiescent use only — tests, conservation)."""
        n = 0
        _, idx = head_unpack(self.head.v)
        while idx != _EMPTY and n <= self.n_pages:
            n += 1
            idx = int(self.next[idx])
        return n

    def live_count(self) -> int:
        return sum(1 for w in self.ref if w.v > 0)

    def conservation(self) -> dict:
        free, live = self.free_count(), self.live_count()
        return {
            "free": free,
            "live": live,
            "free_plus_live": free + live,
            "capacity": self.n_pages,
        }
