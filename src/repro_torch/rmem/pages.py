"""Paged remote KV-cache with hash-keyed prefix sharing (the
`repro.rmem.pages` counterpart).

A request's KV cache is a list of fixed-size token pages living in
decode-rank page pools, and the unit that crosses the wire is a page-table
entry — an (owner, page id) int32 pair — not the page payload.  Identical
prompt prefixes resolve to the same pages: a prefix-index hit bumps a
refcount (zero payload bytes on the wire); a miss allocates from the
owner's free list and ships the page once.  Requests are routed by
rendezvous hash of their FIRST page key, so the decoder's page reads are
pool-local.

Host side: `PagedKVPool` over per-owner `HostPagePool`s, with the elastic
join (`add_owner`) and leave (`migrate_from`: live pages re-homed on
survivors, refcounts kept, same-content pages merged) that `ft.elastic`
wraps as policy.  Device side:
`scatter_pages` writes novel pages into the owners' pools in ONE fused
all-to-all; `gather_pages` is the consumer's pull by descriptor (two fused
gets, the rendezvous data path); `gather_local` is the owner-local
page-table read; `gather_shift` reads rows of the pool of rank r + shift
through the paged-gather kernel.  On a `ProcMesh` (one rank a process) the
device tensors lead with this process's one rank block (``[1, ...]``, the
rule of `rmaq.queue`), and `gather_shift` needs the pool in a symmetric
segment (`ProcMesh.symmetric`, `core.window.win_allocate`): it reads the
owner's pool in place through the peer mapping.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import plan as plan_mod
from ..kernels.paged_gather import ops as pg_ops
from ..mesh import Mesh
from . import heap

# page-table wire format: one int32 pair per page
ENTRY_OWNER, ENTRY_PAGE = range(2)
ENTRY_WORDS = 2


class PageRef(NamedTuple):
    """A page-table entry plus its ABA tag (the tag never hits the wire)."""

    owner: int
    page_id: int
    tag: int


def page_key(tokens) -> bytes:
    """Content hash key of one token page (a page's KV depends only on its
    tokens in the embedding-KV model)."""
    return np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()


def split_pages(tokens, page_tokens: int) -> list:
    """Split a prompt into fixed-size token pages (must divide evenly)."""
    toks = np.asarray(tokens, np.int32)
    if toks.size % page_tokens:
        raise heap.HeapError(
            f"prompt length {toks.size} not a multiple of page_tokens {page_tokens}")
    return [toks[i : i + page_tokens] for i in range(0, toks.size, page_tokens)]


def route_owner(key: bytes, owners: Sequence[int]) -> int:
    """Rendezvous (highest-random-weight) routing: identical prefixes go to
    the identical owner, and an owner joining or leaving only moves its own
    keys."""
    return max(owners, key=lambda r: (zlib.crc32(key + r.to_bytes(4, "little")), r))


# =========================================================================
# host coordinator: per-owner pools + prefix index + page tables
# =========================================================================
class PagedKVPool:
    """Host-side paged-KV coordinator over per-owner `HostPagePool`s: the
    scheduler's mirror of the device pools (allocation, prefix dedup,
    refcounts), while page payloads live in the device pool tensor."""

    def __init__(self, owners: Sequence[int], n_pages: int,
                 page_words: int = 1, dtype=np.float32, fabric=None):
        if not owners:
            raise heap.HeapError("need at least one owner rank")
        self.owners = list(owners)
        self.n_pages = n_pages
        self.page_words = page_words
        self.dtype = dtype
        self.fabric = fabric
        self._pool_gen = 0              # unique bank names across re-joins
        self.pools = {r: self._new_pool(r) for r in self.owners}
        # the prefix index is per owner: sharing is only sound when the hit
        # lives where the request is routed
        self.index: dict[tuple[int, bytes], PageRef] = {}
        self.rev: dict[tuple[int, int], bytes] = {}
        self.page_tables: dict[int, list[PageRef]] = {}
        self.hits = 0
        self.misses = 0
        self.dry = 0

    def _new_pool(self, rank: int) -> heap.HostPagePool:
        self._pool_gen += 1
        return heap.HostPagePool(
            self.n_pages, self.page_words, self.dtype, fabric=self.fabric,
            name=f"kv{rank}.{self._pool_gen}", owner=rank)

    def route(self, first_key: bytes) -> int:
        return route_owner(first_key, self.owners)

    def acquire(self, owner: int, key: bytes) -> Optional[tuple[PageRef, bool]]:
        """One page for `key` at `owner`: (ref, shared).  A hit bumps the
        refcount (shared=True); a miss pops the owner's free list
        (shared=False: the caller ships the payload).  None when dry."""
        ref = self.index.get((owner, key))
        if ref is not None:
            self.pools[owner].ref_add(ref.page_id, 1)
            self.hits += 1
            return ref, True
        pid = self.pools[owner].alloc()
        if pid is None:
            self.dry += 1
            return None
        ref = PageRef(owner, pid, self.pools[owner].tag(pid))
        self.index[(owner, key)] = ref
        self.rev[(owner, pid)] = key
        self.misses += 1
        return ref, False

    def release_ref(self, ref: PageRef) -> bool:
        """Refcount decrement; the 1 -> 0 winner frees the page and retires
        its index entry.  True if the page was freed."""
        freed = self.pools[ref.owner].release(ref.page_id)
        if freed:
            key = self.rev.pop((ref.owner, ref.page_id), None)
            if key is not None:
                self.index.pop((ref.owner, key), None)
        return freed

    def table_set(self, rid: int, refs: list[PageRef]) -> None:
        if rid in self.page_tables:
            raise heap.HeapError(f"request {rid} already has a page table")
        self.page_tables[rid] = list(refs)

    def table_release(self, rid: int) -> list[PageRef]:
        """Release every page a finished request referenced; returns the
        refs actually freed."""
        refs = self.page_tables.pop(rid)
        return [ref for ref in refs if self.release_ref(ref)]

    def table_entries(self, rid: int) -> np.ndarray:
        """[n_pages_of_request, 2] int32 — the wire format rows."""
        return np.asarray(
            [[r.owner, r.page_id] for r in self.page_tables[rid]], np.int32)

    def conservation(self) -> dict:
        per = {r: pool.conservation() for r, pool in self.pools.items()}
        return {
            "per_owner": per,
            "ok": all(c["free_plus_live"] == c["capacity"] for c in per.values()),
        }

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "dry": self.dry,
            "hit_rate": self.hits / max(self.hits + self.misses, 1),
            "live_pages": {r: p.live_count() for r, p in self.pools.items()},
        }

    # ------------------------------------------------------------- elastic
    def add_owner(self, rank: int) -> None:
        """Rank join: bring up an empty pool and add it to the routing set."""
        if rank in self.pools:
            raise heap.HeapError(f"rank {rank} already owns a pool")
        self.pools[rank] = self._new_pool(rank)
        self.owners.append(rank)

    def migrate_from(self, leaving: int) -> dict:
        """Rank leave: move every live page off `leaving` onto survivors.

        Per live page: one get (the page and its refcount from the leaving
        rank) and one put (into a survivor's freshly allocated page), the
        refcount transferred verbatim.  If the survivor already indexes the
        same key, the two pages are merged (refcounts added): migration is
        also a dedup pass.  A full survivor spills to any survivor with
        capacity.  Page tables, the prefix index and the reverse index are
        rewritten; the leaving pool is dropped whole.  Returns
        ``{"moved", "merged", "mapping"}``."""
        if leaving not in self.pools:
            raise heap.HeapError(f"rank {leaving} owns no pool")
        if len(self.owners) < 2:
            raise heap.HeapError("cannot migrate from the last owner")
        src = self.pools.pop(leaving)
        self.owners.remove(leaving)

        mapping: dict[tuple[int, int], PageRef] = {}
        moved = merged = 0
        for pid in range(src.n_pages):
            rc = int(src.ref[pid].v)
            if rc <= 0:
                continue
            key = self.rev.pop((leaving, pid), None)
            target = self.route(key) if key is not None else self.owners[0]
            existing = self.index.get((target, key)) if key is not None else None
            if existing is not None:
                # the survivor holds this content already: merge refcounts
                self.pools[target].ref[existing.page_id].fetch_add(rc)
                mapping[(leaving, pid)] = existing
                merged += 1
                continue
            npid = self.pools[target].alloc()
            if npid is None:
                # spill: indexed under the spill owner, so requests routed
                # to the full owner store a second copy (capacity, not
                # correctness)
                for r in self.owners:
                    npid = self.pools[r].alloc()
                    if npid is not None:
                        target = r
                        break
            if npid is None:
                raise heap.HeapError(
                    f"no survivor capacity for live page ({leaving}, {pid})")
            self.pools[target].pages[npid] = src.pages[pid]      # the get + put
            self.pools[target].ref[npid].v = rc
            nref = PageRef(target, npid, self.pools[target].tag(npid))
            if key is not None:
                self.index[(target, key)] = nref
                self.rev[(target, npid)] = key
            mapping[(leaving, pid)] = nref
            moved += 1

        # the leaving rank's remaining index entries name dead pages
        self.index = {k: v for k, v in self.index.items() if k[0] != leaving}
        for rid, refs in self.page_tables.items():
            self.page_tables[rid] = [
                mapping[(ref.owner, ref.page_id)] if ref.owner == leaving else ref
                for ref in refs
            ]
        return {"moved": moved, "merged": merged, "mapping": mapping}


# =========================================================================
# device data plane
# =========================================================================
def scatter_pages(mesh: Mesh, pool: torch.Tensor, payload: torch.Tensor,
                  slot: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Write pages into remote pools (collective).

    pool [R, n_pages, *ps], payload [R, S, *ps], slot/dest [R, S] int
    (-1 = no page in that staging slot; R = ``mesh.local_ranks``).  Payloads
    and their target slots ride ONE fused all-to-all; each owner scatters
    rows into its pool.  The pool is updated **in place** (a functional
    update would copy every rank's whole pool per step) and returned."""
    p, n_pages, R = mesh.p, pool.shape[1], mesh.local_ranks
    S = slot.shape[1]
    dev = pool.device
    flat = payload.reshape(R, S, -1).to(pool.dtype)
    slot = slot.to(torch.int64)
    dest = dest.to(torch.int64)
    valid = (dest >= 0) & (dest < p) & (slot >= 0) & (slot < n_pages)
    drow = torch.where(valid, dest, torch.full_like(dest, p))   # p = trash row
    rows = torch.arange(R, device=dev)[:, None].expand_as(drow)
    j = torch.arange(S, device=dev)[None, :].expand_as(drow)
    send_pay = torch.zeros((R, p + 1, S, flat.shape[2]), dtype=pool.dtype,
                           device=dev)
    send_pay[rows, drow, j] = flat
    send_slot = torch.full((R, p + 1, S), -1, dtype=torch.int32, device=dev)
    send_slot[rows, drow, j] = torch.where(
        valid, slot, torch.full_like(slot, -1)).to(torch.int32)

    plan = plan_mod.RmaPlan(mesh)
    h_pay = plan.put_all_to_all(send_pay[:, :p], kind="puts")
    h_slot = plan.put_all_to_all(send_slot[:, :p], kind=None)   # rider
    plan.flush(aggregate=True)
    recv_pay = h_pay.result().reshape(R, p * S, -1)
    recv_slot = h_slot.result().reshape(R, p * S).to(torch.int64)

    r_idx, i_idx = (recv_slot >= 0).nonzero(as_tuple=True)
    pool.view(R, n_pages, -1)[r_idx, recv_slot[r_idx, i_idx]] = recv_pay[r_idx, i_idx]
    return pool


def gather_local(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Owner-local page-table read: pool [n_pages, *ps], ids [...] int
    (-1 = zero page).  No communication."""
    n_pages = pool.shape[0]
    out = pool[torch.clamp(ids.to(torch.int64), 0, n_pages - 1)]
    mask = (ids >= 0).reshape(tuple(ids.shape) + (1,) * (out.ndim - ids.ndim))
    return torch.where(mask, out, torch.zeros_like(out))


def gather_pages(mesh: Mesh, pool: torch.Tensor, entries: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Pull pages from their owners' pools by descriptor (collective): the
    rendezvous data path.

    pool [R, n_pages, *ps], entries [R, m, ppb, 2] int ((owner, page id)
    rows, the published descriptors), valid [R, m] bool.  The consumer
    initiates: one fused get carries the wanted-id lists to every owner,
    the owners' packed replies come back on a second — two wire transfers,
    batched over every (request, page) pair.  Returns [R, m, ppb, *ps] with
    invalid requests zeroed.  Every rank takes part: ranks that want
    nothing send empty id lists and still serve replies from their pool."""
    p, n_pages, R = mesh.p, pool.shape[1], mesh.local_ranks
    m, ppb = entries.shape[1], entries.shape[2]
    S = m * ppb                                          # flat pull slots
    dev = pool.device
    owner = entries[..., ENTRY_OWNER].reshape(R, S).to(torch.int64)
    pid = entries[..., ENTRY_PAGE].reshape(R, S).to(torch.int64)
    want = (valid.repeat_interleave(ppb, dim=1) & (owner >= 0) & (owner < p)
            & (pid >= 0) & (pid < n_pages))
    orow = torch.where(want, owner, torch.full_like(owner, p))   # p = trash row
    me = torch.arange(R, device=dev)[:, None].expand_as(orow)    # my rows
    j = torch.arange(S, device=dev)[None, :].expand_as(orow)
    # row d of rank r: the page ids r wants from owner d (-1 elsewhere)
    send_ids = torch.full((R, p + 1, S), -1, dtype=torch.int32, device=dev)
    send_ids[me, orow, j] = torch.where(want, pid, torch.full_like(pid, -1)).to(torch.int32)

    plan = plan_mod.RmaPlan(mesh)
    h_ids = plan.put_all_to_all(send_ids[:, :p], kind="gets")   # id lists out
    plan.flush(aggregate=True)
    recv_ids = h_ids.result()                            # [owner, requester, S]

    # every owner serves every requester from its pool; -1 slots reply zeros
    flat = pool.view(R, n_pages, -1)
    safe = torch.clamp(recv_ids.to(torch.int64), 0, n_pages - 1)
    reply = flat[torch.arange(R, device=dev)[:, None, None], safe]   # [owner, req, S, w]
    reply.masked_fill_((recv_ids < 0)[..., None], 0)

    plan = plan_mod.RmaPlan(mesh)
    h_pay = plan.put_all_to_all(reply, kind="gets")      # packed replies back
    plan.flush(aggregate=True)
    recv_pay = h_pay.result()                            # [requester, owner, S, w]

    out = recv_pay[me, torch.clamp(orow, 0, p - 1), j]   # [R, S, w]
    out.masked_fill_(~want[..., None], 0)
    return out.reshape((R, m, ppb) + tuple(pool.shape[2:]))


def gather_shift(mesh: Mesh, pool: torch.Tensor, ids: torch.Tensor,
                 shift: int) -> torch.Tensor:
    """Cross-rank page read: rank r fetches rows ``ids[r]`` of rank
    (r + shift)'s pool.  pool [R, n_pages, *ps], ids [R, k] int32 ->
    [R, k, *ps], rows whose id is < 0 zeroed (on a `ProcMesh`, R = 1 and
    the pool a symmetric tensor).  One paged-gather launch in
    hole mode on the card (its plain version on the CPU): the kernel clamps
    ids past the pool and writes a hole as zero words without reading it,
    which is the reference's gather of the clamped ids and its mask."""
    return pg_ops.paged_gather(pool, ids, shift, mesh, holes=True)
