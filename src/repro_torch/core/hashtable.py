"""Distributed hashtable on one-sided RMA (paper §4.1): the
`repro.core.hashtable` counterpart over the stacked rank axis.

Each rank owns a *local volume*: a fixed-size table plus an overflow heap,
with the next-free and last-inserted pointers stored inline.  Inserts go to
the owner of hash(key); a key whose table slot holds another key chains
into the heap at the head of that slot's list (the paper's CAS on the
last pointer).

Inserts are batched per epoch: `dsde.exchange_accumulate` routes every
item to its owner (counter accumulate plus one-sided puts), and the owner
applies its received batch.  Lookups are the same exchange of queries, an
owner-side probe of table slot and chain, and the answers put back.

Every tensor is the global view: a volume's leaves are ``[p, table_size]``
and ``[p, heap_size]`` with ``next_free`` and ``last_insert`` ``[p]``, keys
``[p, n]``.  On a `ProcMesh` (one rank a process) the leading dim is this
process's one rank block, R = ``mesh.local_ranks`` (``make_volume(..., R)``):
the owner's work sizes by the volume's rows and only the owner ids and
slot ranges a peer indexes keep p.  Keys and values are int64, links int32.  (The reference
declares the same widths; run without JAX's x64 mode, as its tests run, its
volume is int32.)

The owner insert.  The reference walks the received batch one item at a
time (a `fori_loop`).  `owner_insert` computes the same state with tensor
code over every rank at once; `owner_insert_plain` is that loop in Python,
kept for the tests.  Per rank, in receive order, with ``T0`` the table
keys before the batch:

  * the *filler* of a slot that was empty is its first valid item with a
    key other than `EMPTY`; the slot's key after the batch, ``TK[s]``, is
    ``T0[s]`` if it was set, else the filler's key, and never changes
    after the fill;
  * a valid item is *table-bound* if its key equals ``TK[s]`` (the filler
    and every overwrite; an `EMPTY` key that reaches an empty slot before
    its filler also writes the value), and *heap-bound* otherwise: only
    the table key is checked, so a key already in the heap goes in again
    at the head of the chain;
  * ``table_val[s]`` takes the value of the last table-bound item at s;
  * a heap-bound item's cell is ``next_free + r``, r its exclusive rank
    among the batch's heap-bound items; it is kept iff the cell is below
    ``heap_size``.  Past that the heap is full and the item vanishes,
    uncounted, as in the reference;
  * a kept cell links to the cell of the previous kept item at its slot,
    or to the slot's old chain head; ``table_next[s]`` becomes the last
    kept cell at s, ``next_free`` advances by the cells kept and
    ``last_insert`` is the last of them.

Scatters the reference drops out of range are masked into a trash column
here: a CUDA index out of range is a device assert.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..mesh import Mesh, resolve_device
from . import dsde, plan as plan_mod

EMPTY = -1
U32_MASK = 0xFFFFFFFF
OWNER_MUL, SLOT_MUL = 0x9E3779B9, 0x85EBCA6B
WALK_CHECK = 4          # chain-walk steps between host checks for a live chain


class LocalVolume(NamedTuple):
    """Every rank's shard (paper Fig. 7a text), rank r in row r."""

    table_key: torch.Tensor     # [p, table_size] int64, EMPTY if free
    table_val: torch.Tensor     # [p, table_size] int64
    table_next: torch.Tensor    # [p, table_size] int32 heap cell, -1 = end
    heap_key: torch.Tensor      # [p, heap_size] int64
    heap_val: torch.Tensor      # [p, heap_size] int64
    heap_next: torch.Tensor     # [p, heap_size] int32
    next_free: torch.Tensor     # [p] int32, the paper's next-free-cell pointer
    last_insert: torch.Tensor   # [p] int32, the most recently filled heap cell


def make_volume(table_size: int, heap_size: int, p: int, device=None) -> LocalVolume:
    """An empty volume of `p` rank rows: the mesh's p stacked, or a
    `ProcMesh`'s ``local_ranks`` (1)."""
    dev = resolve_device(device)

    def full(n, v, dtype):
        return torch.full((p, n), v, dtype=dtype, device=dev)

    return LocalVolume(
        table_key=full(table_size, EMPTY, torch.int64),
        table_val=full(table_size, 0, torch.int64),
        table_next=full(table_size, -1, torch.int32),
        heap_key=full(heap_size, EMPTY, torch.int64),
        heap_val=full(heap_size, 0, torch.int64),
        heap_next=full(heap_size, -1, torch.int32),
        next_free=torch.zeros(p, dtype=torch.int32, device=dev),
        last_insert=torch.full((p,), -1, dtype=torch.int32, device=dev),
    )


def volume_from_numpy(leaves: Sequence, device=None) -> LocalVolume:
    """A volume read out as numpy arrays (the 8 leaves in `LocalVolume`'s
    order, stacked over ranks; e.g. the reference's, of any integer width)
    as the port's, at its declared dtypes."""
    dev = resolve_device(device)
    dtypes = (torch.int64, torch.int64, torch.int32, torch.int64, torch.int64,
              torch.int32, torch.int32, torch.int32)
    return LocalVolume(*(torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev, dt)
                         for a, dt in zip(leaves, dtypes, strict=True)))


# -------------------------------------------------------------------- hashes
def _mul_hash(keys: torch.Tensor, mul: int, shift: int) -> torch.Tensor:
    """The reference's uint32 multiplicative hash in int64: the product of
    two 32-bit values may wrap int64, but its low 32 bits are exact."""
    return (((keys.long() & U32_MASK) * mul) & U32_MASK) >> shift


def hash_owner(keys: torch.Tensor, p: int) -> torch.Tensor:
    """Rank owning each key (Fibonacci multiplicative hash), int32."""
    return (_mul_hash(keys, OWNER_MUL, 16) % p).to(torch.int32)


def hash_slot(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    return (_mul_hash(keys, SLOT_MUL, 13) % table_size).to(torch.int32)


# --------------------------------------------------------------- owner insert
def _pad(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x [p, n] with one trash column n appended (a copy)."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat((x, col), dim=1)


def owner_insert(vol: LocalVolume, keys: torch.Tensor, vals: torch.Tensor,
                 valid: torch.Tensor) -> LocalVolume:
    """Apply every rank's received batch (keys, vals, valid [p, m]) to its
    volume: the reference's sequential collision-to-heap loop, computed
    bit for bit with tensor code (the module docstring has the rules)."""
    p, T = vol.table_key.shape
    H = vol.heap_key.shape[1]
    m = keys.shape[1]
    if m == 0:
        return vol
    dev = keys.device
    keys, vals = keys.long(), vals.long()
    pos = torch.arange(m, device=dev).expand(p, m)
    s = torch.where(valid, hash_slot(keys, T).long(), T)     # T: the trash slot

    # the slot's key after the batch: the old one, else its filler's
    t0_at = _pad(vol.table_key, EMPTY).gather(1, s)
    cand = valid & (keys != EMPTY) & (t0_at == EMPTY)
    fill = torch.full((p, T + 1), m, dtype=torch.int64, device=dev).scatter_reduce_(
        1, torch.where(cand, s, T), pos, "amin")
    filled = torch.where(fill[:, :T] < m, keys.gather(1, fill[:, :T].clamp(max=m - 1)), EMPTY)
    table_key = torch.where(vol.table_key != EMPTY, vol.table_key, filled)
    on_table = valid & ((keys == _pad(table_key, EMPTY).gather(1, s))
                        | ((keys == EMPTY) & (t0_at == EMPTY) & (pos < fill.gather(1, s))))

    # the value of the last table-bound item at each slot
    last = torch.full((p, T + 1), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        1, torch.where(on_table, s, T), pos, "amax")[:, :T]
    table_val = torch.where(last >= 0, vals.gather(1, last.clamp(min=0)), vol.table_val)

    # heap-bound items take consecutive cells from next_free while they last
    to_heap = valid & ~on_table
    cell = vol.next_free.long()[:, None] + torch.cumsum(to_heap, 1) - to_heap.long()
    kept = to_heap & (cell < H)
    cell_w = torch.where(kept, cell, H)                         # H: the trash cell
    heap_key = _pad(vol.heap_key, EMPTY).scatter_(1, cell_w, keys)[:, :H]
    heap_val = _pad(vol.heap_val, 0).scatter_(1, cell_w, vals)[:, :H]

    # each kept cell links to the previous kept cell at its slot, or to the
    # slot's old chain head: kept items by slot, receive order within one
    ks, order = torch.sort(torch.where(kept, s, T), dim=1, stable=True)
    cs = cell.gather(1, order)
    head0 = _pad(vol.table_next, -1).gather(1, ks).long()
    link = torch.cat((head0[:, :1], torch.where(ks[:, 1:] == ks[:, :-1], cs[:, :-1],
                                                  head0[:, 1:])), dim=1)
    heap_next = _pad(vol.heap_next, -1).scatter_(
        1, torch.where(ks < T, cs, H), link.to(torch.int32))[:, :H]
    newest = torch.full((p, T + 1), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        1, torch.where(kept, s, T), cell, "amax")[:, :T]
    table_next = torch.where(newest >= 0, newest.to(torch.int32), vol.table_next)

    n_kept = kept.sum(1, dtype=torch.int32)
    next_free = vol.next_free + n_kept
    last_insert = torch.where(n_kept > 0, next_free - 1, vol.last_insert)
    return LocalVolume(table_key, table_val, table_next, heap_key, heap_val, heap_next,
                       next_free, last_insert)


def _slot_int(k: int, table_size: int) -> int:
    return ((((k & U32_MASK) * SLOT_MUL) & U32_MASK) >> 13) % table_size


def owner_insert_plain(vol: LocalVolume, keys: torch.Tensor, vals: torch.Tensor,
                       valid: torch.Tensor) -> LocalVolume:
    """`owner_insert` as the reference's loop (`_owner_insert`), line for
    line over host ints, one rank after another.  For tests and checks."""
    tk, tv, tn, hk, hv, hn, nf, li = (x.cpu().numpy().copy() for x in vol)
    keys, vals, valid = keys.cpu().numpy(), vals.cpu().numpy(), valid.cpu().numpy()
    table_size, heap_size = tk.shape[1], hk.shape[1]
    for r in range(tk.shape[0]):
        for i in range(keys.shape[1]):
            if not valid[r, i]:
                continue
            k, v = int(keys[r, i]), int(vals[r, i])
            s = _slot_int(k, table_size)
            if tk[r, s] == EMPTY:                   # into the table
                tk[r, s], tv[r, s] = k, v
            elif tk[r, s] == k:                     # same key: overwrite
                tv[r, s] = v
            else:                                   # a new overflow cell
                idx = int(nf[r])
                if idx < heap_size:
                    hk[r, idx], hv[r, idx], hn[r, idx] = k, v, tn[r, s]
                    tn[r, s] = idx
                    nf[r] += 1
                    li[r] = idx
    dev = vol.table_key.device
    return LocalVolume(*(torch.from_numpy(a).to(dev) for a in (tk, tv, tn, hk, hv, hn, nf, li)))


# ------------------------------------------------------------------- epochs
def insert_epoch(vol: LocalVolume, keys: torch.Tensor, vals: torch.Tensor, mesh: Mesh,
                 capacity_per_pair: int) -> tuple[LocalVolume, torch.Tensor]:
    """One insert epoch: every rank's keys and values [R, n] routed to their
    owners by one DSDE exchange (one-sided puts), then the owner insert.
    Returns (the new volume, [R] items each rank dropped to the capacity)."""
    keys = keys.long()
    items = torch.stack((keys, vals.long()), dim=2)             # [p, n, 2]
    res = dsde.exchange_accumulate(items, hash_owner(keys, mesh.p), mesh,
                                   capacity_per_pair)
    vol = owner_insert(vol, res.recv_data[..., 0], res.recv_data[..., 1], res.recv_valid)
    return vol, res.sent_dropped


def _probe(vol: LocalVolume, keys: torch.Tensor, live: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner-side probe of [p, m] keys: the table slot, then the chain from
    its head.  A chain stops at its first hit (the newest copy of a key);
    the walk ends once no chain is live, checked every `WALK_CHECK` steps,
    and after heap_size steps at most, as the reference's fixed walk."""
    slots = hash_slot(keys, vol.table_key.shape[1]).long()
    found = vol.table_key.gather(1, slots) == keys
    vals = torch.where(found, vol.table_val.gather(1, slots), 0)
    nxt = torch.where(live & ~found, vol.table_next.gather(1, slots).long(), -1)
    for step in range(vol.heap_key.shape[1]):
        if step % WALK_CHECK == 0 and not bool((nxt >= 0).any()):
            break
        idx = nxt.clamp(min=0)
        hit = (nxt >= 0) & (vol.heap_key.gather(1, idx) == keys)
        vals = torch.where(hit, vol.heap_val.gather(1, idx), vals)
        found = found | hit
        nxt = torch.where((nxt >= 0) & ~hit, vol.heap_next.gather(1, idx).long(), -1)
    return vals, found


def lookup_epoch(vol: LocalVolume, keys: torch.Tensor, mesh: Mesh,
                 capacity_per_pair: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-sided lookup of every rank's keys [R, n]: a DSDE exchange of the
    queries, the owner-side probe, and the answers put back with their
    validity in one plan.  Returns (values [R, n] int64, found [R, n] bool);
    a query dropped to the capacity reads (0, False)."""
    p, R = mesh.p, mesh.local_ranks
    n = keys.shape[1]
    keys = keys.long()
    qid = torch.arange(n, device=keys.device).expand(R, n)
    res = dsde.exchange_accumulate(torch.stack((keys, qid), dim=2),
                                   hash_owner(keys, p), mesh, capacity_per_pair)
    rkeys, rqid = res.recv_data[..., 0], res.recv_data[..., 1]
    vals, found = _probe(vol, rkeys, res.recv_valid)

    # the answers fly back one-sided to the slot ranges they came from
    slots = rkeys.shape[1]
    cap = slots // p
    ans = torch.stack((rqid, vals, found.long()), dim=2).reshape(R, p, cap, 3)
    hplan = plan_mod.RmaPlan(mesh)
    h_back = hplan.put_all_to_all(ans, kind="puts")
    h_bval = hplan.put_all_to_all(res.recv_valid.reshape(R, p, cap), kind=None)
    hplan.flush()
    back = h_back.result().reshape(R, slots, 3)
    idx = torch.where(h_bval.result().reshape(R, slots), back[..., 0], n)   # n: trash
    out_vals = torch.zeros((R, n + 1), dtype=torch.int64, device=keys.device)
    out_found = torch.zeros((R, n + 1), dtype=torch.bool, device=keys.device)
    out_vals.scatter_(1, idx, back[..., 1])
    out_found.scatter_(1, idx, back[..., 2].bool())
    return out_vals[:, :n], out_found[:, :n]
