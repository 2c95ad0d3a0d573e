"""Remote page allocator: the host free-list (copy of `repro.rmem.heap`'s
`HostPagePool`, `head_pack`/`head_unpack` and `HeapError`).

The literal remote free-list: a 64-bit head word packing
(generation << 32 | head index), pop/push by compare-and-swap loops on
`locks_sim._AtomicWord`, per-page refcounts by fetch-and-add.  Every
successful CAS advances the generation, so the ABA interleaving fails the
tag compare instead of corrupting the list.  `release` frees at the 1 -> 0
transition.  Conservation: free + live == capacity.

This is host code: the serving scheduler's allocation mirror.  Page
payloads live in the device pool tensor (`rmem.pages.scatter_pages`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.fabric import default_fabric
from ..core.locks_sim import _AtomicWord
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace


class HeapError(RuntimeError):
    pass


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
                             page=idx, gen=int(self.gen[idx]))
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
                             page=idx, gen=int(self.gen[idx]))
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
