"""Serving-side KV elasticity of the PyTorch port against the JAX reference,
in-process (host code: no mesh, no child process).

`tests/test_rmem.py`'s `TestElasticMigration` on both packages: a rank
leave re-homes every live page (refcounts and payloads kept, same-content
pages merged, a full survivor spilling to another), a join adds an empty
pool, and the last owner cannot leave — with the same reports, page
tables, payloads and conservation in both.  Also `plan_mesh`, and the two
rmem model functions `p_page_alloc` and `prefix_hit_bytes_saved`.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.perfmodel import DEFAULT_MODEL as JAX_MODEL  # noqa: E402
from repro.ft import elastic as jel  # noqa: E402
from repro.rmem import heap as jheap  # noqa: E402
from repro.rmem import pages as jpg  # noqa: E402
from repro_torch.core.perfmodel import DEFAULT_MODEL, H100  # noqa: E402
from repro_torch.ft import elastic as tel  # noqa: E402
from repro_torch.rmem import heap as theap  # noqa: E402
from repro_torch.rmem import pages as tpg  # noqa: E402

PKGS = [(jpg, jel, jheap), (tpg, tel, theap)]


def _view(kv) -> dict:
    """Everything a migration may change, as plain values."""
    return {
        "owners": list(kv.owners),
        "tables": {rid: [tuple(r) for r in refs] for rid, refs in kv.page_tables.items()},
        "index": {k: tuple(v) for k, v in sorted(kv.index.items())},
        "rev": dict(sorted(kv.rev.items())),
        "refs": {r: [w.v for w in p.ref] for r, p in kv.pools.items()},
        "pages": {r: p.pages.tolist() for r, p in kv.pools.items()},
        "cons": kv.conservation(),
    }


def _report(rep) -> dict:
    return {"moved": rep["moved"], "merged": rep["merged"],
            "mapping": {k: tuple(v) for k, v in rep["mapping"].items()}}


def _loaded_kv(pages):
    """Pages pinned per owner so the leaver (rank 2) holds live pages: p0
    (shared by requests 1 and 2) and p1 on rank 2, p2 on rank 3."""
    kv = pages.PagedKVPool(owners=[2, 3], n_pages=8, page_words=4)
    owner_of = {b"p0": 2, b"p1": 2, b"p2": 3}
    for rid, keys in {1: [b"p0", b"p1"], 2: [b"p0", b"p2"]}.items():
        table = []
        for key in keys:
            ref, _ = kv.acquire(owner_of[key], key)
            kv.pools[ref.owner].pages[ref.page_id] = len(key) * 10 + key[-1] % 97
            table.append(ref)
        kv.table_set(rid, table)
    return kv


def _both(fn):
    out = [fn(*pkg) for pkg in PKGS]
    assert out[0] == out[1]
    return out[1]


def test_rank_leave_preserves_pages_and_refcounts():
    def run(pages, elastic, heap):
        kv = _loaded_kv(pages)
        before = _view(kv)
        rep = _report(elastic.migrate_kv_pages(kv, leaving_rank=2))
        after = _view(kv)
        freed = [[tuple(r) for r in kv.table_release(rid)] for rid in (1, 2)]
        return before, rep, after, freed, _view(kv)

    before, rep, after, freed, end = _both(run)
    assert before["refs"][2][:2] == [2, 1]               # p0 shared, p1 once
    assert after["owners"] == [3] and after["cons"]["ok"]
    assert rep["moved"] + rep["merged"] == 2
    assert sum(v > 0 for v in after["refs"][3]) == 3     # no page lost
    assert all(r[0] == 3 for t in after["tables"].values() for r in t)
    assert end["cons"]["ok"] and not any(end["refs"][3])


def test_migration_merges_duplicate_content():
    """A key stored on both ranks merges on migration when it routes to
    the survivor holding it: one page, summed refcount."""

    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[2, 3], n_pages=4, page_words=1)
        ra, _ = kv.acquire(2, b"dup")
        rb, _ = kv.acquire(3, b"dup")
        kv.pools[2].ref_add(ra.page_id, 2)               # refcount 3 on rank 2
        rep = _report(elastic.migrate_kv_pages(kv, leaving_rank=2))
        return rep, _view(kv), tuple(rb)

    rep, view, rb = _both(run)
    assert rep["merged"] == 1 and rep["moved"] == 0
    assert view["index"][(3, b"dup")] == rb and view["refs"][3][rb[1]] == 4
    assert view["cons"]["ok"]


def test_migration_spills_to_a_survivor_with_capacity():
    """A full rendezvous owner spills the page to another survivor."""

    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[1, 2, 3], n_pages=2, page_words=2)
        keys = [f"k{i}".encode() for i in range(40)]
        key = next(k for k in keys if pages.route_owner(k, [2, 3]) == 3)
        ref, _ = kv.acquire(1, key)
        kv.pools[1].pages[ref.page_id] = [7.0, 8.0]
        kv.table_set(5, [ref])
        fill = [k for k in keys if k != key][:2]
        for k in fill:
            kv.acquire(3, k)                             # rank 3 full
        rep = _report(elastic.migrate_kv_pages(kv, leaving_rank=1))
        return rep, _view(kv)

    rep, view = _both(run)
    assert rep["moved"] == 1
    (new,) = rep["mapping"].values()
    assert new[0] == 2 and view["pages"][2][new[1]] == [7.0, 8.0]
    assert view["tables"][5] == [new] and view["cons"]["ok"]


def test_migration_without_survivor_capacity_raises():
    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[1, 2], n_pages=1, page_words=1)
        kv.acquire(1, b"a")
        kv.acquire(2, b"b")
        with pytest.raises(heap.HeapError, match="no survivor capacity"):
            elastic.migrate_kv_pages(kv, leaving_rank=1)
        return kv.owners

    assert _both(run) == [2]


def test_rank_join_expands_routing():
    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[2], n_pages=4, page_words=1)
        ref, _ = kv.acquire(2, b"old")
        elastic.expand_kv_pool(kv, joining_rank=9)
        with pytest.raises(heap.HeapError, match="already owns a pool"):
            elastic.expand_kv_pool(kv, joining_rank=9)
        keys = [f"n{i}".encode() for i in range(64)]
        return _view(kv), tuple(ref), sum(kv.route(k) == 9 for k in keys)

    view, ref, to_new = _both(run)
    assert view["owners"] == [2, 9] and view["cons"]["ok"]
    assert view["index"][(2, b"old")] == ref             # existing pages stay put
    assert 0 < to_new < 64


@pytest.mark.parametrize("leaving", [2, 7])
def test_leave_refused(leaving):
    """The last owner cannot leave; a rank that owns no pool cannot."""

    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[2], n_pages=4, page_words=1)
        with pytest.raises(heap.HeapError) as ei:
            elastic.migrate_kv_pages(kv, leaving_rank=leaving)
        return str(ei.value), kv.owners

    msg, owners = _both(run)
    assert owners == [2] and ("last owner" in msg or "owns no pool" in msg)


def test_kv_membership_change_leave_and_join():
    def run(pages, elastic, heap):
        kv = _loaded_kv(pages)
        rep = elastic.kv_membership_change(kv, leave=2, join=5)
        return (rep["before"], _report(rep["migration"]), rep["after"], _view(kv))

    before, mig, after, view = _both(run)
    assert before["ok"] and after["ok"] and view["owners"] == [3, 5]
    assert mig["moved"] + mig["merged"] == 2


def test_kv_membership_change_refuses_a_broken_pool():
    def run(pages, elastic, heap):
        kv = pages.PagedKVPool(owners=[2, 3], n_pages=4, page_words=1)
        kv.pools[3].ref[0].v = 1                         # live but still on the free list
        with pytest.raises(RuntimeError, match="BEFORE membership change"):
            elastic.kv_membership_change(kv, join=4)
        return kv.owners

    assert _both(run) == [2, 3]


@pytest.mark.parametrize("n,prefer", [(8, 4), (7, 4), (6, 4), (3, 8), (1, 2), (16, 16), (12, 8)])
def test_plan_mesh_matches_reference(n, prefer):
    want, got = jel.plan_mesh(n, prefer), tel.plan_mesh(n, prefer)
    assert (got.data, got.model, got.devices) == (want.data, want.model, want.devices)
    assert got.devices <= n and prefer % got.model == 0


def test_page_alloc_fused_cheaper_than_standalone():
    """Riding an epoch's fused gather leaves the AMO alone; standalone
    pays the head get too.  Priced from the H100 spec."""
    m = DEFAULT_MODEL
    fused, alone = m.p_page_alloc(True), m.p_page_alloc(False)
    assert fused < alone
    assert fused == m.p_message_rate(8.0) == max(H100.launch_latency, 16.0 / H100.copy_bandwidth)
    assert alone == fused + m.p_get(8.0)
    assert m.p_page_alloc() == fused


@pytest.mark.parametrize("block,f", [(2**21, 0.5), (4096.0, 0.0), (4096.0, 1.0),
                                     (1e6, -0.2), (1e6, 1.7), (3.5e5, 0.37)])
def test_prefix_hit_bytes_saved_matches_reference(block, f):
    assert DEFAULT_MODEL.prefix_hit_bytes_saved(block, f) == \
        JAX_MODEL.prefix_hit_bytes_saved(block, f)
    assert DEFAULT_MODEL.prefix_hit_bytes_saved(2**21, 0.5) == 2**20
