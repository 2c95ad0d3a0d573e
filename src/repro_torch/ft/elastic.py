"""Elastic re-meshing and serving-side KV elasticity (the `repro.ft.elastic`
counterpart).

`plan_mesh` picks the largest valid (data, model) grid for a surviving
device count, keeping the model degree where it can; `elastic_restore`
re-shards the latest checkpoint onto that grid: a `Mesh` of named axes
("data", "model") on one device, the reference's weight rules
(`ShardingPolicy.tree_shardings`) placing every leaf, each checked to tile
the grid.  The data axis absorbs the loss; the deterministic pipeline
recomputes shard assignments from (seed, step, shard), so no sample is
skipped or repeated across the restart.

Serving-side elasticity (DESIGN.md §10.6): when a decode rank joins or
leaves, the paged KV cache moves with it.  `migrate_kv_pages` /
`expand_kv_pool` are the policy wrappers over `rmem.pages.PagedKVPool`: a
leave re-homes every live page onto survivors (one get + put a page,
refcounts transferred verbatim, same-content pages merged), a join brings
up an empty pool and adds the rank to the prefix-affinity routing set.
Conservation (free + live == capacity on every surviving rank) holds
before and after.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ckpt.checkpoint import CheckpointManager
from ..mesh import Mesh
from ..parallel.sharding import ShardingPolicy


@dataclasses.dataclass
class MeshPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_mesh(n_devices: int, prefer_model: int) -> MeshPlan:
    """Largest (data x model) grid with model | prefer_model, maximizing use."""
    best = MeshPlan(1, 1)
    model = prefer_model
    while model >= 1:
        data = n_devices // model
        if data >= 1 and data * model > best.devices:
            best = MeshPlan(data, model)
        model //= 2
    return best


def elastic_restore(ckpt: CheckpointManager, like_tree, n_surviving_devices: int,
                    prefer_model: int, device=None, step: Optional[int] = None):
    """Re-shard the latest (or `step`'s) checkpoint onto the mesh the
    survivors make.  Returns (tree, extra, mesh, policy); every leaf is on
    the mesh's device (`device`; None is the card)."""
    plan = plan_mesh(n_surviving_devices, prefer_model)
    mesh = Mesh({"data": plan.data, "model": plan.model}, device=device)
    policy = ShardingPolicy(mesh=mesh)
    shardings = policy.tree_shardings(like_tree)
    tree, extra = ckpt.restore(like_tree, step=step, shardings=shardings)
    return tree, extra, mesh, policy


# --------------------------------------------------- paged-KV elasticity
def migrate_kv_pages(kv, leaving_rank: int) -> dict:
    """Rank leave: re-home every live KV page of `leaving_rank` onto the
    surviving owners, keeping refcounts and rewriting page tables and the
    prefix index (`PagedKVPool.migrate_from`).  Returns its report
    ({"moved", "merged", "mapping"})."""
    return kv.migrate_from(leaving_rank)


def expand_kv_pool(kv, joining_rank: int) -> None:
    """Rank join: attach an empty page pool for `joining_rank` and add it
    to the routing set.  Existing pages stay where they are; only new
    prefixes route to the newcomer (no rebalancing storm on join)."""
    kv.add_owner(joining_rank)


def kv_membership_change(kv, leave: Optional[int] = None,
                         join: Optional[int] = None) -> dict:
    """One membership event: a leave (live pages re-homed), a join (empty
    pool attached), or both, with conservation checked before and after.

    Returns ``{"before": ..., "after": ..., "migration": ...}``; raises
    RuntimeError if either check fails (a membership change must never
    lose or duplicate a page)."""
    before = kv.conservation()
    if not before["ok"]:
        raise RuntimeError(f"pool conservation broken BEFORE membership change: {before}")
    report = {"before": before, "migration": None}
    if leave is not None:
        report["migration"] = migrate_kv_pages(kv, leave)
    if join is not None:
        expand_kv_pool(kv, join)
    after = kv.conservation()
    if not after["ok"]:
        raise RuntimeError(f"pool conservation broken AFTER membership change: {after}")
    report["after"] = after
    return report
