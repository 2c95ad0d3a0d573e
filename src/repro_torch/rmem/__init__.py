"""repro_torch.rmem — remote page pool + paged remote KV-cache.

  * `heap`  — the device page pool over a dynamic window (`pool_allocate`,
    alloc / refcount epochs on the stacked rank axis, grow / shrink,
    conservation) and the host CAS free-list (`HostPagePool`);
  * `pages` — page tables, prefix-sharing `PagedKVPool` (with the elastic
    `add_owner` / `migrate_from`), and the device
    data plane (`scatter_pages`, `gather_local`).
"""

from . import heap, pages  # noqa: F401

__all__ = ["heap", "pages"]
