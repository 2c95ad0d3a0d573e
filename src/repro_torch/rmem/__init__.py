"""repro_torch.rmem — remote page pool + paged remote KV-cache.

  * `heap`  — the host CAS free-list page allocator (`HostPagePool`);
  * `pages` — page tables, prefix-sharing `PagedKVPool`, and the device
    data plane (`scatter_pages`, `gather_local`).
"""

from . import heap, pages  # noqa: F401

__all__ = ["heap", "pages"]
