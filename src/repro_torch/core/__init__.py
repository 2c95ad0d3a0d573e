"""repro_torch.core — the one-sided substrate the serving path runs on.

  * `rma`    — `OpCounter`, the raw-vs-wire message ledger;
  * `window` — the `Window` descriptor in the four MPI-3 creation modes
    (`win_allocate`, `win_create`, `win_create_dynamic`,
    `win_allocate_shared`) and the dynamic window's `DescriptorCache`;
  * `plan`   — epoch-scoped `RmaPlan` recording with same-signature
    coalescing into one wire transfer, and its uint32-word codec;
  * `fabric` / `locks_sim` — the in-process host transport (AMO banks and
    the payload-op ledger `DescriptorCache` charges), and the
    paper's lock protocol (`LockWindow`, `LockOrigin`) with the atomic word
    the host page pool and the serving engine's admission control use.
"""
