"""repro_torch.core — the one-sided substrate the serving path runs on.

  * `rma`    — `OpCounter`, the raw-vs-wire message ledger;
  * `window` — the symmetric `Window` descriptor and `win_allocate`;
  * `plan`   — epoch-scoped `RmaPlan` recording with same-signature
    coalescing into one wire transfer, and its uint32-word codec;
  * `fabric` / `locks_sim` — the in-process host transport, and the
    paper's lock protocol (`LockWindow`, `LockOrigin`) with the atomic word
    the host page pool and the serving engine's admission control use.
"""
