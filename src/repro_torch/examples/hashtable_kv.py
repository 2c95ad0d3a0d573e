"""Distributed hashtable / KV store on one-sided RMA, paper §4.1 (the
counterpart of `examples/hashtable_kv.py`).

    PYTHONPATH=src python -m repro_torch.examples.hashtable_kv            # the card
    PYTHONPATH=src python -m repro_torch.examples.hashtable_kv --device cpu

8 ranks stacked on one device, 64 distinct keys a rank (the reference's
seeded draw), one insert epoch and one lookup epoch at 128 slots a pair
into volumes of 512 table and 512 heap cells; every key must come back
with its value and nothing may be dropped.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import hashtable as ht
from ..mesh import Mesh, resolve_device

N_RANKS, N_KEYS, CAP, TABLE = 8, 64, 128, 512


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = N_RANKS
    mesh = Mesh(n, "x", device=device)
    rng = np.random.default_rng(1)
    keys_np = rng.choice(1 << 20, n * N_KEYS, replace=False).astype(np.int64)
    vals_np = rng.integers(0, 1 << 20, n * N_KEYS).astype(np.int64)
    keys = torch.from_numpy(keys_np).to(device).reshape(n, N_KEYS)
    vals = torch.from_numpy(vals_np).to(device).reshape(n, N_KEYS)

    vol = ht.make_volume(TABLE, TABLE, n, device=device)
    vol, dropped = ht.insert_epoch(vol, keys, vals, mesh, CAP)
    v_out, found = ht.lookup_epoch(vol, keys, mesh, CAP)
    v_out, found = v_out.reshape(-1).cpu().numpy(), found.reshape(-1).cpu().numpy()
    truth = dict(zip(keys_np.tolist(), vals_np.tolist()))
    hits = sum(1 for i, k in enumerate(keys_np.tolist()) if found[i] and v_out[i] == truth[k])
    n_dropped = int(dropped.sum())
    print(f"inserted {n * N_KEYS} keys over {n} ranks (dropped={n_dropped}); "
          f"lookup hits {hits}/{n * N_KEYS}")
    if hits != n * N_KEYS or n_dropped:
        raise SystemExit(f"hashtable lost keys: {hits}/{n * N_KEYS} hits, {n_dropped} dropped")
    return {"hits": hits, "keys": n * N_KEYS, "dropped": n_dropped}


if __name__ == "__main__":
    main()
