"""Distributed hashtable / KV store on one-sided RMA, paper §4.1 (the
counterpart of `examples/hashtable_kv.py`).

    PYTHONPATH=src python -m repro_torch.examples.hashtable_kv            # the card
    PYTHONPATH=src python -m repro_torch.examples.hashtable_kv --device cpu
    PYTHONPATH=src python -m repro_torch.examples.hashtable_kv --procs 4  # one rank a process

8 ranks stacked on one device, 64 distinct keys a rank (the reference's
seeded draw), one insert epoch and one lookup epoch at 128 slots a pair
into volumes of 512 table and 512 heap cells; every key must come back
with its value and nothing may be dropped.

``--procs N`` runs N ranks as N processes (`repro_torch.procmesh`): each
rank inserts and looks up its row of the same keys into its own volume,
and its volume and answers must equal its rows of the stacked run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import procmesh
from ..core import hashtable as ht
from ..mesh import Mesh, resolve_device

N_RANKS, N_KEYS, CAP, TABLE = 8, 64, 128, 512


def _keys(n: int) -> tuple:
    rng = np.random.default_rng(1)
    keys = rng.choice(1 << 20, n * N_KEYS, replace=False).astype(np.int64)
    return keys, rng.integers(0, 1 << 20, n * N_KEYS).astype(np.int64)


def _epochs(keys: torch.Tensor, vals: torch.Tensor, mesh) -> tuple:
    """One insert epoch and one lookup epoch of these rows' keys."""
    vol = ht.make_volume(TABLE, TABLE, mesh.local_ranks, device=keys.device)
    vol, dropped = ht.insert_epoch(vol, keys, vals, mesh, CAP)
    return (vol, dropped) + ht.lookup_epoch(vol, keys, mesh, CAP)


def _rank(mesh) -> list:
    """One rank's process: its row of the keys through both epochs."""
    keys_np, vals_np = _keys(mesh.p)
    r, dev = mesh.rank, mesh.device
    row = slice(r * N_KEYS, (r + 1) * N_KEYS)
    vol, dropped, v_out, found = _epochs(torch.from_numpy(keys_np[row]).to(dev)[None],
                                         torch.from_numpy(vals_np[row]).to(dev)[None], mesh)
    return [t.cpu() for t in (*vol, dropped, v_out, found)]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--procs", type=int, default=0,
                    help="run this many ranks, one a process")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.procs or N_RANKS
    mesh = Mesh(n, "x", device=device)
    keys_np, vals_np = _keys(n)
    keys = torch.from_numpy(keys_np).to(device).reshape(n, N_KEYS)
    vals = torch.from_numpy(vals_np).to(device).reshape(n, N_KEYS)

    vol, dropped, v_out, found = _epochs(keys, vals, mesh)
    if args.procs:
        stacked = [t.cpu() for t in (*vol, dropped, v_out, found)]
        ranks = procmesh.run(_rank, n, device=device)
        same = all(torch.equal(g, w[r:r + 1]) for r, res in enumerate(ranks)
                   for g, w in zip(res, stacked))
        print(f"{n} processes: every rank's volume and answers "
              f"{'equal' if same else 'DIFFER from'} its rows of the stacked run")
        if not same:
            raise SystemExit("hashtable_kv: the ranks differ from the stacked run")
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
