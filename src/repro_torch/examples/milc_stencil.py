"""MILC-style 4-D lattice stencil with a one-sided halo exchange, paper §4.4
(the counterpart of `examples/milc_stencil.py`).

    PYTHONPATH=src python -m repro_torch.examples.milc_stencil            # the card
    PYTHONPATH=src python -m repro_torch.examples.milc_stencil --device cpu
    PYTHONPATH=src python -m repro_torch.examples.milc_stencil --procs 4  # one rank a process

PSCW epochs around the halo puts (`apps.milc.stencil_step`), the paper's
§6 model-guided choice of sync mode for k = 2 neighbours, and agreement
with the single-device stencil within 1e-5.  Each rank holds the
reference's local volume, 4 x 4 x 4 x 4 sites of 6 reals, on the
reference's 8 ranks by default.  The choice is the card's: the H100 model
prices a PSCW handoff and a fence stage alike (one event each), so PSCW's
2k + 2 = 6 handoffs beat ceil(log2 p) fence stages only from p = 65 on.
At 8 ranks the card's answer is the fence, where the reference's TPU
model answers PSCW; a second, labelled choice at p = 128 checks that the
card picks the paper's PSCW past its crossover.

``--procs N`` runs N ranks as N processes (`repro_torch.procmesh`: each
rank's block in its own process, the halos stored into the neighbours'
peer-mapped memory, the PSCW tokens exchanged with the two T neighbours);
every rank holds its block of the same seeded lattice to its rows of the
single-device stencil.
"""

from __future__ import annotations

import argparse

import torch

from .. import procmesh
from ..apps.milc import stencil_reference, stencil_step
from ..core.epoch import choose_sync
from ..mesh import Mesh, resolve_device

LOCAL = (4, 4, 4, 4, 6)         # T_local, X, Y, Z, reals
TOL = 1e-5
PSCW_FROM = 65                  # the H100 model's crossover at k = 2
PSCW_P = 128                    # the labelled choice past it


def _lattice(n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((n,) + LOCAL, generator=gen, device=device)


def _rank(mesh) -> float:
    """One rank's process: its block of the seeded lattice, one step, its
    max error against its rows of the single-device stencil."""
    lat = _lattice(mesh.p, mesh.device)
    r = mesh.rank
    got = stencil_step(lat[r:r + 1].clone(), mesh)
    return float((got - stencil_reference(lat)[r:r + 1]).abs().max())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--procs", type=int, default=0,
                    help="run this many ranks, one a process (overrides --ranks)")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.procs or args.ranks

    mode, want = choose_sync(2, n), "pscw" if n >= PSCW_FROM else "fence"
    past = choose_sync(2, PSCW_P)
    print(f"sync mode for k=2 neighbors at p={n}: {mode} (paper §6 rule, the H100 model)")
    print(f"sync mode for k=2 neighbors at p={PSCW_P}, past the card's crossover: {past}")
    if args.procs:
        errs = procmesh.run(_rank, n, device=device, axis="t")
        print(f"{n} processes, max err by rank: {errs}")
        err = max(errs)
    else:
        lat = _lattice(n, device)
        got = stencil_step(lat, Mesh(n, "t", device=device))
        err = float((got - stencil_reference(lat)).abs().max())
    print(f"distributed vs single-device stencil max err: {err:.2e} "
          f"({'OK' if err < TOL else 'FAIL'})")
    if mode != want or past != "pscw" or not err < TOL:
        raise SystemExit(f"milc_stencil: sync mode {mode} at p={n} (want {want}), {past} at "
                         f"p={PSCW_P} (want pscw), max err {err}")
    return {"sync": mode, "sync_past_crossover": past, "max_err": err}

if __name__ == "__main__":
    main()
