"""Distributed 3-D FFT with a one-sided slab exchange, paper §4.3 (the
counterpart of `examples/fft3d.py`).

    PYTHONPATH=src python -m repro_torch.examples.fft3d            # the card
    PYTHONPATH=src python -m repro_torch.examples.fft3d --device cpu
    PYTHONPATH=src python -m repro_torch.examples.fft3d --procs 4  # one rank a process

A 32³ complex64 grid over 8 stacked ranks of 4 x-planes: the pencil
transform (`apps.fft.fft3d`: local y, z FFTs, a one-sided all-to-all, the
x FFT and the exchange back) against `torch.fft.fftn` of the whole grid,
within 1e-4 of the spectrum's largest magnitude.

``--procs N`` (N dividing 32) runs N ranks as N processes
(`repro_torch.procmesh`): each rank transforms its slab of the same seeded
grid, and its slab of the spectrum must equal its row of the stacked run.
"""

from __future__ import annotations

import argparse

import torch

from .. import procmesh
from ..apps.fft import fft3d, fft3d_reference
from ..mesh import Mesh, resolve_device

N_RANKS, N, TOL = 8, 32, 1e-4


def _grid(n: int, device) -> torch.Tensor:
    """The seeded N³ grid as n slabs [n, N/n, N, N]."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.complex(torch.randn(N, N, N, generator=gen, device=device),
                      torch.randn(N, N, N, generator=gen, device=device))
    return x.reshape(n, N // n, N, N)


def _rank(mesh) -> torch.Tensor:
    """One rank's process: its slab's part of the spectrum."""
    r = mesh.rank
    return fft3d(_grid(mesh.p, mesh.device)[r:r + 1].clone(), mesh).cpu()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--procs", type=int, default=0,
                    help="run this many ranks, one a process (N must divide 32)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.procs or N_RANKS
    x = _grid(n, device)
    got = fft3d(x, Mesh(n, "x", device=device))
    if args.procs:
        ranks = procmesh.run(_rank, n, device=device)
        same = all(torch.equal(s, got[r:r + 1].cpu()) for r, s in enumerate(ranks))
        print(f"{n} processes: every rank's slab "
              f"{'equals' if same else 'DIFFERS from'} its row of the stacked run")
        if not same:
            raise SystemExit("fft3d: the ranks differ from the stacked run")
    want = fft3d_reference(x)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"pencil FFT vs fftn relative error: {err:.2e}  ({'OK' if err < TOL else 'FAIL'})")
    if not err < TOL:
        raise SystemExit(f"fft3d: relative error {err} >= {TOL}")
    return {"rel_err": err}


if __name__ == "__main__":
    main()
