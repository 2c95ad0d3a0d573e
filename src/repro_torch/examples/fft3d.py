"""Distributed 3-D FFT with a one-sided slab exchange, paper §4.3 (the
counterpart of `examples/fft3d.py`).

    PYTHONPATH=src python -m repro_torch.examples.fft3d            # the card
    PYTHONPATH=src python -m repro_torch.examples.fft3d --device cpu

A 32³ complex64 grid over 8 stacked ranks of 4 x-planes: the pencil
transform (`apps.fft.fft3d`: local y, z FFTs, a one-sided all-to-all, the
x FFT and the exchange back) against `torch.fft.fftn` of the whole grid,
within 1e-4 of the spectrum's largest magnitude.
"""

from __future__ import annotations

import argparse

import torch

from ..apps.fft import fft3d, fft3d_reference
from ..mesh import Mesh, resolve_device

N_RANKS, N, TOL = 8, 32, 1e-4


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = N_RANKS
    mesh = Mesh(n, "x", device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.complex(torch.randn(N, N, N, generator=gen, device=device),
                      torch.randn(N, N, N, generator=gen, device=device))
    x = x.reshape(n, N // n, N, N)
    got = fft3d(x, mesh)
    want = fft3d_reference(x)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"pencil FFT vs fftn relative error: {err:.2e}  ({'OK' if err < TOL else 'FAIL'})")
    if not err < TOL:
        raise SystemExit(f"fft3d: relative error {err} >= {TOL}")
    return {"rel_err": err}


if __name__ == "__main__":
    main()
