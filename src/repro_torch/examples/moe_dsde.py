"""MoE token dispatch is the paper's DSDE motif, §4.2 (the counterpart of
`examples/moe_dsde.py`).

    PYTHONPATH=src python -m repro_torch.examples.moe_dsde            # the card
    PYTHONPATH=src python -m repro_torch.examples.moe_dsde --device cpu

`core.dsde.moe_dispatch` routes each token to its top-2 of 16 experts (2 a
rank over 8 stacked ranks) over the one-sided all-to-all, identity
experts hand every item back, and `moe_combine` returns the gate-weighted
copies: with renormalised gates every token comes back as itself, except
the few (token, expert) pairs dropped to the capacity, which the 99th
percentile of the error leaves out.  The run fails unless that error is
below 1e-4.
"""

from __future__ import annotations

import argparse

import torch

from ..core import dsde
from ..mesh import Mesh, resolve_device

N_RANKS, N_TOK, D, TOP_K, TOL = 8, 32, 16, 2, 1e-4


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = N_RANKS
    E = n * 2                                            # 2 experts a rank
    mesh = Mesh(n, "ep", device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randn(n, N_TOK, D, generator=gen, device=device)
    logits = torch.randn(n, N_TOK, E, generator=gen, device=device)
    gate, expert_idx = torch.topk(torch.softmax(logits, dim=-1), TOP_K)
    gate = gate / gate.sum(-1, keepdim=True)             # renormalise over the top-k

    disp = dsde.moe_dispatch(tokens, expert_idx, gate, E, mesh, capacity_factor=2.0)
    # identity experts: combine returns gate-weighted copies of the inputs
    out = dsde.moe_combine(disp.expert_inputs, disp, N_TOK, mesh)
    routed = int(disp.combine_valid.sum())
    err = float(torch.quantile((out - tokens).abs().flatten().float(), 0.99))
    ok = err < TOL
    print(f"routed {routed}/{n * N_TOK * TOP_K} (token,expert) pairs over {n} ranks")
    print(f"identity-expert roundtrip p99 error: {err:.2e}  (DSDE conservation ok: {ok})")
    if not ok:
        raise SystemExit(f"moe_dsde: p99 roundtrip error {err} >= {TOL}")
    return {"routed": routed, "pairs": n * N_TOK * TOP_K, "p99_err": err}


if __name__ == "__main__":
    main()
