"""MoE token dispatch is the paper's DSDE motif, §4.2 (the counterpart of
`examples/moe_dsde.py`).

    PYTHONPATH=src python -m repro_torch.examples.moe_dsde            # the card
    PYTHONPATH=src python -m repro_torch.examples.moe_dsde --device cpu
    PYTHONPATH=src python -m repro_torch.examples.moe_dsde --procs 4  # one rank a process

`core.dsde.moe_dispatch` routes each token to its top-2 of 16 experts (2 a
rank over 8 stacked ranks) over the one-sided all-to-all, identity
experts hand every item back, and `moe_combine` returns the gate-weighted
copies: with renormalised gates every token comes back as itself, except
the few (token, expert) pairs dropped to the capacity, which the 99th
percentile of the error leaves out.  The run fails unless that error is
below 1e-4.

``--procs N`` runs N ranks as N processes (`repro_torch.procmesh`, 2
experts a rank): each rank dispatches and combines its row of the same
seeded tokens, and its results must equal its rows of the stacked run.
"""

from __future__ import annotations

import argparse

import torch

from .. import procmesh
from ..core import dsde
from ..mesh import Mesh, resolve_device

N_RANKS, N_TOK, D, TOP_K, TOL = 8, 32, 16, 2, 1e-4


def _inputs(n: int, device) -> tuple:
    """n ranks' tokens, expert ids and renormalised gates, from one seed."""
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randn(n, N_TOK, D, generator=gen, device=device)
    logits = torch.randn(n, N_TOK, 2 * n, generator=gen, device=device)
    gate, expert_idx = torch.topk(torch.softmax(logits, dim=-1), TOP_K)
    return tokens, expert_idx, gate / gate.sum(-1, keepdim=True)


def _exchange(tokens, expert_idx, gate, mesh) -> tuple:
    """Dispatch, identity experts, combine: (routed pairs, combined tokens)."""
    disp = dsde.moe_dispatch(tokens, expert_idx, gate, 2 * mesh.p, mesh,
                             capacity_factor=2.0)
    out = dsde.moe_combine(disp.expert_inputs, disp, N_TOK, mesh)
    return int(disp.combine_valid.sum()), out


def _rank(mesh) -> tuple:
    """One rank's process: its row of the seeded inputs through the exchange."""
    r = mesh.rank
    rows = [t[r:r + 1].clone() for t in _inputs(mesh.p, mesh.device)]
    routed, out = _exchange(*rows, mesh)
    return routed, out.cpu()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--procs", type=int, default=0,
                    help="run this many ranks, one a process")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.procs or N_RANKS
    tokens, expert_idx, gate = _inputs(n, device)
    routed, out = _exchange(tokens, expert_idx, gate, Mesh(n, "ep", device=device))
    if args.procs:
        ranks = procmesh.run(_rank, n, device=device, axis="ep")
        same = all(torch.equal(got, out[r:r + 1].cpu()) for r, (_, got) in enumerate(ranks))
        print(f"{n} processes: every rank's combined tokens "
              f"{'equal' if same else 'DIFFER from'} its rows of the stacked run")
        if not same or sum(x for x, _ in ranks) != routed:
            raise SystemExit("moe_dsde: the ranks differ from the stacked run")
    err = float(torch.quantile((out - tokens).abs().flatten().float(), 0.99))
    ok = err < TOL
    print(f"routed {routed}/{n * N_TOK * TOP_K} (token,expert) pairs over {n} ranks")
    print(f"identity-expert roundtrip p99 error: {err:.2e}  (DSDE conservation ok: {ok})")
    if not ok:
        raise SystemExit(f"moe_dsde: p99 roundtrip error {err} >= {TOL}")
    return {"routed": routed, "pairs": n * N_TOK * TOP_K, "p99_err": err}


if __name__ == "__main__":
    main()
