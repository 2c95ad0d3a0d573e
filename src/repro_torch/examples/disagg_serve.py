"""Disaggregated prefill/decode serving with a paged remote KV-cache (the
counterpart of `examples/disagg_serve.py`).

    PYTHONPATH=src python -m repro_torch.examples.disagg_serve            # the card
    PYTHONPATH=src python -m repro_torch.examples.disagg_serve --device cpu
    PYTHONPATH=src python -m repro_torch.examples.disagg_serve --procs 4  # one rank a process

Paged mode: channel messages carry page-table entries while KV page
payloads are written directly into the decode ranks' page pools.  Every
request's prompt shares an 8-token prefix, so prefix pages resolve to
pages already resident at the routed decoder: a refcount bump instead of a
payload transfer.  Rendezvous mode goes one further: only a descriptor
travels through the ring and the decoder pulls the pages when it is ready
to attend.  The 4 ranks (2 prefill, 2 decode) are stacked on one device.
Every emitted token is checked against the engine's single-host
reference in all three modes; the run fails otherwise.

``--procs N`` runs the same example with N ranks as N processes
(`repro_torch.procmesh`): every process runs the same host scheduler on its
own rank's device step, and every rank must report the same tokens and
counts; rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import procmesh
from ..mesh import resolve_device
from ..serve.disagg import DisaggConfig, DisaggEngine

N_RANKS, N_REQUESTS, VOCAB, BLOCK = 4, 12, 97, 16


def run(n: int, prompts: dict, device, paged: bool = False,
        transport: str = "eager", mesh=None) -> tuple[dict, DisaggEngine]:
    cfg = DisaggConfig(
        n_prefill=max(1, n // 2), block_tokens=BLOCK, d_model=32,
        queue_capacity=16, max_recv_per_step=4, n_lanes=2, flow=True,
        paged=paged, page_tokens=4, novel_slots=2, pool_pages=48,
        transport=transport,
    )
    engine = DisaggEngine(n, cfg, seed=0, device=None if mesh else device, mesh=mesh)
    for rid, toks in prompts.items():
        engine.submit(rid, toks)
    t0 = time.perf_counter()
    results = engine.run_until_drained()
    dt = time.perf_counter() - t0
    if mesh is None or mesh.rank == 0:
        print(f"[{engine.mode}] served {len(results)} requests in {dt * 1e3:.1f} ms "
              f"({len(results) / dt:.0f} req/s); bytes_wire/req = "
              f"{engine.msg_stats['bytes_wire_per_step'] * engine.steps_run / len(results):.0f}",
              flush=True)
    return results, engine


def serve_all(n: int, prompts: dict, device, mesh=None) -> dict:
    """The three modes on the same prompts; their tokens and counts."""
    res_inline, eng_inline = run(n, prompts, device, paged=False, mesh=mesh)
    res_paged, eng_paged = run(n, prompts, device, paged=True, mesh=mesh)
    res_rdv, eng_rdv = run(n, prompts, device, transport="rendezvous", mesh=mesh)
    ok = sum(res_paged[rid] == eng_paged.reference(toks)
             and res_inline[rid] == eng_paged.reference(toks)
             and res_rdv[rid] == eng_paged.reference(toks)
             for rid, toks in prompts.items())
    return {"results": (res_inline, res_paged, res_rdv), "ok": ok,
            "block_nbytes": eng_inline.cfg.block_nbytes, "retries": eng_paged.retries,
            "ps": eng_paged.paged_stats(), "fs": eng_paged.flow_stats(),
            "rs": eng_rdv.rendezvous_stats()}


def _rank(mesh, prompts: dict) -> dict:
    """One rank's process: the three modes over the process mesh."""
    return serve_all(mesh.p, prompts, mesh.device, mesh=mesh)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--procs", type=int, default=0,
                    help="run this many ranks, one a process")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.procs or N_RANKS

    # shared-prefix workload: every request's first 8 of 16 tokens match
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, VOCAB, size=BLOCK // 2)
    prompts = {i: np.concatenate([prefix, rng.randint(0, VOCAB, size=BLOCK // 2)])
               for i in range(N_REQUESTS)}

    print(f"{N_REQUESTS} requests, 50% shared prompt prefix, "
          f"mesh = {max(1, n // 2)} prefill + {n - max(1, n // 2)} decode ranks")
    if args.procs:
        ranks = procmesh.run(_rank, n, device=device, args=(prompts,))
        out = ranks[0]
        same = all(r["results"] == out["results"] and r["ps"] == out["ps"]
                   and r["rs"] == out["rs"] for r in ranks)
        print(f"{n} processes: every rank's tokens and counts "
              f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise SystemExit("the ranks' host schedulers diverged")
    else:
        out = serve_all(n, prompts, device)
    ok, ps, fs, rs = out["ok"], out["ps"], out["fs"], out["rs"]
    res_paged = out["results"][1]
    print(f"prefix hits: {ps['prefix_hits']} "
          f"(hit rate {ps['prefix_hit_rate']:.2f}), "
          f"novel pages shipped: {ps['novel_pages_shipped']}, "
          f"payload bytes/req: {out['block_nbytes']} (inline) -> "
          f"{ps['effective_payload_bytes'] / N_REQUESTS:.0f} (paged)")
    print(f"rendezvous: {rs['descriptor_appends']} descriptors "
          f"({rs['descriptor_bytes']} B) through the ring, "
          f"{rs['ring_payload_appends']} payload ring slots, "
          f"{rs['pulled_pages']} pages pulled by the decoders "
          f"({rs['pulled_bytes']} B as one-sided gets)")
    conserved = (ps["pool_conservation_ok"] and rs["pool_conservation_ok"]
                 and fs["conservation_ok"])
    print(f"page-pool conservation: "
          f"{'OK' if ps['pool_conservation_ok'] and rs['pool_conservation_ok'] else 'BROKEN'}, "
          f"credit conservation: {'OK' if fs['conservation_ok'] else 'BROKEN'}, "
          f"retries: {out['retries']}")
    print(f"decode == single-host reference (all 3 modes): {ok}/{N_REQUESTS}")
    for rid in sorted(res_paged)[:4]:
        print(f"  req {rid}: token {res_paged[rid]}")
    if ok != N_REQUESTS:
        raise SystemExit("MISMATCH between disaggregated and reference decode")
    if rs["ring_payload_appends"] != 0:
        raise SystemExit("rendezvous moved payload through the ring")
    if not conserved:
        raise SystemExit("pool or credit conservation broken")
    return {"agree": ok, "prefix_hits": ps["prefix_hits"],
            "novel_pages": ps["novel_pages_shipped"],
            "descriptors": rs["descriptor_appends"], "pulled_pages": rs["pulled_pages"],
            "ring_payload_appends": rs["ring_payload_appends"],
            "retries": out["retries"]}


if __name__ == "__main__":
    main()
