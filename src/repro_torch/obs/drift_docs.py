"""The three count documents `obs.drift` gates, made by driving the port.

The reference's smoke benchmarks (`benchmarks/run.py`, `bench_rmaq.py`,
`bench_serve_flow.py`, `bench_rmem.py`) write ``BENCH_rma_plan.json``,
``BENCH_serve_flow.json`` and ``BENCH_rmem.json``; this module writes the
same fields, at the same shapes, by running the port's own protocols on
``p = 4`` stacked ranks (`set_a`).  It records counts only: no field is a
wall-clock time, so with ``measured_msg_rate_per_s`` absent the drift
table's informational rate rows do not appear.

The ``*_record`` / ``*_series`` helpers read one finished `DisaggEngine`;
`run_record` keeps all of them for an engine run elsewhere (a full-width
run, say), and ``set_b`` folds four such records into the same documents.

    docs = drift_docs.set_a("cuda")
    drift_docs.write(docs, root)
    drift.gate(root)
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

NAMES = {"rma_plan": "BENCH_rma_plan.json", "serve_flow": "BENCH_serve_flow.json",
         "rmem": "BENCH_rmem.json"}

P_RANKS = 4
# benchmarks/run.py:51 — k puts of msg_bytes each
RMA_K, RMA_MSG_BYTES = 32, 8
# benchmarks/bench_rmaq.py:23 — rank 1 floods rank 0's ring
FLOOD = dict(n_steps=16, cap=4, k=2, drain=1)
# benchmarks/bench_serve_flow.py — the traced slice, the engines, the A/B sizes
SIM_RANKS, SIM_SCHEDULE, SIM_SEED = 64, "delay", 0
SERVE_REQUESTS = 12
TRANSPORT_SIZES = {
    "short_chat": dict(block_tokens=8, page_tokens=4, d_model=16),
    "prefill_heavy": dict(block_tokens=32, page_tokens=8, d_model=32),
}
CROSSOVER_PAGES = 16
# benchmarks/bench_rmem.py:105 — the shared-prefix workload
RMEM = dict(n_req=12, shared_frac=0.5, seed=5)


def _numbers(d: dict) -> dict:
    """The int / float entries of a stats dict as plain Python numbers."""
    return {k: (int(v) if isinstance(v, (int, np.integer)) else float(v))
            for k, v in d.items()
            if isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool)}


def _served(eng, prompts: dict) -> dict:
    """Submit `prompts`, drain, and check every token against the engine's
    `reference()`; returns the results."""
    for rid, toks in prompts.items():
        eng.submit(rid, toks)
    res = eng.run_until_drained()
    bad = [rid for rid, toks in prompts.items() if res.get(rid) != eng.reference(toks)]
    if len(res) != len(prompts) or bad:
        raise AssertionError(f"{eng.mode}: {len(res)}/{len(prompts)} served, "
                             f"tokens differ for {bad[:8]}")
    return res


# ------------------------------------------------------------ rma_plan
def rma_plan_doc(device) -> dict:
    """k puts of RMA_MSG_BYTES by shift 1: eagerly (k one-op plans), as one
    plan flushed as the model plans it, and as one plan forced to pack."""
    from ..core import plan as plan_mod
    from ..core import rma
    from ..core.rma import OpCounter
    from ..mesh import Mesh

    mesh = Mesh(P_RANKS, "x", device)
    k, words = RMA_K, max(1, RMA_MSG_BYTES // 4)
    x = torch.arange(P_RANKS * k * words, dtype=torch.float32,
                     device=mesh.device).reshape(P_RANKS, k, words)
    want = torch.roll(x, 1, dims=0)

    def eager():
        return torch.stack([rma.put_shift(x[:, i], 1, mesh) for i in range(k)], 1)

    def planned(aggregate):
        pl = plan_mod.RmaPlan(mesh)
        hs = [pl.put_shift(x[:, i], 1) for i in range(k)]
        pl.flush(aggregate=aggregate)
        return torch.stack([h.result() for h in hs], 1)

    out = {"k_msgs": k, "msg_bytes": RMA_MSG_BYTES}
    for name, fn in (("eager", eager), ("coalesced", lambda: planned(None)),
                     ("packed", lambda: planned(True))):
        with OpCounter() as c:
            got = fn()
        if not torch.equal(got, want):
            raise AssertionError(f"rma_plan {name}: puts landed wrong")
        out[name] = {"raw_msgs": c.raw_msgs, "wire_transfers": c.coalesced_msgs}
    return out


# ------------------------------------------------------ serve_flow blocks
def backpressure(device) -> dict:
    """Rank 1 wants k messages a step into rank 0's cap-slot ring, rank 0
    drains `drain` a step (FLOOD).  "retry" sends through `Channel.send` and
    replays what the full ring rejected; "credit" stages only what its
    credit cache covers and sends through `flow.send`."""
    from ..core.rma import OpCounter
    from ..mesh import Mesh
    from ..rmaq import channel as rch
    from ..rmaq import flow

    mesh = Mesh(P_RANKS, "x", device)
    n, dev = P_RANKS, mesh.device
    n_steps, cap, k, drain = (FLOOD[key] for key in ("n_steps", "cap", "k", "drain"))
    lanes = [rch.Lane("m", (4,), torch.float32)]

    def run(scheme: str) -> dict:
        if scheme == "credit":
            ch, qs, fs = flow.flow_allocate(mesh, cap, lanes, n_producers=2)

            def step(qs, fs, payload, tag, dest):
                qs, fs, r = flow.send(ch, qs, fs, "m", payload, tag, dest)
                qs, fs, batch = flow.recv(ch, qs, fs, drain)
                return qs, fs, r.accepted, int(r.rejected.sum()), batch.valid
        else:
            ch, qs = rch.channel_allocate(mesh, cap, lanes)
            fs = None

            def step(qs, fs, payload, tag, dest):
                qs, receipt = ch.send(qs, "m", payload, tag, dest)
                qs, batch = ch.recv(qs, drain)
                return qs, fs, receipt.accepted, 0, batch.valid

        tag = torch.zeros((n, k), dtype=torch.int32, device=dev)
        idle = torch.full((n, k), -1, dtype=torch.int32, device=dev)
        zeros = torch.zeros((n, k, 4), dtype=torch.float32, device=dev)
        clone = lambda t: None if t is None else t.__class__(*(x.clone() for x in t))
        with OpCounter() as c:                  # one idle step on cloned state
            step(clone(qs), clone(fs), zeros, tag, idle)
        stats = dict(steps=n_steps, sent_attempts=0, retries=0, rejects=0,
                     full_ring_steps=0, delivered=0, credit_stalls=0,
                     wire_transfers_per_append=c.coalesced_msgs,
                     raw_msgs_per_append=c.raw_msgs,
                     plan_ledger=[dict(pl) for pl in c.plans])
        backlog = list(range(10 * n_steps))
        for _ in range(n_steps):
            if scheme == "credit":
                credit = int(flow.credits(fs)[1, 0, 0])
                n_stage = min(k, len(backlog), max(credit, 0))
                stats["credit_stalls"] += int(min(k, len(backlog)) - n_stage > 0)
            else:
                n_stage = min(k, len(backlog))
            stage = backlog[:n_stage]
            del backlog[:n_stage]
            payload = np.zeros((n, k, 4), np.float32)
            payload[1, :n_stage, 0] = stage
            dest = np.full((n, k), -1, np.int32)
            dest[1, :n_stage] = 0
            qs, fs, acc, rejected, valid = step(
                qs, fs, torch.as_tensor(payload, device=dev), tag,
                torch.as_tensor(dest, device=dev))
            if rejected:
                raise AssertionError(f"credited send rejected {rejected}")
            acc = acc[1, :n_stage].cpu().numpy()
            refused = [m for m, a in zip(stage, acc) if not a]
            stats["sent_attempts"] += n_stage
            stats["rejects"] += len(refused)
            stats["retries"] += len(refused)
            stats["full_ring_steps"] += int(len(refused) > 0)
            stats["delivered"] += int(valid[0].sum())
            backlog[:0] = refused
        return stats

    return {"retry": run("retry"), "credit": run("credit")}


def engine_record(eng, n_req: int) -> dict:
    """One finished engine's counts, as `bench_serve_flow.run_engines`
    records them (its latency summaries left out)."""
    return {
        "requests": n_req,
        "served": len(eng.results),
        "retries": int(eng.retries),
        "credit_stalls": int(eng.credit_stalls),
        "ring_rejects": int(eng.queue_stats()["dropped_by_me"].sum()),
        "msg_stats": _numbers(eng.msg_stats),
    }


def serve_engines(device) -> dict:
    """Every prefill rank feeds ONE decode rank through a 4-slot ring, with
    reject/retry and with credits."""
    from ..serve.disagg import DisaggConfig, DisaggEngine

    out = {}
    for mode in ("retry", "credit"):
        cfg = DisaggConfig(n_prefill=P_RANKS - 1, block_tokens=8, d_model=16, vocab=61,
                           queue_capacity=4, max_recv_per_step=1, n_lanes=1,
                           flow=(mode == "credit"))
        eng = DisaggEngine(P_RANKS, cfg, seed=0, device=device)
        rng = np.random.RandomState(1)
        _served(eng, {rid: rng.randint(0, cfg.vocab, size=cfg.block_tokens)
                      for rid in range(SERVE_REQUESTS)})
        out[mode] = engine_record(eng, SERVE_REQUESTS)
    return out


def transport_series(eng, n_req: int) -> dict:
    """One finished engine's transport counts (`bench_serve_flow.run_transports`)."""
    from ..rmaq import channel as rch

    cfg = eng.cfg
    slot_nbytes = 4 * (rch.HDR + eng.channel.payload_words)
    rdv = eng.rendezvous_stats()
    return {
        "mode": eng.mode,
        "requests": n_req,
        "served": len(eng.results),
        "block_nbytes": cfg.block_nbytes,
        "ring_slot_nbytes": slot_nbytes,
        "ring_window_nbytes": slot_nbytes * cfg.queue_capacity,
        "ring_payload_appends": int(eng.ring_payload_appends),
        "descriptor_appends": int(eng.descriptor_appends),
        "wire_msgs_per_step": eng.msg_stats["wire_msgs_per_step"],
        "bytes_wire_per_req": eng.steps_run * eng.msg_stats["bytes_wire_per_step"] / n_req,
        "effective_payload_bytes_per_req": (
            (rdv["descriptor_bytes"] + rdv["pulled_bytes"]) / n_req
            if rdv else cfg.block_nbytes),
        "credit_stalls": int(eng.credit_stalls),
        "retries": int(eng.retries),
    }


def crossover() -> dict:
    """The eager/rendezvous pick around the model's crossover at
    CROSSOVER_PAGES pages a block must flip."""
    from ..core.perfmodel import DEFAULT_MODEL as m

    ppb = CROSSOVER_PAGES
    bstar = m.rendezvous_crossover_bytes(ppb)
    eps = max(bstar * 1e-6, 2.0)
    below = m.select_transfer_protocol(bstar - eps, ppb)
    above = m.select_transfer_protocol(bstar + eps, ppb)
    return {"pages_per_block": ppb, "crossover_bytes": bstar, "below": below,
            "above": above, "flip_exact": int(below != above)}


def transports(device) -> dict:
    """Eager push vs rendezvous pull on the same prompts at both A/B sizes:
    token-identical; then the crossover flip."""
    from ..serve.disagg import DisaggConfig, DisaggEngine

    out = {}
    for size_name, dims in TRANSPORT_SIZES.items():
        kw = dict(n_prefill=P_RANKS // 2, vocab=61, queue_capacity=8,
                  max_recv_per_step=2, n_lanes=2, flow=True, pool_pages=64,
                  novel_slots=4, **dims)
        rng = np.random.RandomState(2)
        prompts = {rid: rng.randint(0, 61, size=dims["block_tokens"])
                   for rid in range(SERVE_REQUESTS)}
        series, results = {}, {}
        for transport in ("eager", "rendezvous"):
            eng = DisaggEngine(P_RANKS, DisaggConfig(transport=transport, **kw),
                               seed=0, device=device)
            results[transport] = _served(eng, prompts)
            series[transport] = transport_series(eng, SERVE_REQUESTS)
        if results["eager"] != results["rendezvous"]:
            raise AssertionError(f"{size_name}: pull and push tokens differ")
        out[size_name] = series
    out["crossover"] = crossover()
    return out


def _traced(protocol: str) -> tuple[dict, list, dict]:
    """One conformance run at (SIM_RANKS, SIM_SCHEDULE, SIM_SEED) under a
    tracer, stitched into per-request TTFT breakdowns."""
    from ..sim.conformance import run_one
    from . import causal, critpath
    from . import trace as obs_trace

    tracer = obs_trace.Tracer()
    report = run_one(protocol, SIM_RANKS, SIM_SCHEDULE, SIM_SEED, tracer=tracer)
    events = list(tracer.events)
    breakdowns, connected = [], 0
    for _, dag in sorted(causal.build_dags(events).items()):
        bd = critpath.ttft_breakdown(dag)
        if bd is None:                     # not a completed request
            continue
        connected += bool(dag.connected())
        bd["critical_path"], _ = critpath.critical_path(dag)
        bd["wall"] = dag.wall()
        breakdowns.append(bd)
    agg = critpath.aggregate(breakdowns)
    block = {
        "ranks": SIM_RANKS,
        "schedule": SIM_SCHEDULE,
        "seed": SIM_SEED,
        "virtual_time": report["virtual_time"],
        "requests": len(breakdowns),
        "connected": connected,
        "segment_sum_exact": sum(1 for b in breakdowns if b["segment_sum"] == b["ttft"]),
        "critical_path_le_wall": sum(
            1 for b in breakdowns if b["critical_path"] <= b["wall"]),
        "ttft_vt": agg["ttft"],
        "segments_vt": agg["segments"],
    }
    return block, events, report


def sim_serve() -> dict:
    """The traced eager serve slice (`bench_serve_flow.run_sim_serve`)."""
    from . import critpath

    block, events, _ = _traced("serve")
    block["sync_ledger"] = critpath.SyncLedger.from_events(events).summary()
    return block


def sim_rendezvous() -> dict:
    """The traced rendezvous pull slice (`bench_serve_flow.run_sim_rendezvous`)."""
    block, _, report = _traced("rendezvous")
    for key in ("pulled", "abandoned", "descriptor_sends", "payload_sends"):
        block[key] = report[key]
    return block


# ------------------------------------------------------------------ rmem
def rmem_record(eng, n_req: int) -> dict:
    """One finished inline or paged engine's append counts, as
    `bench_rmem.run_engine` records them (its attend times left out).
    Paged mode counts its append as the plans after plan 0, the novel-page
    scatter."""
    if not eng.flow_stats()["conservation_ok"]:
        raise AssertionError("credit conservation violated")
    plans = eng.msg_stats["plans"]
    if eng.mode == "paged":
        append_transfers = sum(pl["coalesced"] for pl in plans[1:])
        ps = eng.paged_stats()
        if not ps["pool_conservation_ok"]:
            raise AssertionError(f"pool conservation violated: {ps}")
        extra = {
            "novel_pages_shipped": ps["novel_pages_shipped"],
            "prefix_hits": ps["prefix_hits"],
            "prefix_hit_rate": ps["prefix_hit_rate"],
            "effective_payload_bytes_per_req": ps["effective_payload_bytes"] / n_req,
            "attend_path": ps["attend_path"],
            "pages_per_block": ps["pages_per_block"],
            "staging_pages_resident": ps["staging_pages_resident"],
            "staging_bytes_per_decode": ps["staging_bytes_per_decode"],
        }
    else:
        append_transfers = eng.msg_stats["wire_msgs_per_step"]
        extra = {"effective_payload_bytes_per_req": float(eng.cfg.block_nbytes)}
    return {
        "served": len(eng.results),
        "steps": eng.steps_run,
        "wire_transfers_per_append": int(append_transfers),
        "bytes_wire_per_step": eng.msg_stats["bytes_wire_per_step"],
        "bytes_wire_per_req": eng.msg_stats["bytes_wire_per_step"] * eng.steps_run / n_req,
        "retries": int(eng.retries),
        **extra,
    }


def decode_series(fused: dict, gather: dict) -> dict:
    """The fused-vs-gather decode A/B from two paged records."""
    keys = ("attend_path", "staging_pages_resident", "staging_bytes_per_decode",
            "wire_transfers_per_append")
    return {
        "pages_per_block": fused["pages_per_block"],
        "page_nbytes": int(fused["staging_bytes_per_decode"]
                           / fused["staging_pages_resident"]),
        "fused": {k: fused[k] for k in keys},
        "gather": {k: gather[k] for k in keys},
        "staging_bytes_reduction":
            gather["staging_bytes_per_decode"] / fused["staging_bytes_per_decode"],
    }


def rmem_engine(device, paged: bool, attend: str = "fused") -> dict:
    """One mode on the shared-prefix workload (RMEM): every prompt's first
    `shared_frac` is one prefix."""
    from ..serve.disagg import DisaggConfig, DisaggEngine

    n_req, shared_frac, seed = RMEM["n_req"], RMEM["shared_frac"], RMEM["seed"]
    cfg = DisaggConfig(n_prefill=max(1, P_RANKS // 2), block_tokens=16, d_model=32,
                       vocab=61, queue_capacity=16, max_recv_per_step=4, n_lanes=2,
                       flow=True, paged=paged, page_tokens=4, novel_slots=2,
                       pool_pages=48, attend=attend)
    eng = DisaggEngine(P_RANKS, cfg, seed=0, device=device)
    rng = np.random.RandomState(seed)
    n_shared = int(cfg.block_tokens * shared_frac)
    prefix = rng.randint(0, cfg.vocab, size=n_shared)
    prompts = {rid: np.concatenate(
        [prefix, rng.randint(0, cfg.vocab, size=cfg.block_tokens - n_shared)])
        for rid in range(n_req)}
    _served(eng, prompts)
    return rmem_record(eng, n_req)


# --------------------------------------------------------------- the sets
def set_a(device, run: Optional[Callable] = None) -> dict:
    """The three documents at the reference smoke benchmarks' shapes.
    `run`, if given, makes each run: ``run(name, fn)`` returns ``fn()``
    (e.g. with the kernels' launch counts zeroed before and read after)."""
    wrap = run or (lambda name, fn: fn())
    serve_flow = {
        "devices": P_RANKS,
        "queue_backpressure": wrap("queue_backpressure", lambda: backpressure(device)),
        "serve_engine": wrap("serve_engine", lambda: serve_engines(device)),
        "transport": wrap("transport", lambda: transports(device)),
        "sim_serve": wrap("sim_serve", sim_serve),
        "sim_rendezvous": wrap("sim_rendezvous", sim_rendezvous),
    }
    inline = wrap("rmem.inline", lambda: rmem_engine(device, paged=False))
    paged = wrap("rmem.fused", lambda: rmem_engine(device, paged=True, attend="fused"))
    gather = wrap("rmem.gather", lambda: rmem_engine(device, paged=True, attend="gather"))
    rmem = {"devices": P_RANKS, "inline": inline, "paged": paged,
            "decode": decode_series(paged, gather)}
    return {"rma_plan": wrap("rma_plan", lambda: rma_plan_doc(device)),
            "serve_flow": serve_flow, "rmem": rmem}


def run_record(eng, n_req: int) -> dict:
    """What `set_b` reads of one finished engine of `n_req` requests."""
    rec = {"engine": engine_record(eng, n_req), "transport": transport_series(eng, n_req)}
    if eng.mode in ("inline", "paged"):
        rec["rmem"] = rmem_record(eng, n_req)
    return rec


def set_b(fused: dict, gather: dict, inline: dict, rendezvous: dict) -> dict:
    """Documents from the `run_record`s of four finished engines: a paged
    "fused", a paged "gather", an inline and a rendezvous run.  The inline
    run is the credit engine and the eager side of the transport series;
    the flood, the retry engine and the crossover have no such run."""
    serve_flow = {
        "serve_engine": {"credit": inline["engine"]},
        "transport": {"full_width": {"eager": inline["transport"],
                                     "rendezvous": rendezvous["transport"]}},
    }
    rmem = {"inline": inline["rmem"], "paged": fused["rmem"],
            "decode": decode_series(fused["rmem"], gather["rmem"])}
    return {"serve_flow": serve_flow, "rmem": rmem}


def write(docs: dict, root: str) -> None:
    """Write each document under the reference's file name into `root`."""
    for key, doc in docs.items():
        with open(os.path.join(root, NAMES[key]), "w") as f:
            json.dump(doc, f, indent=2, default=float)
