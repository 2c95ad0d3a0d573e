"""Dry-run: count every (arch x shape) cell's step on meta tensors (the
counterpart of `repro.launch.dryrun`, for one card).

The reference lowers and compiles each cell's jitted step for a 256- or
512-chip production mesh from placeholder host devices and reads XLA's
memory analysis and its HLO.  The port has one card and no compiler: each
cell's train, prefill or decode step runs once, eagerly, on meta tensors
(params from `Model.init_shapes`, inputs from `Model.input_specs`, AdamW
moments on meta too) under `launch.hlo_cost`'s counter.  Nothing is
allocated.  Attention runs on backend "torch", the blockwise attention:
on meta its block loops, like the xLSTM's chunk and step loops, run one
trip counted n times (`obs.cost.repeat`).  Mamba's scan has no plain
path on meta: there the scan wrapper reports its kernel's counts and
returns meta outputs.  Each cell's record has
the reference's keys (``mem_*`` and ``hlo_*`` are the whole card's) and
``fits``: whether ``mem_args + mem_out + mem_temp`` fits the card's memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card --jobs 8
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k

``--mesh single`` and ``--mesh multi`` (the reference's 256- and 512-chip
meshes, `repro/launch/mesh.py`) are refused: the port runs on one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core.perfmodel import H100
from ..models import build_model
from ..models import layers as L
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import StepConfig, make_prefill_step, make_serve_step, make_train_step
from . import hlo_cost

MESHES = ("card",)
REFUSED = {"single": "the reference's 16x16 production mesh (256 chips)",
           "multi": "the reference's 2x16x16 production mesh (512 chips)",
           "both": "the reference's two production meshes"}
DEFAULT_OUT = "results/dryrun"


def run_cell(arch: str, shape_name: str, mesh_name: str = "card", smoke: bool = False) -> dict:
    """One cell's record: "skipped" where `shape_applicable` says so, else
    the counter's summary of the step on meta tensors."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": 1}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    model = build_model(cfg)
    params = model.init_shapes()
    inputs = model.input_specs(shape)
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(), StepConfig())
        args = (params, init_opt_state(params), inputs)
    elif shape.kind == "prefill":
        args = (params, inputs)
        step = make_prefill_step(model)
    else:
        step = make_serve_step(model)
        args = (params, inputs["token"], inputs["cache"])

    caller = L._ATTN_BACKEND[0]
    L.set_attention_backend("torch")
    t0 = time.time()
    try:
        hlo = hlo_cost.analyze(step, *args, scopes=False)
    finally:
        L.set_attention_backend(caller)
    t_count = time.time() - t0
    total = hlo.mem_args + hlo.mem_out + hlo.mem_temp
    rec.update(
        status="ok",
        kind=shape.kind,
        t_count_s=round(t_count, 2),
        # the whole card's memory (bytes)
        mem_args=hlo.mem_args,
        mem_out=hlo.mem_out,
        mem_temp=hlo.mem_temp,
        fits=total <= H100.hbm_capacity,
        # the counter's totals (every op as it ran: loops unrolled)
        hlo_flops=hlo.flops,
        hlo_bytes=hlo.hbm_bytes,
        product_flops=hlo.product_flops,
        coll_bytes=hlo.collective_bytes,
        coll_by_kind=hlo.collective_bytes_by_kind(),
        coll_by_group={str(k): v for k, v in hlo.collective_bytes_by_group_size().items()},
        hlo_warnings=hlo.warnings[:5],
        n_ops=hlo.n_ops,
        n_params=model.param_count(),
        n_active_params=cfg.n_active_params(),
    )
    return rec


def _cell(cell: tuple) -> dict:
    """`run_cell`, a failure recorded rather than raised (a failing cell is
    a bug; the run reports it and exits non-zero)."""
    arch, shape, mesh_name, smoke = cell
    try:
        return run_cell(arch, shape, mesh_name, smoke=smoke)
    except Exception as e:  # noqa: BLE001
        return {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": 1,
                "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="card")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=1, help="cells counted in parallel processes")
    args = ap.parse_args(argv)
    if args.mesh not in MESHES:
        raise SystemExit(f"--mesh {args.mesh}: {REFUSED.get(args.mesh, 'unknown mesh')}; the "
                         f"port runs on one card: use --mesh card")

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    cells = [(arch, shape, args.mesh, args.smoke) for arch in archs for shape in shapes]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")    # the caller may hold a CUDA context
        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as ex:
            recs = list(ex.map(_cell, cells))
    else:
        recs = [_cell(c) for c in cells]
    failures = 0
    for rec in recs:
        tag = f"{rec['arch']}_{rec['shape']}_{args.mesh}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        extra = ""
        if rec["status"] == "ok":
            mem = (rec["mem_args"] + rec["mem_out"] + rec["mem_temp"]) / 2**30
            extra = (f"count={rec['t_count_s']}s flops={rec['hlo_flops']:.3e} "
                     f"bytes={rec['hlo_bytes']:.3e} mem={mem:.2f}GiB fits={rec['fits']}")
        elif rec["status"] == "FAILED":
            extra = rec["error"][:160]
            failures += 1
        print(f"[{rec['status']:7s}] {tag} {extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return recs


if __name__ == "__main__":
    main(sys.argv[1:])
