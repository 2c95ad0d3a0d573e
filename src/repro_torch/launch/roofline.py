"""Roofline report over the dry-run's records (the counterpart of
`repro.launch.roofline`).

Reads `launch.dryrun`'s records and prints, per (arch x shape) cell on the
card, the three roofline terms of `core.perfmodel.roofline_terms`, the
dominant one, MODEL_FLOPS (6·N·D train / 2·N·D prefill and decode, N the
active params for MoE) over the counted FLOPs, and a one-line note on what
would move the dominant term.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir results/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_config
from ..core.perfmodel import roofline_terms
from .dryrun import DEFAULT_OUT


def model_flops_total(arch: str, shape_name: str) -> float:
    """Whole-step useful FLOPs: 6ND train, 2ND prefill, 2ND/token decode."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.n_active_params() if cfg.moe_experts else cfg.n_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token a sequence a step


def advice(rec: dict, terms: dict) -> str:
    dom = terms["dominant"]
    if dom == "compute_s":
        if rec.get("_mf_ratio", 1.0) < 0.5:
            return ("compute-bound but <50% useful: cut recomputed and masked FLOPs "
                    "(remat policy, a causal attention backward)")
        return "near the compute roofline: only the tensor cores' utilisation is left"
    if dom == "memory_s":
        return ("HBM-bound: fuse attention and the scan (hand kernels), drop f32 "
                "intermediates to bf16, fewer eager round trips")
    return ("collective-bound: fewer stacked-rank copies (views, not puts), or a "
            "mesh over NVLink")


def load(dirname: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_row(rec: dict) -> str | None:
    if rec.get("status") == "skipped":
        return (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | — | — | — | — | — | "
                f"skipped: {rec['reason'][:40]} |")
    if rec.get("status") != "ok":
        return (f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | FAILED | | | | | "
                f"{rec.get('error', '')[:60]} |")
    chips = rec["chips"]
    # hlo_* are the whole card's: one chip
    t = roofline_terms(rec["hlo_flops"], rec["hlo_bytes"], rec["coll_bytes"], chips=1)
    mf = model_flops_total(rec["arch"], rec["shape"]) / chips
    ratio = mf / max(rec["hlo_flops"], 1.0)
    rec["_mf_ratio"] = ratio
    dom = t["dominant"].replace("_s", "")
    return (
        f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
        f"| {t['compute_s']:.3e} | {t['memory_s']:.3e} | {t['collective_s']:.3e} "
        f"| **{dom}** | {ratio:.3f} | {advice(rec, t)[:80]} |"
    )


HEADER = (
    "| arch | shape | mesh | compute (s) | memory (s) | collective (s) "
    "| dominant | 6ND/HLO | to move the dominant term |\n"
    "|---|---|---|---|---|---|---|---|---|"
)


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    recs = load(args.dir)
    rows = [HEADER] + [row for row in map(fmt_row, recs) if row]
    for row in rows:
        print(row)
    return rows


if __name__ == "__main__":
    main()
