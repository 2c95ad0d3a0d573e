"""Batched serving launcher: continuous batching over the ServeEngine (the
counterpart of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --max-new 12 [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
        --layers 16          # on the card: 2 of Jamba's 4 periods, 48.5 GiB
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b

It runs on the card unless ``--device cpu`` is given; the weights are random,
from a seeded `torch.Generator` on the device.  ``--layers`` cuts the depth
(a whole number of periods for the hybrid and ssm families) and the cut is
printed.  It serves the dense, vlm, moe (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b), hybrid (jamba-v0.1-52b) and ssm (xlstm-1.3b)
families.  The audio family (whisper-small) exits with the reference
launcher's message: the engine prefills without frames, so an
encoder-decoder is served through `Model.prefill(..., {"frames": ...})`
and `decode_step` instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "audio":
        raise SystemExit("serve demo targets decoder-only archs; see examples/ for enc-dec")
    if args.layers is not None and args.layers != cfg.n_layers:
        print(f"{cfg.name}: depth cut to {args.layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    try:
        model = build_model(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    params = model.init(0, device=args.device)
    print(f"{cfg.name}: {model.param_count()} parameters")
    engine = ServeEngine(model, params, n_slots=args.slots, max_seq=args.max_seq,
                         device=args.device)

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(args.requests):
        plen = 4 + (i % 5)
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        req = Request(rid=i, prompt=prompt, max_new=args.max_new)
        reqs.append(req)
        engine.submit(req)

    t0 = time.perf_counter()
    engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    for r in reqs[:4]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    print(f"{len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {args.slots} slots, "
          f"lock AMOs={engine.lock_win.total_amos}, device {engine.device})")
    assert all(r.done.is_set() for r in reqs)


if __name__ == "__main__":
    main()
