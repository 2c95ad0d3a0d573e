"""End-to-end training launcher (the counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 20 --batch 4 --seq 2048          # on the card, at full width

It runs on the card unless ``--device cpu`` is given: the Trainer, the
synthetic pipeline, AdamW with remat and the checkpoints, with random
weights from a seeded `torch.Generator` on the device.  On the card the
attention runs through the flash kernel.  ``--layers`` cuts the depth (a
whole number of periods for the hybrid and ssm families) and the cut is
printed.  The audio family is refused: its loss needs frames, which the
synthetic token pipeline does not make.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..ckpt.checkpoint import DEFAULT_DIR, CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..ft.heartbeat import HeartbeatMonitor
from ..mesh import resolve_device
from ..models import build_model
from ..models import layers as L
from ..train.optimizer import AdamWConfig
from ..train.train_step import StepConfig, make_train_step
from ..train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_DIR / "train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "audio":
        raise SystemExit(f"{cfg.name}: training needs frames [B, {cfg.encoder_seq}, "
                         f"{cfg.d_model}] beside the tokens, and the data pipeline makes "
                         "tokens only")
    if args.layers is not None and args.layers != cfg.n_layers:
        print(f"{cfg.name}: depth cut to {args.layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    try:
        model = build_model(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    params = model.init(0, device=device)
    print(f"arch={cfg.name} params={model.param_count() / 1e6:.2f}M device={device}")

    pipeline = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch),
                                      device=device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step = make_train_step(model, opt_cfg, StepConfig(n_microbatches=args.microbatches))
    trainer = Trainer(
        step, params, pipeline,
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      log_every=max(args.steps // 20, 1), ckpt_dir=args.ckpt_dir),
        monitor=HeartbeatMonitor(1),
        ckpt=CheckpointManager(args.ckpt_dir),
    )
    if args.resume and trainer.maybe_resume():
        print(f"resumed at step {trainer.step}")

    L.set_attention_backend("cuda" if device.type == "cuda" else "torch")
    try:
        history = trainer.run(on_step=lambda r: print(
            f"step {r['step']:5d}  loss {r['loss']:.4f}  gnorm {r['grad_norm']:.3f}  "
            f"{r['dt_s'] * 1e3:.0f} ms"))
    finally:
        L.set_attention_backend("torch")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return history


if __name__ == "__main__":
    main()
