"""End to end: train a llama-style LM for a few hundred steps (the
counterpart of `examples/train_e2e.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --width 768 --layers 12 --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --device cpu --steps 20

The default is a ~10M-parameter config: the deterministic pipeline, the
train step with remat and AdamW, atomic asynchronous checkpoints; it fails
unless the loss falls.  On the card the attention runs through the flash
kernel.
"""

from __future__ import annotations

import argparse
import time

from ..ckpt.checkpoint import DEFAULT_DIR, CheckpointManager
from ..configs.base import ArchConfig
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..mesh import resolve_device
from ..models import build_model
from ..models import layers as L
from ..train.optimizer import AdamWConfig
from ..train.train_step import StepConfig, make_train_step
from ..train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_DIR / "e2e"))
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ArchConfig(
        name=f"e2e-{args.width}x{args.layers}", family="dense",
        n_layers=args.layers, d_model=args.width,
        n_heads=max(args.width // 64, 2), n_kv_heads=max(args.width // 128, 1),
        d_ff=args.width * 4, vocab_size=8192, tie_embeddings=True,
    )
    model = build_model(cfg)
    params = model.init(0, device=device)
    print(f"{cfg.name}: {model.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch),
                                  device=device)
    step = make_train_step(
        model, AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps),
        StepConfig(remat=True))
    trainer = Trainer(
        step, params, pipe,
        TrainerConfig(total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                      log_every=max(args.steps // 20, 1), ckpt_dir=args.ckpt_dir),
        ckpt=CheckpointManager(args.ckpt_dir))
    L.set_attention_backend("cuda" if device.type == "cuda" else "torch")
    t0 = time.time()
    try:
        hist = trainer.run(on_step=lambda r: print(
            f"  step {r['step']:4d}  loss {r['loss']:.4f}  {r['dt_s'] * 1e3:.0f} ms"))
    finally:
        L.set_attention_backend("torch")
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} | "
          f"{toks / dt:.0f} tok/s | checkpoints in {args.ckpt_dir}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit("training failed to improve")
    return hist


if __name__ == "__main__":
    main()
