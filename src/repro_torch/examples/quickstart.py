"""Quickstart: train a small LM on the port's stack, then sample greedily
(the counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

SmolLM-360M's SMOKE config, 60 AdamW steps on [4, 64] synthetic tokens,
then a greedy decode of 8 tokens from a 4-token prompt.  On the card the
attention runs through the flash kernel.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..mesh import resolve_device
from ..models import build_model
from ..models import layers as L
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import StepConfig, make_train_step


def main(argv: list[str] | None = None) -> list[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--new", type=int, default=8, help="tokens to sample")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device=device)
    print(f"{cfg.name}: {model.param_count() / 1e3:.0f}k params")

    pipe = SyntheticTokenPipeline(DataConfig(cfg.vocab_size, seq_len=64, global_batch=4),
                                  device=device)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=args.steps), StepConfig())
    opt = init_opt_state(params)
    L.set_attention_backend("cuda" if device.type == "cuda" else "torch")
    try:
        for i in range(args.steps):
            params, opt, m = step(params, opt, pipe.batch_at(i))
            if i % 10 == 0:
                print(f"step {i:3d}  loss {float(m['loss']):.4f}")
    finally:
        L.set_attention_backend("torch")

    # greedy decode from a prompt
    with torch.no_grad():
        cache = model.init_cache(1, 32, device=device)
        prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device=device)
        logits, cache = model.prefill(params, prompt, cache)
        toks = []
        for _ in range(args.new):
            tok = logits.argmax(-1)
            toks.append(int(tok[0]))
            logits, cache = model.decode_step(params, tok, cache)
    print("sampled:", toks)
    return toks


if __name__ == "__main__":
    main()
