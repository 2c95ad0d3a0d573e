"""Deterministic, seekable synthetic token pipeline, sharded per host (the
counterpart of `repro.data.pipeline`).

A batch is a pure function of (seed, step, shard): restarting at step k
replays the batches the failed run would have seen, and the checkpoint only
stores the step.  Tokens come from a Zipf distribution (exponent 1.1) over
the vocab with short-range structure: with p = 0.3 a token repeats the
previous token + 1 (mod V).  ``tokens`` and ``labels`` are the same draw
shifted by one.

The reference draws with `jax.random` (threefry keys folded with the step
and the shard); here an explicit `torch.Generator` on the CPU is seeded
with a mix of the three and the batch is then moved to the device, so the
CPU and the card see the same batches.  The bits differ from the
reference's by design (ROADMAP §3): the parity tests hand both packages
the reference pipeline's batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import resolve_device

_MASK = (1 << 64) - 1


def _mix(*words: int) -> int:
    """SplitMix64 over the words: a seed for (seed, step, shard), < 2**63."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _MASK)) * 0xBF58476D1CE4E5B9 & _MASK
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK
        h ^= h >> 29
    return h >> 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1       # data-loading hosts
    shard_id: int = 0


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.local_batch = cfg.global_batch // cfg.n_shards
        self.device = resolve_device(device)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** 1.1
        self._probs = torch.from_numpy(w / w.sum())        # fixed Zipf weights, O(V)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """Pure function of (seed, step, shard): deterministic replay."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(_mix(cfg.seed, step, cfg.shard_id))
        shape = (self.local_batch, cfg.seq_len + 1)
        base = torch.multinomial(self._probs, shape[0] * shape[1], replacement=True,
                                 generator=gen).reshape(shape)
        rep = torch.rand(shape, generator=gen, dtype=torch.float64) < 0.3
        shifted = (torch.roll(base, 1, dims=1) + 1) % cfg.vocab_size
        tokens = torch.where(rep, shifted, base).to(torch.int32).to(self.device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
