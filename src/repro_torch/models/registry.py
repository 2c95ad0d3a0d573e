"""Model facade: init / forward / loss / prefill / decode (the counterpart
of `repro.models.registry`), plus `input_specs` (meta-tensor stand-ins for
the dry-run) and `params_from_jax`, which turns the reference's param
pytree (as numpy) into the port's, or into this rank's blocks of it under
a policy that splits the model over processes.  `forward_logits`,
`prefill` and `decode_step` run unchanged under such a policy
(`parallel.sharding`): given this rank's blocks, and a cache made by
`init_cache` under the policy, they return the whole vocabulary's
logits on every rank; `loss` is then this rank's rows' loss, which the
split train step (`train.train_step`) sums over the data axes."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..parallel.sharding import ShardingPolicy
from . import transformer as T


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ----------------------------------------------------------- params
    def init(self, seed: int = 0, device=None) -> dict:
        """Random bf16 weights from a seeded `torch.Generator` on the
        device (CUDA unless `device` says otherwise)."""
        dev = _device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return T.init_lm(self.cfg, gen, dev)

    def init_shapes(self) -> dict:
        """The params as meta tensors (no allocation): torch's counterpart
        of the reference's `ShapeDtypeStruct` tree, for the dry-run."""
        return T.init_lm(self.cfg, None, "meta")

    def param_count(self) -> int:
        """The exact sum of the leaves' sizes (the reference's count wraps
        at 2**31 on a leaf that large; ROADMAP §3)."""
        return sum(leaf.numel() for leaf in _leaves(self.init_shapes()))

    # ------------------------------------------------------------ train
    def forward_logits(self, params: dict, batch: dict,
                       rows: Optional[int] = None) -> T.ForwardOut:
        """The cache-free forward: logits for a train or prefill batch.  Its
        attention runs on the backend `layers.set_attention_backend` names.
        The audio family encodes ``batch["frames"]`` and runs its decoder
        over a fresh zero K/V cache of S rows, as the reference does.
        Under a model split `rows` is the global batch's row count
        (`transformer.forward`)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        prefix = batch.get("patches")
        if cfg.family == "audio":
            shape = (cfg.n_layers, tokens.shape[0], tokens.shape[1], cfg.n_kv_heads, cfg.hd)
            cache = {"kv": {k: torch.zeros(shape, dtype=torch.bfloat16, device=tokens.device)
                            for k in ("k", "v")},
                     "enc_out": T.encode(params, cfg, _frames(cfg, batch)),
                     "len": torch.zeros((), dtype=torch.int32, device=tokens.device)}
            out = T.forward(params, cfg, tokens, cache=cache)
        else:
            out = T.forward(params, cfg, tokens, prefix_embeds=prefix, rows=rows)
        logits = out.logits
        if cfg.family == "vlm" and prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        return out._replace(logits=logits)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        labels = batch["labels"]
        out = self.forward_logits(params, batch)
        logp = torch.log_softmax(out.logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
        loss = nll.mean()
        total = loss + 0.01 * out.aux_loss + 0.001 * out.z_loss
        return total, {"nll": loss, "aux": out.aux_loss, "z": out.z_loss}

    # ------------------------------------------------------------ serve
    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        return T.init_cache(self.cfg, batch, max_seq, _device(device))

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                extra: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
        """The audio family encodes ``extra["frames"]`` and puts the encoder
        output into the returned cache in its own dtype (the leaf is
        replaced, not written: an f32 model keeps an f32 ``enc_out``)."""
        cfg = self.cfg
        if cfg.family == "audio":
            cache = {**cache, "enc_out": T.encode(params, cfg, _frames(cfg, extra))}
        prefix = extra.get("patches") if (extra and cfg.family == "vlm") else None
        out = T.forward(params, cfg, tokens, cache=cache, prefix_embeds=prefix)
        return out.logits[:, -1], out.cache

    def decode_step(self, params: dict, token: torch.Tensor,
                    cache: dict) -> tuple[torch.Tensor, dict]:
        """token [B] -> (logits [B, V], cache)."""
        out = T.forward(params, self.cfg, token[:, None], cache=cache)
        return out.logits[:, 0], out.cache


    # ---------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig, dp_shards: int = 1) -> dict:
        """Meta-tensor stand-ins for every model input of this cell, the
        reference's shapes and dtypes (`dp_shards` is unused there too).

        train  : {tokens, labels [B,S]} (+frontend stubs)
        prefill: {tokens [B,S]} (+frontend stubs)
        decode : {token [B], cache(seq_len)} — one new token against a full cache
        """
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def sds(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        def frontend(d):
            if cfg.frontend == "audio_frames":
                d["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), torch.float32)
            elif cfg.frontend == "vision_patches":
                d["patches"] = sds((B, cfg.frontend_tokens, cfg.d_model), torch.float32)
            return d

        if shape.kind == "train":
            return frontend({"tokens": sds((B, S)), "labels": sds((B, S))})
        if shape.kind == "prefill":
            return frontend({"tokens": sds((B, S))})
        return {"token": sds((B,)), "cache": T.init_cache(cfg, B, S, "meta")}


def _frames(cfg: ArchConfig, inputs: Optional[dict]) -> torch.Tensor:
    if not inputs or inputs.get("frames") is None:
        raise ValueError(f"{cfg.name}: the audio family needs frames [B, "
                         f"{cfg.encoder_seq}, {cfg.d_model}] (precomputed frame embeddings)")
    return inputs["frames"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def build_model(cfg: ArchConfig) -> Model:
    T.check_family(cfg)
    return Model(cfg)


# leaves the reference keeps in f32 whatever the model's dtype: the MoE
# router (`repro.models.moe`) and Mamba's A_log and D_skip (`repro.models.mamba`)
F32_LEAVES = ("router", "A_log", "D_skip")


def params_from_jax(np_params: dict, device=None, dtype=torch.bfloat16,
                    policy: Optional[ShardingPolicy] = None) -> dict:
    """The reference's param pytree, its leaves as numpy, as the port's
    params on `device` in `dtype` (the dtype the reference ran them in:
    bf16 as it makes them, or f32 where a test casts them); the leaves of
    `F32_LEAVES` stay f32, as the reference keeps them.  The structure and
    the leaf shapes are the same in both packages.  Under a `policy` that
    splits the model over processes (`ShardingPolicy.splits_model`) each
    leaf is this rank's block of it (`NamedSharding.local` of its fitted
    spec: `ShardingPolicy.local_params`; 2-D over ``data`` x ``model``
    under ``fsdp=True``), cut from the numpy leaf before it reaches the
    device; any other policy changes nothing."""
    if policy is not None and policy.splits_model:
        np_params = policy.local_params(np_params)
    dev = _device(device)
    return {k: (params_from_jax(v, device, dtype) if isinstance(v, dict)
                else torch.tensor(np.ascontiguousarray(v)).to(
                    device=dev, dtype=torch.float32 if k in F32_LEAVES else dtype))
            for k, v in np_params.items()}
