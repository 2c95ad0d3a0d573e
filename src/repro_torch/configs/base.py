"""Architecture + shape configuration schema.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the exact published numbers) and ``SMOKE`` (a reduced config of
the same family for CPU smoke tests).  ``SHAPES`` below is the assigned
input-shape set shared by all LM-family archs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    qkv_bias: bool = False
    rope_style: str = "full"         # full | 2d | none
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_every: int = 1               # MoE FFN on every k-th layer (others dense)
    moe_shared_ff: int = 0           # shared-expert hidden dim (0 = none)

    # --- hybrid / SSM ---
    ssm_type: str = "none"           # none | mamba | xlstm
    attn_period: int = 0             # jamba: 1 attention layer per `attn_period`
    ssm_state_dim: int = 16          # mamba N
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    slstm_period: int = 0            # xlstm: 1 sLSTM block per `slstm_period`

    # --- encoder/decoder, frontends ---
    is_enc_dec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0             # encoder context length (whisper: 1500)
    frontend: str = "none"           # none | audio_frames | vision_patches
    frontend_tokens: int = 0         # stub frontend: #embedding positions

    # --- bookkeeping ---
    source: str = ""
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic sequence mixing)?"""
        return self.ssm_type != "none"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (whisper is enc-dec)

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks), for roofline 6·N·D."""
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        return _count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention; long_500k skipped per spec (see DESIGN.md)"
    return True, ""


# ----------------------------------------------------------- param counting
def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.hd
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    b = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + b


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp_type == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _mamba_params(cfg: ArchConfig) -> int:
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state_dim
    return (
        cfg.d_model * 2 * d_in          # in_proj (x and z)
        + cfg.ssm_conv_width * d_in     # conv1d
        + d_in * (n * 2 + 1)            # B, C, dt projections (x_proj)
        + d_in                          # dt bias + A diag approx
        + d_in * n                      # A
        + d_in * cfg.d_model            # out_proj
    )


def _xlstm_params(cfg: ArchConfig) -> int:
    # mLSTM block: up-proj (pf=2, x+z), block-diagonal q/k/v per head,
    # i/f/o gates, down-proj — matches repro.models.xlstm exactly.
    d = cfg.d_model
    nh = max(cfg.n_heads, 1)
    d_in = 2 * d
    mlstm = (
        d * 2 * d_in                 # up projection (x, z)
        + 3 * d_in * d_in // nh      # blockdiag q/k/v
        + 3 * d_in                   # i/f/o gate biases+scales
        + d_in * d                   # down projection
    )
    # sLSTM block: 4 gates x (input d->d + blockdiag recurrent d->d/nh),
    # followed by gated FFN with pf=4/3.
    slstm = 4 * (d * d + d * d // nh) + 3 * d * (4 * d) // 3
    if cfg.slstm_period:
        n_s = cfg.n_layers // cfg.slstm_period
    else:
        n_s = 0
    n_m = cfg.n_layers - n_s
    return (n_m * mlstm + n_s * slstm) // cfg.n_layers  # per-layer average


def _layer_params(cfg: ArchConfig, layer_idx: int, active_only: bool) -> int:
    total = 0
    # sequence mixer
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        total += _attn_params(cfg)
    elif cfg.family == "hybrid":
        if cfg.attn_period and layer_idx % cfg.attn_period == cfg.attn_period // 2:
            total += _attn_params(cfg)
        else:
            total += _mamba_params(cfg)
    elif cfg.family == "ssm":
        total += _xlstm_params(cfg) if cfg.ssm_type == "xlstm" else _mamba_params(cfg)
    # channel mixer
    is_moe_layer = cfg.moe_experts > 0 and (layer_idx % cfg.moe_every == cfg.moe_every - 1)
    if is_moe_layer:
        e = cfg.moe_top_k if active_only else cfg.moe_experts
        total += e * _mlp_params(cfg, cfg.moe_d_ff)
        total += cfg.d_model * cfg.moe_experts  # router
        if cfg.moe_shared_ff:
            total += _mlp_params(cfg, cfg.moe_shared_ff)
    elif cfg.d_ff > 0:
        total += _mlp_params(cfg, cfg.d_ff)
    total += 2 * cfg.d_model  # norms
    return total


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model  # embeddings
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model  # lm head
    for i in range(cfg.n_layers):
        total += _layer_params(cfg, i, active_only)
    if cfg.is_enc_dec:
        for i in range(cfg.encoder_layers):
            total += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 2 * cfg.d_model
            total += _attn_params(cfg)  # cross-attention in decoder
    return total
