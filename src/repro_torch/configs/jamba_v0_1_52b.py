"""Jamba-v0.1-52B [hybrid] — Mamba+attn 1:7, MoE 16e top-2. [arXiv:2403.19887; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    rope_style="none",  # jamba uses no positional encoding (Mamba carries position)
    moe_experts=16, moe_top_k=2, moe_d_ff=14336, moe_every=2,
    ssm_type="mamba", attn_period=8, ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    source="arXiv:2403.19887",
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, rope_style="none",
    moe_experts=4, moe_top_k=2, moe_d_ff=128, moe_every=2,
    ssm_type="mamba", attn_period=8, ssm_state_dim=8, ssm_conv_width=4, ssm_expand=2,
)
