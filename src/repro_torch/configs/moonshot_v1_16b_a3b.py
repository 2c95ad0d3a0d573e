"""Moonlight-16B-A3B [moe] — kimi/moonlight, 64e top-6. [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    rope_style="full", mlp_type="swiglu",
    moe_experts=64, moe_top_k=6, moe_d_ff=1408, moe_every=1, moe_shared_ff=1408,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab_size=256, head_dim=16,
    rope_style="full", moe_experts=8, moe_top_k=2, moe_d_ff=64, moe_every=1, moe_shared_ff=64,
)
