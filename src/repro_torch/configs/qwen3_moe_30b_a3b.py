"""Qwen3-30B-A3B [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    rope_style="full", mlp_type="swiglu",
    moe_experts=128, moe_top_k=8, moe_d_ff=768, moe_every=1,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab_size=256, head_dim=16,
    rope_style="full", moe_experts=8, moe_top_k=2, moe_d_ff=64, moe_every=1,
)
