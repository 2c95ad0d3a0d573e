"""Qwen1.5-110B [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_style="full", mlp_type="swiglu",
    source="hf:Qwen/Qwen1.5-110B",
)

SMOKE = ArchConfig(
    name="qwen1.5-110b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qkv_bias=True, rope_style="full", mlp_type="swiglu",
)
