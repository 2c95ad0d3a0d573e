"""ChatGLM3-6B [dense] — 2D RoPE, GQA kv=2. [arXiv:2406.12793; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    qkv_bias=True, rope_style="2d", mlp_type="swiglu",
    source="arXiv:2406.12793",
)

SMOKE = ArchConfig(
    name="chatglm3-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qkv_bias=True, rope_style="2d", mlp_type="swiglu",
)
