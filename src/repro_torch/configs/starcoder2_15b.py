"""StarCoder2-15B [dense] — GQA kv=4, RoPE, gelu MLP. [arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152, head_dim=128,
    qkv_bias=True, rope_style="full", mlp_type="gelu",
    source="arXiv:2402.19173",
)

SMOKE = ArchConfig(
    name="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab_size=256, head_dim=16,
    qkv_bias=True, rope_style="full", mlp_type="gelu",
)
