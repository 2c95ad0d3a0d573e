"""SmolLM-360M [dense] — llama-arch small, GQA kv=5. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    qkv_bias=False, rope_style="full", mlp_type="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1,
    d_ff=128, vocab_size=256, head_dim=20,
    rope_style="full", mlp_type="swiglu", tie_embeddings=True,
)
