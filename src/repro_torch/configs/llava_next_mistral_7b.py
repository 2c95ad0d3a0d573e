"""LLaVA-NeXT (Mistral-7B backbone) [vlm] — anyres tiling frontend is a STUB
(input_specs supplies precomputed patch embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    rope_style="full", mlp_type="swiglu",
    frontend="vision_patches", frontend_tokens=2880,  # anyres: up to 5 tiles x 576
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = ArchConfig(
    name="llava-next-mistral-7b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    rope_style="full", frontend="vision_patches", frontend_tokens=16,
)
