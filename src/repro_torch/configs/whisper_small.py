"""Whisper-small [audio] — enc-dec; conv frontend is a STUB (input_specs
supplies precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    rope_style="none", mlp_type="gelu",  # whisper uses learned/sinusoidal pos
    is_enc_dec=True, encoder_layers=12, encoder_seq=1500,
    frontend="audio_frames", frontend_tokens=1500,
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-small-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    rope_style="none", mlp_type="gelu",
    is_enc_dec=True, encoder_layers=2, encoder_seq=32,
    frontend="audio_frames", frontend_tokens=32,
)
