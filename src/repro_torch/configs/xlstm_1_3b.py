"""xLSTM-1.3B [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    rope_style="none", ssm_type="xlstm", slstm_period=8,
    source="arXiv:2405.04517",
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=256,
    rope_style="none", ssm_type="xlstm", slstm_period=8,
)
