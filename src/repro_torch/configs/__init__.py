"""Architecture configs: one module per assigned architecture (copies of
`repro.configs`, data only; the port serves every family of them)."""

from . import base
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

_MODULES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-15b": "starcoder2_15b",
    "smollm-360m": "smollm_360m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-small": "whisper_small",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
