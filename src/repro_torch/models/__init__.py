"""The model zoo's dense, vlm, moe and hybrid families (the counterpart of
`repro.models`): `layers`, `moe`, `mamba`, `transformer`, `registry`."""

from . import layers, mamba, moe, registry, transformer  # noqa: F401
from .registry import Model, build_model, params_from_jax  # noqa: F401
