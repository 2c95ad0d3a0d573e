"""The model zoo (the counterpart of `repro.models`): `layers`, `moe`,
`mamba`, `xlstm`, `transformer`, `registry`."""

from . import layers, mamba, moe, registry, transformer, xlstm  # noqa: F401
from .registry import Model, build_model, params_from_jax  # noqa: F401
