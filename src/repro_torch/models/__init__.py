"""The model zoo's dense and vlm families (the counterpart of
`repro.models`): `layers`, `transformer`, `registry`."""

from . import layers, registry, transformer  # noqa: F401
from .registry import Model, build_model, params_from_jax  # noqa: F401
