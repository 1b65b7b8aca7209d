"""The port's dense model: config, parameters, prefill, decode."""

from .convert import params_from_jax
from .model import (
    Model,
    ModelConfig,
    decode_step,
    init_random_,
    make_decode_cache,
    param_specs,
    prefill,
    state_bytes,
)

__all__ = ["Model", "ModelConfig", "decode_step", "init_random_",
           "make_decode_cache", "param_specs", "params_from_jax", "prefill",
           "state_bytes"]
