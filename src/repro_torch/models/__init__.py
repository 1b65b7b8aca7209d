"""The port's models (dense, MoE, RWKV-6, the Mamba hybrid, the
encoder-decoder and the vision prefix): config, parameters, encode,
prefill, decode, and the training forward."""

from .convert import opt_state_from_jax, params_from_jax, to_numpy_tree
from .model import (
    Model,
    ModelConfig,
    decode_step,
    encode,
    forward_logits,
    forward_logits_aux,
    forward_train,
    init_random_,
    make_decode_cache,
    param_specs,
    prefill,
    state_bytes,
)
from .moe import (
    MoEConfig,
    moe_ffn,
    moe_param_specs,
    moe_residual_param_specs,
    moe_with_residual,
)
from .rwkv import (
    rwkv_channel_mix,
    rwkv_channel_mix_step,
    rwkv_param_specs,
    rwkv_time_mix,
    rwkv_time_mix_step,
)
from .ssm import mamba_decode_step, mamba_forward, mamba_param_specs

__all__ = ["Model", "ModelConfig", "MoEConfig", "decode_step", "encode",
           "forward_logits", "forward_logits_aux", "forward_train", "init_random_",
           "make_decode_cache", "mamba_decode_step", "mamba_forward",
           "mamba_param_specs", "moe_ffn", "moe_param_specs", "moe_residual_param_specs",
           "moe_with_residual", "opt_state_from_jax", "param_specs", "params_from_jax",
           "prefill",
           "rwkv_channel_mix", "rwkv_channel_mix_step", "rwkv_param_specs",
           "rwkv_time_mix", "rwkv_time_mix_step", "state_bytes", "to_numpy_tree"]
