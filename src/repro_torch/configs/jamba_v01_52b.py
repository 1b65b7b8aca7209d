"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every 2nd layer.
[arXiv:2403.19887; hf]

Period of 8 layers: attention at position 4 (rest Mamba); MoE on odd
positions (e:2 spacing), dense FFN elsewhere; Mamba layers carry no extra
FFN at even positions per the published block diagram simplification.

Per request the transfer carries KV pages for the attention layers (which a
prefix hit shortens) and, whole, each Mamba layer's SSM and conv state.

``CONFIG`` and ``SMOKE`` are the JAX package's block; :func:`published` turns
either into the block AI21 publishes (``modeling_jamba.py``), which Jamba
v0.1, Jamba 1.5 Mini and Jamba2 Mini share.
"""

import dataclasses

from ..models.model import ModelConfig
from ..models.moe import MoEConfig
from .base import ArchSpec

_BLOCKS = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")
_FFN = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=14336, vocab_size=65536,
    block_pattern=_BLOCKS, ffn_pattern=_FFN,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, dispatch_chunks=8),
    rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="jamba-52b-smoke", d_model=128, n_layers=8, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=256, vocab_size=512,
    block_pattern=_BLOCKS, ffn_pattern=_FFN,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=256),
)
SPEC = ArchSpec(arch_id="jamba-v0.1-52b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2403.19887; hf]",
                train_microbatches=16, optimizer="adafactor",
                shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"))


def published(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with the published block's four mechanisms, which JAX's
    block lacks: attention with no positional encoding, RMSNorms of dt, B
    and C inside every Mamba mixer, the top-k gates left unnormalised, and
    no token dropped (``capacity_factor`` = E / k makes every expert's
    capacity the whole dispatch group)."""
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k,
                              renormalize=False)
    return dataclasses.replace(cfg, attn_rope=False, mamba_inner_norms=True, moe=moe)
