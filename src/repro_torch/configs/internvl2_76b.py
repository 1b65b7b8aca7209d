"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT front end (a stub: precomputed patch embeddings)
and an InternLM2-76B-class backbone.  [arXiv:2404.16821; unverified]

``prefill`` takes ``n_prefix_embeds`` patch embeddings in front of the
tokens; the cluster serves text only, as the JAX cluster does.
"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="internvl2-76b", d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
    d_head=128, d_ff=28672, vocab_size=128256,
    frontend="vision", n_prefix_embeds=256, rope_theta=1e6, remat=True,
)
SMOKE = ModelConfig(
    name="internvl2-smoke", d_model=128, n_layers=4, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=256, vocab_size=512, frontend="vision", n_prefix_embeds=8,
)
SPEC = ArchSpec(arch_id="internvl2-76b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2404.16821; unverified]",
                train_microbatches=16, serve_fsdp=True, decode_cache_shard="seq",
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
