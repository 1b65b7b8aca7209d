"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="phi3-medium-14b", d_model=5120, n_layers=40, n_heads=40, n_kv_heads=10,
    d_head=128, d_ff=17920, vocab_size=100352, rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", d_model=128, n_layers=4, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=256, vocab_size=512,
)
SPEC = ArchSpec(arch_id="phi3-medium-14b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2404.14219; unverified]",
                train_microbatches=8,
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
