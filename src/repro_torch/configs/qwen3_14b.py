"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="qwen3-14b", d_model=5120, n_layers=40, n_heads=40, n_kv_heads=8,
    d_head=128, d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6, remat=True,
)
SMOKE = ModelConfig(
    name="qwen3-14b-smoke", d_model=128, n_layers=4, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=256, vocab_size=512, qk_norm=True,
)
SPEC = ArchSpec(arch_id="qwen3-14b", model=CONFIG, smoke=SMOKE,
                source="[hf:Qwen/Qwen3-8B; hf]",
                train_microbatches=8,
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
