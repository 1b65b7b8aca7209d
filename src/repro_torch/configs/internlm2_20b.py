"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA.  [arXiv:2403.17297; hf]"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="internlm2-20b", d_model=6144, n_layers=48, n_heads=48, n_kv_heads=8,
    d_head=128, d_ff=16384, vocab_size=92544, rope_theta=1e6, remat=True,
)
SMOKE = ModelConfig(
    name="internlm2-20b-smoke", d_model=128, n_layers=4, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=256, vocab_size=512,
)
SPEC = ArchSpec(arch_id="internlm2-20b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2403.17297; hf]",
                train_microbatches=8,
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
