"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="smollm-135m", d_model=576, n_layers=30, n_heads=9, n_kv_heads=3,
    d_head=64, d_ff=1536, vocab_size=49152, rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="smollm-135m-smoke", d_model=96, n_layers=3, n_heads=3, n_kv_heads=3,
    d_head=32, d_ff=192, vocab_size=512,
)
SPEC = ArchSpec(arch_id="smollm-135m", model=CONFIG, smoke=SMOKE,
                source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
                train_microbatches=4,
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
