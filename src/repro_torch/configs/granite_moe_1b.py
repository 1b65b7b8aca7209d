"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
MoE 32e top-8, vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from ..models.model import ModelConfig
from ..models.moe import MoEConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", d_model=1024, n_layers=24, n_heads=16, n_kv_heads=8,
    d_head=64, d_ff=512, vocab_size=49155,
    ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, dispatch_chunks=4),
    rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="granite-moe-smoke", d_model=128, n_layers=3, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=96, vocab_size=512,
    ffn_pattern=("moe",), moe=MoEConfig(n_experts=8, top_k=4, d_expert=96),
)
SPEC = ArchSpec(arch_id="granite-moe-1b-a400m", model=CONFIG, smoke=SMOKE,
                source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
                train_microbatches=8,
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
