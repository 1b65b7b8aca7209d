"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual.  [hf:Snowflake/snowflake-arctic-base; hf]"""

from ..models.model import ModelConfig
from ..models.moe import MoEConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="arctic-480b", d_model=7168, n_layers=35, n_heads=56, n_kv_heads=8,
    d_head=128, d_ff=4864, vocab_size=32000,
    ffn_pattern=("moe_res",),
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864, dense_residual=True,
                  dispatch_chunks=16),
    rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="arctic-480b-smoke", d_model=128, n_layers=3, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=96, vocab_size=512,
    ffn_pattern=("moe_res",),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, dense_residual=True),
)
SPEC = ArchSpec(arch_id="arctic-480b", model=CONFIG, smoke=SMOKE,
                source="[hf:Snowflake/snowflake-arctic-base; hf]",
                train_microbatches=16, optimizer="adafactor",
                serve_fsdp=True, train_param_dtype="bfloat16",
                grad_accum_dtype="bfloat16",
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
