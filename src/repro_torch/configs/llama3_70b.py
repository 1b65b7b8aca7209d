"""llama3-70b — the PAPER's evaluation model (§VI-A): 80L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.  KV = 320 KB/token aggregate (Eq. 1).
[arXiv:2407.21783; hf]"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="llama3-70b", d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
    d_head=128, d_ff=28672, vocab_size=128256, rope_theta=5e5, remat=True,
)
SMOKE = ModelConfig(
    name="llama3-70b-smoke", d_model=128, n_layers=4, n_heads=8, n_kv_heads=2,
    d_head=16, d_ff=256, vocab_size=512,
)
SPEC = ArchSpec(arch_id="llama3-70b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2407.21783; hf]",
                train_microbatches=16, serve_fsdp=True, decode_cache_shard="seq",
                skip_notes={"long_500k": "pure full attention: 500k decode skipped (DESIGN §4)"})
