"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]

NetKV arch-applicability note (DESIGN §4): the transferred decode state is
O(1) in sequence length (WKV + shift states), so Prop. 1's context-length
amplification does not apply; the scheduler still routes the state transfer.
"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="rwkv6-3b", d_model=2560, n_layers=32, n_heads=40, n_kv_heads=40,
    d_head=64, d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv",), ffn_pattern=("none",), remat=True,
)
SMOKE = ModelConfig(
    name="rwkv6-smoke", d_model=128, n_layers=3, n_heads=2, n_kv_heads=2,
    d_head=64, d_ff=256, vocab_size=512,
    block_pattern=("rwkv",), ffn_pattern=("none",),
)
SPEC = ArchSpec(arch_id="rwkv6-3b", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2404.05892; hf]",
                train_microbatches=4,
                shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"))
