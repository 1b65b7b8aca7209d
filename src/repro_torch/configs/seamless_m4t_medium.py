"""seamless-m4t-medium [audio]: enc-dec 12L+12L d_model=1024 16H (GQA kv=16)
d_ff=4096 vocab=256206 — multimodal; the audio front end is a stub: the
encoder takes precomputed frame embeddings.  [arXiv:2308.11596; hf]

Served through the model's entry points (``encode``, ``prefill`` with the
memory, ``decode_step``); the cluster refuses it, as the JAX cluster cannot
serve it (ROADMAP §3 item 7).
"""

from ..models.model import ModelConfig
from .base import ArchSpec

CONFIG = ModelConfig(
    name="seamless-m4t-medium", d_model=1024, n_layers=12, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=4096, vocab_size=256206,
    n_enc_layers=12, frontend="audio", rope_theta=1e4, remat=True,
)
SMOKE = ModelConfig(
    name="seamless-smoke", d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
    d_head=32, d_ff=256, vocab_size=512, n_enc_layers=2, frontend="audio",
)
SPEC = ArchSpec(arch_id="seamless-m4t-medium", model=CONFIG, smoke=SMOKE,
                source="[arXiv:2308.11596; hf]",
                train_microbatches=8,
                skip_notes={"long_500k": "encoder-decoder full attention: 500k decode skipped"})
