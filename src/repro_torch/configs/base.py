"""ArchSpec: an architecture's full-width model, its smoke-scale twin, its
training knobs and the simulator's transfer-size model.

``repro/configs/base.py`` imports JAX at module level, so the port keeps this
small version of its own; the benchmark input shapes of the JAX spec and its
serving-sharding knobs belong to the dry run, which is not ported yet
(ROADMAP §1, sharding and launch).
"""

from __future__ import annotations

import dataclasses

from ..core.cost import ModelKVSpec
from ..models.model import ModelConfig, state_bytes


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    source: str
    train_microbatches: int = 16
    optimizer: str = "adamw"              # "adamw" | "adafactor"
    train_param_dtype: str = "float32"    # "bfloat16" for arctic's master copy
    grad_accum_dtype: str = "float32"     # "bfloat16" halves the accumulator

    def kv_spec(self) -> ModelKVSpec:
        """Simulator-side transfer-size model (Eq. 1 generalised)."""
        m = self.model
        return ModelKVSpec(
            name=self.arch_id,
            n_layers=m.n_layers,
            n_kv_heads=m.n_kv_heads,
            d_head=m.d_head,
            bytes_per_elem=2,
            n_attn_layers=m.n_attn_layers,
            fixed_state_bytes=state_bytes(m, 0),
            tp=4,
        )
