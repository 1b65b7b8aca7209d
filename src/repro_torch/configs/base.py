"""ArchSpec: an architecture's full-width model, its smoke-scale twin, its
training and serving knobs, the simulator's transfer-size model and the four
benchmark input shapes (``repro/configs/base.py``).

Shapes:
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> decode_step (KV cache at 32k)
  long_500k    seq 524,288 global_batch 1     -> decode_step; SSM/hybrid only

:meth:`ArchSpec.input_specs` gives every input of a shape's step as a tensor
on the meta device (shape and dtype, no storage), JAX's ShapeDtypeStructs;
the dry run (``launch/dryrun.py``) distributes them over its mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.cost import ModelKVSpec
from ..models.model import ModelConfig, make_decode_cache, state_bytes

SHAPES = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    source: str
    train_microbatches: int = 16
    optimizer: str = "adamw"              # "adamw" | "adafactor"
    train_param_dtype: str = "float32"    # "bfloat16" for arctic's master copy (dry run)
    grad_accum_dtype: str = "float32"     # "bfloat16" halves the accumulator (dry run)
    serve_fsdp: bool = False              # shard serving weights over data too
    decode_cache_shard: str = "seq"       # "seq" | "heads" (seq always divides the mesh)
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: dict[str, str] = dataclasses.field(default_factory=dict)

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

    def input_specs(self, shape_name: str) -> dict:
        """Meta tensors for every input of the shape's step: ``{"batch":
        {...}}`` to train, the prompt (and frames or prefix embeddings) to
        prefill, ``{"token", "cache"}`` to decode, the cache the port's
        :func:`make_decode_cache` on the meta device with ``pos`` a 0-d
        int32.  Raises KeyError for an unknown shape and ValueError for one
        this architecture skips."""
        if shape_name not in SHAPES:
            raise KeyError(shape_name)
        if shape_name not in self.shapes:
            raise ValueError(
                f"{self.arch_id} skips {shape_name}: "
                f"{self.skip_notes.get(shape_name, 'not applicable')}"
            )
        sh = SHAPES[shape_name]
        s, b = sh["seq_len"], sh["global_batch"]
        m = self.model
        bf16 = torch.bfloat16
        npfx = m.n_prefix_embeds
        if sh["kind"] == "train":
            if m.is_enc_dec:
                batch = {"frames": _meta(b, s, m.d_model, dtype=bf16),
                         "tokens": _meta(b, s), "labels": _meta(b, s)}
            elif m.frontend == "vision":
                batch = {"embeds": _meta(b, npfx, m.d_model, dtype=bf16),
                         "tokens": _meta(b, s - npfx), "labels": _meta(b, s - npfx)}
            else:
                batch = {"tokens": _meta(b, s), "labels": _meta(b, s)}
            return {"batch": batch}
        if sh["kind"] == "prefill":
            if m.is_enc_dec:
                return {"frames": _meta(b, s, m.d_model, dtype=bf16), "tokens": _meta(b, 256)}
            if m.frontend == "vision":
                return {"prefix_embeds": _meta(b, npfx, m.d_model, dtype=bf16),
                        "tokens": _meta(b, s - npfx)}
            return {"tokens": _meta(b, s)}
        cache = make_decode_cache(m, b, s, "meta", enc_len=s if m.is_enc_dec else 0)
        cache["pos"] = _meta()
        return {"token": _meta(b, 1), "cache": cache}

    def runnable_shapes(self) -> list[str]:
        return list(self.shapes)
