"""The system under test, built from the benchmark's files: the port's
``DisaggregatedCluster`` serving a model whose weights the benchmark drew.

This is the only module of the harness that imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, ModelConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.serving import DisaggregatedCluster, ServeRequest
from repro_torch.serving import cluster as cluster_module  # noqa: F401 (the spans wrap its names)
from repro_torch.serving import engine as engine_module  # noqa: F401 (the spans wrap its names)

TIERS = (0, 1, 2, 3)


def model_config(cfg: dict) -> ModelConfig:
    """The program's config for a configuration file, every number taken
    from the file."""
    moe = None
    ffn = ("dense",)
    if cfg.get("num_local_experts"):
        moe = MoEConfig(n_experts=int(cfg["num_local_experts"]),
                        top_k=int(cfg["num_experts_per_tok"]),
                        d_expert=int(cfg["intermediate_size"]),
                        capacity_factor=float(cfg["capacity_factor"]),
                        dispatch_chunks=int(cfg["dispatch_chunks"]))
        ffn = ("moe",)
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return ModelConfig(
        name=cfg["name"], d_model=d, n_layers=int(cfg["num_hidden_layers"]), n_heads=h,
        n_kv_heads=int(cfg["num_key_value_heads"]), d_head=int(cfg.get("head_dim") or d // h),
        d_ff=int(cfg["intermediate_size"]), vocab_size=int(cfg["vocab_size"]),
        ffn_pattern=ffn, moe=moe, rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]), compute_dtype=getattr(torch, cfg["dtype"]))


def model_with(mcfg: ModelConfig, weights: dict) -> Model:
    """The program's model holding the benchmark's tensors (no copy): built
    on the meta device, then each parameter assigned."""
    model = Model(mcfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def cluster(mcfg: ModelConfig, model: Model, deploy: dict, seed: int,
            device: torch.device) -> DisaggregatedCluster:
    return DisaggregatedCluster(
        mcfg, scheduler=deploy["scheduler"], n_prefill=int(deploy["n_prefill"]),
        n_decode=int(deploy["n_decode"]), n_slots=int(deploy["n_slots"]),
        cache_len=int(deploy["cache_len"]), seed=seed, background=float(deploy["background"]),
        params=model, device=device)


def serve(c: DisaggregatedCluster, batch: list[tuple[int, np.ndarray, int, float]]) -> None:
    """Hand ``(request_id, prompt, max_new, due_s)`` requests to one
    ``serve()`` call; its results are read from the spans, not from here
    (``ServeResult.ttft`` is a simulated clock)."""
    c.serve([ServeRequest(rid, prompt, max_new, arrival=due) for rid, prompt, max_new, due
             in batch])


def free_of(c: DisaggregatedCluster) -> None:
    """Drop the cluster's device state (caches, engines), keeping nothing of
    it alive from here."""
    for eng in c.decode:
        eng.cache.clear()
    c.decode.clear()
    c.prefill.clear()
