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

from . import stacks

TIERS = (0, 1, 2, 3)


def model_config(cfg: dict) -> ModelConfig:
    """The program's config for a configuration file, every field the
    file's layer stack gives (``nkb.stacks``)."""
    fields = dict(stacks.of(cfg).model_fields(cfg))
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    fields["compute_dtype"] = getattr(torch, fields["compute_dtype"])
    return ModelConfig(**fields)


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
