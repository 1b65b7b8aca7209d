"""Weights from the JAX package's parameter tree.

The caller turns the JAX arrays into NumPy arrays (``np.asarray`` on every
leaf); the port only ever sees NumPy.  The tree keeps the JAX layout:
``{"embed", "out_norm", "lm_head", "layers": {"b0": {...}, "f0": {...}, ...}}``
with a ``b{i}`` and, where the position has an FFN, an ``f{i}`` for each
position ``i`` of the period (no ``f{i}`` for RWKV; a MoE nests its experts
under ``f{i}.moe``), every leaf stacked over periods.  An encoder-decoder's
tree adds ``enc_layers`` ({"b0", "f0"}, stacked over the encoder's
periods), ``enc_norm`` and ``cross_layers`` ({"c{i}"} for each attention
position, stacked over the decoder's periods).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import Model, ModelConfig


def _leaf(tree, name: str):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


@torch.no_grad()
def params_from_jax(tree, cfg: ModelConfig, *, device=None, dtype=None) -> Model:
    """Build the port's :class:`Model` from a NumPy copy of the JAX params.

    ``dtype`` (default ``cfg.compute_dtype``) becomes the model's compute
    dtype: tensors of more than one dimension are stored in it, 1-D ones in
    f32, which are the values JAX computes with after its per-call cast."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = Model(cfg, device=device)
    params = dict(model.named_parameters())
    for name in model.specs:
        src = np.asarray(_leaf(tree, name))
        dst = params[name]
        if src.shape != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {src.shape}, port {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return model
