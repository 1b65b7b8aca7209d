"""Weights and optimizer state across the two packages.

The caller turns the JAX arrays into NumPy arrays (``np.asarray`` on every
leaf); the port only ever sees NumPy.  The tree keeps the JAX layout:
``{"embed", "out_norm", "lm_head", "layers": {"b0": {...}, "f0": {...}, ...}}``
with a ``b{i}`` and, where the position has an FFN, an ``f{i}`` for each
position ``i`` of the period (no ``f{i}`` for RWKV; a MoE nests its experts
under ``f{i}.moe``), every leaf stacked over periods.  An encoder-decoder's
tree adds ``enc_layers`` ({"b0", "f0"}, stacked over the encoder's
periods), ``enc_norm`` and ``cross_layers`` ({"c{i}"} for each attention
position, stacked over the decoder's periods).  A parameter's dotted name in
the port (``layers.f1.moe.router``) is its path in that tree.

:func:`opt_state_from_jax` carries JAX's optimizer state across the same
way, and :func:`to_numpy_tree` turns the port's model and state back into a
NumPy tree with JAX's paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.build import resolve_device
from .model import Model, ModelConfig


def _leaf(tree, name: str):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


def _tensor(src) -> torch.Tensor:
    """A NumPy leaf as a tensor: a 2-byte void or ``ml_dtypes`` bfloat16
    array holds bf16 bits; anything else is read as it is."""
    src = np.asarray(src)
    if src.dtype.itemsize == 2 and src.dtype.kind == "V":
        return torch.from_numpy(src.copy(order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(src, dtype=np.float32 if src.dtype.kind == "f" else None))


@torch.no_grad()
def params_from_jax(tree, cfg: ModelConfig, *, device=None, dtype=None,
                    train_dtype=None) -> Model:
    """Build the port's :class:`Model` from a NumPy copy of the JAX params.

    ``dtype`` (default ``cfg.compute_dtype``) becomes the model's compute
    dtype: tensors of more than one dimension are stored in it, 1-D ones in
    f32, which are the values JAX computes with after its per-call cast.
    With ``train_dtype`` the model is a master copy to train, every
    parameter in that dtype (``Model``'s ``train_dtype``): f32 master
    parameters carry JAX's f32 values exactly."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = Model(cfg, device=device, train_dtype=train_dtype)
    params = dict(model.named_parameters())
    for name in model.specs:
        src = _tensor(_leaf(tree, name))
        dst = params[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)}, port {tuple(dst.shape)}")
        dst.copy_(src)
    return model


def nested(node) -> dict | None:
    """A tree node's children by path step, in JAX's flattening order
    (sorted keys): a :class:`Model` stands for its parameters by name, and
    a dotted key (``layers.b0.wq``) for the nested path.  None for a leaf."""
    if isinstance(node, Model):
        node = dict(node.named_parameters())
    if not isinstance(node, dict):
        return None
    out: dict = {}
    for key, value in node.items():
        parts = str(key).split(".")
        d = out
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = value
    return dict(sorted(out.items()))


def to_numpy_tree(tree):
    """The port's tree (a :class:`Model`, an optimizer state, or dicts of
    them) as a NumPy tree with JAX's paths: nested dicts, every leaf a NumPy
    array; a bf16 tensor's bits as a 2-byte void array, as ``np.asarray``
    holds a JAX bf16 leaf (view it as ``ml_dtypes.bfloat16`` to hand it to
    JAX)."""
    kids = nested(tree)
    if kids is not None:
        return {k: to_numpy_tree(v) for k, v in kids.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(tree)


def opt_state_from_jax(state, names, *, device=None) -> dict:
    """The port's optimizer state from a NumPy copy of JAX's: ``step`` as a
    0-d int32 tensor; ``m``/``v`` (AdamW) as dicts of f32 tensors by
    parameter name, and ``acc`` (Adafactor) as dicts of {"vr", "vc"} or
    {"v"} by name.  ``names``: the model's parameter names."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        return _tensor(leaf).to(dev)

    out = {}
    for key, sub in state.items():
        if key == "step":
            out[key] = torch.tensor(np.asarray(sub), dtype=torch.int32, device=dev)
        else:
            out[key] = {name: conv(_leaf(sub, name)) for name in names}
    return out

