"""RWKV-6 (Finch) block of the port: data-dependent decay linear attention.

A port of ``repro/models/rwkv.py``.  Time mix with per-channel decay
``w_t = exp(-exp(w0 + lora(x)))`` and a rank-reduced ddlerp token shift;
channel-mix FFN.  Attention-free: the decode state is a (B, H, dh, dh) f32
WKV state and two (B, d) shift states per layer, whatever the prompt length.

The prefill recurrence, a ``lax.scan`` over time in the JAX package, is one
``ops.rwkv_scan`` call (the ``rwkv_scan`` CUDA kernel for tensors on the
card) on f32 r, k, v and w; training runs the plain scan, which autograd
differentiates as JAX differentiates its ``lax.scan``.  The decode step's
one-token state update stays plain PyTorch, as it is plain jnp in JAX.  The dtype points are JAX's: the
mixing and the projections run in the parameters' dtype (the model's
compute dtype), ``_decay`` goes to f32 before its double ``exp``, ``bonus_u``
is used in f32, and ``_group_norm`` runs in f32, multiplies by its scale and
is cast back by the caller.

The JAX functions' ``wkv0`` / ``shift0`` arguments (a starting state) are
left out: no caller in the JAX package passes them, so every prefill starts
from a zero state and a zero shift.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import InitSpec
from .sharding import local_region, merge_dims, split_dim

HEAD_DIM = 64
LORA_R = 32


def rwkv_param_specs(d_model: int, d_ff: int) -> dict[str, InitSpec]:
    """One layer's parameters, named and shaped as in the JAX package."""
    h = d_model // HEAD_DIM
    return {
        # time mix
        "mu_base": InitSpec((5, d_model)),            # r, k, v, w, g static lerp
        "mu_lora_a": InitSpec((d_model, LORA_R)),
        "mu_lora_b": InitSpec((LORA_R, 5 * d_model), scale=0.0, kind="zeros"),
        "w_r": InitSpec((d_model, d_model)),
        "w_k": InitSpec((d_model, d_model)),
        "w_v": InitSpec((d_model, d_model)),
        "w_g": InitSpec((d_model, d_model)),
        "w_o": InitSpec((d_model, d_model)),
        "decay_base": InitSpec((d_model,), kind="zeros"),
        "decay_lora_a": InitSpec((d_model, LORA_R)),
        "decay_lora_b": InitSpec((LORA_R, d_model), scale=0.0, kind="zeros"),
        "bonus_u": InitSpec((h, HEAD_DIM)),
        "ln_x": InitSpec((d_model,), kind="ones"),
        # channel mix
        "cm_mu": InitSpec((2, d_model)),
        "cm_k": InitSpec((d_model, d_ff)),
        "cm_v": InitSpec((d_ff, d_model)),
        "cm_r": InitSpec((d_model, d_model)),
    }


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) delayed one step, a zero row first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token shift: the five mixed streams (r, k, v, w, g),
    (..., 5, d)."""
    d = x.shape[-1]
    delta = x_prev - x
    lora = torch.tanh(delta @ p["mu_lora_a"])
    dyn = (lora @ p["mu_lora_b"]).reshape(*x.shape[:-1], 5, d)
    mix = p["mu_base"] + dyn
    return x[..., None, :] + delta[..., None, :] * mix


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), f32."""
    lora = torch.tanh(xw @ p["decay_lora_a"])
    w = p["decay_base"] + lora @ p["decay_lora_b"]
    return torch.exp(-torch.exp(w.float()))


def _group_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm of (..., H, dh) in f32, flattened to (..., d) and
    scaled (f32 out, as JAX promotes)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return merge_dims(xf * torch.rsqrt(var + 1e-5), -2) * scale.float()


def rwkv_time_mix(p: dict, x: torch.Tensor, scan=None):
    """x (B, S, d) -> (out (B, S, d), (wkv_state (B, H, dh, dh) f32, last_x
    (B, d))).  ``scan`` runs the recurrence: ``ops.rwkv_scan`` by default
    (K7 on the card, no backward), ``ref.rwkv_scan_ref`` to train."""
    h = x.shape[-1] // HEAD_DIM
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shifted(x)).unbind(dim=2)
    r, k, v = (split_dim(t @ p[n], -1, (h, HEAD_DIM))
               for t, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(xg @ p["w_g"])
    w = split_dim(_decay(p, xw), -1, (h, HEAD_DIM))
    rows = ("batch", None, None, None)
    scan = local_region(scan or ops.rwkv_scan, (rows,) * 4 + ((None, None),), (rows, rows),
                        shapes=_scan_shapes)
    y, final = scan(r.float(), k.float(), v.float(), w.contiguous(), p["bonus_u"].float())
    y = _group_norm(y, p["ln_x"]).to(x.dtype)
    return (y * g) @ p["w_o"], (final, x[:, -1])


def _scan_shapes(r, k, v, w, u):
    """The scan's stand-in on the meta device (the dry run's local shards
    hold shapes, no values; no kernel takes them): not the T steps but one
    elementwise step over every position, of the scan's output shapes and
    dtypes and reading every input (so the backward pass reaches each).
    The recurrence is elementwise, which operation counts leave out either
    way."""
    kv = k.float()[..., :, None] * v.float()[..., None, :]        # (B, T, H, dh, dh)
    u = u.float()[None, None, :, :, None]
    ys = (r.float()[..., None] * (w.float()[..., None] + u * kv)).sum(dim=-2)
    return ys.to(r.dtype), kv.sum(dim=1)


def rwkv_time_mix_step(p: dict, x: torch.Tensor, wkv: torch.Tensor,
                       x_prev: torch.Tensor):
    """One token: x (B, 1, d); wkv (B, H, dh, dh) f32; x_prev (B, d).
    Returns (out (B, 1, d), new wkv, x[:, 0])."""
    b, _, d = x.shape
    h = d // HEAD_DIM
    xr, xk, xv, xw, xg = _ddlerp(p, x[:, 0], x_prev).unbind(dim=1)
    r, k, v = (split_dim(t @ p[n], -1, (h, HEAD_DIM)).float()
               for t, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(xg @ p["w_g"])
    w = split_dim(_decay(p, xw), -1, (h, HEAD_DIM))
    u = p["bonus_u"].float()
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, wkv + u[None, :, :, None] * kv)
    new_wkv = wkv * w[..., None] + kv
    y = _group_norm(y, p["ln_x"]).to(x.dtype)
    return ((y * g) @ p["w_o"])[:, None, :], new_wkv, x[:, 0]


def _channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    delta = x_prev - x
    xk = x + delta * p["cm_mu"][0]
    xr = x + delta * p["cm_mu"][1]
    kk = torch.relu(xk @ p["cm_k"]).square()
    return torch.sigmoid(xr @ p["cm_r"]) * (kk @ p["cm_v"])


def rwkv_channel_mix(p: dict, x: torch.Tensor):
    """Channel-mix FFN with token shift over x (B, S, d); returns (out,
    last_x (B, d))."""
    return _channel_mix(p, x, _shifted(x)), x[:, -1]


def rwkv_channel_mix_step(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """One token: x (B, 1, d), x_prev (B, d); returns (out (B, 1, d), x[:, 0])."""
    return _channel_mix(p, x[:, 0], x_prev)[:, None, :], x[:, 0]
