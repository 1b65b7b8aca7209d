"""Mamba (S6) block of the port, for the Jamba hybrid architecture.

A port of ``repro/models/ssm.py``: a selective state-space layer with an
input-dependent (Delta, B, C) and a diagonal state transition.  Prefill runs
the recurrence over time; decode makes one O(1) update.  The recurrent state
(B, d_inner, d_state) f32 and the conv tail (B, d_conv-1, d_inner) are the
decode state that NetKV transfers for a hybrid model's Mamba layers: unlike
KV it does not grow with the prompt.

The dtype points are JAX's: the projections, the conv and the skip run in
the parameters' dtype (the model's compute dtype), ``a_log`` is up-cast to
f32 where it is used, and the scan and its state are f32.  Prefill casts
dt and the conv output to f32 before it multiplies them; decode multiplies
``dt * conv`` in the compute dtype and casts the product, as JAX does.

The published Jamba mixer (AI21's ``JambaMambaMixer``) also normalises dt,
B and C after ``x_proj``, each by an RMSNorm with a learned scale
(``dt_norm``, ``b_norm``, ``c_norm``), before ``dt_proj``: the mixers take
``inner_norm_eps`` for such a layer (None, JAX's block, for none), in
prefill and decode alike.

The scan (a ``lax.scan`` in JAX, and a ``jax.checkpoint``-ed two-level one
for long prompts, which only saves training memory and sums in the same
order) is plain PyTorch here; the JAX package has no Pallas kernel for it.
What does not depend on the carried state, ``exp(dt * A)`` and
``dt * x * B``, is computed for a block of ``TIME_BLOCK`` steps at once, so
the loop over time issues one in-place multiply-add a step (out of place
where autograd records the steps, to train); the readout
``y_t = state_t . C_t`` runs once a block, summing over the state axis in
another order than JAX's per-step ``einsum`` (within f32 rounding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import InitSpec, rms_norm
from .sharding import local_region

D_STATE = 16
D_CONV = 4
# Steps whose exp(dt*A) and dt*x*B are held at once: at jamba's d_inner of
# 8192 each is a (256, B, 8192, 16) f32 tensor, 134 MB a row of the batch.
TIME_BLOCK = 256


def mamba_param_specs(d_model: int, inner_norms: bool = False) -> dict[str, InitSpec]:
    """One layer's parameters, named and shaped as in the JAX package; with
    ``inner_norms`` the scales of the dt, B and C norms too."""
    d_inner = 2 * d_model
    dt_rank = max(d_model // 16, 1)
    norms = {"dt_norm": InitSpec((dt_rank,), kind="ones"),
             "b_norm": InitSpec((D_STATE,), kind="ones"),
             "c_norm": InitSpec((D_STATE,), kind="ones")} if inner_norms else {}
    return {
        "in_proj": InitSpec((d_model, 2 * d_inner)),
        "conv_w": InitSpec((D_CONV, d_inner)),
        "conv_b": InitSpec((d_inner,), kind="zeros"),
        "x_proj": InitSpec((d_inner, dt_rank + 2 * D_STATE)),
        "dt_proj": InitSpec((dt_rank, d_inner)),
        "dt_bias": InitSpec((d_inner,), kind="zeros"),
        "a_log": InitSpec((d_inner, D_STATE), kind="ones"),
        "d_skip": InitSpec((d_inner,), kind="ones"),
        "out_proj": InitSpec((d_inner, d_model)),
        **norms,
    }


def _ssm_coeffs(params: dict, x_in: torch.Tensor, inner_norm_eps: float | None):
    """x_in (..., d_inner) -> (dt, B, C), the input-dependent coefficients;
    with ``inner_norm_eps`` dt (before ``dt_proj``), B and C each RMSNormed."""
    dt_rank = params["dt_proj"].shape[0]
    proj = x_in @ params["x_proj"]
    dt, bmat, cmat = torch.split(proj, [dt_rank, D_STATE, D_STATE], dim=-1)
    if inner_norm_eps is not None:
        dt = rms_norm(dt, params["dt_norm"], inner_norm_eps)
        bmat = rms_norm(bmat, params["b_norm"], inner_norm_eps)
        cmat = rms_norm(cmat, params["c_norm"], inner_norm_eps)
    dt = F.softplus(dt @ params["dt_proj"] + params["dt_bias"])
    return dt, bmat, cmat


def _conv(xc: torch.Tensor, conv_w: torch.Tensor, s: int) -> torch.Tensor:
    """The depthwise causal conv's taps over ``s`` steps of the padded xc,
    added left to right from zero, as JAX's ``sum`` does."""
    out = 0
    for i in range(D_CONV):
        out = out + xc[:, i:i + s] * conv_w[i]
    return out


def _a(params: dict) -> torch.Tensor:
    return -torch.exp(params["a_log"].float())        # (di, N) f32


def mamba_forward(params: dict, x: torch.Tensor,
                  inner_norm_eps: float | None = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d_model) -> (out (B, S, d_model), final state)."""
    b, s, _ = x.shape
    d_inner = params["conv_w"].shape[1]
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    pad = torch.zeros((b, D_CONV - 1, d_inner), dtype=x_in.dtype, device=x.device)
    xc = torch.cat([pad, x_in], dim=1)
    conv = F.silu(_conv(xc, params["conv_w"], s) + params["conv_b"])
    dt, bmat, cmat = _ssm_coeffs(params, conv, inner_norm_eps)   # (B,S,di), (B,S,N) x 2
    rows, di = ("batch", None, None), ("batch", None, "ff")
    y, state = local_region(_selective_scan, (di, di, rows, rows, ("ff", None)),
                            (di, ("batch", "ff", None)))(conv, dt, bmat, cmat, _a(params))
    y = y.to(x.dtype)
    y = y + conv * params["d_skip"]
    out = (y * F.silu(z)) @ params["out_proj"]
    return out, {"ssm": state.clone(), "conv": xc[:, -(D_CONV - 1):]}


def _selective_scan(conv, dt, bmat, cmat, a):
    """The S6 recurrence over (B, S): (y (B, S, di) f32, the final state
    (B, di, N) f32)."""
    b, s, d_inner = conv.shape
    # Time-major f32 copies: a step's slice of each block is contiguous.
    conv_t, dt_t, b_t, c_t = (t.transpose(0, 1).float() for t in (conv, dt, bmat, cmat))
    state = torch.zeros((b, d_inner, D_STATE), dtype=torch.float32, device=conv.device)
    ys = []
    for t0 in range(0, s, TIME_BLOCK):
        blk = slice(t0, min(t0 + TIME_BLOCK, s))
        da = torch.exp(dt_t[blk, ..., None] * a)                       # (T, B, di, N)
        # dt*x*B for each step; the loop turns it into that step's state.
        states = (dt_t[blk] * conv_t[blk])[..., None] * b_t[blk, :, None, :]
        if states.requires_grad:
            # Autograd saves each step's state, which the in-place form
            # would overwrite: the same multiply-adds, out of place.
            steps = []
            for state_t, da_t in zip(states.unbind(0), da.unbind(0)):
                state = torch.addcmul(state_t, state, da_t)
                steps.append(state)
            states = torch.stack(steps)
        else:
            for state_t, da_t in zip(states.unbind(0), da.unbind(0)):
                state = state_t.addcmul_(state, da_t)
        ys.append(torch.einsum("tbin,tbn->tbi", states, c_t[blk]))
        del da, states
    return torch.cat(ys).transpose(0, 1), state          # (B, S, di)


def mamba_decode_step(params: dict, x: torch.Tensor, state: dict,
                      inner_norm_eps: float | None = None) -> tuple[torch.Tensor, dict]:
    """x (B, 1, d_model); state {"ssm": (B, di, N) f32, "conv": (B, D_CONV-1,
    di)} -> (out (B, 1, d_model), new state)."""
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)          # (B, 1, di)
    xc = torch.cat([state["conv"], x_in], dim=1)               # (B, D_CONV, di)
    conv = F.silu(_conv(xc, params["conv_w"], 1)[:, 0] + params["conv_b"])   # (B, di)
    dt, bmat, cmat = _ssm_coeffs(params, conv, inner_norm_eps)
    da = torch.exp(dt.float()[..., None] * _a(params))
    new_ssm = state["ssm"] * da + (dt * conv).float()[..., None] * bmat.float()[:, None, :]
    y = torch.einsum("bin,bn->bi", new_ssm, cmat.float()).to(x.dtype)
    y = y + conv * params["d_skip"]
    out = ((y * F.silu(z[:, 0])) @ params["out_proj"])[:, None, :]
    return out, {"ssm": new_ssm, "conv": xc[:, 1:]}
