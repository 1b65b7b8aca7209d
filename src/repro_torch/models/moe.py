"""Mixture-of-Experts FFN with capacity-based dispatch (``repro/models/moe.py``).

Top-k routing with a per-expert token capacity ``cap = max(int(T * k / E *
cf), 1)``; a (token, k) slot past its expert's capacity is dropped (its
combine weight is zero).  At ``cf = E / k`` the capacity is T (exactly, for E
and k powers of two): no slot is dropped, the published Jamba block's full
capacity.  The k gates are the top-k softmax probabilities renormalised to
sum to 1 (granite's rule, and JAX's), or, with ``renormalize=False``, as they
are (Jamba's).  Slot positions come from a cumulative count over the
token-major ``(T*k)`` order, so a lower token index, then a lower k, wins a
slot.  Variants: plain top-k (granite) and MoE plus a parallel dense
FFN (arctic, ``moe_with_residual``).

Every op is deterministic on the card: no atomics.  Dispatch writes each
kept slot to its own row of the expert buffer and each dropped slot to a
spill row of its own, so no two writes share a row; the combine sums a
token's k terms one after another in the output dtype, the order (and, in
bf16, the rounding after each add) of the reference's scatter-add on the
CPU.

A decode step (one token a row, T within the rows K8 holds, E within
K9's) runs K9 (``kernels.ops.moe_route``: routing, slot positions, the aux
loss and the capacity rule in one launch) and K8 (``kernels.ops.moe_decode``)
in place of the routing chain, the dispatch, the ``bmm`` over all E experts
and the gather, at any capacity: K9 gives each dropped slot gate 0, so its
term is 0 as on the ``bmm`` path, and its positions are the token-major
ones, so the drop order stays the reference's.  K8 reads only the routed
experts' weights and rounds where the ``bmm`` path rounds.  Every prefill
(and dispatch chunk), training and mesh run keeps the ``bmm`` path
(:func:`decodes_routed`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.moe_decode import held_rows
from ..kernels.moe_route import routes
from ..kernels.ref import moe_aux_loss, route_ref as route
from .common import ConfigOptions, InitSpec, swiglu
from .sharding import current_mesh, merge_dims


@dataclasses.dataclass(frozen=True, eq=False)
class MoEConfig(ConfigOptions):
    n_experts: int
    top_k: int
    d_expert: int            # expert hidden size
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic-style parallel dense FFN
    dispatch_chunks: int = 1      # token-chunked dispatch (memory vs launch)
    # an option JAX's config lacks (``ConfigOptions``): False keeps the top-k
    # softmax probabilities as the gates, unnormalised
    renormalize: dataclasses.InitVar[bool] = True

    OPTIONS = ("renormalize",)

    def __post_init__(self, renormalize):
        self._keep(bool(renormalize))


def moe_param_specs(d_model: int, cfg: MoEConfig) -> dict[str, InitSpec]:
    e, f = cfg.n_experts, cfg.d_expert
    return {
        "router": InitSpec((d_model, e)),
        "w_gate": InitSpec((e, d_model, f)),
        "w_up": InitSpec((e, d_model, f)),
        "w_down": InitSpec((e, f, d_model)),
    }


def moe_residual_param_specs(d_model: int, d_ff: int, cfg: MoEConfig) -> dict[str, InitSpec]:
    specs = moe_param_specs(d_model, cfg)
    specs.update(
        res_gate=InitSpec((d_model, d_ff)),
        res_up=InitSpec((d_model, d_ff)),
        res_down=InitSpec((d_ff, d_model)),
    )
    return specs


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).

    aux_loss is the load-balancing loss (mean_e f_e * p_e * E), f32.  With
    ``dispatch_chunks`` nc > 1 and S divisible by nc, the tokens are
    dispatched in nc chunks along S, each with its own capacity, and
    aux_loss is the chunks' mean."""
    b, s, d = x.shape
    nc = cfg.dispatch_chunks
    if nc > 1 and s % nc == 0:
        parts = [_moe_ffn_once(xi, params, cfg, False) for xi in x.split(s // nc, dim=1)]
        return (torch.cat([o for o, _ in parts], dim=1),
                torch.stack([a for _, a in parts]).mean())
    return _moe_ffn_once(x, params, cfg, decodes_routed(x, params, cfg))


def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots an expert keeps of a dispatch group of ``t`` tokens."""
    return max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def slot_positions(experts: torch.Tensor, n_experts: int):
    """(pos, counts): each (token, k) slot's position in its expert's
    buffer, the count of earlier slots of the token-major flat order with
    its expert, and each expert's count of slots."""
    flat = experts.reshape(-1)
    # (E, T*k): the count runs along the last dimension, where the card's
    # scan is parallel (along the first it is one thread a column).
    onehot = (torch.arange(n_experts, device=flat.device)[:, None] == flat).int()
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return before.gather(0, flat[None, :])[0], onehot.sum(dim=1)


def decodes_routed(x: torch.Tensor, params: dict, cfg: MoEConfig) -> bool:
    """Whether :func:`moe_ffn` takes K9 and K8 for its input x (B, S, d): a
    decode-shaped input (S = 1; a prefill's dispatch chunk is no decode) of
    T = B tokens within the rows K8 holds at width d, E and k that K9 takes,
    plain tensors on the card or the CPU outside mesh rules, and no gradient
    wanted (neither kernel has a backward).  Slots may drop: K9 gives a
    dropped slot gate 0, and with a token's k experts distinct no expert
    gets more than T slots, which K8 holds."""
    b, s, d = x.shape
    leaves = (x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    return (s == 1 and b <= held_rows(d, x.dtype) and routes(cfg.n_experts, cfg.top_k)
            and current_mesh() is None
            and all(t.device.type in ("cpu", "cuda") for t in leaves)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)))


def _moe_ffn_once(x: torch.Tensor, params: dict, cfg: MoEConfig,
                  routed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One dispatch group: K9 and K8 where ``routed`` (:func:`decodes_routed`),
    else the routing, the capacity dispatch and the bmm over every expert."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    xf = x.reshape(t, d)
    if routed:
        experts, gates_kept, aux = ops.moe_route(xf, params["router"], k, cap, cfg.renormalize)
        out = ops.moe_decode(xf, experts, gates_kept, params["w_gate"], params["w_up"],
                             params["w_down"])
        return out.reshape(b, s, d), aux
    probs, gates, experts = route(xf, params["router"], k, cfg.renormalize)
    pos, counts = slot_positions(experts, e)
    aux = moe_aux_loss(counts, probs, k)
    out = dispatch_bmm(xf, experts, gates, pos, cap, params)
    return out.reshape(b, s, d), aux


def dispatch_bmm(xf: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
                 pos: torch.Tensor, cap: int, params: dict) -> torch.Tensor:
    """The capacity dispatch: xf (T, d) routed to ``experts`` (T, k) with
    ``gates``, each slot at its position ``pos`` in its expert's buffer of
    ``cap`` rows (a slot at or past ``cap`` dropped), the ``bmm`` over all E
    experts' buffers, and the gated combine -> (T, d)."""
    t, d = xf.shape
    k = experts.shape[1]
    e = params["w_gate"].shape[0]
    flat_e = experts.reshape(-1)
    keep = pos < cap
    gate_kept = torch.where(keep, gates.reshape(-1), 0.0)
    # Kept slot j goes to row flat_e*cap + pos of the (E*cap) expert rows,
    # a dropped one to spill row E*cap + j: every row is written once.
    n = t * k
    flat_idx = torch.arange(n, device=xf.device)
    kept_row = flat_e * cap + pos
    buf = xf.new_zeros((e * cap + n, d))
    buf[torch.where(keep, kept_row, e * cap + flat_idx)] = xf[flat_idx // k]
    h = buf[:e * cap].view(e, cap, d)

    # Expert computation over the stacked expert weights.
    h = F.silu(torch.bmm(h, params["w_gate"])) * torch.bmm(h, params["w_up"])
    y = merge_dims(torch.bmm(h, params["w_down"]), 0, 1)

    # Gather back (a dropped slot reads the zero row) and combine with the
    # gates, a token's k terms summed in order in x's dtype.
    y = torch.cat([y, y.new_zeros((1, d))])
    picked = y[torch.where(keep, kept_row, e * cap)]
    terms = (picked * gate_kept[:, None].to(xf.dtype)).view(t, k, d)
    out = xf.new_zeros((t, d))
    for j in range(k):
        out = out + terms[:, j]
    return out


def moe_with_residual(x: torch.Tensor, params: dict,
                      cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Arctic: dense FFN residual branch in parallel with the MoE."""
    moe_out, aux = moe_ffn(x, params, cfg)
    dense = swiglu(x, params["res_gate"], params["res_up"], params["res_down"])
    return moe_out + dense, aux
