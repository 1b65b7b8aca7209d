"""The Jamba stack: the published Jamba block (jamba2-mini-16l and its smoke
size), periods of ``attn_layer_period`` layers, one attention block (no
positional encoding) at ``attn_layer_offset`` and Mamba mixers with their
dt/B/C norms elsewhere, a mixture of SwiGLU experts (top-k gates left
unnormalised, no token dropped) on the layers ``expert_layer_period`` and
``expert_layer_offset`` give and a dense SwiGLU on the others.  The hooks
are those ``nkb.stacks`` lists."""

from __future__ import annotations

import math

from nkb.roofline import BF16, PAGE_TOKENS
from reference import jamba as reference

F32 = 4
# The program's Mamba mixer (models/ssm.py) has these fixed, and dt_rank =
# hidden_size / 16; a configuration that states others is refused.
MAMBA = {"mamba_d_state": 16, "mamba_d_conv": 4, "mamba_expand": 2, "mamba_conv_bias": True,
         "mamba_proj_bias": False}


def _widths(cfg: dict):
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return (d, int(cfg["num_hidden_layers"]), h, int(cfg["num_key_value_heads"]),
            int(cfg.get("head_dim") or d // h), int(cfg["intermediate_size"]),
            int(cfg["vocab_size"]), int(cfg["num_experts"]), int(cfg["num_experts_per_tok"]))


def _mamba(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, dt_rank, d_state, d_conv), checked against the program's."""
    for key, value in MAMBA.items():
        if cfg[key] != value:
            raise ValueError(f"{cfg['name']}: {key} {cfg[key]!r}; the program's mixer has "
                             f"{value!r}")
    d = int(cfg["hidden_size"])
    if int(cfg["mamba_dt_rank"]) != d // 16:
        raise ValueError(f"{cfg['name']}: mamba_dt_rank {cfg['mamba_dt_rank']}; the program's "
                         f"is hidden_size / 16 = {d // 16}")
    return (int(cfg["mamba_expand"]) * d, int(cfg["mamba_dt_rank"]), int(cfg["mamba_d_state"]),
            int(cfg["mamba_d_conv"]))


def _period(cfg: dict) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """The blocks and FFNs of one period, as the reference's ``kinds`` gives
    each layer; the expert period divides the attention period."""
    p = int(cfg["attn_layer_period"])
    if p % int(cfg["expert_layer_period"]) or int(cfg["num_hidden_layers"]) % p:
        raise ValueError(f"{cfg['name']}: layers {cfg['num_hidden_layers']} / period {p} / "
                         f"expert period {cfg['expert_layer_period']}")
    blocks, ffns = zip(*(reference.kinds(cfg, i) for i in range(p)))
    return blocks, ffns


def model_fields(cfg: dict) -> dict:
    d, layers, h, kv, dh, ff, vocab, experts, top_k = _widths(cfg)
    _mamba(cfg)
    blocks, ffns = _period(cfg)
    cf = float(cfg["capacity_factor"])
    if cf != experts / top_k:
        raise ValueError(f"{cfg['name']}: capacity_factor {cf}; the published block drops no "
                         f"token, which takes num_experts / num_experts_per_tok")
    moe = dict(n_experts=experts, top_k=top_k, d_expert=ff, capacity_factor=cf,
               dispatch_chunks=int(cfg["dispatch_chunks"]), renormalize=False)
    return dict(name=cfg["name"], d_model=d, n_layers=layers, n_heads=h, n_kv_heads=kv,
                d_head=dh, d_ff=ff, vocab_size=vocab, block_pattern=blocks, ffn_pattern=ffns,
                moe=moe, norm_eps=float(cfg["rms_norm_eps"]), compute_dtype=cfg["dtype"],
                attn_rope=False, mamba_inner_norms=True)


# The moments of the mixer's own tensors (the others as nkb.weights says):
# a_log about log(1..16), the published initialisation's A = -(1..16); dt_bias
# about log(dt) for the published dt of 0.001-0.1 (log-uniform), so that dt =
# softplus(dt_proj(dt) + dt_bias) lies near 0.01 and exp(dt A) is a decay near 1;
# the conv's bias small; the skip D about its published 1.
A_LOG = (1.9, 0.75)
DT_BIAS = (-4.6, 1.33)
CONV_B = (0.0, 0.1)
NORM = (1.0, 0.1)


def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, float, float]]:
    d, layers, h, kv, dh, ff, v, experts, _ = _widths(cfg)
    di, rank, states, taps = _mamba(cfg)
    blocks, ffns = _period(cfg)
    n = layers // len(blocks)
    dt = cfg["dtype"]
    out = [("embed", (v, d), dt, 0.0, d ** -0.5),
           ("out_norm", (d,), "float32", *NORM),
           ("lm_head", (d, v), dt, 0.0, d ** -0.5)]
    for i, (blk, ffn) in enumerate(zip(blocks, ffns)):
        b, f = f"layers.b{i}.", f"layers.f{i}."
        out.append((b + "ln", (n, d), dt, *NORM))
        if blk == "attn":
            out += [(b + "wq", (n, d, h * dh), dt, 0.0, d ** -0.5),
                    (b + "wk", (n, d, kv * dh), dt, 0.0, d ** -0.5),
                    (b + "wv", (n, d, kv * dh), dt, 0.0, d ** -0.5),
                    (b + "wo", (n, h * dh, d), dt, 0.0, (h * dh) ** -0.5)]
        else:
            out += [(b + "in_proj", (n, d, 2 * di), dt, 0.0, d ** -0.5),
                    (b + "conv_w", (n, taps, di), dt, 0.0, taps ** -0.5),
                    (b + "conv_b", (n, di), dt, *CONV_B),
                    (b + "x_proj", (n, di, rank + 2 * states), dt, 0.0, di ** -0.5),
                    (b + "dt_proj", (n, rank, di), dt, 0.0, rank ** -0.5),
                    (b + "dt_bias", (n, di), dt, *DT_BIAS),
                    (b + "a_log", (n, di, states), dt, *A_LOG),
                    (b + "d_skip", (n, di), dt, *NORM),
                    (b + "out_proj", (n, di, d), dt, 0.0, di ** -0.5),
                    (b + "dt_norm", (n, rank), dt, *NORM),
                    (b + "b_norm", (n, states), dt, *NORM),
                    (b + "c_norm", (n, states), dt, *NORM)]
        out.append((f + "ln", (n, d), dt, *NORM))
        if ffn == "moe":
            out += [(f + "moe.router", (n, d, experts), dt, 0.0, d ** -0.5),
                    (f + "moe.w_gate", (n, experts, d, ff), dt, 0.0, d ** -0.5),
                    (f + "moe.w_up", (n, experts, d, ff), dt, 0.0, d ** -0.5),
                    (f + "moe.w_down", (n, experts, ff, d), dt, 0.0, ff ** -0.5)]
        else:
            out += [(f + "gate", (n, d, ff), dt, 0.0, d ** -0.5),
                    (f + "up", (n, d, ff), dt, 0.0, d ** -0.5),
                    (f + "down", (n, ff, d), dt, 0.0, ff ** -0.5)]
    return out


def decode_step_work(cfg: dict, positions: list[int]) -> tuple[float, float]:
    """For the active requests at ``positions``: every weight they use read
    once (for a MoE layer the router and the routed experts, at most all of
    them; the embedding's rows gathered), each lane's Mamba states read and
    written, its K/V rows of the attention layers read and the new row
    written; 2 operations a weight a token, 4·H·dh a (query, key) pair and 7
    a Mamba state element a token (exp(dt·A), dt·x·B, the update, the
    readout)."""
    n = len(positions)
    if n == 0:
        return 0.0, 0.0
    d, layers, h, kv, dh, ff, vocab, experts, top_k = _widths(cfg)
    di, rank, states, taps = _mamba(cfg)
    blocks, ffns = _period(cfg)
    periods = layers // len(blocks)
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    mixer = 2 * d * di + di * (rank + 2 * states) + rank * di + di * d   # the products
    # the conv's taps and bias, dt_bias, D, a_log and the three norms' scales
    mixer_small = (taps + 3) * di + di * states + rank + 2 * states
    expert = 3 * d * ff
    w_read = w_ops = state_bytes = 0
    for blk, ffn in zip(blocks, ffns):
        if blk == "attn":
            w_read += attn
            w_ops += attn
        else:
            w_read += mixer + mixer_small
            w_ops += mixer
            state_bytes += 2 * (di * states * F32 + (taps - 1) * di * BF16)   # read, written
        if ffn == "moe":
            w_read += d * experts + min(experts, top_k * n) * expert
            w_ops += d * experts + top_k * expert
        else:
            w_read += 3 * d * ff
            w_ops += 3 * d * ff
        w_read += 2 * d                                  # the block's and the FFN's norm
    attn_layers = periods * blocks.count("attn")
    mamba_layers = periods * blocks.count("mamba")
    keys = sum(p + 1 for p in positions)
    nbytes = periods * w_read * BF16 + d * vocab * BF16 + d * F32 \
        + n * periods * state_bytes \
        + attn_layers * 2 * kv * dh * BF16 * (keys + n) + n * d * BF16
    flops = 2.0 * n * (periods * w_ops + d * vocab) + 4.0 * attn_layers * h * dh * keys \
        + 7.0 * n * mamba_layers * di * states
    return float(nbytes), flops


def transfer_layout(cfg: dict, pos: int, pages_per_layer: int) -> tuple[dict, dict]:
    """The attention positions' ``k{i}``/``v{i}`` over every period, pages 0
    to the last valid one (the prompts are unique: no page is a hit); each
    Mamba position's ``ssm{i}`` (f32) and ``conv{i}`` state shipped whole."""
    d, layers, *_ = _widths(cfg)
    di, _, states, taps = _mamba(cfg)
    blocks, _ = _period(cfg)
    periods = layers // len(blocks)
    table = tuple(per * pages_per_layer + pg for per in range(periods)
                  for pg in range(math.ceil(pos / PAGE_TOKENS)))
    tables, whole = {}, {}
    for i, blk in enumerate(blocks):
        if blk == "attn":
            tables[f"k{i}"] = tables[f"v{i}"] = table
        else:
            whole[f"ssm{i}"] = periods * di * states * F32
            whole[f"conv{i}"] = periods * (taps - 1) * di * BF16
    return tables, whole
