"""The decoder stack: every layer attention with RoPE, then one FFN, dense
SwiGLU or a top-k mixture of SwiGLU experts (internlm2-20b, granite-moe and
their smoke sizes).  The hooks are those ``nkb.stacks`` lists."""

from __future__ import annotations

import math

from nkb.roofline import BF16, PAGE_TOKENS
from reference import model as reference  # noqa: F401 (the stack's reference)


def _widths(cfg: dict):
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return (d, int(cfg["num_hidden_layers"]), h, int(cfg["num_key_value_heads"]),
            int(cfg.get("head_dim") or d // h), int(cfg["intermediate_size"]),
            int(cfg["vocab_size"]), int(cfg.get("num_local_experts") or 0),
            int(cfg.get("num_experts_per_tok") or 0))


def model_fields(cfg: dict) -> dict:
    d, layers, h, kv, dh, ff, vocab, experts, top_k = _widths(cfg)
    moe = None
    if experts:
        moe = dict(n_experts=experts, top_k=top_k, d_expert=ff,
                   capacity_factor=float(cfg["capacity_factor"]),
                   dispatch_chunks=int(cfg["dispatch_chunks"]))
    return dict(name=cfg["name"], d_model=d, n_layers=layers, n_heads=h, n_kv_heads=kv,
                d_head=dh, d_ff=ff, vocab_size=vocab, block_pattern=("attn",),
                ffn_pattern=("moe",) if experts else ("dense",), moe=moe,
                rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]),
                compute_dtype=cfg["dtype"])


def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, float, float]]:
    """A tied output head is not drawn: ``lm_head`` is the embedding's
    transpose (``nkb.weights``)."""
    d, L, h, kv, dh, ff, v, experts, _ = _widths(cfg)
    dt = cfg["dtype"]
    norm = (1.0, 0.1)
    out = [("embed", (v, d), dt, 0.0, d ** -0.5),
           ("out_norm", (d,), "float32", *norm)]
    if not cfg.get("tie_word_embeddings"):
        out.append(("lm_head", (d, v), dt, 0.0, d ** -0.5))
    out += [("layers.b0.ln", (L, d), dt, *norm),
            ("layers.b0.wq", (L, d, h * dh), dt, 0.0, d ** -0.5),
            ("layers.b0.wk", (L, d, kv * dh), dt, 0.0, d ** -0.5),
            ("layers.b0.wv", (L, d, kv * dh), dt, 0.0, d ** -0.5),
            ("layers.b0.wo", (L, h * dh, d), dt, 0.0, (h * dh) ** -0.5),
            ("layers.f0.ln", (L, d), dt, *norm)]
    if experts:
        e = experts
        out += [("layers.f0.moe.router", (L, d, e), dt, 0.0, d ** -0.5),
                ("layers.f0.moe.w_gate", (L, e, d, ff), dt, 0.0, d ** -0.5),
                ("layers.f0.moe.w_up", (L, e, d, ff), dt, 0.0, d ** -0.5),
                ("layers.f0.moe.w_down", (L, e, ff, d), dt, 0.0, ff ** -0.5)]
    else:
        out += [("layers.f0.gate", (L, d, ff), dt, 0.0, d ** -0.5),
                ("layers.f0.up", (L, d, ff), dt, 0.0, d ** -0.5),
                ("layers.f0.down", (L, ff, d), dt, 0.0, ff ** -0.5)]
    return out


def decode_step_work(cfg: dict, positions: list[int]) -> tuple[float, float]:
    """Every weight the active requests use read once (for a MoE, the router
    and the routed experts, at most all of them), their own K/V rows read and
    the new row written, the embedding rows gathered; 2 operations a weight a
    token and 4·H·dh a (query, key) pair."""
    n = len(positions)
    if n == 0:
        return 0.0, 0.0
    d, layers, h, kv, dh, ff, vocab, experts, top_k = _widths(cfg)
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    expert = 3 * d * ff
    if experts:
        ffn_bytes = (d * experts + min(experts, top_k * n) * expert) * BF16
        ffn_per_token = d * experts + top_k * expert
    else:
        ffn_bytes = 3 * d * ff * BF16
        ffn_per_token = 3 * d * ff
    norms = 2 * d * BF16                          # a layer's two norm scales
    weights = layers * (attn * BF16 + ffn_bytes + norms) \
        + d * vocab * BF16 + d * 4                # lm_head, the final norm in f32
    keys = sum(p + 1 for p in positions)
    kv_bytes = layers * 2 * kv * dh * BF16 * (keys + n)
    embed = n * d * BF16
    flops = 2.0 * n * (layers * (attn + ffn_per_token) + d * vocab) \
        + 4.0 * layers * h * dh * keys
    return float(weights + kv_bytes + embed), flops


def transfer_layout(cfg: dict, pos: int, pages_per_layer: int) -> tuple[dict, dict]:
    """``k0`` and ``v0`` over every layer, pages 0 to the last valid one (the
    prompts are unique: no page is a hit); nothing shipped whole."""
    layers = int(cfg["num_hidden_layers"])
    table = tuple(per * pages_per_layer + pg for per in range(layers)
                  for pg in range(math.ceil(pos / PAGE_TOKENS)))
    return {"k0": table, "v0": table}, {}
