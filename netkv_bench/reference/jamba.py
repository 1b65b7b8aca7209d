"""A plain float32 forward of the published Jamba block (Jamba v0.1, Jamba
1.5 Mini and Jamba2 Mini share it), from the benchmark's own tensors
(``nkb.weights``), layer by layer.

The equations are those of ``transformers/models/jamba/modeling_jamba.py``
(transformers 4.57.6): layer ``l`` is attention where ``l % attn_layer_period
== attn_layer_offset`` and a Mamba mixer elsewhere; its FFN is a mixture of
SwiGLU experts where ``l % expert_layer_period == expert_layer_offset`` and a
dense SwiGLU elsewhere; each block and each FFN is RMSNormed first and adds
to the residual.

* Mamba (``JambaMambaMixer.slow_forward``): ``x, z`` from ``in_proj``; a
  causal depthwise conv of ``mamba_d_conv`` taps with its bias, then SiLU;
  ``dt, B, C`` from ``x_proj``, each RMSNormed with its own scale
  (``dt_norm``, ``b_norm``, ``c_norm``); ``dt = softplus(dt_proj(dt) +
  dt_bias)``, ``A = -exp(a_log)``; the selective scan, one step after
  another, ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t``, ``y_t = s_t . C_t``;
  then ``y + D x``, gated by ``SiLU(z)``, and ``out_proj``.
* Attention: grouped-query (query head h reads KV head h // (H/KV)), a
  causal softmax, no positional encoding.
* MoE (``JambaSparseMoeBlock``): a softmax over the router's logits, the
  top-k probabilities kept as the gates without renormalising, every token
  computed by its experts (no capacity, no drop).

The layouts are the program's parameter tree, which the benchmark draws:
``layers.b{i}.*`` / ``layers.f{i}.*`` stacked over periods of
``attn_layer_period`` layers, so layer ``l`` is period ``l // period``,
position ``l % period``; weights applied as ``x @ W``; ``conv_w`` (taps,
d_inner), tap j multiplying the input j - (taps - 1) steps back.  Every
product runs in float32 with TF32 off (``reference.model.set_exact``).  The
bf16 weights are up-cast one layer at a time, a MoE layer one expert at a
time, so the forward fits beside the served model.  ``fp8=True`` is the
control of ``reference.model``: every product's operands rounded to fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.model import _mm, attention, rms_norm

TIME_BLOCK = 256     # scan steps whose exp(dt A) and dt x B are held at once


def kinds(cfg: dict, layer: int) -> tuple[str, str]:
    """(block, FFN) of ``layer``: ("attn" or "mamba", "moe" or "dense")."""
    attn = layer % int(cfg["attn_layer_period"]) == int(cfg["attn_layer_offset"])
    moe = layer % int(cfg["expert_layer_period"]) == int(cfg["expert_layer_offset"])
    return ("attn" if attn else "mamba"), ("moe" if moe else "dense")


def _tensors(weights: dict, cfg: dict, layer: int, part: str) -> dict:
    """Layer ``layer``'s tensors of ``part`` ("b" block, "f" FFN) up-cast
    to float32, the experts left as stored (``moe``)."""
    per, i = divmod(layer, int(cfg["attn_layer_period"]))
    pre = f"layers.{part}{i}."
    out = {}
    for name, t in weights.items():
        if name.startswith(pre):
            key = name[len(pre):].replace("moe.", "")
            out[key] = t[per] if key.startswith("w_") else t[per].float()
    return out


def selective_scan(x, dt, bmat, cmat, a):
    """The recurrence over (N, T) padded sequences, one step at a time:
    ``y`` (N, T, d_inner)."""
    n, t, di = x.shape
    state = torch.zeros((n, di, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = torch.empty_like(x)
    for t0 in range(0, t, TIME_BLOCK):
        blk = slice(t0, min(t, t0 + TIME_BLOCK))
        da = torch.exp(dt[:, blk, :, None] * a)                    # (N, Tb, di, S)
        dbx = (dt[:, blk] * x[:, blk])[..., None] * bmat[:, blk, None, :]
        for s in range(da.shape[1]):
            state = da[:, s] * state + dbx[:, s]
            ys[:, t0 + s] = torch.einsum("nds,ns->nd", state, cmat[:, t0 + s])
        del da, dbx
    return ys


def mamba(hs: list, w: dict, cfg: dict, fp8: bool) -> list:
    """The Mamba mixer of each normed sequence (T_n, d); the scan runs over
    them all at once, padded to the longest (padding lies after every real
    step, so no real output reads it)."""
    taps, rank = int(cfg["mamba_d_conv"]), int(cfg["mamba_dt_rank"])
    states = int(cfg["mamba_d_state"])
    eps = float(cfg["rms_norm_eps"])
    parts = []
    for h in hs:
        t = h.shape[0]
        x, z = _mm(h, w["in_proj"], fp8).chunk(2, dim=-1)
        xp = torch.cat([x.new_zeros((taps - 1, x.shape[1])), x])
        conv = sum(xp[j:j + t] * w["conv_w"][j] for j in range(taps)) + w["conv_b"]
        x = F.silu(conv)
        dt, bmat, cmat = _mm(x, w["x_proj"], fp8).split([rank, states, states], dim=-1)
        dt = rms_norm(dt, w["dt_norm"], eps)
        bmat = rms_norm(bmat, w["b_norm"], eps)
        cmat = rms_norm(cmat, w["c_norm"], eps)
        dt = F.softplus(_mm(dt, w["dt_proj"], fp8) + w["dt_bias"])
        parts.append((x, z, dt, bmat, cmat))
    longest = max(p[0].shape[0] for p in parts)

    def padded(k):
        return torch.stack([F.pad(p[k], (0, 0, 0, longest - p[k].shape[0])) for p in parts])

    ys = selective_scan(padded(0), padded(2), padded(3), padded(4), -torch.exp(w["a_log"]))
    out = []
    for (x, z, *_), y in zip(parts, ys):
        y = (y[:x.shape[0]] + x * w["d_skip"]) * F.silu(z)
        out.append(_mm(y, w["out_proj"], fp8))
    return out


def moe(h, w: dict, cfg: dict, fp8: bool, margins: list | None = None) -> torch.Tensor:
    """Top-k experts of every token of h (T, d), the gates the top-k softmax
    probabilities as they are; each expert's weights up-cast in turn.
    ``margins``, where given, gets each token's router margin at the top-k
    edge: the k-th largest probability less the (k+1)-th."""
    e, k = int(cfg["num_experts"]), int(cfg["num_experts_per_tok"])
    probs = torch.softmax(_mm(h, w["router"], fp8), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append(gates[:, k - 1] - gates[:, k])
    gates, experts = gates[:, :k], experts[:, :k]
    out = torch.zeros_like(h)
    for x in range(e):
        tok, j = torch.nonzero(experts == x, as_tuple=True)
        if tok.numel() == 0:
            continue
        hx = h[tok]
        gate, up, down = (w[n][x].float() for n in ("w_gate", "w_up", "w_down"))
        y = F.silu(_mm(hx, gate, fp8)) * _mm(hx, up, fp8)
        out.index_add_(0, tok, _mm(y, down, fp8) * gates[tok, j][:, None])
    return out


@torch.no_grad()
def served_logits(weights: dict, cfg: dict, seqs: list[tuple[torch.Tensor, int]], *,
                  fp8: bool = False, margins: list | None = None) -> list[torch.Tensor]:
    """For each (tokens (T,), n_prompt): float32 logits (T - n_prompt + 1, V)
    of positions n_prompt-1 .. T-1, each predicting the token after it, as
    ``reference.model.served_logits`` gives them.  All sequences go through
    each layer before the next is up-cast.  ``margins``, an empty list where
    given, gets for each sequence the smallest router margin over the MoE
    layers (``moe``) at each of those positions."""
    h, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = int(cfg["hidden_size"])
    dh = int(cfg.get("head_dim") or d // h)
    eps = float(cfg["rms_norm_eps"])
    xs = [weights["embed"][tok].float() for tok, _ in seqs]
    lens = [x.shape[0] for x in xs]
    for layer in range(int(cfg["num_hidden_layers"])):
        block, ffn = kinds(cfg, layer)
        w = _tensors(weights, cfg, layer, "b")
        normed = [rms_norm(x, w["ln"], eps) for x in xs]
        if block == "attn":
            outs = []
            for a in normed:
                t = a.shape[0]
                q = _mm(a, w["wq"], fp8).view(t, h, dh)
                k = _mm(a, w["wk"], fp8).view(t, kv, dh)
                v = _mm(a, w["wv"], fp8).view(t, kv, dh)
                outs.append(_mm(attention(q, k, v), w["wo"], fp8))
        else:
            outs = mamba(normed, w, cfg, fp8)
        xs = [x + o for x, o in zip(xs, outs)]
        w = _tensors(weights, cfg, layer, "f")
        a = rms_norm(torch.cat(xs), w["ln"], eps)
        if ffn == "moe":
            edge = [] if margins is not None else None
            out = moe(a, w, cfg, fp8, edge)
            if edge:
                for n, (m, (_, n_prompt)) in enumerate(zip(edge[0].split(lens), seqs)):
                    m = m[n_prompt - 1:]
                    if len(margins) <= n:
                        margins.append(m)
                    else:
                        margins[n] = torch.minimum(margins[n], m)
        else:
            out = _mm(F.silu(_mm(a, w["gate"], fp8)) * _mm(a, w["up"], fp8), w["down"], fp8)
        xs = [x + o for x, o in zip(xs, out.split(lens))]
        del w
    head = weights["lm_head"].float()
    return [_mm(rms_norm(x[n_prompt - 1:], weights["out_norm"], eps), head, fp8)
            for x, (_, n_prompt) in zip(xs, seqs)]
