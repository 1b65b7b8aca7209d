"""A plain float32 forward of the served decoder models, from the
benchmark's own tensors (``nkb.weights``), layer by layer.

The block is the published one: RMSNorm, grouped-query attention with
rotary embeddings over split halves (query head h reads KV head h // (H/KV)),
a causal softmax, a SwiGLU FFN or a top-k mixture of SwiGLU experts whose
k gates are the renormalised softmax probabilities, a final RMSNorm and the
output head.  The one departure the configuration states is reproduced: the
router's capacity rule (see ``moe``).  Every product runs in float32 with
TF32 off; the bf16 weights are up-cast one layer at a time, so the forward
fits beside the served model.

``fp8=True`` is the control: every product's operands rounded to fp8 (e4m3;
weights per output column, activations per row, each scaled by its largest
magnitude), the next precision below the served bf16.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def set_exact() -> None:
    """Float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32; with ``fp8`` both rounded first."""
    if fp8:
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, dh) at positions 0..T-1; angles in float64."""
    t, _, dh = x.shape
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 512) -> torch.Tensor:
    """Causal attention of q (T, H, dh) over k, v (T, KV, dh): (T, H*dh)."""
    t, h, dh = q.shape
    kv = k.shape[1]
    qg = q.view(t, kv, h // kv, dh)
    out = torch.empty((t, h * dh), dtype=torch.float32, device=q.device)
    idx = torch.arange(t, device=q.device)
    for a in range(0, t, block):
        b = min(t, a + block)
        s = torch.einsum("qkgd,skd->kgqs", qg[a:b], k[:b]) * dh ** -0.5
        s = s.masked_fill(idx[None, None, a:b, None] < idx[None, None, None, :b], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqs,skd->qkgd", p, v[:b]).reshape(b - a, h * dh)
    return out


def dispatch_groups(n_prompt: int, total: int, chunks: int) -> list[tuple[int, int]]:
    """The (start, end) token groups a capacity is counted over: the prompt
    as the prefill dispatches it (``chunks`` equal groups where its length
    divides, else one), then every later token alone, as each decode step
    carries one token of a request."""
    if chunks > 1 and n_prompt % chunks == 0:
        step = n_prompt // chunks
        groups = [(a, a + step) for a in range(0, n_prompt, step)]
    else:
        groups = [(0, n_prompt)]
    return groups + [(i, i + 1) for i in range(n_prompt, total)]


def moe(h, w: dict, cfg: dict, n_prompt: int, fp8: bool,
        margins: list | None = None) -> torch.Tensor:
    """Top-k experts with the capacity rule the configuration states: in
    each dispatch group of T tokens an expert keeps at most int(T*k/E*cf)
    (at least 1) of the (token, k) slots sent to it, earlier tokens first,
    then lower k; a dropped slot adds nothing.  ``margins``, where given,
    gets each token's router margin at the top-k edge: the k-th largest
    probability less the (k+1)-th."""
    t = h.shape[0]
    e, k = int(cfg["num_local_experts"]), int(cfg["num_experts_per_tok"])
    cf, chunks = float(cfg["capacity_factor"]), int(cfg["dispatch_chunks"])
    probs = torch.softmax(_mm(h, w["router"], fp8), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append(gates[:, k - 1] - gates[:, k])
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.zeros((t, k), dtype=torch.bool, device=h.device)
    for a, b in dispatch_groups(n_prompt, t, chunks):
        cap = max(int((b - a) * k / e * cf), 1)
        flat = experts[a:b].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, e)
        pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
        keep[a:b] = (pos < cap).view(b - a, k)
    out = torch.zeros_like(h)
    for x in range(e):
        tok, j = torch.nonzero((experts == x) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        hx = h[tok]
        y = torch.nn.functional.silu(_mm(hx, w["w_gate"][x], fp8)) * _mm(hx, w["w_up"][x], fp8)
        out.index_add_(0, tok, _mm(y, w["w_down"][x], fp8) * gates[tok, j][:, None])
    return out


def _layer(weights: dict, i: int) -> dict:
    """Layer i's tensors up-cast to float32."""
    pre = "layers."
    out = {}
    for name, t in weights.items():
        if name.startswith(pre):
            key = name[len(pre):].replace("moe.", "")
            out[key] = t[i].float()
    return out


@torch.no_grad()
def served_logits(weights: dict, cfg: dict, seqs: list[tuple[torch.Tensor, int]], *,
                  fp8: bool = False, margins: list | None = None) -> list[torch.Tensor]:
    """For each (tokens (T,), n_prompt): float32 logits (T - n_prompt + 1, V)
    of positions n_prompt-1 .. T-1, each predicting the token after it.
    ``tokens`` is the prompt followed by the served tokens but the last.
    All sequences go through each layer before the next layer is up-cast.
    ``margins``, an empty list where given, gets for each sequence of a MoE
    model the smallest router margin over the layers (``moe``) at each of
    those positions."""
    h, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = int(cfg["hidden_size"])
    dh = int(cfg.get("head_dim") or d // h)
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    is_moe = bool(cfg.get("num_local_experts"))
    xs = [weights["embed"][tok].float() for tok, _ in seqs]
    for i in range(int(cfg["num_hidden_layers"])):
        w = _layer(weights, i)
        for n, (x, (_, n_prompt)) in enumerate(zip(xs, seqs)):
            t = x.shape[0]
            a = rms_norm(x, w["b0.ln"], eps)
            q = rope(_mm(a, w["b0.wq"], fp8).view(t, h, dh), theta)
            k = rope(_mm(a, w["b0.wk"], fp8).view(t, kv, dh), theta)
            v = _mm(a, w["b0.wv"], fp8).view(t, kv, dh)
            x = x + _mm(attention(q, k, v), w["b0.wo"], fp8)
            a = rms_norm(x, w["f0.ln"], eps)
            if is_moe:
                fw = {"router": w["f0.router"], "w_gate": w["f0.w_gate"],
                      "w_up": w["f0.w_up"], "w_down": w["f0.w_down"]}
                edge = [] if margins is not None else None
                x = x + moe(a, fw, cfg, n_prompt, fp8, edge)
                if edge:
                    m = edge[0][n_prompt - 1:]
                    if len(margins) <= n:
                        margins.append(m)
                    else:
                        margins[n] = torch.minimum(margins[n], m)
            else:
                g = torch.nn.functional.silu(_mm(a, w["f0.gate"], fp8)) * _mm(a, w["f0.up"], fp8)
                x = x + _mm(g, w["f0.down"], fp8)
            xs[n] = x
        del w
    head = weights["lm_head"].float()
    out = []
    for x, (_, n_prompt) in zip(xs, seqs):
        y = rms_norm(x[n_prompt - 1:], weights["out_norm"], eps)
        out.append(_mm(y, head, fp8))
    return out
