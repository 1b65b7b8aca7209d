"""GQA attention for the dense model: chunked causal (prefill) and the
one-token decode reference.

``chunked_causal_attention`` loops over query chunks so live memory stays at
(B, H, chunk, S), as ``repro/models/attention.py`` does with ``lax.scan``.
The serving decode path runs ``kernels.ops.flash_decode``;
``decode_attention`` is the JAX package's XLA decode path, kept as the
reference the model tests hold the kernel path against.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def _group(n_heads: int, n_kv: int) -> int:
    """Query heads per KV head.  Only whole groups are ported: the JAX
    package's head-expanded path for H % KV != 0 serves padded-sharding
    architectures that the port does not have yet."""
    if n_heads % n_kv:
        raise NotImplementedError(f"{n_heads} heads over {n_kv} KV heads: "
                                  "only H % KV == 0 is ported")
    return n_heads // n_kv


def _causal_mask(q_offset: int, c: int, s: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(c, device=device)[:, None]
    return torch.arange(s, device=device)[None, :] <= q_pos


def _attn_block_grouped(qg, k, v, q_offset, causal, scale):
    """qg (B, C, KV, G, dh) against raw k/v (B, S, KV, dh): the head-expanded
    cache is never built."""
    b, c, kv, g, dh = qg.shape
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k).float() * scale
    if causal:
        mask = _causal_mask(q_offset, c, k.shape[1], qg.device)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(qg.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", probs, v)
    return out.reshape(b, c, kv * g, dh)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             chunk: int = 1024, causal: bool = True,
                             scale: float | None = None) -> torch.Tensor:
    """q (B, S, H, dh), k/v (B, S, KV, dh) -> (B, S, H, dh), H % KV == 0.

    Query rows are independent, so the last chunk is simply shorter (the
    JAX version pads it and drops the padded rows)."""
    b, s, h, dh = q.shape
    g = _group(h, k.shape[2])
    scale = scale if scale is not None else dh ** -0.5

    def block(qi, start):
        return _attn_block_grouped(qi.reshape(b, qi.shape[1], -1, g, dh),
                                   k, v, start, causal, scale)

    if s <= chunk:
        return block(q, 0)
    return torch.cat([block(q[:, i:i + chunk], i) for i in range(0, s, chunk)], dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, *, scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, dh) against the first ``pos`` entries of k/v (B, S, KV, dh)."""
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    valid = torch.arange(s, device=q.device) < pos
    qg = q.reshape(b, 1, kv, _group(h, kv), dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, dh)
