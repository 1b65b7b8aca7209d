"""GQA attention: chunked causal (prefill), bidirectional (encoder), cross
(the encoder-decoder's decoder) and the one-token decode reference.

``chunked_causal_attention`` loops over query chunks so live memory stays at
(B, H, chunk, S), as ``repro/models/attention.py`` does with ``lax.scan``.
Where the query heads group over the KV heads (H % KV == 0) the raw K/V are
contracted per group; otherwise K/V are expanded to H heads by
``_gqa_expand``'s tile-and-slice, as in JAX.
The serving decode path runs ``kernel_decode_attention`` (K4 through
``kernels.ops.flash_decode``); ``decode_attention`` is the JAX package's XLA
decode path, kept as the reference the model tests hold the kernel path
against.
"""

from __future__ import annotations

import torch

from ..kernels import ops

NEG_INF = -2.0e38


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, H, dh): each KV head repeated H/KV times, or,
    where KV does not divide H, tiled ceil(H/KV) times and the first H kept
    (query head j reads KV head j // ceil(H/KV))."""
    return k.repeat_interleave(-(-n_heads // k.shape[2]), dim=2)[:, :, :n_heads]


def _causal_mask(q_offset: int, c: int, s: int, device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(c, device=device)[:, None]
    return torch.arange(s, device=device)[None, :] <= q_pos


def _attn_block(q, kx, vx, q_offset, causal, scale):
    """q (B, C, H, dh) against head-expanded kx/vx (B, S, H, dh)."""
    logits = torch.einsum("bchd,bshd->bhcs", q, kx).float() * scale
    if causal:
        mask = _causal_mask(q_offset, q.shape[1], kx.shape[1], q.device)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhcs,bshd->bchd", probs, vx)


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
    """q (B, S, H, dh), k/v (B, S, KV, dh) -> (B, S, H, dh); ``causal=False``
    is the encoder's bidirectional attention.

    Query rows are independent, so the last chunk is simply shorter (the
    JAX version pads it and drops the padded rows)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    if h % kv == 0:
        def block(qi, start):
            return _attn_block_grouped(qi.reshape(b, qi.shape[1], kv, h // kv, dh),
                                       k, v, start, causal, scale)
    else:
        kx, vx = _gqa_expand(k, h), _gqa_expand(v, h)

        def block(qi, start):
            return _attn_block(qi, kx, vx, start, causal, scale)

    if s <= chunk:
        return block(q, 0)
    return torch.cat([block(q[:, i:i + chunk], i) for i in range(0, s, chunk)], dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, *, scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, dh) against the first ``pos`` entries of k/v (B, S, KV, dh)."""
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    if h % kv:   # the causal mask of a query at pos - 1 keeps keys [0, pos)
        return _attn_block(q, _gqa_expand(k_cache, h), _gqa_expand(v_cache, h), pos - 1,
                           True, scale)
    valid = torch.arange(s, device=q.device) < pos
    qg = q.reshape(b, 1, kv, h // kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, dh)


def cross_attention(q: torch.Tensor, k_mem: torch.Tensor, v_mem: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, S_dec, H, dh) over the whole encoder memory k/v (B, S_enc, KV,
    dh), no mask; the probabilities are cast to q's dtype before the value
    product, as in JAX."""
    h = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _attn_block(q, _gqa_expand(k_mem, h), _gqa_expand(v_mem, h), 0, False, scale)


def kernel_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: int, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """One-token attention of q (B, H, dh) over the first ``pos`` rows of
    k/v (B, S, KV, dh), or row b over its first ``lengths[b]`` (each in
    [1, pos]), through ``ops.flash_decode`` (K4 on the card).

    Where KV does not divide H, q is padded with zero heads to KV * G, G =
    ceil(H/KV), and the first H outputs are kept: K4's query head j reads KV
    head j // G, the tile-and-slice order of ``_gqa_expand``."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    g = -(-h // kv)
    if kv * g == h:
        return ops.flash_decode(q, k_cache, v_cache, pos, lengths)
    qp = torch.cat([q, q.new_zeros((b, kv * g - h, dh))], dim=1)
    return ops.flash_decode(qp, k_cache, v_cache, pos, lengths)[:, :h]
