"""GQA attention: chunked causal (prefill), bidirectional (encoder), cross
(the encoder-decoder's decoder) and the one-token decode reference.

``chunked_causal_attention`` loops over query chunks so live memory stays at
(B, H, chunk, S), as ``repro/models/attention.py`` does with ``lax.scan``.
Where the query heads group over the KV heads (H % KV == 0) the raw K/V are
contracted per group; otherwise K/V are expanded to H heads by
``_gqa_expand``'s tile-and-slice, as in JAX.
The serving decode path runs ``kernel_decode_attention`` (K4 through
``kernels.ops.flash_decode``), with a self term for the read-only decode;
``decode_attention`` is the JAX package's XLA decode path, kept as the
reference the model tests hold the kernel path against.  The sequence-sharded
decode (``seq_sharded_decode_attention``) runs each shard's local partial on
K4 in partials mode and merges the partials, over a list or over a mesh.
"""

from __future__ import annotations

import torch

from ..kernels import ops, ref
from .sharding import merge_dims, split_dim

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
    c = qg.shape[1]
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k).float() * scale
    if causal:
        mask = _causal_mask(q_offset, c, k.shape[1], qg.device)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(qg.dtype)
    return merge_dims(torch.einsum("bkgcs,bskd->bckgd", probs, v), 2, 3)


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
            return _attn_block_grouped(split_dim(qi, 2, (kv, h // kv)), k, v, start, causal,
                                       scale)
    else:
        kx, vx = _gqa_expand(k, h), _gqa_expand(v, h)

        def block(qi, start):
            return _attn_block(qi, kx, vx, start, causal, scale)

    if s <= chunk:
        return block(q, 0)
    return torch.cat([block(q[:, i:i + chunk], i) for i in range(0, s, chunk)], dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos, *, k_new: torch.Tensor | None = None,
                     v_new: torch.Tensor | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q (B, 1, H, dh) against the first ``pos`` entries of k/v (B, S, KV,
    dh); ``pos`` an int or a (B,) tensor of each row's.  With ``k_new``/
    ``v_new`` (B, 1, KV, dh) the cache is read only and the current token's
    key joins the softmax last (JAX's paged decode); the probabilities are
    cast to q's dtype before both products, as in JAX."""
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    if isinstance(pos, torch.Tensor):
        pos = pos.to(q.device).reshape(-1, 1, 1, 1, 1)
    valid = torch.arange(s, device=q.device) < pos
    if h % kv:   # head-expanded: (B, 1, KV*G, dh) caches, one group a head
        kc, vc = _gqa_expand(k_cache, h), _gqa_expand(v_cache, h)
        kn = None if k_new is None else _gqa_expand(k_new, h)
        vn = None if v_new is None else _gqa_expand(v_new, h)
        qg, kv, g = q.reshape(b, 1, h, 1, dh), h, 1
    else:
        kc, vc, kn, vn = k_cache, v_cache, k_new, v_new
        qg, g = q.reshape(b, 1, kv, h // kv, dh), h // kv
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float() * scale
    logits = torch.where(valid, logits, NEG_INF)
    if kn is None:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, vc)
    else:
        self_logit = torch.einsum("bqkgd,bnkd->bkgqn", qg, kn).float() * scale
        probs = torch.softmax(torch.cat([logits, self_logit], dim=-1), dim=-1).to(q.dtype)
        out = (torch.einsum("bkgqs,bskd->bqkgd", probs[..., :s], vc)
               + torch.einsum("bkgqn,bnkd->bqkgd", probs[..., s:], vn))
    return out.reshape(b, 1, h, dh)


def cross_attention(q: torch.Tensor, k_mem: torch.Tensor, v_mem: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, S_dec, H, dh) over the whole encoder memory k/v (B, S_enc, KV,
    dh), no mask; the probabilities are cast to q's dtype before the value
    product, as in JAX."""
    h = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _attn_block(q, _gqa_expand(k_mem, h), _gqa_expand(v_mem, h), 0, False, scale)


def _padded(q: torch.Tensor, kv: int):
    """q (B, H, dh) with zero heads to KV * ceil(H/KV), and H."""
    b, h, dh = q.shape
    g = -(-h // kv)
    if kv * g == h:
        return q, h
    return torch.cat([q, q.new_zeros((b, kv * g - h, dh))], dim=1), h


def kernel_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: int, lengths: torch.Tensor | None = None, *,
                            k_new: torch.Tensor | None = None,
                            v_new: torch.Tensor | None = None) -> torch.Tensor:
    """One-token attention of q (B, H, dh) over the first ``pos`` rows of
    k/v (B, S, KV, dh), or row b over its first ``lengths[b]`` (each in
    [1, pos]), through ``ops.flash_decode`` (K4 on the card).  With
    ``k_new``/``v_new`` (B, KV, dh) the cache is read only and the current
    token's key is one more key (lengths then from 0, ``pos`` from 0).

    Where KV does not divide H, q is padded with zero heads to KV * G, G =
    ceil(H/KV), and the first H outputs are kept: K4's query head j reads KV
    head j // G, the tile-and-slice order of ``_gqa_expand``."""
    qp, h = _padded(q, k_cache.shape[2])
    return ops.flash_decode(qp, k_cache, v_cache, pos, lengths, k_new, v_new)[:, :h]


# ---------------------------------------------------------------------------
# Sequence-sharded decode (``repro/models/attention.py``:
# ``sharded_decode_attention`` and ``seq_sharded_decode_attention``).  The
# KV cache is cut along S; each shard's local partial is K4 in partials mode
# (its plain version off the card), and the merge is a max of m and a sum of
# the rescaled (acc, l): over a list of partials, or with all-reduces over
# the mesh's sequence axes.  The self term joins on shard 0 only.
# ---------------------------------------------------------------------------

EMPTY_M = -1e30   # the m of a row with no key in a shard; the merge weighs it 0


def decode_partial(q: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor,
                   lengths: torch.Tensor, longest: int, start: int,
                   k_new: torch.Tensor | None = None, v_new: torch.Tensor | None = None,
                   kernel=ops.flash_decode_partials):
    """The local partial of the shard holding cache rows ``[start, start +
    S_loc)``: (acc (B, H, dh), m (B, H), l (B, H)) in f32.  ``lengths``:
    each row's global valid length, a (B,) int32 tensor on q's device;
    ``longest``, a host int at least their maximum, bounds the shard's
    range.  ``k_new``/``v_new`` (B, KV, dh), the self term, only where
    ``start`` is 0.  ``kernel``: K4 in partials mode, or its plain version."""
    qp, h = _padded(q, k_loc.shape[2])
    local = min(max(longest - start, 0), k_loc.shape[1])
    acc, m, l = kernel(qp, k_loc, v_loc, local, lengths, start=start, k_new=k_new, v_new=v_new)
    return acc[:, :h], m[:, :h], l[:, :h]


def merge_partials(parts, dtype) -> torch.Tensor:
    """Merge a list of shard partials (acc, m, l) into the attention output
    (B, H, dh) in ``dtype``: m the max of the shards', each shard weighed by
    exp(m_i - m)."""
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    acc = sum(p[0] * torch.exp(p[1] - m)[..., None] for p in parts)
    l = sum(p[2] * torch.exp(p[1] - m) for p in parts)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def _shard_bounds(s: int, n_shards: int) -> list[tuple[int, int]]:
    if s % n_shards:
        raise ValueError(f"S {s} does not split into {n_shards} equal shards")
    step = s // n_shards
    return [(i * step, (i + 1) * step) for i in range(n_shards)]


def seq_sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, lengths: torch.Tensor, longest: int,
                                 k_new: torch.Tensor | None = None,
                                 v_new: torch.Tensor | None = None, *, mesh=None,
                                 batch_axes=(), seq_axes=(), n_shards: int | None = None
                                 ) -> torch.Tensor:
    """Read-only decode attention with the KV cache cut along S: q (B, 1, H,
    dh), k/v (B, S, KV, dh), k_new/v_new (B, 1, KV, dh) -> (B, 1, H, dh);
    row b attends to its first ``lengths[b]`` cache rows (a (B,) int32
    tensor, each at most the host int ``longest``).

    Without a mesh the cache is cut into ``n_shards`` equal shards here and
    their partials are merged in shard order.  Under a ``DeviceMesh`` the
    cache is a DTensor sharded on dim 1 over ``seq_axes`` (and on dim 0 over
    ``batch_axes``, as are q and the lengths); each shard's partial is taken
    on its local rows with ``local_map``, then m is all-reduced with MAX and
    the rescaled acc and l with SUM over each sequence axis: O(B H dh) a
    layer, never the cache."""
    q1 = q[:, 0]
    kn = None if k_new is None else k_new[:, 0]
    vn = None if v_new is None else v_new[:, 0]
    if mesh is None:
        parts = [decode_partial(q1, k_cache[:, lo:hi], v_cache[:, lo:hi], lengths, longest, lo,
                                *((kn, vn) if lo == 0 else (None, None)))
                 for lo, hi in _shard_bounds(k_cache.shape[1], n_shards or 1)]
        return merge_partials(parts, q.dtype)[:, None]
    return _mesh_sharded(q1, k_cache, v_cache, lengths, longest, kn, vn, mesh,
                         tuple(batch_axes), tuple(seq_axes))[:, None]


def sharded_decode_attention(q, k_cache, v_cache, pos: int, *, mesh=None, seq_axis: str = "",
                             n_shards: int | None = None) -> torch.Tensor:
    """JAX's sequence-parallel decode without a self term: every row over
    the first ``pos`` rows of the cache sharded along S over ``seq_axis``
    (or cut into ``n_shards``)."""
    lengths = torch.full((q.shape[0],), int(pos), dtype=torch.int32, device=q.device)
    return seq_sharded_decode_attention(q, k_cache, v_cache, lengths, int(pos), mesh=mesh,
                                        seq_axes=(seq_axis,) if mesh is not None else (),
                                        n_shards=n_shards)


def _mesh_sharded(q, k_cache, v_cache, lengths, longest, k_new, v_new, mesh, batch_axes,
                  seq_axes):
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names

    def placements(dims: dict):
        return tuple(next((Shard(d) for d, axes in dims.items() if n in axes), Replicate())
                     for n in names)

    rows = placements({0: batch_axes})
    cache = placements({0: batch_axes, 1: seq_axes})

    def local(ql, kl, vl, ll, kn, vn):
        idx = 0
        for a in seq_axes:
            idx = idx * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        start = idx * kl.shape[1]
        first = start == 0 and kn is not None
        # The dry run's local shards are meta tensors (shapes, no values),
        # which no kernel takes: the plain version gives the partial's shapes.
        kernel = ref.flash_decode_partials_ref if kl.is_meta else ops.flash_decode_partials
        acc, m, l = decode_partial(ql, kl, vl, ll, longest, start,
                                   *((kn, vn) if first else (None, None)), kernel=kernel)
        gm = m
        for a in seq_axes:
            gm = all_reduce(gm, "max", (mesh, names.index(a)))
        w = torch.exp(m - gm)
        acc, l = acc * w[..., None], l * w
        for a in seq_axes:
            acc = all_reduce(acc, "sum", (mesh, names.index(a)))
            l = all_reduce(l, "sum", (mesh, names.index(a)))
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(ql.dtype)

    # The host's lengths enter replicated; local_map cuts each rank's rows.
    lengths = DTensor.from_local(lengths, mesh, [Replicate()] * mesh.ndim, run_check=False)
    # local_map reads a tuple as one placement list an output: lists here.
    rows, cache = list(rows), list(cache)
    fn = local_map(local, out_placements=rows,
                   in_placements=(rows, cache, cache, rows, rows if k_new is not None else None,
                                  rows if v_new is not None else None),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k_cache, v_cache, lengths, k_new, v_new)
