"""KV transfer path: page the prefill cache, pack to a contiguous buffer.

The port of ``repro/serving/transfer.py``.  Packing runs ``kv_pack`` (the
CUDA kernel for tensors on the card) over a block table built on the host;
the byte count it returns is what the NetKV cost model prices (Eq. 1/2):
callers skip packing the prefix-hit pages (Eq. 2's lambda term).
"""

from __future__ import annotations

import torch

from ..core.cost import B_TOK
from ..kernels import ops


def paged_view(k_cache: torch.Tensor, page_tokens: int = B_TOK) -> torch.Tensor:
    """(P, 1, S, KV, dh) per-request cache leaf -> (P*S/page, page, KV, dh)."""
    p, b, s, kv, dh = k_cache.shape
    assert b == 1
    return k_cache.reshape(p * (s // page_tokens), page_tokens, kv, dh)


def pack_transfer_chunk(cache: dict, hit_pages: int, start_page: int,
                        end_page: int | None = None, *, final: bool = True,
                        page_tokens: int = B_TOK):
    """Pack one streamed chunk of the cache: attention pages in
    ``[max(hit_pages, start_page), min(end_page, valid))``; fixed-size state
    rides with the ``final`` chunk.  Returns (buffers dict, total_bytes),
    where each buffer is ``(tensor, page table tuple)``."""
    buffers = {}
    total = 0
    for name, leaf in cache.items():
        if name == "pos" or not isinstance(leaf, torch.Tensor):
            continue
        if name.startswith(("k", "v")) and leaf.dim() == 5:
            pos = int(cache["pos"])
            n_pages_valid = max((pos + page_tokens - 1) // page_tokens, 0)
            lo = max(hit_pages, start_page)
            hi = n_pages_valid if end_page is None else min(end_page, n_pages_valid)
            pages_per_period = leaf.shape[2] // page_tokens
            table = [per * pages_per_period + pg
                     for per in range(leaf.shape[0]) for pg in range(lo, hi)]
            if not table:
                continue
            buf = ops.kv_pack(paged_view(leaf, page_tokens),
                              torch.tensor(table, dtype=torch.int32))
            buffers[name] = (buf, tuple(table))
            total += buf.numel() * buf.element_size()
        elif final:
            buffers[name] = (leaf, None)
            total += leaf.numel() * leaf.element_size()
    return buffers, total


def pack_transfer(cache: dict, hit_pages: int, page_tokens: int = B_TOK):
    """Pack every non-hit page of the attention KV leaves; returns (buffers,
    total_bytes) — Eq. (2)'s s_eff, materialised."""
    return pack_transfer_chunk(cache, hit_pages, 0, None, final=True,
                               page_tokens=page_tokens)


def merge_chunk_buffers(chunks: list[dict]) -> dict:
    """Merge per-chunk buffer dicts (in chunk order) into one transfer-
    equivalent dict for :func:`unpack_transfer`."""
    out: dict = {}
    for buffers in chunks:
        for name, (buf, table) in buffers.items():
            if table is None:
                out[name] = (buf, None)
            elif name in out:
                prev, ptab = out[name]
                out[name] = (torch.cat([prev, buf], dim=0), ptab + tuple(table))
            else:
                out[name] = (buf, tuple(table))
    return out


def unpack_transfer(buffers: dict, like_cache: dict, page_tokens: int = B_TOK):
    """Reassemble a per-request cache dict from transfer buffers.

    As in the JAX package, each paged leaf starts from a zero pool and only
    the shipped pages are scattered in: pages the decode side holds as a
    prefix hit stay zero here (ROADMAP §3 records this behaviour)."""
    out = {}
    for name, leaf in like_cache.items():
        if name == "pos" or not isinstance(leaf, torch.Tensor):
            continue
        if name in buffers:
            buf, table = buffers[name]
            if table is None:
                out[name] = buf
            else:
                pool = torch.zeros(
                    (leaf.shape[0] * (leaf.shape[2] // page_tokens), page_tokens,
                     leaf.shape[3], leaf.shape[4]),
                    dtype=leaf.dtype, device=leaf.device)
                ops.kv_unpack(pool, buf, torch.tensor(table, dtype=torch.int32))
                out[name] = pool.reshape(leaf.shape)
        else:
            out[name] = torch.zeros_like(leaf)
    return out
