"""Per-tensor dispatch between the CUDA kernels and their plain versions.

A tensor on a CUDA device goes to the kernel, which launches or raises;
a tensor on the CPU goes to the plain PyTorch version in ``ref.py``.  There
is no other route and no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for a tensor on {t.device}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int) -> torch.Tensor:
    if _on_card(q):
        from .flash_decode import flash_decode as kernel

        return kernel(q, k_cache, v_cache, pos)
    return ref.flash_decode_ref(q, k_cache, v_cache, pos)


def kv_pack(pool: torch.Tensor, block_table) -> torch.Tensor:
    if _on_card(pool):
        from .kv_pack import kv_pack as kernel

        return kernel(pool, block_table)
    return ref.kv_pack_ref(pool, torch.as_tensor(block_table))


def kv_unpack(pool: torch.Tensor, buf: torch.Tensor, block_table) -> torch.Tensor:
    """In place: ``pool`` receives the pages and is returned."""
    if _on_card(pool):
        from .kv_pack import kv_unpack as kernel

        return kernel(pool, buf, block_table)
    return ref.kv_unpack_ref(pool, buf, torch.as_tensor(block_table))


def netkv_score_cohort(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                       iter_scale, tier_bw, tier_lat, congestion, infl_rows,
                       **kw):
    if _on_card(hit_rows):
        from .netkv_score import netkv_score_cohort as kernel

        return kernel(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                      iter_scale, tier_bw, tier_lat, congestion, infl_rows, **kw)
    return ref.netkv_score_cohort_ref(free_mem, queued, batch, hit_rows,
                                      tier_rows, healthy, iter_scale, tier_bw,
                                      tier_lat, congestion, infl_rows, **kw)


def waterfill_progressive(paths: torch.Tensor, caps: torch.Tensor,
                          active: torch.Tensor):
    """K5: ``(rates, trace_links, trace_shares, n_rounds)``, ``n_rounds``
    an int."""
    if _on_card(caps):
        from .waterfill import waterfill_progressive as kernel

        rates, tl, ts, rounds = kernel(paths, caps, active)
        r = int(rounds[0])
        if r < 0:
            raise RuntimeError("waterfill_progressive overran its round bound")
        return rates, tl, ts, r
    return ref.waterfill_fixed_point_ref(paths, caps, active)


def waterfill_fast(caps: torch.Tensor, active: torch.Tensor,
                   nhops: torch.Tensor) -> torch.Tensor:
    """K6: rates (S, F) of S flow tables."""
    if _on_card(caps):
        from .waterfill import waterfill_fast as kernel

        return kernel(caps, active, nhops)
    return ref.waterfill_rates_fast_ref(caps, active, nhops)
