"""Per-tensor dispatch between the CUDA kernels and their plain versions.

A tensor on a CUDA device goes to the kernel, which launches or raises;
a tensor on the CPU goes to the plain PyTorch version in ``ref.py``.  There
is no other route and no fallback from one to the other.  The kernels have
no backward, so inputs that require grad are refused on either device:
training differentiates the plain versions, called by name.
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


def _no_grad(what: str, *tensors: torch.Tensor) -> None:
    """The kernels have no backward: refuse inputs that would need one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: its inputs require grad (training "
                           "differentiates the plain version)")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int, lengths: torch.Tensor | None = None,
                 k_new: torch.Tensor | None = None,
                 v_new: torch.Tensor | None = None) -> torch.Tensor:
    """K4: one-token attention over the first ``pos`` keys, or row b over
    its first ``lengths[b]`` (a (B,) int32 tensor on q's device, each in
    [1, pos], ``pos`` their maximum); with ``k_new``/``v_new`` (B, KV, dh)
    the current token's key and value as one more key (lengths from 0)."""
    _no_grad("flash_decode", q, k_cache, v_cache)
    if _on_card(q):
        from .flash_decode import flash_decode as kernel

        return kernel(q, k_cache, v_cache, pos, lengths, k_new, v_new)
    return ref.flash_decode_ref(q, k_cache, v_cache, pos if lengths is None else lengths,
                                k_new, v_new)


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: int, lengths: torch.Tensor | None = None, *, start: int = 0,
                          k_new: torch.Tensor | None = None,
                          v_new: torch.Tensor | None = None):
    """K4 in partials mode: a sequence shard's (acc, m, l) in f32."""
    _no_grad("flash_decode", q, k_cache, v_cache)
    if _on_card(q):
        from .flash_decode import flash_decode_partials as kernel

        return kernel(q, k_cache, v_cache, pos, lengths, start=start, k_new=k_new, v_new=v_new)
    return ref.flash_decode_partials_ref(q, k_cache, v_cache, pos, lengths, start=start,
                                         k_new=k_new, v_new=v_new)


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


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
              renormalize: bool):
    """K9: a decode step's routing and capacity rule, ``(experts (T, k),
    gates_kept (T, k), aux)``, a dropped slot's gate 0."""
    _no_grad("moe_route", x, router)
    if _on_card(x):
        from .moe_route import moe_route as kernel

        return kernel(x, router, top_k, cap, renormalize)
    return ref.moe_route_ref(x, router, top_k, cap, renormalize)


def moe_decode(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """K8: a decode step's MoE FFN (T, d) over the experts its T tokens
    route to (``experts``, ``gates`` (T, k) from K9, a dropped slot's gate
    0)."""
    _no_grad("moe_decode", x, w_gate, w_up, w_down)
    if _on_card(x):
        from .moe_decode import moe_decode as kernel

        return kernel(x, experts, gates, w_gate, w_up, w_down)
    return ref.moe_decode_ref(x, experts, gates, w_gate, w_up, w_down)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor):
    """K7: the WKV-6 recurrence, ``(y, final_state)``."""
    _no_grad("rwkv_scan", r, k, v, w, u)
    if _on_card(r):
        from .rwkv_scan import rwkv_scan as kernel

        return kernel(r, k, v, w, u)
    return ref.rwkv_scan_ref(r, k, v, w, u)
