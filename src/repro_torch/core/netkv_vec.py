"""Vectorised NetKV scorer in PyTorch: the port's counterpart of
``repro/core/netkv_jax.py``.

Algorithm 1's per-candidate loop (lines 3-13) as one vectorised computation
over candidate columns, in f32 with the JAX version's operation order, on
an explicit device (the CUDA card by default).  The JAX module jits it under
XLA; it reaches no Pallas kernel, so this is plain tensor code: the decision
kernel of the port is ``kernels.netkv_score_cohort`` (K1).  ``PoolArrays``,
``score_pool``, ``score_pool_batched`` and the ``netkv-jax`` rung keep the
JAX names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.build import resolve_device
from .schedulers import CandidateState

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PoolArrays:
    """Struct-of-arrays snapshot of the decode pool, on one device."""

    free_memory: torch.Tensor   # (D,) f32 bytes
    queued: torch.Tensor        # (D,) i32
    batch: torch.Tensor         # (D,) i32
    hit_tokens: torch.Tensor    # (D,) f32
    tier: torch.Tensor          # (D,) i64 in {0..3} (an index)
    healthy: torch.Tensor       # (D,) bool
    iter_scale: torch.Tensor    # (D,) f32

    @staticmethod
    def _make(cols: dict, device) -> "PoolArrays":
        dev = resolve_device(device)
        dtypes = dict(free_memory=F32, queued=torch.int32, batch=torch.int32,
                      hit_tokens=F32, tier=torch.int64, healthy=torch.bool, iter_scale=F32)
        return PoolArrays(**{k: torch.as_tensor(np.asarray(cols[k]), device=dev).to(dt)
                             for k, dt in dtypes.items()})

    @staticmethod
    def from_candidates(cands: list[CandidateState], tiers, device=None) -> "PoolArrays":
        return PoolArrays._make(dict(
            free_memory=[c.free_memory for c in cands], queued=[c.queued for c in cands],
            batch=[c.batch_size for c in cands], hit_tokens=[c.hit_tokens for c in cands],
            tier=list(tiers), healthy=[c.healthy for c in cands],
            iter_scale=[c.iter_scale for c in cands]), device)

    @staticmethod
    def from_view(cv, prefill_id: int, device=None) -> "PoolArrays":
        """A snapshot of a ClusterView's columns and tier row."""
        cols = {k: cv.column(k) for k in ("free_memory", "queued", "batch", "hit_tokens",
                                           "healthy", "iter_scale")}
        cols["tier"] = cv.tier_row(prefill_id)
        return PoolArrays._make(cols, device)


def score_pool(pool: PoolArrays, kv_bytes, input_len, tier_bw, tier_lat, congestion,
               n_inflight, iter_a, iter_b, m_min, *, beta_max: int):
    """(costs (D,), best index): Eq. (5) per candidate in f32, +inf where
    infeasible.  ``kv_bytes``/``input_len`` are s_r and l_r; the tier
    tables are 4 numbers; ``n_inflight`` this prefill instance's transfers
    in flight by tier."""
    dev = pool.tier.device

    def f32(x):
        return torch.as_tensor(x, device=dev).to(F32)

    kv_bytes, input_len = f32(kv_bytes), f32(input_len)
    tier_bw, tier_lat, congestion = f32(tier_bw), f32(tier_lat), f32(congestion)
    n_inflight = torch.as_tensor(n_inflight, device=dev).to(torch.int32)
    iter_a, iter_b, m_min = f32(iter_a), f32(iter_b), f32(m_min)
    one = f32(1.0)
    hit = torch.minimum(pool.hit_tokens, input_len)
    s_eff = kv_bytes * (one - hit / torch.maximum(input_len, one))            # Eq. (2)
    beff = (tier_bw[pool.tier] * (one - congestion[pool.tier])
            / (one + n_inflight[pool.tier].to(F32)))                           # Eq. (4)
    t_xfer = s_eff / beff + tier_lat[pool.tier]                                # Eq. (3)
    t_iter = (iter_a + iter_b * pool.batch.to(F32)) * pool.iter_scale
    blocked = torch.clamp(pool.queued - (beta_max - pool.batch), min=0)
    t_queue = blocked.to(F32) * t_iter                                         # Eq. (6)
    t_dec = (iter_a + iter_b * (pool.batch + 1).to(F32)) * pool.iter_scale     # Eq. (7)
    cost = t_xfer + t_queue + t_dec                                            # Eq. (5)
    feasible = pool.healthy & (pool.free_memory >= s_eff + m_min)
    cost = torch.where(feasible, cost, torch.full_like(cost, float("inf")))
    return cost, torch.argmin(cost)


def score_pool_batched(pool: PoolArrays, kv_bytes, input_len, tier_bw, tier_lat, congestion,
                       n_inflight, iter_a, iter_b, m_min, *, beta_max: int):
    """R requests against one pool snapshot: ``kv_bytes``/``input_len`` (R,),
    ``n_inflight`` (R, 4) -> (costs (R, D), best (R,))."""
    out = [score_pool(pool, kv_bytes[r], input_len[r], tier_bw, tier_lat, congestion,
                      n_inflight[r], iter_a, iter_b, m_min, beta_max=beta_max)
           for r in range(len(kv_bytes))]
    return torch.stack([c for c, _ in out]), torch.stack([i for _, i in out])


class VecNetKV:
    """Drop-in NetKV-Full whose argmin runs vectorised (same decisions):
    the ``netkv-jax`` rung."""

    name = "netkv-jax"

    def __init__(self, iter_model, beta_max: int, m_min: float = 2 * 1024**3):
        self.iter_model = iter_model
        self.beta_max = beta_max
        self.m_min = m_min

    def select_arrays(self, pool: PoolArrays, req_kv_bytes, req_len, oracle_view,
                      n_inflight_by_tier):
        costs, idx = score_pool(
            pool, req_kv_bytes, req_len, oracle_view.bandwidth_array(),
            oracle_view.latency_array(), oracle_view.congestion_array(),
            n_inflight_by_tier, self.iter_model.a, self.iter_model.b, self.m_min,
            beta_max=self.beta_max)
        idx = int(idx)
        if not np.isfinite(float(costs[idx])):
            return None, costs
        return idx, costs


JaxNetKV = VecNetKV   # the JAX module's name for the rung
