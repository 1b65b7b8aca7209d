# The port's own copy of repro/core/multihop.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Beyond-paper: multi-hop KV routing through DRAM staging caches (§VII-D).

The paper's future-work sketch: "Multi-hop KV routing extends NetKV to
architectures that stage KV state through intermediate caches in CPU DRAM
or SSDs: the oracle exposes tier information for both hops and the cost
model sums the two transfer times, with the greedy generalising naturally."

Implementation: a cluster hosts ``StagingStore`` nodes (CPU-DRAM block
caches, Mooncake-style).  For a request whose prefix blocks live in a store,
NetKV-MultiHop scores each decode candidate d over the best *plan*:

  direct:            T(p -> d, s_eff)
  staged(s):         max( T(s -> d, s_hit),  T(p -> d, s_miss) )   [parallel]

where s_hit is the portion of the payload resident in store s (fetched over
the s->d path at the store's DRAM-capped bandwidth) and s_miss is the
remainder that must still come from the prefill instance.  Completed
transfers populate the stores (write-through), so hot shared prefixes
migrate close to every pod — cutting cross-pod bytes beyond what
decode-local prefix caches can.

Cost arithmetic reuses Eqs. (2)-(4) per hop as vectorised array ops over the
``ClusterView`` columns: each store contributes one candidate-wide leg-time
vector, and the plan choice is an elementwise min across plans.  Prop. 2's
staleness tolerance applies hop-wise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .oracle import TIERS
from .schedulers import Decision, NetKVFull, v_transfer_time
from .view import as_cluster_view


@dataclasses.dataclass
class StagingStore:
    """CPU-DRAM block cache on a host (instance-id addressable)."""

    node_id: int
    capacity_bytes: float
    dram_bw: float = 40e9          # sustained DRAM->NIC read bandwidth
    bytes_per_block: float = 16 * 320 * 1024 / 4

    def __post_init__(self):
        from collections import OrderedDict

        self._lru: "OrderedDict" = OrderedDict()

    @property
    def bytes_used(self) -> float:
        return len(self._lru) * self.bytes_per_block

    def hit_blocks(self, hashes: Sequence) -> int:
        n = 0
        for h in hashes:
            if h in self._lru:
                n += 1
            else:
                break
        return n

    def insert(self, hashes: Sequence) -> None:
        for h in hashes:
            self._lru[h] = None
            self._lru.move_to_end(h)
        while self.bytes_used > self.capacity_bytes and self._lru:
            self._lru.popitem(last=False)


@dataclasses.dataclass
class HopPlan:
    kind: str                     # "direct" | "staged"
    store_id: int = -1
    t_xfer: float = 0.0
    staged_bytes: float = 0.0
    direct_bytes: float = 0.0


class NetKVMultiHop(NetKVFull):
    """NetKV-Full + staged-fetch planning over DRAM KV stores."""

    name = "netkv-multihop"

    def __init__(self, *args, stores: Sequence[StagingStore] = (),
                 block_tokens: int = 16, **kwargs):
        super().__init__(*args, **kwargs)
        self.stores = list(stores)
        self.block_tokens = block_tokens
        self._req_hashes: Sequence = ()
        self.plans: dict[int, HopPlan] = {}
        # Self-contention on the store's egress NIC — the same idea the
        # paper applies to prefill NICs (n_inflight^tau), hop-wise.
        self.store_inflight: dict[int, int] = {}

    def observe_request(self, block_hashes: Sequence) -> None:
        """Simulator hook: the current request's block-hash sequence."""
        self._req_hashes = tuple(block_hashes)

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        tier_row = cv.tier_row(prefill_id)
        # Direct plan: one p->d leg under Alg. 1's information set.
        t_best = self._xfer_vec(req, cv, prefill_id, oracle, inflight, s_eff, tier_row)
        plan_store = np.full(cv.n, -1, np.int64)       # -1 == direct
        plan_staged = np.zeros(cv.n)
        plan_direct = s_eff.copy()
        # Staged plans: per store, one candidate-wide pair of leg vectors.
        # Tokens already on the decode candidate are not refetched from
        # anywhere; staging competes only for the remainder.
        if self._req_hashes:
            hit = cv.column("hit_tokens")
            bytes_per_tok = req.kv_bytes / max(req.input_len, 1)
            cong = self._congestion_by_tier(oracle)
            n_by = self._n_by_tier(inflight, prefill_id)
            for store in self.stores:
                hit_blocks = store.hit_blocks(self._req_hashes)
                hit_tokens = min(hit_blocks * self.block_tokens, req.input_len)
                extra = np.maximum(hit_tokens - hit, 0.0)
                staged_bytes = extra * bytes_per_tok
                direct_bytes = np.maximum(s_eff - staged_bytes, 0.0)
                s_tier_row = cv.tier_row(store.node_id)
                bw_capped = {t: min(oracle.tier_bandwidth[t], store.dram_bw)
                             for t in TIERS}
                n_store = self.store_inflight.get(store.node_id, 0)
                t_staged_leg = v_transfer_time(
                    staged_bytes, s_tier_row, bw_capped, cong,
                    {t: n_store for t in TIERS}, oracle.tier_latency)
                t_direct_leg = v_transfer_time(
                    direct_bytes, tier_row, oracle.tier_bandwidth, cong, n_by,
                    oracle.tier_latency)
                t = np.maximum(t_staged_leg, t_direct_leg)  # parallel fetch
                better = (s_eff > 0.0) & (extra > 0.0) & (t < t_best)
                t_best = np.where(better, t, t_best)
                plan_store = np.where(better, store.node_id, plan_store)
                plan_staged = np.where(better, staged_bytes, plan_staged)
                plan_direct = np.where(better, direct_bytes, plan_direct)
        cost = t_best + self._t_queue_vec(cv) + self._t_decode_vec(cv)
        j = int(idx[np.lexsort((self._ties(idx.size), cost[idx]))[0]])
        tier = int(tier_row[j])
        staged = plan_store[j] >= 0
        best_plan = HopPlan(
            "staged" if staged else "direct",
            int(plan_store[j]), float(t_best[j]),
            float(plan_staged[j]) if staged else 0.0, float(plan_direct[j]),
        )
        if inflight is not None and best_plan.kind == "direct":
            inflight.incr(prefill_id, tier)
        if best_plan.kind == "staged":
            self.store_inflight[best_plan.store_id] = \
                self.store_inflight.get(best_plan.store_id, 0) + 1
        self.plans[req.request_id] = best_plan
        return Decision(int(cv.ids[j]), float(cost[j]), best_plan.t_xfer, tier,
                        float(s_eff[j]))

    def on_transfer_complete(self, block_hashes: Sequence, store_id: int | None = None):
        """Write-through: landed prefixes populate the (nearest) store."""
        targets = [s for s in self.stores if store_id is None or s.node_id == store_id]
        for s in targets:
            s.insert(block_hashes)

    def staged_leg_done(self, store_id: int) -> None:
        cur = self.store_inflight.get(store_id, 0)
        if cur > 1:
            self.store_inflight[store_id] = cur - 1
        else:
            self.store_inflight.pop(store_id, None)
