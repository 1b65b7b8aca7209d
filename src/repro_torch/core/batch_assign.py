# The port's own copy of repro/core/batch_assign.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Beyond-paper: batch-level joint decode-instance assignment.

The paper's §VII-C lists as future work: "the per-request greedy does not
jointly optimise across concurrent requests; a batch-level formulation could
yield better results at higher computational cost."  This module implements
that formulation.

Requests that arrive within an assignment window W (default 10 ms) are
assigned *jointly*: we run a regret-minimising greedy over the
(request x candidate) cost matrix that re-evaluates marginal costs after each
commitment, so two same-window requests from one prefill instance are not
both sent down the same tier at its pre-dispatch n_inflight, and queue growth
on a popular decode instance is charged to later assignments.

This is the classic auction/regret heuristic for the assignment problem —
O(W^2 |D|) per window instead of O(|D|) per request, matching the paper's
"higher computational cost" caveat, and it strictly generalises Algorithm 1
(window of 1 == NetKV-Full).  Each commit round evaluates the full
(remaining-requests x candidates) cost matrix as vectorised array ops over
the ``ClusterView`` columns plus the virtualised (free, queued, batch)
deltas — no per-candidate Python loops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .oracle import OracleView, SelfContentionTracker, TIERS
from .schedulers import (
    Decision,
    NetKVFull,
    RequestInfo,
    v_iter_time,
    v_s_eff,
    v_transfer_time,
)
from .view import ClusterView, as_cluster_view


class NetKVBatch(NetKVFull):
    name = "netkv-batch"

    def __init__(self, *args, window: float = 0.010, **kwargs):
        super().__init__(*args, **kwargs)
        self.window = window

    # Single-request path stays Alg. 1 (used when the window holds 1 request).
    def _coerce_batch(self, cands_per_req, oracle):
        """Accept (ClusterView, hits (R,D)) or legacy per-request lists."""
        if (isinstance(cands_per_req, tuple) and len(cands_per_req) == 2
                and isinstance(cands_per_req[0], ClusterView)):
            cv, hits = cands_per_req
            return cv, np.asarray(hits, np.float64)
        cv = as_cluster_view(cands_per_req[0], oracle)
        hits = np.array(
            [[c.hit_tokens for c in cl] for cl in cands_per_req], np.float64
        )
        return cv, hits

    def select_batch(
        self,
        reqs: Sequence[tuple[RequestInfo, int]],
        cands_per_req,  # (ClusterView, hits) | Sequence[Sequence[CandidateState]]
        oracle: OracleView,
        inflight: Optional[SelfContentionTracker] = None,
    ) -> list[Optional[Decision]]:
        """Jointly assign a window of (request, prefill_id) pairs.

        ``hits[i]`` is request i's prefix-hit column over the shared pool
        (hit_tokens is request-specific; load/memory state is shared and
        virtualised below).  Returns one Decision (or None = reject) per
        input, in input order.
        """
        n = len(reqs)
        cv, hits = self._coerce_batch(cands_per_req, oracle)
        assert hits.shape == (n, cv.n)
        out: list[Optional[Decision]] = [None] * n
        ids = cv.column("ids")
        healthy = cv.column("healthy")
        iter_scale = cv.column("iter_scale")
        # Virtual shared state we mutate as we commit assignments.
        vfree = cv.column("free_memory").astype(np.float64)
        vqueued = cv.column("queued").astype(np.int64)
        vbatch = cv.column("batch").astype(np.int64)
        vinflight: dict[tuple[int, int], int] = {}
        # Request-side constants: s_eff rows and tier rows.
        s_eff_rows = np.stack([
            v_s_eff(req.kv_bytes, hits[i], req.input_len)
            for i, (req, _) in enumerate(reqs)
        ])
        tier_rows = [cv.tier_row(pid) for _, pid in reqs]
        cong = {t: oracle.congestion.get(t, 0.0) for t in TIERS}
        remaining = list(range(n))

        while remaining:
            # Shared load terms under the current virtual state (one pass).
            t_iter = v_iter_time(self.iter_model, vbatch)
            blocked = np.maximum(0, vqueued - (self.beta_max - vbatch))
            t_queue = iter_scale * (blocked * t_iter)
            t_dec = iter_scale * v_iter_time(self.iter_model, vbatch + 1)
            # Regret-minimising pick: commit the request whose best-vs-second
            # gap is largest (it has the most to lose from waiting).
            best_pick = None  # (neg_regret, best_cost, i, slot, t_x, tier)
            for i in remaining:
                _, pid = reqs[i]
                s_eff = s_eff_rows[i]
                feas = np.flatnonzero(healthy & (vfree >= s_eff + self.m_min))
                if feas.size == 0:
                    continue
                n_by = {
                    t: (inflight.get(pid, t) if inflight is not None else 0)
                    + vinflight.get((pid, t), 0)
                    for t in TIERS
                }
                t_x = v_transfer_time(s_eff, tier_rows[i], oracle.tier_bandwidth,
                                      cong, n_by, oracle.tier_latency)
                cost = t_x + t_queue + t_dec
                cf = cost[feas]
                order = np.lexsort((ids[feas], cf))  # ties -> lowest id
                b = int(feas[order[0]])
                best_cost = float(cost[b])
                regret = (float(cf[order[1]]) - best_cost
                          if feas.size > 1 else float("inf"))
                entry = (-regret, best_cost, i, b, float(t_x[b]),
                         int(tier_rows[i][b]))
                if best_pick is None or entry < best_pick:
                    best_pick = entry
            if best_pick is None:
                break  # everything left is infeasible
            _, best_cost, i, b, t_x_b, tier = best_pick
            _, pid = reqs[i]
            s_eff_b = float(s_eff_rows[i][b])
            # Commit: mutate virtual state so later picks see the consequences.
            vfree[b] -= s_eff_b
            vbatch[b] = min(vbatch[b] + 1, self.beta_max)
            if vbatch[b] >= self.beta_max:
                vqueued[b] += 1
            vinflight[(pid, tier)] = vinflight.get((pid, tier), 0) + 1
            if inflight is not None:
                inflight.incr(pid, tier)
            out[i] = Decision(int(ids[b]), best_cost, t_x_b, tier, s_eff_b)
            remaining.remove(i)
        return out
