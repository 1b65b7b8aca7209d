# The port's own copy of repro/core/reference.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_oracles.py holds the two equal.
"""Retired per-candidate Python scoring loop — kept as the parity oracle.

This is the seed's scheduler ladder verbatim: O(|D|) Python iteration over
``CandidateState`` objects, one tie-break RNG draw per feasible candidate.
The production ladder in ``schedulers.py`` is vectorised over ``ClusterView``
and must stay *bit-identical* to this module (same winner, same ``Decision``
cost/tier/s_eff, same rejection behaviour, same RNG stream consumption) —
``tests/test_view_parity.py`` enforces it.  Benchmarks also use this loop as
the "python" baseline arm.

The single intentional divergence from the seed: ``ReferenceNetKVPredictive``
advances its EWMA predictor once per ``select`` call instead of once per
scored candidate (the seed's per-candidate update made candidate costs
depend on their scan position — an artifact, not a design).  The vectorised
``NetKVPredictive`` implements the same once-per-select semantics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .cost import (
    IterTimeModel,
    effective_transfer_bytes,
    first_decode_time,
    queue_time,
    transfer_time,
)
from .oracle import OracleView, SelfContentionTracker, EWMACongestionPredictor, TIERS
from .schedulers import CandidateState, Decision, RequestInfo


class ReferenceScheduler:
    """Base: feasibility filter + shared component models (seed semantics)."""

    name = "base"
    uses_tier = False
    uses_self_contention = False
    uses_congestion = False

    def __init__(self, iter_model: IterTimeModel, beta_max: int,
                 m_min: float = 2 * 1024**3, seed: int = 0):
        self.iter_model = iter_model
        self.beta_max = beta_max
        self.m_min = m_min
        self._rng = np.random.default_rng(seed + 0xC0FFEE)

    def _tie(self) -> float:
        return float(self._rng.random())

    def _s_eff(self, req: RequestInfo, cand: CandidateState) -> float:
        return effective_transfer_bytes(req.kv_bytes, cand.hit_tokens, req.input_len)

    def feasible(self, req: RequestInfo, cands: Sequence[CandidateState]):
        return [
            c for c in cands
            if c.healthy and c.free_memory >= self._s_eff(req, c) + self.m_min
        ]

    def _t_queue(self, cand: CandidateState) -> float:
        return cand.iter_scale * queue_time(
            cand.queued, cand.batch_size, self.beta_max, self.iter_model
        )

    def _t_decode(self, cand: CandidateState) -> float:
        return cand.iter_scale * first_decode_time(cand.batch_size, self.iter_model)

    def _xfer(self, req, cand, prefill_id, oracle, inflight):
        tier = oracle.tier_of(prefill_id, cand.instance_id)
        s_eff = self._s_eff(req, cand)
        c = self._congestion(oracle, tier)
        n = self._n_inflight(inflight, prefill_id, tier)
        t = transfer_time(
            s_eff, oracle.tier_bandwidth[tier], c, n, oracle.tier_latency[tier]
        )
        return t, tier, s_eff

    def _congestion(self, oracle: OracleView, tier: int) -> float:
        return oracle.congestion.get(tier, 0.0) if self.uses_congestion else 0.0

    def _n_inflight(self, inflight, prefill_id, tier) -> int:
        if self.uses_self_contention and inflight is not None:
            return inflight.get(prefill_id, tier)
        return 0

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        raise NotImplementedError


class ReferenceRoundRobin(ReferenceScheduler):
    name = "rr"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._next = 0

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        feas = self.feasible(req, cands)
        if not feas:
            return None
        feas.sort(key=lambda c: c.instance_id)
        cand = feas[self._next % len(feas)]
        self._next += 1
        tier = oracle.tier_of(prefill_id, cand.instance_id)
        return Decision(cand.instance_id, 0.0, 0.0, tier, self._s_eff(req, cand))


class ReferenceLoadAware(ReferenceScheduler):
    name = "la"

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        feas = self.feasible(req, cands)
        if not feas:
            return None
        best = min(feas, key=lambda c: (self._t_queue(c) + self._t_decode(c), self._tie()))
        tier = oracle.tier_of(prefill_id, best.instance_id)
        return Decision(
            best.instance_id,
            self._t_queue(best) + self._t_decode(best),
            0.0,
            tier,
            self._s_eff(req, best),
        )


class ReferenceCacheAware(ReferenceScheduler):
    name = "ca"

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        feas = self.feasible(req, cands)
        if not feas:
            return None
        best = min(
            feas,
            key=lambda c: (-c.hit_tokens, self._t_queue(c) + self._t_decode(c), self._tie()),
        )
        tier = oracle.tier_of(prefill_id, best.instance_id)
        return Decision(best.instance_id, -best.hit_tokens, 0.0, tier, self._s_eff(req, best))


class ReferenceCacheLoadAware(ReferenceScheduler):
    name = "cla"

    def __init__(self, *args, w_cache: float = 1.0, w_load: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.w_cache = w_cache
        self.w_load = w_load

    def _score(self, req: RequestInfo, cand: CandidateState) -> float:
        miss = 1.0 - min(cand.hit_tokens, req.input_len) / max(req.input_len, 1)
        load = (self._t_queue(cand) + self._t_decode(cand)) / self.iter_model(self.beta_max)
        return self.w_cache * miss + self.w_load * load

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        feas = self.feasible(req, cands)
        if not feas:
            return None
        best = min(feas, key=lambda c: (self._score(req, c), self._tie()))
        tier = oracle.tier_of(prefill_id, best.instance_id)
        return Decision(
            best.instance_id, self._score(req, best), 0.0, tier, self._s_eff(req, best)
        )


class ReferenceNetKVFull(ReferenceScheduler):
    name = "netkv-full"
    uses_tier = True
    uses_self_contention = True
    uses_congestion = True

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        feas = self.feasible(req, cands)
        if not feas:
            return None
        best, best_cost, best_x, best_tier, best_seff = None, float("inf"), 0.0, 0, 0.0
        best_tie = 2.0
        for c in feas:
            t_x, tier, s_eff = self._xfer(req, c, prefill_id, oracle, inflight)
            cost = t_x + self._t_queue(c) + self._t_decode(c)
            tie = self._tie()
            if cost < best_cost or (cost == best_cost and tie < best_tie):
                best, best_cost, best_x, best_tier, best_seff = c, cost, t_x, tier, s_eff
                best_tie = tie
        assert best is not None
        if inflight is not None:
            inflight.incr(prefill_id, best_tier)
        return Decision(best.instance_id, best_cost, best_x, best_tier, best_seff)


class ReferenceNetKVStatic(ReferenceNetKVFull):
    name = "netkv-static"
    uses_congestion = False


class ReferenceNetKVTopoOnly(ReferenceNetKVFull):
    name = "netkv-topo"
    uses_self_contention = False
    uses_congestion = False

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        return super().select(req, prefill_id, cands, oracle, inflight=None)


class ReferenceNetKVPredictive(ReferenceNetKVFull):
    name = "netkv-pred"

    def __init__(self, *args, predictor: EWMACongestionPredictor | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.predictor = predictor or EWMACongestionPredictor()

    def _congestion(self, oracle: OracleView, tier: int) -> float:
        return self.predictor.predict(tier)

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        self.predictor.update(oracle.congestion)  # once per decision
        return super().select(req, prefill_id, cands, oracle, inflight)


REFERENCE_LADDER = {
    "rr": ReferenceRoundRobin,
    "la": ReferenceLoadAware,
    "ca": ReferenceCacheAware,
    "cla": ReferenceCacheLoadAware,
    "netkv-topo": ReferenceNetKVTopoOnly,
    "netkv-static": ReferenceNetKVStatic,
    "netkv-full": ReferenceNetKVFull,
    "netkv-pred": ReferenceNetKVPredictive,
}


def make_reference_scheduler(name: str, iter_model: IterTimeModel, beta_max: int,
                             **kw) -> ReferenceScheduler:
    try:
        cls = REFERENCE_LADDER[name]
    except KeyError:
        raise ValueError(
            f"unknown reference scheduler {name!r}; known: {sorted(REFERENCE_LADDER)}"
        )
    return cls(iter_model, beta_max, **kw)
