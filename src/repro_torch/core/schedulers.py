# The port's own copy of repro/core/schedulers.py.  It differs only in the
# kernel hook (``backend="kernel"``).
"""Decode-instance selection policies (Algorithm 1 + the baseline ladder),
vectorised over the ``ClusterView`` struct-of-arrays state plane.

Every policy is a *scorer plugin* with the same call signature, mirroring the
paper's deployment story (llm-d Endpoint Picker scorer chain / Dynamo KV
router scoring fn).  The ladder, in ablation order (§VI-H):

  RoundRobin        -> no signal
  LoadAware         -> T_queue + T_decode
  CacheAware        -> max prefix hit, load tiebreak
  CacheLoadAware    -> tuned w_cache/w_load composite (Mooncake Conductor /
                       llm-d composite scorer equivalent; "CLA*")
  NetKVTopoOnly     -> CLA* + static tier map (B_tau, L_tau)
  NetKVStatic       -> + self-contention counter n_inflight^tau(p)
  NetKVFull         -> + dynamic congestion c_tau (Algorithm 1 complete)
  NetKVPredictive   -> beyond paper: EWMA one-step congestion forecast
  NetKVBatch        -> beyond paper: batch-level joint assignment (§VII-C
                       'future work'), see batch_assign.py

Scoring is one pass of NumPy array ops over the view's columns — feasibility
mask, s_eff, T_xfer, T_queue, T_decode as Eq. (2)-(7) vectors — instead of a
per-candidate Python loop; ``NetKVFull(backend="kernel")`` routes the fused
Eq. (2)-(7) + argmin through the ``netkv_score_cohort`` CUDA kernel (its
plain PyTorch version when ``device="cpu"``).  Decisions, rejection
behaviour, and deterministic tie-breaking are those of ``repro.core.
schedulers``, of which this module is the port's copy
(tests/test_torch_serving.py).  ``select`` accepts either a maintained
``ClusterView`` or a legacy ``CandidateState`` sequence (coerced).

All policies share the same feasibility filter (line 1 of Alg. 1) and return
``None`` to signal rejection (line 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .cost import (
    IterTimeModel,
    deflected_cost,
    effective_bandwidth_tiers,
    transfer_time,
)
from .oracle import OracleView, SelfContentionTracker, EWMACongestionPredictor, TIERS
from .view import ROLE_DECODE, ClusterView, as_cluster_view


@dataclasses.dataclass
class CandidateState:
    """Scheduler-visible state of one decode instance (§III-C).

    Retained as the row-at-a-time compatibility type: ``select`` coerces a
    sequence of these into a one-shot ``ClusterView``.  The simulator itself
    maintains a columnar view and never builds these.
    """

    instance_id: int
    free_memory: float          # m_d, bytes
    queued: int                 # q_d
    batch_size: int             # beta_d
    hit_tokens: float           # lambda_r(d) for the *current* request
    healthy: bool = True
    iter_scale: float = 1.0     # straggler EWMA multiplier (1.0 = nominal)


@dataclasses.dataclass
class RequestInfo:
    """What the scheduler knows about a request at selection time.

    Under streamed chunked prefill (``SimConfig.kv_streaming``) selection
    happens at *first-chunk* readiness, and the two extra fields describe
    the prefill/transfer overlap the network term may credit: bytes keep
    becoming ready for ``prefill_remaining`` more seconds, and only the
    final ``tail_bytes`` are forced to cross the wire after that.  Both
    default to the serial (no-overlap) values, leaving every legacy code
    path bit-identical.
    """

    request_id: int
    input_len: int
    kv_bytes: float             # s_r (Eq. 1), aggregate across TP shards
    prefill_remaining: float = 0.0   # s of prefill still to run (streaming)
    tail_bytes: float | None = None  # final-chunk bytes (None = all of s_eff)


@dataclasses.dataclass
class Decision:
    instance_id: int
    cost: float                 # policy-internal score of the winner
    est_transfer_time: float    # seconds, 0 for network-oblivious policies
    tier: int
    s_eff: float                # effective bytes to move


def _runner_up(idx: np.ndarray, ties: np.ndarray, keys: tuple) -> int:
    """Full-space index of the *second* candidate under the ladder's
    ``(keys..., ties)`` stable lexsort order, or -1 with a lone candidate.

    ``keys`` are idx-space arrays in ``np.lexsort`` order (primary last).
    Computed only on sampled forensics decisions; both dispatch modes pass
    the same key vectors and tie draws, so the runner-up is bit-identical
    whether the winner came from ``select()`` or ``CohortSelector``."""
    if idx.size < 2:
        return -1
    order = np.lexsort((ties,) + keys)
    return int(idx[order[1]])


# --------------------------------------------------------------------------
# Vectorised cost components: Eq. (2)-(7) as array ops over view columns.
# Operation order matches the scalar helpers in cost.py exactly so results
# stay bit-identical to the per-candidate reference loop.
# --------------------------------------------------------------------------

def v_iter_time(iter_model: IterTimeModel, beta: np.ndarray) -> np.ndarray:
    """t_iter(beta) elementwise, including the optional piecewise segments."""
    t = iter_model.a + iter_model.b * np.maximum(beta, 0.0)
    for brk, slope in zip(iter_model.breaks, iter_model.slopes):
        t = np.where(beta > brk, t + slope * (beta - brk), t)
    return t


def v_s_eff(kv_bytes: float, hit_tokens: np.ndarray, input_len: int) -> np.ndarray:
    """Eq. (2): s_eff = s_r * (1 - lambda/l), hit clamped to [0, l]."""
    if input_len <= 0:
        return np.zeros_like(hit_tokens)
    l = float(input_len)
    frac = np.minimum(np.maximum(hit_tokens, 0.0), l) / l
    return kv_bytes * (1.0 - frac)


def v_transfer_time(
    s_eff: np.ndarray,
    tier_row: np.ndarray,
    tier_bandwidth,
    congestion_by_tier,
    n_by_tier,
    tier_latency,
    prefill_remaining: float = 0.0,
    tail_bytes: float | None = None,
) -> np.ndarray:
    """Eq. (3)-(4) gathered through the per-candidate tier row.

    Per-tier effective bandwidths are computed with the scalar cost.py
    helper (4 values), then gathered — identical arithmetic to the loop.

    With ``prefill_remaining``/``tail_bytes`` set (streamed chunked
    prefill), the column credits the prefill/transfer overlap per
    candidate — ``max(s_eff/B_eff, prefill_remaining + tail/B_eff)`` with
    the tail clamped to each candidate's s_eff (a deep prefix hit shrinks
    the tail too); the defaults leave the serial op sequence untouched
    (bit-identical to the reference loop).
    """
    beff = effective_bandwidth_tiers(tier_bandwidth, congestion_by_tier, n_by_tier)
    lat = np.array([tier_latency[t] for t in TIERS], np.float64)
    lat_row = lat[tier_row]
    if prefill_remaining > 0.0 or tail_bytes is not None:
        b_row = beff[tier_row]
        tail = s_eff if tail_bytes is None else \
            np.minimum(np.maximum(tail_bytes, 0.0), s_eff)
        t_stream = np.maximum(s_eff / b_row, prefill_remaining + tail / b_row)
        return np.where(s_eff <= 0.0, lat_row, t_stream + lat_row)
    return np.where(s_eff <= 0.0, lat_row, s_eff / beff[tier_row] + lat_row)


class Scheduler:
    """Base: feasibility mask + shared vectorised component models."""

    name = "base"
    uses_tier = False            # static tier map
    uses_self_contention = False
    uses_congestion = False

    def __init__(self, iter_model: IterTimeModel, beta_max: int, m_min: float = 2 * 1024**3,
                 seed: int = 0):
        self.iter_model = iter_model
        self.beta_max = beta_max
        self.m_min = m_min
        # Unbiased deterministic tie-breaking: scoring ties must not collapse
        # onto low instance ids (that would topology-bias network-oblivious
        # policies, since ids order pods).  One draw per feasible candidate,
        # in candidate order — the same RNG stream the reference loop reads.
        self._rng = np.random.default_rng(seed + 0xC0FFEE)
        # TracePlane decision-forensics hook (``sim/trace.py``); None keeps
        # every select path allocation-free.  Both dispatch modes call
        # ``want_decision()`` once per decision so sampling stays aligned.
        self.trace_hook = None

    def _ties(self, k: int) -> np.ndarray:
        return self._rng.random(k)

    def _note_decision(self, kind, req, prefill_id, cv, oracle, tier_fn,
                       j, j2, *, cost=None, cache=None, load=None, xfer=None):
        """Record one sampled forensics row: winner ``j`` vs runner-up
        ``j2`` (full-space indices, -1 = none), components as full-space
        vectors.  Scalar extraction is synchronous, so reused view scratch
        buffers are safe to pass; congestion is read from the *raw* oracle
        snapshot — never ``_congestion_by_tier``, whose predictive
        override advances an EWMA per call."""
        def pair(vec):
            if vec is None:
                return 0.0, 0.0
            return float(vec[j]), (float(vec[j2]) if j2 >= 0 else float("nan"))

        cost_w, cost_r = pair(cost)
        cache_w, cache_r = pair(cache)
        load_w, load_r = pair(load)
        xfer_w, xfer_r = pair(xfer)
        tier_w = tier_fn(j)
        tier_r = tier_fn(j2) if j2 >= 0 else -1
        self.trace_hook.decision(
            kind, req.request_id, prefill_id,
            int(cv.ids[j]), int(cv.ids[j2]) if j2 >= 0 else -1,
            tier_w, tier_r, float(oracle.congestion.get(tier_w, 0.0)),
            cost_w, cost_r, cache_w, cache_r, load_w, load_r,
            xfer_w, xfer_r)

    def _oracle_tier_fn(self, cv, oracle, prefill_id):
        return lambda jj: oracle.tier_of(prefill_id, int(cv.ids[jj]))

    # -- shared vector components -------------------------------------------
    def _prep(self, req: RequestInfo, cv: ClusterView):
        """(s_eff vector, feasibility mask) — line 1 of Alg. 1.

        Candidates are the ROLE_DECODE rows of the unified instance axis;
        with every row decode (no flips) the role term is all-True and the
        mask is bit-identical to the pre-RolePlane two-pool filter.
        """
        s_eff = v_s_eff(req.kv_bytes, cv.column("hit_tokens"), req.input_len)
        mask = cv.column("healthy") & (cv.column("role") == ROLE_DECODE) \
            & (cv.column("free_memory") >= s_eff + self.m_min)
        return s_eff, mask

    def _t_queue_vec(self, cv: ClusterView) -> np.ndarray:
        """Eq. (6) scaled by the straggler estimate."""
        beta = cv.column("batch")
        blocked = np.maximum(0, cv.column("queued") - (self.beta_max - beta))
        return cv.column("iter_scale") * (blocked * v_iter_time(self.iter_model, beta))

    def _t_decode_vec(self, cv: ClusterView) -> np.ndarray:
        """Eq. (7) scaled by the straggler estimate."""
        return cv.column("iter_scale") * v_iter_time(self.iter_model, cv.column("batch") + 1)

    def _congestion_by_tier(self, oracle: OracleView) -> dict[int, float]:
        if self.uses_congestion:
            return {t: oracle.congestion.get(t, 0.0) for t in TIERS}
        return {t: 0.0 for t in TIERS}

    def _n_by_tier(self, inflight: Optional[SelfContentionTracker],
                   prefill_id: int) -> dict[int, int]:
        if self.uses_self_contention and inflight is not None:
            return {t: inflight.get(prefill_id, t) for t in TIERS}
        return {t: 0 for t in TIERS}

    def _xfer_vec(self, req, cv, prefill_id, oracle, inflight, s_eff, tier_row):
        """T_xfer vector under this policy's information set."""
        return v_transfer_time(
            s_eff, tier_row, oracle.tier_bandwidth,
            self._congestion_by_tier(oracle), self._n_by_tier(inflight, prefill_id),
            oracle.tier_latency,
            prefill_remaining=req.prefill_remaining,
            tail_bytes=req.tail_bytes,
        )

    # -- interface ----------------------------------------------------------
    def select(
        self,
        req: RequestInfo,
        prefill_id: int,
        cands,  # ClusterView | Sequence[CandidateState]
        oracle: OracleView,
        inflight: Optional[SelfContentionTracker] = None,
    ) -> Optional[Decision]:
        raise NotImplementedError

    def select_cohort(
        self,
        items,  # Sequence[dispatch.CohortItem]
        cands,  # ClusterView | Sequence[CandidateState]
        oracle: OracleView,
        inflight: Optional[SelfContentionTracker] = None,
        *,
        hit_matrix,
        hit_fn=None,
        evictions_fn=None,
    ):
        """Batched R-request selection (DispatchPlane, ``core/dispatch.py``).

        Returns a ``CohortSelector`` whose ``select_row(k)`` walk is
        bit-identical — decisions, RNG tie-break stream, side effects — to
        R sequential ``select`` calls against the live view.
        """
        from .dispatch import CohortSelector  # cycle-free late import

        return CohortSelector(
            self, items, as_cluster_view(cands, oracle), oracle, inflight,
            hit_matrix=hit_matrix, hit_fn=hit_fn, evictions_fn=evictions_fn,
        )

    # -- prefill deflection (RolePlane) -------------------------------------
    def select_deflected(self, req: RequestInfo, cands,
                         deflect_eta) -> Optional[Decision]:
        """Score ROLE_DECODE rows as *prefill* targets (deflection).

        The KV is born on the decode host, so Eq. (4) collapses — no wire,
        no tier gather, no self-contention bump; the network term of the
        objective is replaced by the target's deflected-chunk-queue drain
        ETA (``deflect_eta``, relative seconds) and the decode-side
        Eq. (6)/(7) load stays (``core/cost.py::deflected_cost``).
        Feasibility requires room for the request's *full* KV (it
        materialises locally, nothing is prefix-elided): ``m_d >= s_r +
        m_min``.  One RNG tie draw per feasible candidate, same stream as
        ``select`` — with deflection off this is never called and the
        stream is untouched.
        """
        cv = as_cluster_view(cands)
        eta = np.asarray(deflect_eta, np.float64)
        mask = cv.column("healthy") & (cv.column("role") == ROLE_DECODE) \
            & (cv.column("free_memory") >= req.kv_bytes + self.m_min)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        cost = deflected_cost(eta, self._t_queue_vec(cv) + self._t_decode_vec(cv))
        ties = self._ties(idx.size)
        j = int(idx[np.lexsort((ties, cost[idx]))[0]])
        return Decision(int(cv.ids[j]), float(cost[j]), 0.0, 0, 0.0)


class RoundRobin(Scheduler):
    name = "rr"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._next = 0

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        ord_ids = np.argsort(cv.ids[idx])
        pos = self._next % idx.size
        j = int(idx[ord_ids[pos]])
        self._next += 1
        iid = int(cv.ids[j])
        tier = oracle.tier_of(prefill_id, iid)
        h = self.trace_hook
        if h is not None and h.want_decision():
            # rr's "runner-up" is the next cursor position.
            j2 = int(idx[ord_ids[(pos + 1) % idx.size]]) if idx.size > 1 else -1
            self._note_decision("rr", req, prefill_id, cv, oracle,
                                self._oracle_tier_fn(cv, oracle, prefill_id),
                                j, j2, cache=cv.column("hit_tokens"))
        return Decision(iid, 0.0, 0.0, tier, float(s_eff[j]))


class LoadAware(Scheduler):
    """min T_queue + T_decode."""

    name = "la"

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        load = self._t_queue_vec(cv) + self._t_decode_vec(cv)
        ties = self._ties(idx.size)
        j = int(idx[np.lexsort((ties, load[idx]))[0]])
        iid = int(cv.ids[j])
        tier = oracle.tier_of(prefill_id, iid)
        h = self.trace_hook
        if h is not None and h.want_decision():
            self._note_decision("la", req, prefill_id, cv, oracle,
                                self._oracle_tier_fn(cv, oracle, prefill_id),
                                j, _runner_up(idx, ties, (load[idx],)),
                                cost=load, cache=cv.column("hit_tokens"),
                                load=load)
        return Decision(iid, float(load[j]), 0.0, tier, float(s_eff[j]))


class CacheAware(Scheduler):
    """max prefix hit length, load as tiebreaker."""

    name = "ca"

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        neg_hit = -cv.column("hit_tokens")
        load = self._t_queue_vec(cv) + self._t_decode_vec(cv)
        ties = self._ties(idx.size)
        j = int(idx[np.lexsort((ties, load[idx], neg_hit[idx]))[0]])
        iid = int(cv.ids[j])
        tier = oracle.tier_of(prefill_id, iid)
        h = self.trace_hook
        if h is not None and h.want_decision():
            self._note_decision("ca", req, prefill_id, cv, oracle,
                                self._oracle_tier_fn(cv, oracle, prefill_id),
                                j, _runner_up(idx, ties,
                                              (load[idx], neg_hit[idx])),
                                cost=neg_hit, cache=cv.column("hit_tokens"),
                                load=load)
        return Decision(iid, float(neg_hit[j]), 0.0, tier, float(s_eff[j]))


class CacheLoadAware(Scheduler):
    """CLA*: w_cache * miss_frac + w_load * normalised load (tuned weights).

    Matches the scoring component of Mooncake's Conductor and llm-d's
    composite scorer; weights per workload from a grid search (§VI-A).
    """

    name = "cla"

    def __init__(self, *args, w_cache: float = 1.0, w_load: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.w_cache = w_cache
        self.w_load = w_load

    def _score_vec(self, req: RequestInfo, cv: ClusterView) -> np.ndarray:
        miss = 1.0 - np.minimum(cv.column("hit_tokens"), req.input_len) / max(req.input_len, 1)
        load = (self._t_queue_vec(cv) + self._t_decode_vec(cv)) / self.iter_model(self.beta_max)
        return self.w_cache * miss + self.w_load * load

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        score = self._score_vec(req, cv)
        ties = self._ties(idx.size)
        j = int(idx[np.lexsort((ties, score[idx]))[0]])
        iid = int(cv.ids[j])
        tier = oracle.tier_of(prefill_id, iid)
        h = self.trace_hook
        if h is not None and h.want_decision():
            # Same normalised-load expression the cohort selector caches.
            loadn = (self._t_queue_vec(cv) + self._t_decode_vec(cv)) \
                / self.iter_model(self.beta_max)
            self._note_decision("cla", req, prefill_id, cv, oracle,
                                self._oracle_tier_fn(cv, oracle, prefill_id),
                                j, _runner_up(idx, ties, (score[idx],)),
                                cost=score, cache=cv.column("hit_tokens"),
                                load=loadn)
        return Decision(iid, float(score[j]), 0.0, tier, float(s_eff[j]))


class NetKVFull(Scheduler):
    """Algorithm 1: C[d] = T_xfer + T_queue + T_decode, full oracle.

    ``backend="numpy"`` (default) evaluates Eq. (2)-(7) as one pass of f64
    array ops — bit-identical to the reference loop.  ``backend="kernel"``
    routes the fused scoring + masked argmin through ``netkv_score_cohort``
    with one cohort row (f32, lowest-index tie-break) on ``device``: the
    CUDA kernel on ``"cuda"`` (the default), its plain PyTorch version on
    ``"cpu"``.  Parity on the winner is asserted with a cost tolerance.
    """

    name = "netkv-full"
    uses_tier = True
    uses_self_contention = True
    uses_congestion = True

    def __init__(self, *args, backend: str = "numpy", device=None, **kwargs):
        super().__init__(*args, **kwargs)
        if backend not in ("numpy", "kernel"):
            raise ValueError(f"unknown scoring backend {backend!r}")
        if backend == "kernel" and self.iter_model.breaks:
            raise ValueError("kernel backend supports linear iter models only")
        self.backend = backend
        self.device = None
        if backend == "kernel":
            from ..kernels.build import resolve_device

            self.device = resolve_device(device)

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        cv = as_cluster_view(cands, oracle)
        s_eff, mask = self._prep(req, cv)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        tier_row = cv.tier_row(prefill_id)
        if self.backend == "kernel" and req.prefill_remaining <= 0.0 \
                and req.tail_bytes is None:
            # The fused kernel evaluates the serial Eq. (3); streamed-chunk
            # decisions (overlap-aware T_xfer) take the NumPy path.
            return self._select_kernel(
                req, prefill_id, cv, oracle, inflight, s_eff, tier_row)
        t_x = self._xfer_vec(req, cv, prefill_id, oracle, inflight, s_eff, tier_row)
        t_q = self._t_queue_vec(cv)
        t_d = self._t_decode_vec(cv)
        cost = t_x + t_q + t_d
        ties = self._ties(idx.size)
        j = int(idx[np.lexsort((ties, cost[idx]))[0]])
        best_tier = int(tier_row[j])
        if inflight is not None:
            inflight.incr(prefill_id, best_tier)  # line 14; decremented on done
        h = self.trace_hook
        if h is not None and h.want_decision():
            self._note_decision(self.name, req, prefill_id, cv, oracle,
                                lambda jj: int(tier_row[jj]),
                                j, _runner_up(idx, ties, (cost[idx],)),
                                cost=cost, cache=cv.column("hit_tokens"),
                                load=t_q + t_d, xfer=t_x)
        return Decision(int(cv.ids[j]), float(cost[j]), float(t_x[j]),
                        best_tier, float(s_eff[j]))

    # -- kernel scoring path ------------------------------------------------
    def _select_kernel(self, req, prefill_id, cv, oracle, inflight, s_eff, tier_row):
        from ..kernels.netkv_score import BIG, score_cohort_snapshot

        cong = self._congestion_by_tier(oracle)
        nfl = self._n_by_tier(inflight, prefill_id)
        _, res = score_cohort_snapshot(
            cv.column("free_memory"), cv.column("queued"), cv.column("batch"),
            cv.column("hit_tokens"), tier_row,
            cv.column("healthy") & (cv.column("role") == ROLE_DECODE),
            cv.column("iter_scale"),
            [oracle.tier_bandwidth[t] for t in TIERS],
            [oracle.tier_latency[t] for t in TIERS],
            [cong[t] for t in TIERS], [[nfl[t] for t in TIERS]],
            s_r=[req.kv_bytes], input_len=[req.input_len],
            iter_a=self.iter_model.a, iter_b=self.iter_model.b,
            m_min=self.m_min, beta_max=self.beta_max, device=self.device,
        )
        j = int(res[0, 0])
        best_cost = float(res[0].view(np.float32)[1])
        if not best_cost < BIG / 2:  # all candidates masked infeasible
            return None
        tier = int(tier_row[j])
        se = float(s_eff[j])
        # Decision bookkeeping fields at f64 through the scalar cost model.
        t_x = transfer_time(se, oracle.tier_bandwidth[tier], cong[tier],
                            nfl[tier], oracle.tier_latency[tier])
        if inflight is not None:
            inflight.incr(prefill_id, tier)
        h = self.trace_hook
        if h is not None and h.want_decision():
            self._note_kernel(req, prefill_id, cv, oracle, tier_row, s_eff,
                              cv.column("hit_tokens"), res[0], cong, nfl, t_x)
        return Decision(int(cv.ids[j]), best_cost, t_x, tier, se)

    def _note_kernel(self, req, prefill_id, cv, oracle, tier_row, s_eff,
                     hit, res_row, cong, nfl, t_x_w):
        """Forensics row for a kernel-scored decision, from the kernel's
        packed result row: winner ``j`` and runner-up ``j2``, the first
        argmin of its f32 cost row with ``j`` masked (-1 when that is
        infeasible).  Shared with the cohort selector's cached-row path so
        both dispatch modes record identical rows."""
        c = res_row.view(np.float32)
        j, j2 = int(res_row[0]), int(res_row[2])
        cost = {j: float(c[1]), j2: float(c[3])}
        xfer_r = float("nan")
        if j2 >= 0:
            tier_r = int(tier_row[j2])
            xfer_r = transfer_time(
                float(s_eff[j2]), oracle.tier_bandwidth[tier_r], cong[tier_r],
                nfl[tier_r], oracle.tier_latency[tier_r])
        # The kernel does not materialise T_queue/T_decode separately;
        # record load as the cost with the (f64-recomputed) T_xfer removed.
        # Only entries j and j2 are read (``_note_decision`` takes any
        # index-addressed vector).
        xvec = {j: t_x_w, j2: xfer_r}
        lvec = {j: cost[j] - t_x_w, j2: cost[j2] - xfer_r}
        self._note_decision(self.name, req, prefill_id, cv, oracle,
                            lambda jj_: int(tier_row[jj_]), j, j2,
                            cost=cost, cache=hit, load=lvec, xfer=xvec)


class NetKVStatic(NetKVFull):
    """Static tier map + self-contention, congestion withheld ('+Self-cont.')."""

    name = "netkv-static"
    uses_congestion = False


class NetKVTopoOnly(NetKVFull):
    """Static tier map only ('+Static' ablation rung)."""

    name = "netkv-topo"
    uses_self_contention = False
    uses_congestion = False

    def select(self, req, prefill_id, cands, oracle, inflight=None):
        # No n_inflight bookkeeping at all on this rung.
        return super().select(req, prefill_id, cands, oracle, inflight=None)


class NetKVPredictive(NetKVFull):
    """Beyond paper: consume an EWMA forecast instead of the raw snapshot."""

    name = "netkv-pred"

    def __init__(self, *args, predictor: EWMACongestionPredictor | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.predictor = predictor or EWMACongestionPredictor()

    def _congestion_by_tier(self, oracle: OracleView) -> dict[int, float]:
        self.predictor.update(oracle.congestion)  # one step per decision
        return {t: self.predictor.predict(t) for t in TIERS}


LADDER = {
    "rr": RoundRobin,
    "la": LoadAware,
    "ca": CacheAware,
    "cla": CacheLoadAware,
    "netkv-topo": NetKVTopoOnly,
    "netkv-static": NetKVStatic,
    "netkv-full": NetKVFull,
    "netkv-pred": NetKVPredictive,
}


def make_scheduler(name: str, iter_model: IterTimeModel, beta_max: int, **kw) -> Scheduler:
    try:
        cls = LADDER[name]
    except KeyError:
        from .batch_assign import NetKVBatch  # cycle-free late import

        if name == "netkv-batch":
            return NetKVBatch(iter_model, beta_max, **kw)
        raise ValueError(f"unknown scheduler {name!r}; known: {sorted(LADDER) + ['netkv-batch']}")
    return cls(iter_model, beta_max, **kw)
