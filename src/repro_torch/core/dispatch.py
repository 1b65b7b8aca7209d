# The port's own copy of repro/core/dispatch.py.  It differs only in the kernel
# hook (``backend="kernel"``); tests/test_torch_sim.py holds the two equal.
"""DispatchPlane: cohort-batched decode selection with fused R x D scoring.

EventPlane delivers dispatch-ready requests in same-timestamp cohorts
(arrival bursts, epoch-batched transfer completions, chunk-ready streams),
but the scheduler was once invoked per request: every dispatch
re-ran a ``RadixPlane.hit_row``, rebuilt the Eq. (6)/(7) load columns, and
paid a D log D ``lexsort`` — the last per-event Python hot path at
2048-4096 GPUs.  ``CohortSelector`` amortises all of it over the cohort:

* ONE stacked ``hit_rows`` call builds the (R, n) prefix-hit matrix H
  (``sim/kvcache.py``; shared prefixes across the cohort dedupe to one
  broadcast LCP each),
* s_eff, T_queue, T_decode and T_xfer are evaluated as R x D matrices in
  one broadcast pass per prefill-source group (queue/batch/straggler
  columns are *cohort-invariant*: nothing enqueues or admits between the
  argmin rows of one cohort, so Eq. (6)/(7) are computed once),
* the per-row winner is a min-scan (min -> equal-cost slice -> tie argmin)
  proven order-identical to the ladder's stable ``lexsort``,
* between rows only the *winning column* moves (memory pinned at reserve,
  self-contention +1, reserve-time cache eviction), so each assignment
  applies an O(1) delta — ``ClusterView.apply_assignment`` for external
  drivers, eviction-counter watches + per-source inflight invalidation
  internally — instead of a full re-score.

**Bit-exactness is the contract**, same as every prior plane: walking
``select_row(0..R-1)`` produces the identical ``Decision`` stream —
including the RNG tie-break draws, ``RoundRobin._next`` cursor,
``SelfContentionTracker`` increments and ``NetKVPredictive`` EWMA updates —
as R sequential ``Scheduler.select`` calls against the live view.  Rows
whose precomputed scores a delta invalidated (a reserve-time eviction
changed their hit row, or an earlier same-source assignment bumped
n_inflight) recompute through the scheduler's own vector helpers at their
turn, so the fallback *is* the sequential op sequence.  The per-request
path stays available as ``SimConfig.dispatch_mode="reference"``.

``netkv-full(backend="kernel")`` rows score through the ``netkv_score_cohort``
kernel (``kernels/netkv_score.py``), R rows in one launch on the
scheduler's device, computed once on the snapshot; a row falls back to the
single-row kernel only if a later assignment flipped any candidate's f32
feasibility bit for that row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .cost import deflected_cost, effective_bandwidth_tiers, transfer_time
from .oracle import OracleView, SelfContentionTracker, TIERS
from .schedulers import (
    CacheAware,
    CacheLoadAware,
    Decision,
    LoadAware,
    NetKVFull,
    NetKVPredictive,
    NetKVStatic,
    NetKVTopoOnly,
    RequestInfo,
    RoundRobin,
    Scheduler,
    _runner_up,
)
from .view import ROLE_DECODE, ClusterView

__all__ = ["CohortItem", "CohortSelector", "DeflectedCohortSelector",
           "supports_cohort"]

# Exact-type -> scoring shape.  Subclasses of the ladder types are not
# assumed to keep the parent's op sequence, so membership is by type.
_KIND = {
    RoundRobin: "rr",
    LoadAware: "la",
    CacheAware: "ca",
    CacheLoadAware: "cla",
    NetKVTopoOnly: "netkv",
    NetKVStatic: "netkv",
    NetKVFull: "netkv",
    NetKVPredictive: "netkv",
}


def supports_cohort(sched: Scheduler) -> bool:
    """True when ``sched`` has a bit-exact cohort path.

    Exact ladder types only: netkv-batch's windowed joint assigner and the
    staged multihop scheduler run their own batching and fall back to the
    per-request dispatch path.
    """
    return type(sched) in _KIND


@dataclasses.dataclass
class CohortItem:
    """One dispatch-ready request inside a same-timestamp cohort."""

    req: RequestInfo
    prefill_id: int


def _pick_min(idx: np.ndarray, key: np.ndarray, ties: np.ndarray) -> int:
    """argmin with RNG tie-break == ``idx[np.lexsort((ties, key[idx]))[0]]``.

    The stable lexsort's head is: minimal key, then minimal tie, then lowest
    position.  ``argmin`` returns the first occurrence, which reproduces the
    positional tie exactly; ``==`` treats -0.0 and 0.0 as equal on both
    paths.
    """
    sub = key[idx]
    pos = np.flatnonzero(sub == sub.min())
    if pos.size > 1:
        return int(idx[pos[int(np.argmin(ties[pos]))]])
    return int(idx[pos[0]])


def _pick_min2(idx: np.ndarray, k1: np.ndarray, k2: np.ndarray,
               ties: np.ndarray) -> int:
    """Two-key variant == ``idx[np.lexsort((ties, k2[idx], k1[idx]))[0]]``."""
    s1 = k1[idx]
    p1 = np.flatnonzero(s1 == s1.min())
    if p1.size == 1:
        return int(idx[p1[0]])
    s2 = k2[idx[p1]]
    p2 = p1[np.flatnonzero(s2 == s2.min())]
    if p2.size > 1:
        return int(idx[p2[int(np.argmin(ties[p2]))]])
    return int(idx[p2[0]])


class CohortSelector:
    """Batched selection over one same-timestamp dispatch cohort.

    Construct once per cohort (the R x D precompute), then call
    ``select_row(k)`` for k = 0..R-1 *in order*, dispatching each returned
    ``Decision`` before the next call (reserve/incr exactly as the
    sequential path would).  Rows may be skipped — a skipped row simply
    never draws its ties, like a request that never reached ``select``.

    ``hit_fn(k, iid)`` / ``evictions_fn(iid)`` wire the reserve-time
    eviction watch: after each assignment the selector polls the winner's
    eviction counter and refreshes the affected hit-matrix column for the
    remaining rows.  Omit both when nothing evicts between rows (pure
    benchmarks, frozen views).
    """

    def __init__(
        self,
        sched: Scheduler,
        items: Sequence[CohortItem],
        cv: ClusterView,
        oracle: OracleView,
        inflight: Optional[SelfContentionTracker] = None,
        *,
        hit_matrix: np.ndarray,
        hit_fn: Optional[Callable[[int, int], float]] = None,
        evictions_fn: Optional[Callable[[int], int]] = None,
    ) -> None:
        t0 = time.perf_counter()
        kind = _KIND.get(type(sched))
        if kind is None:
            raise ValueError(
                f"no cohort path for scheduler type {type(sched).__name__}")
        self._sched = sched
        self._items = list(items)
        self._cv = cv
        self._oracle = oracle
        self._inflight = inflight
        self._hit_fn = hit_fn
        self._evictions_fn = evictions_fn
        self._kind = kind
        R = len(self._items)
        n = cv.n
        self.H = np.asarray(hit_matrix, np.float64)
        if self.H.shape != (R, n):
            raise ValueError(f"hit_matrix shape {self.H.shape} != {(R, n)}")

        # s_eff as one broadcast: per-element identical to v_s_eff per row
        # (rows with input_len <= 0 are all-zero there, zeroed here).
        kv_col = np.array([it.req.kv_bytes for it in self._items],
                          np.float64)[:, None]
        l_vec = np.array([it.req.input_len for it in self._items], np.float64)
        l_col = np.where(l_vec > 0.0, l_vec, 1.0)[:, None]
        frac = np.minimum(np.maximum(self.H, 0.0), l_col) / l_col
        self.SE = kv_col * (1.0 - frac)
        self.SE[l_vec <= 0.0] = 0.0

        self._dirty = np.zeros(R, bool)
        self._infl_dirty: set[int] = set()
        self._watch: dict[int, tuple[int, int]] = {}   # iid -> (slot, count)
        self._load = self._loadn = None
        self._tx = None
        self._has_tx = np.zeros(R, bool)
        self._pl_result = self._pl_thr32 = None
        self._free0 = self._healthy0 = None

        if kind in ("la", "ca", "cla"):
            # Cohort-invariant Eq. (6)/(7): queue/batch/straggler columns do
            # not move between the rows of one cohort, so the sequential
            # per-select recompute yields these exact bits every time.
            load = sched._t_queue_vec(cv) + sched._t_decode_vec(cv)
            self._load = load
            if kind == "cla":
                self._loadn = load / sched.iter_model(sched.beta_max)
        elif kind == "netkv":
            self._is_pred = isinstance(sched, NetKVPredictive)
            self._kernel = sched.backend == "kernel"
            self._streamed = np.array(
                [it.req.prefill_remaining > 0.0 or it.req.tail_bytes is not None
                 for it in self._items], bool)
            self._t_q = sched._t_queue_vec(cv)
            self._t_d = sched._t_decode_vec(cv)
            if not self._is_pred:
                # NetKVPredictive's congestion read advances its EWMA — a
                # per-select side effect that must happen at each row's
                # *turn*, so pred rows always recompute (no precompute).
                self._build_netkv(R, n)
        t1 = time.perf_counter()
        self._setup_s = t1 - t0

    # ------------------------------------------------------------ netkv build
    def _build_netkv(self, R: int, n: int) -> None:
        sched = self._sched
        cv, oracle = self._cv, self._oracle
        infl = self._inflight if sched.uses_self_contention else None
        cong = sched._congestion_by_tier(oracle)
        lat = oracle.latency_array()
        # Group rows by prefill source: one tier-row gather + one Eq. (4)
        # row per source, then every cost component as a broadcast matrix.
        # Only t_x is materialised R x D; the final cost row is summed
        # lazily at each row's turn (two L2-resident O(D) adds) so skipped
        # and fallback rows never pay for it.
        by_pid: dict[int, list[int]] = {}
        for k, it in enumerate(self._items):
            by_pid.setdefault(it.prefill_id, []).append(k)
        np_rows = np.flatnonzero(~self._streamed) if self._kernel else None
        if self._kernel and np_rows is not None and np_rows.size == 0:
            np_rows = None
        self._tx = np.zeros((R, n), np.float64)
        for pid, rows in by_pid.items():
            tier_row = cv.tier_row(pid)
            beff = effective_bandwidth_tiers(
                oracle.tier_bandwidth, cong, sched._n_by_tier(infl, pid))
            lat_row = lat[tier_row]
            b_row = beff[tier_row]
            serial = [k for k in rows if not self._streamed[k]]
            if serial and not self._kernel:
                se = self.SE[serial]
                self._tx[serial] = np.where(
                    se <= 0.0, lat_row, se / b_row + lat_row)
                self._has_tx[serial] = True
            tail_none = [k for k in rows if self._streamed[k]
                         and self._items[k].req.tail_bytes is None]
            tailed = [k for k in rows if self._streamed[k]
                      and self._items[k].req.tail_bytes is not None]
            if tail_none:
                se = self.SE[tail_none]
                pr = np.array([self._items[k].req.prefill_remaining
                               for k in tail_none], np.float64)[:, None]
                t_stream = np.maximum(se / b_row, pr + se / b_row)
                self._tx[tail_none] = np.where(
                    se <= 0.0, lat_row, t_stream + lat_row)
                self._has_tx[tail_none] = True
            if tailed:
                se = self.SE[tailed]
                pr = np.array([self._items[k].req.prefill_remaining
                               for k in tailed], np.float64)[:, None]
                tb = np.array([self._items[k].req.tail_bytes
                               for k in tailed], np.float64)[:, None]
                tail = np.minimum(np.maximum(tb, 0.0), se)
                t_stream = np.maximum(se / b_row, pr + tail / b_row)
                self._tx[tailed] = np.where(
                    se <= 0.0, lat_row, t_stream + lat_row)
                self._has_tx[tailed] = True
        if self._kernel and np_rows is not None:
            self._build_kernel(np_rows, n)

    def _build_kernel(self, rows: np.ndarray, n: int) -> None:
        """Run the cohort-axis kernel once on the snapshot for the serial
        rows; snapshot free/healthy + the kernel's f32 feasibility threshold
        so later rows can prove their precomputed argmin is still live."""
        from ..kernels.netkv_score import score_cohort_snapshot

        sched, cv, oracle = self._sched, self._cv, self._oracle
        infl = self._inflight if sched.uses_self_contention else None
        cong = sched._congestion_by_tier(oracle)
        items = [self._items[int(k)] for k in rows]
        tier_rows = np.stack([cv.tier_row(it.prefill_id) for it in items])
        infl_rows = [[sched._n_by_tier(infl, it.prefill_id)[t] for t in TIERS]
                     for it in items]
        _, res = score_cohort_snapshot(
            cv.column("free_memory"), cv.column("queued"), cv.column("batch"),
            self.H[rows], tier_rows,
            cv.column("healthy") & (cv.column("role") == ROLE_DECODE),
            cv.column("iter_scale"),
            [oracle.tier_bandwidth[t] for t in TIERS],
            [oracle.tier_latency[t] for t in TIERS],
            [cong[t] for t in TIERS], infl_rows,
            s_r=[it.req.kv_bytes for it in items],
            input_len=[it.req.input_len for it in items],
            iter_a=sched.iter_model.a, iter_b=sched.iter_model.b,
            m_min=sched.m_min, beta_max=sched.beta_max, device=sched.device,
        )
        self._pl_rows = {int(k): i for i, k in enumerate(rows)}
        self._pl_result = res   # (R, 4): best, best_cost, second, second_cost
        self._free0 = cv.column("free_memory").copy()
        self._healthy0 = (cv.column("healthy")
                          & (cv.column("role") == ROLE_DECODE)).copy()
        # The kernel masks in f32: replicate its s_eff + m_min threshold so
        # feasibility flips from later reserves are detected in f32 terms.
        h32 = self.H[rows].astype(np.float32)
        l32 = np.array([it.req.input_len for it in items],
                       np.float32)[:, None]
        s32 = np.array([it.req.kv_bytes for it in items], np.float32)[:, None]
        hit = np.minimum(h32, l32)
        se32 = s32 * (np.float32(1.0) - hit / np.maximum(l32, np.float32(1.0)))
        self._pl_thr32 = se32 + np.float32(sched.m_min)

    # -------------------------------------------------------------- accounting
    def take_setup_time(self) -> float:
        """One-shot: the cohort precompute wall time (fold into row 0's
        decision latency so the per-decision metric stays comparable)."""
        s, self._setup_s = self._setup_s, 0.0
        return s

    def _watch_slot(self, iid: int) -> None:
        if self._evictions_fn is None:
            return
        self._watch[iid] = (self._cv.slot_of(iid), self._evictions_fn(iid))

    def _poll_evictions(self, k: int) -> None:
        """Reserve-time evictions on a winner shrink later rows' prefix hits
        on that slot only; refresh exactly those H/SE entries."""
        if not self._watch:
            return
        for iid, (slot, count) in list(self._watch.items()):
            cur = self._evictions_fn(iid)
            if cur == count:
                continue
            self._watch[iid] = (slot, cur)
            for r in range(k, len(self._items)):
                req = self._items[r].req
                new = float(self._hit_fn(r, iid))
                if new == self.H[r, slot]:
                    continue
                self.H[r, slot] = new
                if req.input_len > 0:
                    l = float(req.input_len)
                    self.SE[r, slot] = req.kv_bytes * (
                        1.0 - min(max(new, 0.0), l) / l)
                self._dirty[r] = True

    # ------------------------------------------------------------------ select
    def select_row(self, k: int) -> Optional[Decision]:
        """Row k's decision — bit-identical to ``sched.select`` at its turn."""
        self._poll_evictions(k)
        item = self._items[k]
        req, pid = item.req, item.prefill_id
        sched, cv, oracle = self._sched, self._cv, self._oracle
        se = self.SE[k]
        mask = cv.column("healthy") & (cv.column("role") == ROLE_DECODE) & (
            cv.column("free_memory") >= se + sched.m_min)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        kind = self._kind
        h = sched.trace_hook
        if kind == "rr":
            ord_ids = np.argsort(cv.ids[idx])
            pos = sched._next % idx.size
            j = int(idx[ord_ids[pos]])
            sched._next += 1
            iid = int(cv.ids[j])
            if h is not None and h.want_decision():
                j2 = int(idx[ord_ids[(pos + 1) % idx.size]]) \
                    if idx.size > 1 else -1
                sched._note_decision("rr", req, pid, cv, oracle,
                                     sched._oracle_tier_fn(cv, oracle, pid),
                                     j, j2, cache=self.H[k])
            self._watch_slot(iid)
            return Decision(iid, 0.0, 0.0, oracle.tier_of(pid, iid),
                            float(se[j]))
        if kind == "la":
            ties = sched._ties(idx.size)
            j = _pick_min(idx, self._load, ties)
            iid = int(cv.ids[j])
            if h is not None and h.want_decision():
                sched._note_decision(
                    "la", req, pid, cv, oracle,
                    sched._oracle_tier_fn(cv, oracle, pid),
                    j, _runner_up(idx, ties, (self._load[idx],)),
                    cost=self._load, cache=self.H[k], load=self._load)
            self._watch_slot(iid)
            return Decision(iid, float(self._load[j]), 0.0,
                            oracle.tier_of(pid, iid), float(se[j]))
        if kind == "ca":
            neg_hit = -self.H[k]
            ties = sched._ties(idx.size)
            j = _pick_min2(idx, neg_hit, self._load, ties)
            iid = int(cv.ids[j])
            if h is not None and h.want_decision():
                sched._note_decision(
                    "ca", req, pid, cv, oracle,
                    sched._oracle_tier_fn(cv, oracle, pid),
                    j, _runner_up(idx, ties,
                                  (self._load[idx], neg_hit[idx])),
                    cost=neg_hit, cache=self.H[k], load=self._load)
            self._watch_slot(iid)
            return Decision(iid, float(neg_hit[j]), 0.0,
                            oracle.tier_of(pid, iid), float(se[j]))
        if kind == "cla":
            miss = 1.0 - np.minimum(self.H[k], req.input_len) \
                / max(req.input_len, 1)
            score = sched.w_cache * miss + sched.w_load * self._loadn
            ties = sched._ties(idx.size)
            j = _pick_min(idx, score, ties)
            iid = int(cv.ids[j])
            if h is not None and h.want_decision():
                sched._note_decision(
                    "cla", req, pid, cv, oracle,
                    sched._oracle_tier_fn(cv, oracle, pid),
                    j, _runner_up(idx, ties, (score[idx],)),
                    cost=score, cache=self.H[k], load=self._loadn)
            self._watch_slot(iid)
            return Decision(iid, float(score[j]), 0.0,
                            oracle.tier_of(pid, iid), float(se[j]))
        # netkv rungs
        tier_row = cv.tier_row(pid)
        infl = self._inflight if sched.uses_self_contention else None
        if self._kernel and not self._streamed[k]:
            return self._kernel_row(k, req, pid, se, tier_row, infl)
        if self._has_tx[k] and not self._dirty[k] \
                and pid not in self._infl_dirty:
            t_x = self._tx[k]
        else:
            # Invalidated (eviction refresh / same-source n_inflight bump)
            # or never precomputed (pred): the sequential op sequence, with
            # the cohort-invariant Eq. (6)/(7) vectors reused.
            t_x = sched._xfer_vec(req, cv, pid, oracle, infl, se, tier_row)
        cost = (t_x + self._t_q) + self._t_d
        ties = sched._ties(idx.size)
        j = _pick_min(idx, cost, ties)
        best_tier = int(tier_row[j])
        if infl is not None:
            infl.incr(pid, best_tier)
            self._infl_dirty.add(pid)
        if h is not None and h.want_decision():
            sched._note_decision(sched.name, req, pid, cv, oracle,
                                 lambda jj: int(tier_row[jj]),
                                 j, _runner_up(idx, ties, (cost[idx],)),
                                 cost=cost, cache=self.H[k],
                                 load=self._t_q + self._t_d, xfer=t_x)
        iid = int(cv.ids[j])
        self._watch_slot(iid)
        return Decision(iid, float(cost[j]), float(t_x[j]), best_tier,
                        float(se[j]))

    # ------------------------------------------------------------ kernel rows
    def _kernel_feas_unchanged(self, i: int) -> bool:
        """True iff no slot's f32 feasibility bit for kernel row i flipped
        since the snapshot (cost entries don't read free_memory, so an
        unchanged mask means an unchanged row)."""
        cv = self._cv
        live = cv.column("healthy") & (cv.column("role") == ROLE_DECODE)
        if not np.array_equal(live, self._healthy0):
            return False
        free = cv.column("free_memory")
        changed = np.flatnonzero(free != self._free0)
        if changed.size == 0:
            return True
        thr = self._pl_thr32[i, changed]
        f_new = free[changed].astype(np.float32)
        f_old = self._free0[changed].astype(np.float32)
        return bool(np.all((f_new >= thr) == (f_old >= thr)))

    def _kernel_row(self, k, req, pid, se, tier_row, infl):
        sched, cv, oracle = self._sched, self._cv, self._oracle
        i = self._pl_rows.get(k) if self._pl_result is not None else None
        if i is None or self._dirty[k] or pid in self._infl_dirty \
                or not self._kernel_feas_unchanged(i):
            # The single-row kernel reads the live hit_tokens column, which
            # the cohort path never fills (that per-request fill is the cost
            # being amortised) — install row k's hits like _fill_hits would.
            cv.hit_tokens[: cv.n] = self.H[k]
            d = sched._select_kernel(req, pid, cv, oracle, infl, se, tier_row)
        else:
            from ..kernels.netkv_score import BIG

            row = self._pl_result[i]
            j = int(row[0])
            best_cost = float(row.view(np.float32)[1])
            if not best_cost < BIG / 2:
                return None
            tier = int(tier_row[j])
            se_j = float(se[j])
            cong = sched._congestion_by_tier(oracle)
            nfl = sched._n_by_tier(infl, pid)
            t_x = transfer_time(se_j, oracle.tier_bandwidth[tier], cong[tier],
                                nfl[tier], oracle.tier_latency[tier])
            if infl is not None:
                infl.incr(pid, tier)
            h = sched.trace_hook
            if h is not None and h.want_decision():
                # Same row the single-row kernel path records (the cohort
                # kernel's f32 cost row is bit-identical across shapes).
                sched._note_kernel(req, pid, cv, oracle, tier_row, se,
                                   self.H[k], row, cong, nfl, t_x)
            d = Decision(int(cv.ids[j]), best_cost, t_x, tier, se_j)
        if d is not None:
            if infl is not None:
                self._infl_dirty.add(pid)
            self._watch_slot(d.instance_id)
        return d


class DeflectedCohortSelector:
    """Fused R x D twin of sequential ``Scheduler.select_deflected`` calls.

    The deflected objective (``core/cost.py::deflected_cost``) has no
    network term, so the whole cohort shares ONE Eq. (6)/(7) load vector
    (cohort-invariant: deflected requests enqueue on decode only at prefill
    completion, never between the rows of one cohort) and only two columns
    move between rows: the winner's deflect-queue ETA grows by its own
    ``c*l + d`` and its free memory shrinks by the pinned KV.  Each row
    applies exactly that O(1) delta — same values the live ChunkPlane ETA
    fold and ``reserve`` would produce — so ``select_row(0..R-1)`` is
    bit-identical (decisions AND RNG tie draws) to the sequential ladder
    walking the live view.  Proven by ``tests/test_roleplane.py``.
    """

    def __init__(self, sched: Scheduler, reqs: Sequence[RequestInfo],
                 cv: ClusterView, deflect_eta: np.ndarray,
                 prefill_model) -> None:
        self._sched = sched
        self._reqs = list(reqs)
        self._cv = cv
        self._model = prefill_model
        self._eta = np.array(deflect_eta, np.float64)
        self._free = cv.column("free_memory").copy()
        self._role_ok = cv.column("healthy") \
            & (cv.column("role") == ROLE_DECODE)
        self._load = sched._t_queue_vec(cv) + sched._t_decode_vec(cv)

    def select_row(self, k: int) -> Optional[Decision]:
        sched = self._sched
        req = self._reqs[k]
        mask = self._role_ok & (self._free >= req.kv_bytes + sched.m_min)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return None
        cost = deflected_cost(self._eta, self._load)
        ties = sched._ties(idx.size)
        j = int(idx[np.lexsort((ties, cost[idx]))[0]])
        # O(1) winner delta: the ETA fold of submitting this request's
        # chunks (+ c*l + d) and the reserve-time pin, mirroring what the
        # live ChunkPlane/engine do between sequential selections.
        self._eta[j] += self._model.c * req.input_len + self._model.d
        self._free[j] = max(self._free[j] - req.kv_bytes, 0.0)
        return Decision(int(self._cv.ids[j]), float(cost[j]), 0.0, 0, 0.0)
