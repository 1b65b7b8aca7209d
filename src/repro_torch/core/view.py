# The port's own copy of repro/core/view.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_serving.py holds the two equal.
"""ClusterView: struct-of-arrays scheduler-visible state plane (§III-C).

The seed scored candidates by rebuilding a list of ``CandidateState``
dataclasses from scratch on every scheduling event and looping over it in
Python.  At 1000-GPU scale that rebuild+loop *is* the scheduler hot path
(the paper reports 1.5 ms/decision at 1024 GPUs, §VI exp7).  ``ClusterView``
replaces it with one set of parallel NumPy columns that the instance engine
maintains **incrementally**: the columnar ``InstancePlane`` syncs every
scheduler-visible scalar in one vectorised assignment per event (the
retired per-object ``DecodeSim`` writes its slot on each mutation), so a
scheduling event reads the current cluster state with zero allocation and
scores all D candidates as array ops.  ``free_memory`` is clamped at zero
by the writers: decode-side KV growth may overcommit the budget, and a
negative value would score as phantom negative capacity.

Columns (all length ``n``, slot-indexed):

  ids          i64   instance id of each slot
  free_memory  f64   m_d, bytes (evictable cache counts as free)
  queued       i64   q_d
  batch        i64   beta_d
  iter_scale   f64   straggler EWMA multiplier (scheduler-visible estimate)
  healthy      bool  scheduler-visible health (lags true health by the
                     fault detection delay — see Simulation._on_fault)
  hit_tokens   f64   lambda_r(d) scratch column, filled per request.
                     Under streamed chunked prefill (SimConfig.kv_streaming)
                     the fill — and the whole selection pass — happens at
                     *first-chunk* readiness rather than prefill end, and
                     the request's full KV bytes are pinned (free_memory
                     drops) from that earlier instant; the overlap itself
                     reaches the ladder per request via
                     RequestInfo.prefill_remaining / tail_bytes, not as a
                     column (it is candidate-independent).

Tier lookups are row-cached: ``tier_row(src_id)`` returns the (n,) tier
vector from a source instance (prefill or staging store) to every slot,
computed once from the static topology and invalidated only when the pool
membership changes (elastic join).  ``slot_of`` is the O(1) id->index map
that replaces the seed's ``_decode_by_id`` linear scan.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

# Instance roles (RolePlane).  One instance axis, role as a column: the
# schedulers mask candidates to ROLE_DECODE rows, the deflection path masks
# to the same rows when scoring decode hosts as prefill targets, and the
# role-flip controller rewrites the column in place (no pool rebuild).
ROLE_PREFILL = 0
ROLE_DECODE = 1


class ClusterView:
    """Columnar scheduler<->simulator interface over the decode pool."""

    def __init__(self, tier_fn: Optional[Callable[[int, int], int]] = None,
                 capacity: int = 16):
        capacity = max(int(capacity), 1)
        self.tier_fn = tier_fn
        self.n = 0
        self.ids = np.zeros(capacity, np.int64)
        self.free_memory = np.zeros(capacity, np.float64)
        self.queued = np.zeros(capacity, np.int64)
        self.batch = np.zeros(capacity, np.int64)
        self.iter_scale = np.ones(capacity, np.float64)
        self.healthy = np.zeros(capacity, bool)
        self.hit_tokens = np.zeros(capacity, np.float64)
        self.role = np.full(capacity, ROLE_DECODE, np.int64)
        self._slot: dict[int, int] = {}
        self._tier_rows: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------- membership
    def __len__(self) -> int:
        return self.n

    def _grow(self) -> None:
        cap = len(self.ids) * 2
        for name in ("ids", "free_memory", "queued", "batch", "iter_scale",
                     "healthy", "hit_tokens", "role"):
            old = getattr(self, name)
            new = np.full(cap, ROLE_DECODE, old.dtype) if name == "role" \
                else np.zeros(cap, old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def add_instance(self, instance_id: int, *, free_memory: float = 0.0,
                     queued: int = 0, batch: int = 0, hit_tokens: float = 0.0,
                     healthy: bool = True, iter_scale: float = 1.0,
                     role: int = ROLE_DECODE) -> int:
        """Register an instance; returns its (stable) column slot."""
        if instance_id in self._slot:
            raise ValueError(f"instance {instance_id} already registered")
        if self.n == len(self.ids):
            self._grow()
        s = self.n
        self.n += 1
        self.ids[s] = instance_id
        self.free_memory[s] = free_memory
        self.queued[s] = queued
        self.batch[s] = batch
        self.iter_scale[s] = iter_scale
        self.healthy[s] = healthy
        self.hit_tokens[s] = hit_tokens
        self.role[s] = role
        self._slot[instance_id] = s
        self._tier_rows.clear()  # cached rows are now one column short
        return s

    def slot_of(self, instance_id: int) -> int:
        """O(1) id -> column index (replaces the _decode_by_id linear scan)."""
        return self._slot[instance_id]

    # ------------------------------------------------------------ tier plane
    def tier_row(self, src_id: int) -> np.ndarray:
        """(n,) tier of the path src_id -> each slot, row-cached."""
        row = self._tier_rows.get(src_id)
        if row is None:
            if self.tier_fn is None:
                raise ValueError("ClusterView has no tier_fn; cannot derive tiers")
            fn = self.tier_fn
            row = np.fromiter(
                (fn(src_id, int(i)) for i in self.ids[: self.n]),
                dtype=np.int64, count=self.n,
            )
            self._tier_rows[src_id] = row
        return row

    # ------------------------------------------------------------- accessors
    def column(self, name: str) -> np.ndarray:
        """Active slice of one column (no copy)."""
        return getattr(self, name)[: self.n]

    # ------------------------------------------------------------ cohort apply
    def apply_assignment(self, slot: int, *, kv_bytes: float = 0.0,
                         queued_delta: int = 0, batch_delta: int = 0) -> None:
        """O(1) column delta for one cohort assignment.

        Between the argmin rows of a batched dispatch only the *winning*
        slot's scheduler-visible scalars move (memory pinned at reserve,
        queue/batch deltas); this applies exactly that delta without a full
        engine resync.  ``free_memory`` clamps at zero like every writer.
        """
        self.free_memory[slot] = max(self.free_memory[slot] - kv_bytes, 0.0)
        if queued_delta:
            self.queued[slot] += queued_delta
        if batch_delta:
            self.batch[slot] += batch_delta

    # ----------------------------------------------------------------- compat
    @classmethod
    def from_candidates(cls, cands: Sequence, tier_fn=None) -> "ClusterView":
        """Coerce a legacy ``CandidateState`` list into a one-shot view."""
        cv = cls(tier_fn=tier_fn, capacity=max(len(cands), 1))
        for c in cands:
            cv.add_instance(
                c.instance_id, free_memory=c.free_memory, queued=c.queued,
                batch=c.batch_size, hit_tokens=c.hit_tokens,
                healthy=c.healthy, iter_scale=c.iter_scale,
            )
        return cv


def as_cluster_view(cands, oracle=None) -> ClusterView:
    """Accept either a maintained ClusterView or a CandidateState sequence."""
    if isinstance(cands, ClusterView):
        return cands
    tier_fn = oracle.tier_of if oracle is not None else None
    return ClusterView.from_candidates(cands, tier_fn=tier_fn)
