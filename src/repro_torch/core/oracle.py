# The port's own copy of repro/core/oracle.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_serving.py holds the two equal.
"""The network cost oracle — the operator→scheduler interface (§III-E).

The operator publishes four maps every ``refresh_interval`` seconds:

  * ``tier_map``        static: (instance, instance) -> tier id in {0,1,2,3}
  * ``tier_bandwidth``  static: tier -> bytes/s
  * ``tier_latency``    static: tier -> seconds
  * ``congestion``      dynamic: tier -> [0, 1)

The scheduler reads a *snapshot* (``OracleView``) that is immutable between
refreshes — this is exactly the staleness regime analysed by Proposition 2.
Optionally the scheduler sends ``TransferIntent`` hints back to the operator.

The oracle is deliberately tiny: tier classification + per-tier scalars.  It
carries no raw topology, no per-link state, and no inference semantics.

RolePlane note: *deflected* prefill (``Scheduler.select_deflected``) never
consults the oracle — the KV materialises on the decode host itself, so
Eq. (3)/(4) collapse to a zero-transfer term (tier 0, no congestion, no
self-contention hint) and the only network-adjacent input is the host's
deflected-chunk drain ETA from the instance engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np

TIERS = (0, 1, 2, 3)

# Paper defaults (§VI-A): B0=450 GB/s NVLink, B1=100 Gbps ToR,
# B2=50 Gbps (2:1 oversub), B3=25 Gbps (4:1 oversub).
PAPER_TIER_BANDWIDTH = {
    0: 450e9,            # bytes/s (NVLink)
    1: 100e9 / 8,        # 100 Gbps
    2: 50e9 / 8,         # 50 Gbps
    3: 25e9 / 8,         # 25 Gbps
}
PAPER_TIER_LATENCY = {0: 1e-6, 1: 3e-6, 2: 8e-6, 3: 15e-6}

# TPU-fabric preset (see DESIGN.md §3): intra-host ICI / slice ICI /
# intra-pod DCN / cross-pod DCN.
TPU_TIER_BANDWIDTH = {0: 400e9, 1: 50e9, 2: 25e9 / 8 * 4, 3: 25e9 / 8}
TPU_TIER_LATENCY = {0: 1e-6, 1: 5e-6, 2: 10e-6, 3: 25e-6}


@dataclasses.dataclass(frozen=True)
class OracleView:
    """Immutable snapshot consumed by the scheduler between refreshes."""

    tier_of: Callable[[int, int], int]
    tier_bandwidth: Mapping[int, float]
    tier_latency: Mapping[int, float]
    congestion: Mapping[int, float]
    timestamp: float = 0.0

    def __post_init__(self) -> None:
        # The per-tier arrays are a function of the (immutable) snapshot, so
        # compute them once here instead of allocating three fresh arrays on
        # every dispatch.  Read-only so a caller can't corrupt the cache.
        bw = np.array([self.tier_bandwidth[t] for t in TIERS], dtype=np.float64)
        lat = np.array([self.tier_latency[t] for t in TIERS], dtype=np.float64)
        cong = np.array([self.congestion.get(t, 0.0) for t in TIERS],
                        dtype=np.float64)
        for a in (bw, lat, cong):
            a.flags.writeable = False
        object.__setattr__(self, "_bw_arr", bw)
        object.__setattr__(self, "_lat_arr", lat)
        object.__setattr__(self, "_cong_arr", cong)

    def bandwidth_array(self) -> np.ndarray:
        return self._bw_arr

    def latency_array(self) -> np.ndarray:
        return self._lat_arr

    def congestion_array(self) -> np.ndarray:
        return self._cong_arr

    def est_transfer_time(
        self,
        s_eff: float,
        tier: int,
        n_inflight: int = 0,
        prefill_remaining: float = 0.0,
        tail_bytes: float | None = None,
    ) -> float:
        """Eq. (3) through this snapshot's maps, overlap-aware.

        With the defaults this is the serial T_xfer; with
        ``prefill_remaining``/``tail_bytes`` set it is the streamed-chunk
        estimate (``cost.streamed_transfer_time``): bytes keep becoming
        ready while prefill runs, so only the final-chunk tail is forced
        to cross the wire after prefill ends.  The scalar twin of the
        ladder's vectorised ``v_transfer_time`` column.
        """
        from .cost import streamed_transfer_time

        return streamed_transfer_time(
            s_eff, self.tier_bandwidth[tier], self.congestion.get(tier, 0.0),
            n_inflight, self.tier_latency[tier],
            prefill_remaining=prefill_remaining, tail_bytes=tail_bytes,
        )


@dataclasses.dataclass
class TransferIntent:
    """Optional scheduler→operator hint for an upcoming KV flow."""

    src: int
    dst: int
    bytes: int
    priority: int = 0
    deadline: float | None = None


class NetworkCostOracle:
    """Operator-side oracle with a refresh clock.

    ``telemetry_fn(now) -> {tier: congestion}`` is the operator's aggregation
    of switch counters (INT/sFlow/SNMP), *excluding* the scheduler's own
    marked KV flows (DSCP class), per §III-D.  The scheduler only ever sees
    the last published snapshot.

    ``source`` selects where the congestion signal comes from:

    * ``"model"`` (default) — ``telemetry_fn``, the background model's
      ground-truth per-tier utilisation (the paper's idealised operator).
    * ``"measured"`` — ``measured_fn``, per-tier congestion aggregated from
      the network plane's *per-link byte counters*, including the
      scheduler's own in-flight KV traffic (an operator that cannot
      subtract the KV DSCP class).  This opens a realistic telemetry-noise
      axis for the staleness experiments
      (``FlowPlane.measured_tier_congestion``).

    **Rewire awareness**: the "static" per-tier maps are held as *live*
    references (pass ``topology=`` or the topology's own dicts) and
    snapshotted into the immutable ``OracleView`` at each refresh.  An OCS
    rewire (``FatTree.rewire``) therefore reaches the scheduler only at the
    *next* refresh — between a rewire and that refresh the scheduler routes
    on pre-rewire bandwidths, which is exactly the staleness regime of
    Prop. 2 extended to the capacity axis.  The previous construction-time
    ``dict()`` copy drifted silently from any topology whose capacities
    changed (or whose caller mutated its ``tier_bandwidth`` after build).
    """

    def __init__(
        self,
        tier_of: Callable[[int, int], int],
        tier_bandwidth: Mapping[int, float] | None = None,
        tier_latency: Mapping[int, float] | None = None,
        telemetry_fn: Callable[[float], Mapping[int, float]] | None = None,
        refresh_interval: float = 1.0,
        measured_fn: Callable[[float], Mapping[int, float]] | None = None,
        source: str = "model",
        topology=None,
    ) -> None:
        if source not in ("model", "measured"):
            raise ValueError(f"unknown telemetry source {source!r}")
        if source == "measured" and measured_fn is None:
            raise ValueError("source='measured' requires measured_fn")
        self.tier_of = tier_of
        if topology is not None:
            # Wire the static maps straight to the live topology dicts.
            tier_bandwidth = tier_bandwidth if tier_bandwidth is not None \
                else topology.tier_bandwidth
            tier_latency = tier_latency if tier_latency is not None \
                else topology.tier_latency
        # Live references, NOT copies: a rewire mutates these in place and
        # the next refresh snapshots the new values.  The paper defaults are
        # copied so nobody can corrupt the module constants through us.
        self.tier_bandwidth = tier_bandwidth if tier_bandwidth is not None \
            else dict(PAPER_TIER_BANDWIDTH)
        self.tier_latency = tier_latency if tier_latency is not None \
            else dict(PAPER_TIER_LATENCY)
        self._telemetry_fn = telemetry_fn or (lambda now: {t: 0.0 for t in TIERS})
        self._measured_fn = measured_fn
        self.source = source
        self.refresh_interval = refresh_interval
        self._last_refresh = -float("inf")
        self._snapshot: OracleView | None = None
        self.intents: list[TransferIntent] = []
        self.refreshes = 0

    def view(self, now: float) -> OracleView:
        """Return the current snapshot, refreshing if the interval elapsed."""
        if self._snapshot is None or now - self._last_refresh >= self.refresh_interval:
            fn = self._measured_fn if self.source == "measured" else self._telemetry_fn
            congestion = {t: float(np.clip(c, 0.0, 0.999)) for t, c in fn(now).items()}
            for t in TIERS:
                congestion.setdefault(t, 0.0)
            self._snapshot = OracleView(
                tier_of=self.tier_of,
                # Immutable copies: the snapshot must hold the pre-rewire
                # values until the next refresh, not track the live dicts.
                tier_bandwidth=dict(self.tier_bandwidth),
                tier_latency=dict(self.tier_latency),
                congestion=congestion,
                timestamp=now,
            )
            self._last_refresh = now
            self.refreshes += 1
        return self._snapshot

    def force_refresh(self, now: float) -> "OracleView":
        """Out-of-band refresh: drop the snapshot and rebuild immediately.

        The rewire-notification path (``SimConfig.notify_rewires``): an OCS
        controller that *tells* the operator it moved capacity, instead of
        letting the scheduler route on a stale pre-rewire snapshot until the
        periodic interval elapses.  Counts as a normal refresh.
        """
        self._snapshot = None
        return self.view(now)

    def submit_intent(self, intent: TransferIntent) -> None:
        self.intents.append(intent)


class SelfContentionTracker:
    """n_inflight^tau(p): the scheduler's own in-flight flows per (p, tier).

    Incremented on dispatch, decremented via the engine's transfer-complete
    callback (vLLM ``KVConnectorBase_V1.get_finished`` equivalent).  Capped
    (default 16 ~ NIC saturated flow count) to avoid runaway under overload.
    """

    def __init__(self, cap: int = 16) -> None:
        self.cap = cap
        self._counts: dict[tuple[int, int], int] = {}

    def get(self, prefill_id: int, tier: int) -> int:
        return self._counts.get((prefill_id, tier), 0)

    def incr(self, prefill_id: int, tier: int) -> None:
        key = (prefill_id, tier)
        self._counts[key] = min(self.cap, self._counts.get(key, 0) + 1)

    def decr(self, prefill_id: int, tier: int) -> None:
        key = (prefill_id, tier)
        cur = self._counts.get(key, 0)
        if cur <= 1:
            self._counts.pop(key, None)
        else:
            self._counts[key] = cur - 1

    def snapshot(self, prefill_id: int) -> dict[int, int]:
        return {t: self.get(prefill_id, t) for t in TIERS}


class EWMACongestionPredictor:
    """Beyond-paper: predictive congestion via exponential smoothing (§VII-D).

    Replaces the instantaneous snapshot with a one-step-ahead forecast
    ``c_hat = alpha * obs + (1 - alpha) * c_hat`` plus a trend term
    (Holt's linear method, damped).  Prop. 2's large staleness tolerance is
    what makes this safe: a modest forecast error never flips tier order.
    """

    def __init__(self, alpha: float = 0.4, beta: float = 0.2, damp: float = 0.9) -> None:
        self.alpha, self.beta, self.damp = alpha, beta, damp
        self._level: dict[int, float] = {}
        self._trend: dict[int, float] = {}

    def update(self, congestion: Mapping[int, float]) -> None:
        for t, obs in congestion.items():
            lvl = self._level.get(t)
            if lvl is None:
                self._level[t], self._trend[t] = float(obs), 0.0
                continue
            trend = self._trend.get(t, 0.0)
            new_level = self.alpha * float(obs) + (1 - self.alpha) * (lvl + self.damp * trend)
            self._trend[t] = self.beta * (new_level - lvl) + (1 - self.beta) * self.damp * trend
            self._level[t] = new_level

    def predict(self, tier: int) -> float:
        lvl = self._level.get(tier, 0.0) + self.damp * self._trend.get(tier, 0.0)
        return float(np.clip(lvl, 0.0, 0.999))

    def predicted_map(self, tiers: Sequence[int] = TIERS) -> dict[int, float]:
        return {t: self.predict(t) for t in tiers}
