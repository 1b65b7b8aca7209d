# The port's own copy of repro/sim/metrics.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Metric collection: TTFT, TBT, SLO attainment, goodput, transfer stats."""

from __future__ import annotations

import dataclasses

import numpy as np

from .trace import ttft_attribution


@dataclasses.dataclass
class RunMetrics:
    scheduler: str
    n_measured: int
    n_rejected: int
    n_unfinished: int
    ttft_mean: float
    ttft_p50: float
    ttft_p95: float
    ttft_p99: float
    tbt_mean: float
    tbt_p95: float
    slo_attainment: float
    goodput_rps: float
    xfer_mean: float
    xfer_p95: float
    tier_fraction: dict[int, float]
    hit_frac_mean: float
    decision_latency_mean: float
    decision_latency_p99: float
    requeues: int = 0
    decode_iterations: int = 0  # continuous-batching steps across instances
    # TTFT attribution (sim/trace.py::ttft_attribution): per-phase shares
    # of time-to-first-token over the measurement window.  NaN on
    # degenerate windows, like every distributional metric above.
    queue_wait_mean: float = float("nan")
    queue_wait_p95: float = float("nan")
    prefill_mean: float = float("nan")
    prefill_p95: float = float("nan")
    admit_wait_mean: float = float("nan")
    admit_wait_p95: float = float("nan")
    xfer_share_mean: float = float("nan")
    xfer_share_p95: float = float("nan")
    # RolePlane telemetry: per-role compute utilization over the run (busy
    # seconds / instance-seconds, NaN when a role has no instances) and the
    # fraction of finished measured requests whose prefill was deflected
    # onto a decode host (0.0 with deflection off, NaN on empty windows).
    prefill_util: float = float("nan")
    decode_util: float = float("nan")
    deflected_frac: float = float("nan")

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("tier_fraction")
        for t in range(4):
            d[f"tier{t}"] = self.tier_fraction.get(t, 0.0)
        return d


def _pct(a: np.ndarray, q: float) -> float:
    """NaN-safe percentile: np.percentile raises on empty input."""
    return float(np.percentile(a, q)) if a.size else float("nan")


def _mean(a: np.ndarray) -> float:
    return float(a.mean()) if a.size else float("nan")


def summarize(records, *, window: tuple[float, float], scheduler: str,
              decision_latencies=(), rejected: int = 0,
              decode_iterations: int = 0,
              prefill_util: float = float("nan"),
              decode_util: float = float("nan")) -> RunMetrics:
    """Aggregate per-request records whose ARRIVAL falls in the window.

    Degenerate windows are first-class: when nothing arrives (or nothing
    reaches its first token) inside the window every distributional metric
    is NaN rather than a crash or a fabricated sentinel — mid-sweep a
    starved arm must produce a row that ``aggregate_seeds`` (which filters
    non-finite values) can digest.  The previous implementation fed
    ``np.percentile`` empty arrays (e.g. ``done`` non-empty but no record
    with a valid TBT) and padded others with fake ``[0.0]``/``[inf]``
    entries that skewed downstream means.
    """
    lo, hi = window
    meas = [r for r in records if lo <= r.req.arrival < hi and not r.rejected]
    done = [r for r in meas if r.first_token >= 0]
    unfinished = len(meas) - len(done)
    ttfts = np.array([r.ttft for r in done], np.float64)
    fin_ttfts = ttfts[np.isfinite(ttfts)]
    tbts = np.array([r.tbt for r in done if r.tbt >= 0], np.float64)
    # Transfer time: from prefill end (scheduling) to transfer landed.
    xfers = np.array([r.transfer_end - r.prefill_end for r in done
                      if r.transfer_end >= 0], np.float64)
    slo_ok = sum(1 for r in done if r.ttft <= r.req.slo)
    span = max(hi - lo, 1e-9)
    tiers = [r.tier for r in done if r.tier >= 0]
    tier_frac = {
        t: (sum(1 for x in tiers if x == t) / max(len(tiers), 1)) for t in range(4)
    }
    hits = np.array(
        [min(r.hit_tokens, r.req.input_len) / max(r.req.input_len, 1) for r in done],
        np.float64,
    )
    dl = np.asarray(decision_latencies, np.float64)
    return RunMetrics(
        scheduler=scheduler,
        n_measured=len(meas),
        n_rejected=rejected,
        n_unfinished=unfinished,
        ttft_mean=_mean(fin_ttfts),
        ttft_p50=_pct(ttfts, 50),
        ttft_p95=_pct(ttfts, 95),
        ttft_p99=_pct(ttfts, 99),
        tbt_mean=_mean(tbts),
        tbt_p95=_pct(tbts, 95),
        slo_attainment=slo_ok / len(meas) if meas else float("nan"),
        goodput_rps=slo_ok / span,
        xfer_mean=_mean(xfers),
        xfer_p95=_pct(xfers, 95),
        tier_fraction=tier_frac,
        hit_frac_mean=_mean(hits),
        decision_latency_mean=_mean(dl),
        decision_latency_p99=_pct(dl, 99),
        requeues=sum(r.requeues for r in meas),
        decode_iterations=decode_iterations,
        prefill_util=prefill_util,
        decode_util=decode_util,
        deflected_frac=(sum(1 for r in done if r.deflected) / len(done)
                        if done else float("nan")),
        **ttft_attribution(records, window),
    )


def aggregate_seeds(runs: list[RunMetrics]) -> dict:
    """mean ± std across seeds for the headline metrics."""
    keys = ["ttft_mean", "ttft_p99", "tbt_mean", "slo_attainment", "xfer_mean",
            "goodput_rps", "xfer_share_mean",
            "prefill_util", "decode_util", "deflected_frac"]
    out = {"scheduler": runs[0].scheduler, "n_seeds": len(runs)}
    for k in keys:
        vals = np.array([getattr(r, k) for r in runs], dtype=np.float64)
        vals = vals[np.isfinite(vals)]
        out[k] = float(vals.mean()) if vals.size else float("nan")
        out[k + "_std"] = float(vals.std()) if vals.size else float("nan")
    for t in range(4):
        out[f"tier{t}"] = float(np.mean([r.tier_fraction.get(t, 0.0) for r in runs]))
    return out
