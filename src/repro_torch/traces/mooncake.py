# The port's own copy of repro/traces/mooncake.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Mooncake-statistics synthetic trace generation (§VI-A; DESIGN.md §5).

The container is offline, so the 23K-request Mooncake trace is synthesised to
its published marginal statistics: bursty arrivals (two-state MMPP), a
heavy-tailed log-normal input-length mixture, log-normal output lengths, and
prefix sharing with probability p_share drawn from a Zipf pool of shared
prefixes.  Timestamps are compressed by a single multiplicative factor to
achieve the target arrival rate while preserving burstiness — the paper's
procedure verbatim.

Three workload profiles (§VI-A):

  chatbot       inputs <= 8K,        p_share = 0.3, TTFT SLO 2 s
  rag           inputs in [4K, 64K], p_share = 0.7, TTFT SLO 5 s
  long_context  inputs > 16K,        p_share = 0.1, TTFT SLO 10 s
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.cost import B_TOK, n_blocks


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    min_input: int
    max_input: int
    p_share: float
    slo: float          # TTFT SLO, seconds
    out_mu: float       # log-normal output length params
    out_sigma: float


PROFILES = {
    "chatbot": Profile("chatbot", 16, 8_192, 0.30, 2.0, np.log(220.0), 0.8),
    "rag": Profile("rag", 4_096, 65_536, 0.70, 5.0, np.log(180.0), 0.7),
    "long_context": Profile("long_context", 16_385, 131_072, 0.10, 10.0, np.log(140.0), 0.7),
}


@dataclasses.dataclass
class Request:
    request_id: int
    arrival: float
    input_len: int
    output_len: int
    block_hashes: tuple
    share_group: int    # -1 = unshared
    slo: float


def _sample_input_lengths(rng: np.random.Generator, n: int, prof: Profile) -> np.ndarray:
    """Heavy-tailed mixture matching the Mooncake length histogram shape:
    a body of conversational lengths and a long RAG/document tail."""
    body = rng.lognormal(mean=np.log(2600.0), sigma=1.0, size=n)
    tail = rng.lognormal(mean=np.log(14000.0), sigma=0.7, size=n)
    pick_tail = rng.random(n) < 0.25
    lens = np.where(pick_tail, tail, body)
    # Rejection-free: clip into the profile filter window.
    return np.clip(lens, prof.min_input, prof.max_input).astype(np.int64)


def _mmpp_arrivals(rng: np.random.Generator, n: int, base_rate: float,
                   burst_factor: float = 4.0, dwell_calm: float = 1.2,
                   dwell_burst: float = 0.35) -> np.ndarray:
    """Two-state Markov-modulated Poisson arrivals (bursty, like the trace)."""
    times = np.empty(n)
    t, state = 0.0, 0
    state_end = rng.exponential(dwell_calm)
    for i in range(n):
        rate = base_rate * (burst_factor if state == 1 else 1.0)
        t += rng.exponential(1.0 / rate)
        while t > state_end:
            state = 1 - state
            state_end = t + rng.exponential(dwell_burst if state == 1 else dwell_calm)
        times[i] = t
    return times


def generate_trace(
    profile: str | Profile,
    *,
    duration: float,
    target_rps: float,
    seed: int = 0,
    p_share: float | None = None,
    input_len_override: int | None = None,
    n_share_groups: int = 48,
    zipf_a: float = 1.4,
) -> list[Request]:
    """Synthesise a trace of ``duration`` seconds at ``target_rps`` mean rate.

    ``p_share`` / ``input_len_override`` support Experiments 5 and 2.
    """
    prof = PROFILES[profile] if isinstance(profile, str) else profile
    if p_share is None:
        p_share = prof.p_share
    rng = np.random.default_rng(seed)
    n = max(int(duration * target_rps * 1.3) + 8, 8)
    raw = _mmpp_arrivals(rng, n, base_rate=max(target_rps, 1e-6) / 1.9)
    # Single multiplicative compression to the target rate over the window.
    span = raw[-1] - raw[0]
    want_n = max(int(duration * target_rps), 1)
    arrivals = (raw - raw[0]) * (duration / span) * (n / max(want_n, 1))
    arrivals = arrivals[arrivals < duration][:want_n * 2]

    m = len(arrivals)
    if input_len_override is not None:
        in_lens = np.full(m, int(input_len_override), dtype=np.int64)
    else:
        in_lens = _sample_input_lengths(rng, m, prof)
    out_lens = np.clip(
        rng.lognormal(prof.out_mu, prof.out_sigma, size=m), 1, 2048
    ).astype(np.int64)

    # Shared-prefix pool: group id ~ Zipf, per-group prefix length in blocks.
    group_prefix_blocks = rng.integers(
        low=max(2, prof.min_input // (2 * B_TOK)),
        high=max(3, prof.max_input // (2 * B_TOK)),
        size=n_share_groups,
    )
    reqs: list[Request] = []
    for i in range(m):
        l_in = int(in_lens[i])
        blocks = n_blocks(l_in)
        if rng.random() < p_share:
            g = int(min(rng.zipf(zipf_a), n_share_groups) - 1)
            pb = int(min(group_prefix_blocks[g], max(blocks - 1, 1)))
            hashes = tuple(("g", g, j) for j in range(pb)) + tuple(
                ("r", i, j) for j in range(blocks - pb)
            )
        else:
            g = -1
            hashes = tuple(("r", i, j) for j in range(blocks))
        reqs.append(
            Request(
                request_id=i,
                arrival=float(arrivals[i]),
                input_len=l_in,
                output_len=int(out_lens[i]),
                block_hashes=hashes,
                share_group=g,
                slo=prof.slo,
            )
        )
    return reqs


def calibrated_capacity_rps(
    *,
    n_prefill: int,
    n_decode: int,
    beta_max: int,
    mean_input: float,
    mean_output: float,
    prefill_model,
    iter_model,
    kv_bytes_per_token: float = 0.0,
    mean_hit_frac: float = 0.0,
    egress_bytes_per_s: float = float("inf"),
    headroom: float = 0.85,
) -> float:
    """Analytic 100 %-capacity point (requests/s) for rate sweeps.

    Prefill: n_p serial instances, each 1/T_prefill(E[l]) rps.
    Decode:  each instance completes beta_max requests per E[out] iterations.
    Network: the prefill rack's ToR egress divided by the mean effective
             transfer size (the binding resource for long-context profiles).
    """
    prefill_rps = n_prefill / prefill_model(mean_input)
    decode_rps = n_decode * beta_max / (mean_output * iter_model(beta_max))
    if kv_bytes_per_token > 0 and egress_bytes_per_s != float("inf"):
        mean_eff = kv_bytes_per_token * mean_input * (1.0 - mean_hit_frac)
        net_rps = egress_bytes_per_s * headroom / max(mean_eff, 1.0)
    else:
        net_rps = float("inf")
    return min(prefill_rps, decode_rps, net_rps)


def empirical_means(profile: str, seed: int = 0, n: int = 4000) -> tuple[float, float]:
    prof = PROFILES[profile]
    rng = np.random.default_rng(seed)
    ins = _sample_input_lengths(rng, n, prof)
    outs = np.clip(rng.lognormal(prof.out_mu, prof.out_sigma, size=n), 1, 2048)
    return float(ins.mean()), float(outs.mean())


def profile_capacity(profile: str, *, n_prefill: int = 4, n_decode: int = 12,
                     beta_max: int = 64, kv_bytes_per_token: float = 327_680.0,
                     tor_egress_bytes_per_s: float = 8 * 50e9 / 8,
                     agg_egress_bytes_per_s: float = 8 * 25e9 / 8,
                     tier3_frac: float = 0.67, background: float = 0.2,
                     headroom: float = 0.35,
                     prefill_model=None, iter_model=None, seed: int = 0) -> float:
    """Per-workload calibrated capacity (the sweeps' 100 % point).

    The network term uses the *binding* fabric constraint under
    topology-agnostic routing: either the prefill rack's ToR egress, or the
    pod agg layer carrying ``tier3_frac`` of the traffic (uniform candidate
    choice sends 8/12 of transfers cross-pod).  ``headroom`` absorbs MMPP
    burstiness and ECMP imbalance so that 100 % sits at the knee, not past
    it — the paper's sweeps remain meaningful up to 250 %.
    """
    from ..core.cost import H100_TP4_ITER, H100_TP4_PREFILL

    prof = PROFILES[profile]
    mi, mo = empirical_means(profile, seed=seed)
    fabric = min(tor_egress_bytes_per_s, agg_egress_bytes_per_s / max(tier3_frac, 1e-6))
    fabric *= (1.0 - background)
    return calibrated_capacity_rps(
        n_prefill=n_prefill, n_decode=n_decode, beta_max=beta_max,
        mean_input=mi, mean_output=mo,
        prefill_model=prefill_model or H100_TP4_PREFILL,
        iter_model=iter_model or H100_TP4_ITER,
        kv_bytes_per_token=kv_bytes_per_token,
        mean_hit_frac=prof.p_share * 0.55,
        egress_bytes_per_s=fabric,
        headroom=headroom,
    )
