# The port's own copy of repro/core/cost.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_serving.py holds the two equal.
"""Cost model for disaggregated decode-instance selection.

Implements Eqs. (1)-(7) of the paper:

  (1) KV cache size          s_r = 2 * n_layers * n_kv_heads * d_head * l_r * b_elem
  (2) effective transfer     s_eff(d) = s_r * (1 - lambda_r(d) / l_r)
  (3) transfer time          T_xfer = s_eff / B_eff(p, d) + L_tau
  (4) effective bandwidth    B_eff = B_tau * (1 - c_tau) / (1 + n_inflight^tau(p))
  (6) queueing delay         T_queue = max(0, q_d - (beta_max - beta_d)) * t_iter(beta_d)
  (7) first decode step      T_decode = t_iter(beta_d + 1)

All quantities are SI: bytes, bytes/s, seconds.  The module is pure and
side-effect free so it can be consumed from the Python simulator, the
vectorised JAX scorer, and the Pallas scoring kernel's reference oracle
without divergence.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

GiB = 1024.0 ** 3
GBPS = 1e9 / 8.0  # 1 Gbps in bytes/s
B_TOK = 16  # block size in tokens for block-level prefix matching (SIII-B)


def n_blocks(tokens: int) -> int:
    return (tokens + B_TOK - 1) // B_TOK


@dataclasses.dataclass(frozen=True)
class ModelKVSpec:
    """Per-model constants needed by Eq. (1) and its generalisation.

    For attention models ``state_bytes_per_token`` is the Eq. (1) coefficient
    (2 * n_layers * n_kv_heads * d_head * b_elem).  For hybrid / SSM models
    the transferred state has a sequence-length-independent component
    (``fixed_state_bytes``: Mamba SSM + conv state, RWKV WKV + token-shift
    state) on top of the per-token KV of any attention layers.
    """

    name: str
    n_layers: int
    n_kv_heads: int
    d_head: int
    bytes_per_elem: int = 2  # FP16 / BF16
    n_attn_layers: int | None = None  # hybrid: attention layers only
    fixed_state_bytes: int = 0  # SSM/RWKV per-request constant state
    tp: int = 1  # tensor-parallel degree: per-shard flows

    @property
    def kv_bytes_per_token(self) -> int:
        """Eq. (1) coefficient: aggregate KV bytes per token."""
        layers = self.n_attn_layers if self.n_attn_layers is not None else self.n_layers
        return 2 * layers * self.n_kv_heads * self.d_head * self.bytes_per_elem

    def kv_bytes(self, input_len: int) -> int:
        """Eq. (1) + fixed-state generalisation: total transferred bytes."""
        return self.kv_bytes_per_token * input_len + self.fixed_state_bytes


# Llama-3-70B at TP=4 -- the paper's evaluation model (320 KB/token aggregate).
LLAMA3_70B_KV = ModelKVSpec(
    name="llama3-70b", n_layers=80, n_kv_heads=8, d_head=128, bytes_per_elem=2, tp=4
)


def effective_transfer_bytes(s_r: float, hit_tokens: float, input_len: int) -> float:
    """Eq. (2): s_eff = s_r * (1 - lambda/l).  hit_tokens is clamped to [0, l]."""
    if input_len <= 0:
        return 0.0
    frac = min(max(hit_tokens, 0.0), float(input_len)) / float(input_len)
    return s_r * (1.0 - frac)


def effective_bandwidth(
    tier_bw: float, congestion: float, n_inflight: int
) -> float:
    """Eq. (4): B_eff = B_tau (1 - c_tau) / (1 + n_inflight).

    ``tier_bw`` in bytes/s; ``congestion`` in [0, 1); ``n_inflight`` >= 0.
    """
    c = min(max(congestion, 0.0), 0.999999)
    return tier_bw * (1.0 - c) / (1.0 + max(n_inflight, 0))


def effective_bandwidth_tiers(
    tier_bandwidth, congestion_by_tier, n_by_tier
) -> "np.ndarray":
    """Eq. (4) across all four tiers at once: B_eff per tier as a (4,) array.

    Element-for-element the same IEEE operation sequence as four scalar
    ``effective_bandwidth`` calls — the ladder's ``v_transfer_time`` and the
    DispatchPlane's cohort scorer both gather from this row, so bit-exact
    parity between them reduces to sharing it.
    """
    import numpy as np

    from .oracle import TIERS

    return np.array(
        [effective_bandwidth(tier_bandwidth[t], congestion_by_tier[t],
                             n_by_tier[t]) for t in TIERS],
        dtype=np.float64,
    )


def transfer_time(
    s_eff: float, tier_bw: float, congestion: float, n_inflight: int, tier_latency: float
) -> float:
    """Eq. (3): T_xfer = s_eff / B_eff + L_tau."""
    if s_eff <= 0.0:
        return tier_latency
    beff = effective_bandwidth(tier_bw, congestion, n_inflight)
    return s_eff / beff + tier_latency


def streamed_transfer_time(
    s_eff: float,
    tier_bw: float,
    congestion: float,
    n_inflight: int,
    tier_latency: float,
    prefill_remaining: float = 0.0,
    tail_bytes: float | None = None,
) -> float:
    """Eq. (3) under chunk-streamed prefill/transfer overlap (ChunkPlane).

    Chunks enter the network as they prefill, so the last byte lands at
    the later of (a) the pipe draining all ``s_eff`` bytes from now and
    (b) the final chunk — ``tail_bytes``, which only exists once prefill
    ends ``prefill_remaining`` seconds from now — crossing the wire:

        T_xfer = max(s_eff / B_eff,  prefill_remaining + tail / B_eff) + L_tau

    With ``prefill_remaining == 0`` and ``tail_bytes in (None, >= s_eff)``
    this is exactly ``transfer_time`` — the serial model.
    """
    if s_eff <= 0.0:
        return tier_latency
    beff = effective_bandwidth(tier_bw, congestion, n_inflight)
    tail = s_eff if tail_bytes is None else min(max(tail_bytes, 0.0), s_eff)
    return max(s_eff / beff, prefill_remaining + tail / beff) + tier_latency


def deflected_cost(deflect_eta, decode_load):
    """Deflected-candidate branch of the Eq. (5) objective (RolePlane).

    When a prefill storm deflects chunked prefill onto a decode host, the
    KV is *born* on the target — Eq. (2) gives s_eff = 0 and Eq. (3)/(4)
    collapse entirely (no wire, no tier, no self-contention).  What
    remains is the target's deflected-chunk-queue drain ETA plus the
    decode-side Eq. (6)/(7) load (``decode_load`` = T_queue + T_decode,
    pre-summed by the caller so the sequential ladder and the fused R x D
    cohort path share one IEEE op sequence — bit-exact parity between
    them reduces to sharing this helper):

        C_defl[d] = ETA_defl(d) + (T_queue(d) + T_decode(d))
    """
    return deflect_eta + decode_load


@dataclasses.dataclass(frozen=True)
class IterTimeModel:
    """Piecewise-linear iteration-time model  t_iter(beta) = a + b * beta.

    Optionally piecewise: ``breaks``/``slopes`` extend beyond the first
    segment, matching the paper's 'piecewise-linear function fitted from
    published profiling data'.
    """

    a: float  # base seconds
    b: float  # seconds per batched request
    breaks: Sequence[float] = ()
    slopes: Sequence[float] = ()

    def __call__(self, beta: float) -> float:
        t = self.a + self.b * max(beta, 0.0)
        for brk, slope in zip(self.breaks, self.slopes):
            if beta > brk:
                t += slope * (beta - brk)
        return t


def iter_time_vector(model: "IterTimeModel", beta) -> "np.ndarray":
    """Vectorised ``IterTimeModel.__call__`` over a beta array.

    Element-for-element the same IEEE operation sequence as the scalar
    call (the InstancePlane's cohort deadline computation relies on this
    for bit-exact parity with the per-object reference engine).
    """
    import numpy as np

    beta = np.asarray(beta)
    t = model.a + model.b * np.maximum(beta, 0.0)
    for brk, slope in zip(model.breaks, model.slopes):
        t = np.where(beta > brk, t + slope * (beta - brk), t)
    return t


@dataclasses.dataclass(frozen=True)
class PrefillTimeModel:
    """T_prefill(l) = c * l + d (piecewise-linear in prompt length)."""

    c: float  # seconds per token
    d: float  # base seconds

    def __call__(self, input_len: int) -> float:
        return self.c * input_len + self.d


# Fits triangulated from DistServe / vLLM v0.6 / MLPerf Inference v5.0
# (Llama-2/3-70B class at TP=4 on H100).  Deliberately biased toward *fast*
# decode, per the paper, so the network term is conservatively weighted.
# t_iter spans [12.4 ms @ beta=0, 13.4 ms @ beta=64] — the paper's observed
# absolute TBT band across all runs is 12.55-13.42 ms (§VI-J).
H100_TP4_ITER = IterTimeModel(a=0.0124, b=1.6e-5)        # 12.4 ms + 16 us/req
H100_TP4_PREFILL = PrefillTimeModel(c=5.0e-5, d=0.015)   # 50 us/token + 15 ms
# TPU v5e preset derived with the same published-roofline methodology.
V5E_TP4_ITER = IterTimeModel(a=0.0168, b=2.2e-5)
V5E_TP4_PREFILL = PrefillTimeModel(c=6.8e-5, d=0.019)


def queue_time(q_d: int, beta_d: int, beta_max: int, iter_model: IterTimeModel) -> float:
    """Eq. (6): requests blocked behind a full batch wait one iter each."""
    blocked = max(0, q_d - (beta_max - beta_d))
    return blocked * iter_model(beta_d)


def first_decode_time(beta_d: int, iter_model: IterTimeModel) -> float:
    """Eq. (7): the first decode step after joining the batch on d."""
    return iter_model(beta_d + 1)


def post_prefill_latency(
    *,
    s_r: float,
    hit_tokens: float,
    input_len: int,
    tier_bw: float,
    congestion: float,
    n_inflight: int,
    tier_latency: float,
    q_d: int,
    beta_d: int,
    beta_max: int,
    iter_model: IterTimeModel,
) -> float:
    """Eq. (5) objective for one candidate: T_xfer + T_queue + T_decode."""
    s_eff = effective_transfer_bytes(s_r, hit_tokens, input_len)
    return (
        transfer_time(s_eff, tier_bw, congestion, n_inflight, tier_latency)
        + queue_time(q_d, beta_d, beta_max, iter_model)
        + first_decode_time(beta_d, iter_model)
    )


def decision_breakdown(
    *,
    s_eff: float,
    tier_bw: float,
    congestion: float,
    n_inflight: int,
    tier_latency: float,
    q_d: int,
    beta_d: int,
    beta_max: int,
    iter_model: IterTimeModel,
) -> tuple[float, float, float]:
    """Eq. (5) split into its Eq. (3)/(6)/(7) terms: (T_xfer, T_queue,
    T_decode) for one candidate — the schema of a TracePlane forensics
    row's transfer/load components.  Pure, so tests can recompute a
    recorded winner's breakdown and assert bit-equality."""
    return (
        transfer_time(s_eff, tier_bw, congestion, n_inflight, tier_latency),
        queue_time(q_d, beta_d, beta_max, iter_model),
        first_decode_time(beta_d, iter_model),
    )


def feasible(m_d: float, s_eff: float, m_min: float) -> bool:
    """Feasibility: D_r = {d : m_d >= s_eff(d) + m_min}."""
    return m_d >= s_eff + m_min
