# The port's own copy of repro/core/propositions.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_oracles.py holds the two equal.
"""Propositions 1 and 2 as executable predicates.

These are used by the property-based tests (hypothesis) to check that the
cost model and the scheduler respect the paper's analytical claims, and by
EXPERIMENTS.md to report the empirical staleness margin.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Prop1Instance:
    """Two-candidate instance of Proposition 1.

    d1: same-rack (bandwidth B1, congestion c1, hit ratio rho1)
    d2: cross-pod (bandwidth B3 = B1/k, congestion c3, hit ratio rho2 >= rho1)
    """

    s_r: float
    B1: float
    k: float
    c1: float
    c3: float
    rho1: float
    rho2: float
    t_queue_d1: float = 0.0
    t_queue_d2: float = 0.0


def prop1_rhs(inst: Prop1Instance) -> float:
    """Right-hand side of Eq. (8)."""
    band = inst.k * (1.0 - inst.c1) / (1.0 - inst.c3) * (1.0 - inst.rho2)
    queue = inst.B1 * (1.0 - inst.c1) / inst.s_r * (inst.t_queue_d2 - inst.t_queue_d1)
    return band + queue


def prop1_condition(inst: Prop1Instance) -> bool:
    """True iff the same-rack candidate d1 wins despite the colder cache."""
    return (1.0 - inst.rho1) < prop1_rhs(inst)


def prop1_latencies(inst: Prop1Instance) -> tuple[float, float]:
    """Direct post-prefill latencies (transfer + queue) of (d1, d2)."""
    t1 = inst.s_r * (1.0 - inst.rho1) / (inst.B1 * (1.0 - inst.c1)) + inst.t_queue_d1
    B3 = inst.B1 / inst.k
    t2 = inst.s_r * (1.0 - inst.rho2) / (B3 * (1.0 - inst.c3)) + inst.t_queue_d2
    return t1, t2


def prop2_epsilon_bound(B_hi: float, c_hi: float, B_lo: float, c_lo: float) -> float:
    """Eq. (9): staleness tolerance for preserving the tier ordering.

    Requires the true ordering B_hi (1 - c_hi) > B_lo (1 - c_lo); returns the
    largest per-tier congestion error epsilon that cannot invert it.  A
    non-positive return means no tolerance exists (the faster tier is at or
    past the crossover, e.g. near saturation).
    """
    return (B_hi * (1.0 - c_hi) - B_lo * (1.0 - c_lo)) / (B_hi + B_lo)


def prop2_ordering_preserved(
    B_hi: float, c_hi: float, B_lo: float, c_lo: float, eps: float
) -> bool:
    """Worst-case stale ordering check: inflate the fast tier, deflate the slow."""
    stale_hi = B_hi * (1.0 - min(c_hi + eps, 0.999999))
    stale_lo = B_lo * (1.0 - max(c_lo - eps, 0.0))
    return stale_hi > stale_lo
