"""A frozen NumPy copy of NetKV's decision, Eq. (2)-(7) and Algorithm 1's
argmin, from the inputs the cluster handed its scheduler.

Feasible decode instances are the healthy decode rows with free memory for
s_eff plus m_min.  Cost = T_xfer + T_queue + T_decode, in float64, in the
order of operations of the paper's equations; ties go to the lowest draw
of one uniform number per feasible candidate, from a generator seeded with
the configuration's ``tie_seed`` and drawn once per decision in call order.
"""

from __future__ import annotations

import numpy as np

ROLE_DECODE = 1


def iter_time(a: float, b: float, beta: np.ndarray) -> np.ndarray:
    """Eq. (5): t_iter(beta) = a + b * beta."""
    return a + b * np.maximum(beta, 0.0)


def select(rec: dict, deploy: dict, rng: np.random.Generator):
    """(instance_id, tier) Algorithm 1 picks for one recorded decision, or
    None where no candidate is feasible (no draw is made then)."""
    a, b = float(deploy["iter_model"]["a"]), float(deploy["iter_model"]["b"])
    beta_max, m_min = float(deploy["n_slots"]), float(deploy["m_min"])
    hit, l = rec["hit_tokens"], float(rec["input_len"])
    # Eq. (2)
    if l <= 0:
        s_eff = np.zeros_like(hit)
    else:
        s_eff = rec["kv_bytes"] * (1.0 - np.minimum(np.maximum(hit, 0.0), l) / l)
    mask = rec["healthy"] & (rec["role"] == ROLE_DECODE) & (rec["free_memory"] >= s_eff + m_min)
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return None
    # Eq. (4), per tier, then Eq. (3) gathered through the tier row
    bw, lat = np.array(rec["bandwidth"]), np.array(rec["latency"])
    cong, nfl = np.array(rec["congestion"]), np.array(rec["n_inflight"], dtype=np.float64)
    beff = np.array([bw[t] * (1.0 - min(max(cong[t], 0.0), 0.999999)) / (1.0 + max(nfl[t], 0))
                     for t in range(len(bw))])
    tier = rec["tier_row"]
    lat_row, b_row = lat[tier], beff[tier]
    if rec["prefill_remaining"] > 0.0 or rec["tail_bytes"] is not None:
        tail = s_eff if rec["tail_bytes"] is None else \
            np.minimum(np.maximum(rec["tail_bytes"], 0.0), s_eff)
        t_stream = np.maximum(s_eff / b_row, rec["prefill_remaining"] + tail / b_row)
        t_x = np.where(s_eff <= 0.0, lat_row, t_stream + lat_row)
    else:
        t_x = np.where(s_eff <= 0.0, lat_row, s_eff / b_row + lat_row)
    # Eq. (6), (7)
    beta = rec["batch"]
    blocked = np.maximum(0, rec["queued"] - (beta_max - beta))
    t_q = rec["iter_scale"] * (blocked * iter_time(a, b, beta))
    t_d = rec["iter_scale"] * iter_time(a, b, beta + 1)
    cost = t_x + t_q + t_d
    ties = rng.random(idx.size)
    j = int(idx[np.lexsort((ties, cost[idx]))[0]])
    return int(rec["ids"][j]), int(tier[j])


def mismatches(decisions: list[dict], deploy: dict) -> list[dict]:
    """The recorded decisions (all of a run, in call order) whose instance
    or tier differ from the reference's."""
    rng = np.random.default_rng(int(deploy["tie_seed"]))
    bad = []
    for rec in decisions:
        want = select(rec, deploy, rng)
        if want != rec["chosen"]:
            bad.append(dict(request_id=rec["request_id"], got=rec["chosen"], want=want))
    return bad
