"""CUDA netkv_score_cohort wrapper (``csrc/netkv_score.cu``).

Algorithm 1's scoring pass, Eq. (2)-(7), for R requests against one D-wide
pool snapshot, in f32, and per request the first (cost, index) minimum and
the runner-up.  Cost rows equal the f32 NumPy twin of the JAX package bit
for bit, so the host can re-derive feasibility from them.  Row i equals a
single-row call: every row runs the same code.

The kernel runs one thread block cluster a row; :func:`score_plan` sizes the
cluster and its blocks.  A decision copies its snapshot in once
(:func:`score_cohort_snapshot`), launches once and copies back only the
(R, 4) packed result: ``best``, ``best_cost``, ``second``, ``second_cost``,
the costs as float bits in int32 words (:func:`unpack_result`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build

BIG = 3.0e38
MAX_THREADS = 256   # threads a block (the kernel's launch bound)
MAX_CLUSTER = 8     # blocks a cluster: the portable cluster size
MAX_GRID_X = 2 ** 31 - 1

_VP, _I = ctypes.c_void_p, ctypes.c_int
_PARAMS = ctypes.c_float * 16


class ScorePlan(NamedTuple):
    cluster: int   # blocks a row, one thread block cluster
    threads: int   # threads a block
    span: int      # lanes a block: rank k takes [k * span, min(D, (k + 1) * span))
    grid: int      # blocks: R x cluster


def score_plan(r_rows: int, d_pool: int, n_sm: int) -> ScorePlan:
    """The launch of R rows of D lanes on a card of ``n_sm`` SMs.

    A row's cluster doubles while its blocks would hold more than
    MAX_THREADS lanes each and twice the clusters still fit the SMs, up to
    MAX_CLUSTER; a block then takes a 32-lane-aligned share of the row with
    as many threads as lanes, MAX_THREADS at most.  At R 1 × D 2048: 8 blocks
    of 256 threads, one lane a thread; at D 16 one block of one warp."""
    if r_rows < 1 or d_pool < 1 or n_sm < 1:
        raise ValueError(f"score_plan needs R, D and SMs >= 1, got {r_rows}, {d_pool}, {n_sm}")
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster * MAX_THREADS < d_pool
           and 2 * r_rows * cluster <= n_sm):
        cluster *= 2
    if r_rows * cluster > MAX_GRID_X:
        raise ValueError(f"score_plan: {r_rows} rows exceed the grid")
    span = _ceil(_ceil(d_pool, cluster), 32) * 32
    return ScorePlan(cluster, min(MAX_THREADS, span), span, r_rows * cluster)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def block_ranges(plan: ScorePlan, d_pool: int) -> list[tuple[int, int]]:
    """The lanes [lo, hi) of each block rank of a row's cluster."""
    return [(min(d_pool, k * plan.span), min(d_pool, (k + 1) * plan.span))
            for k in range(plan.cluster)]


def unpack_result(res: np.ndarray):
    """(best, best_cost, second, second_cost) columns of a packed (R, 4)
    int32 result; ``second`` is -1 where there is no feasible runner-up."""
    f = res.view(np.float32)
    return res[:, 0], f[:, 1], res[:, 2], f[:, 3]


def score_case(r: int, d: int, kind: str = "random", seed: int = 0,
               n_sm: int = 132) -> dict:
    """Seeded inputs of R rows × D lanes for the card tests and
    ``chip_smoke.py``, keyed by the wrapper's argument names (arrays as
    NumPy).  ``random``: a seeded pool and rows.  The other kinds give every
    lane the same cost and choose the feasible lanes by the plan on
    ``n_sm`` SMs: ``edge`` the last lane of cluster rank 0 and the first of
    rank 1, ``ranks`` one lane in every rank, ``none`` no lane, ``one`` one
    lane."""
    rng = np.random.default_rng(seed + r * 1000 + d)
    case = dict(
        free_mem=rng.uniform(1e9, 4e11, d), queued=rng.integers(0, 20, d),
        batch=rng.integers(0, 64, d), hit_rows=rng.uniform(0, 9000, (r, d)),
        tier_rows=rng.integers(0, 4, (r, d)), healthy=rng.random(d) > 0.15,
        iter_scale=rng.uniform(1, 2, d), infl_rows=rng.integers(0, 8, (r, 4)),
        s_r=rng.uniform(1e9, 4e9, r), input_len=rng.integers(1, 9000, r))
    if kind != "random":
        case.update(free_mem=np.full(d, 4e11), queued=np.full(d, 3), batch=np.full(d, 8),
                    hit_rows=np.full((r, d), 1024.0), tier_rows=np.full((r, d), 2),
                    healthy=np.zeros(d, bool), iter_scale=np.ones(d),
                    infl_rows=np.ones((r, 4)), s_r=np.full(r, 2e9), input_len=np.full(r, 4096))
        ranges = [(lo, hi) for lo, hi in block_ranges(score_plan(r, d, n_sm), d) if hi > lo]
        lanes = {"edge": [ranges[1][0] - 1, ranges[1][0]] if len(ranges) > 1 else [d - 1],
                 "ranks": [min(lo + 3, hi - 1) for lo, hi in ranges],
                 "none": [], "one": [int(rng.integers(d))]}[kind]
        case["healthy"][lanes] = True
    case = {k: v.astype(np.int32 if k == "tier_rows" else np.float32) for k, v in case.items()}
    return dict(case, tier_bw=[4.5e11, 1.25e10, 6.25e9, 3.125e9],
                tier_lat=[1e-6, 3e-6, 8e-6, 1.5e-5], congestion=[0.2, 0.1, 0.3, 0.05],
                iter_a=0.0124, iter_b=1.6e-5, m_min=2e9, beta_max=64)


def _lib():
    lib = build.library("netkv_score")
    fn = lib.netkv_score_cohort_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 11 + [_I] * 5 + [_VP] * 3
        fn.restype = _I
    return lib


def _params(tier_bw, tier_lat, congestion, iter_a, iter_b, m_min, beta_max):
    vals = []
    for what, x in (("tier_bw", tier_bw), ("tier_lat", tier_lat), ("congestion", congestion)):
        four = [float(v) for v in x]
        if len(four) != 4:
            raise ValueError(f"{what} needs one value per tier (4), got {len(four)}")
        vals += four
    return _PARAMS(*vals, float(iter_a), float(iter_b), float(m_min), float(beta_max))


def _launch(ptrs, params, r: int, d: int, cost: torch.Tensor, res: torch.Tensor,
            stream: int) -> None:
    """One launch on pointers the caller has checked: the pool columns
    free_mem, queued, batch, hit, tier, healthy, iter_scale, s_r,
    input_len, infl, in that order; writes ``cost`` (R, D) and ``res``
    (R, 4) on ``stream``."""
    plan = score_plan(r, d, build.sm_count(cost.device))
    lib = _lib()
    rc = lib.netkv_score_cohort_launch(
        *ptrs, ctypes.addressof(params), r, d, plan.cluster, plan.threads, plan.span,
        cost.data_ptr(), res.data_ptr(), stream)
    build.check(lib, rc, "netkv_score_cohort")
    build.LAUNCHES["netkv_score_cohort"] += 1


def netkv_score_cohort(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                       iter_scale, tier_bw, tier_lat, congestion, infl_rows,
                       *, s_r, input_len, iter_a: float, iter_b: float,
                       m_min: float, beta_max: int):
    """CUDA tensors: pool columns free_mem/queued/batch/healthy/iter_scale
    (D,) f32; hit_rows (R, D) f32; tier_rows (R, D) int32; infl_rows (R, 4)
    f32; s_r/input_len (R,) f32.  Tier tables are 4 numbers each.

    Returns (costs (R, D) f32, result (R, 4) int32), both on the card."""
    f32 = torch.float32
    build.require(hit_rows, "hit_rows", dtype=f32, ndim=2, align=4)
    dev = hit_rows.device
    r, d = hit_rows.shape
    if d == 0:
        raise ValueError("netkv_score_cohort needs at least one lane")
    cols = {"free_mem": free_mem, "queued": queued, "batch": batch,
            "healthy": healthy, "iter_scale": iter_scale}
    for name, t in cols.items():
        build.require(t, name, dtype=f32, ndim=1, device=dev, align=4)
        if t.shape[0] != d:
            raise ValueError(f"{name} has {t.shape[0]} lanes, hit_rows {d}")
    build.require(tier_rows, "tier_rows", dtype=torch.int32, ndim=2, device=dev, align=4)
    build.require(infl_rows, "infl_rows", dtype=f32, ndim=2, device=dev, align=4)
    build.require(s_r, "s_r", dtype=f32, ndim=1, device=dev, align=4)
    build.require(input_len, "input_len", dtype=f32, ndim=1, device=dev, align=4)
    if tier_rows.shape != (r, d) or infl_rows.shape != (r, 4) \
            or s_r.shape != (r,) or input_len.shape != (r,):
        raise ValueError("per-row inputs disagree with hit_rows' (R, D)")
    params = _params(tier_bw, tier_lat, congestion, iter_a, iter_b, m_min, beta_max)
    cost = torch.empty((r, d), dtype=f32, device=dev)
    res = torch.empty((r, 4), dtype=torch.int32, device=dev)
    if r > 0:
        ptrs = [t.data_ptr() for t in (free_mem, queued, batch, hit_rows, tier_rows, healthy,
                                       iter_scale, s_r, input_len, infl_rows)]
        _launch(ptrs, params, r, d, cost, res, torch.cuda.current_stream(dev).cuda_stream)
    return cost, res


class _Staging:
    """A device's snapshot buffers, reused from call to call: the snapshot
    in pinned host memory and on the card, the packed result on the card and
    in pinned host memory, each grown geometrically.  Every call ends in a
    synchronisation of the stream, so no copy or launch of one call is in
    flight when the next call writes a buffer again."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = self.card = self.res = self.out = None

    def snapshot(self, words: int):
        if self.host is None or self.host.numel() < words:
            n = max(words, 2 * (0 if self.host is None else self.host.numel()))
            self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self.card = torch.empty(n, dtype=torch.float32, device=self.device)
        return self.host, self.card

    def result(self, rows: int):
        if self.out is None or self.out.shape[0] < rows:
            n = max(rows, 2 * (0 if self.out is None else self.out.shape[0]))
            self.res = torch.empty((n, 4), dtype=torch.int32, device=self.device)
            self.out = torch.empty((n, 4), dtype=torch.int32, pin_memory=True)
        return self.res[:rows], self.out[:rows]


_STAGING: dict[torch.device, _Staging] = {}


def score_cohort_snapshot(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                          iter_scale, tier_bw, tier_lat, congestion, infl_rows, *,
                          s_r, input_len, iter_a: float, iter_b: float,
                          m_min: float, beta_max: int, device: torch.device):
    """R requests against a host (NumPy) snapshot of the pool.  The columns
    (D,), the hit and tier rows (R, D), the self-contention rows (R, 4) and
    the per-request s_r and input_len (R,) are rounded to f32 into one
    buffer; on the card it is pinned and crosses in one copy, the kernel
    launches once, and only the (R, 4) result crosses back, after one
    synchronisation.  On the CPU the plain version scores the same buffer.

    Returns (costs (R, D) f32 on ``device``, result (R, 4) int32 NumPy)."""
    from . import ops

    d = len(free_mem)
    hit_rows = np.asarray(hit_rows).reshape(-1, d)
    r = hit_rows.shape[0]
    rd = r * d
    words = 5 * d + 2 * rd + 6 * r
    on_card = device.type == "cuda"
    if on_card:
        stage = _STAGING.get(device)
        if stage is None:
            stage = _STAGING[device] = _Staging(device)
        host_t, card = stage.snapshot(words)
        host = host_t.numpy()
    else:
        host = np.empty(words, np.float32)
    for i, col in enumerate((free_mem, queued, batch, healthy, iter_scale)):
        host[i * d:(i + 1) * d] = col
    o = 5 * d
    host[o:o + rd] = hit_rows.ravel()
    host[o + rd:o + 2 * rd].view(np.int32)[:] = np.asarray(tier_rows).ravel()
    o += 2 * rd
    host[o:o + 4 * r] = np.asarray(infl_rows, np.float64).ravel()
    host[o + 4 * r:o + 5 * r] = s_r
    host[o + 5 * r:o + 6 * r] = input_len
    if not on_card:
        buf = torch.from_numpy(host)
        pool = buf[:5 * d].view(5, d)
        costs, res = ops.netkv_score_cohort(
            pool[0], pool[1], pool[2], buf[5 * d:5 * d + rd].view(r, d),
            buf[5 * d + rd:o].view(torch.int32).view(r, d), pool[3], pool[4],
            tier_bw, tier_lat, congestion, buf[o:o + 4 * r].view(r, 4),
            s_r=buf[o + 4 * r:o + 5 * r], input_len=buf[o + 5 * r:o + 6 * r],
            iter_a=iter_a, iter_b=iter_b, m_min=m_min, beta_max=beta_max)
        return costs, res.numpy()
    build.require(card, "snapshot", dtype=torch.float32, ndim=1, align=16)
    params = _params(tier_bw, tier_lat, congestion, iter_a, iter_b, m_min, beta_max)
    stream = torch.cuda.current_stream(device)
    costs = torch.empty((r, d), dtype=torch.float32, device=device)
    res, out = stage.result(r)
    card[:words].copy_(host_t[:words], non_blocking=True)
    base = card.data_ptr()
    offs = (0, d, 2 * d, 5 * d, 5 * d + rd, 3 * d, 4 * d, o + 4 * r, o + 5 * r, o)
    _launch([base + 4 * w for w in offs], params, r, d, costs, res, stream.cuda_stream)
    out.copy_(res, non_blocking=True)
    stream.synchronize()
    return costs, out.numpy().copy()
