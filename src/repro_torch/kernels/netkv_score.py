"""CUDA netkv_score_cohort wrapper (``csrc/netkv_score.cu``).

Algorithm 1's scoring pass, Eq. (2)-(7), and the masked argmin with the
lowest index, for R requests against one D-wide pool snapshot, in f32.  Cost
rows equal the f32 NumPy twin of the JAX package bit for bit, so the host
can re-derive feasibility from them.  Row i equals a single-row call: no
padding of R = 1 is needed, because every row runs the same code.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

BIG = 3.0e38

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.library("netkv_score")
    fn = lib.netkv_score_cohort_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 10 + [_F] * 16 + [_I, _I, _VP, _VP, _VP]
        fn.restype = _I
    return lib


def _four(x, what: str) -> list[float]:
    vals = [float(v) for v in x]
    if len(vals) != 4:
        raise ValueError(f"{what} needs one value per tier (4), got {len(vals)}")
    return vals


def netkv_score_cohort(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                       iter_scale, tier_bw, tier_lat, congestion, infl_rows,
                       *, s_r, input_len, iter_a: float, iter_b: float,
                       m_min: float, beta_max: int):
    """CUDA tensors: pool columns free_mem/queued/batch/healthy/iter_scale
    (D,) f32; hit_rows (R, D) f32; tier_rows (R, D) int32; infl_rows (R, 4)
    f32; s_r/input_len (R,) f32.  Tier tables are 4 numbers each.

    Returns (costs (R, D) f32, best (R,) int32)."""
    f32 = torch.float32
    build.require(hit_rows, "hit_rows", dtype=f32, ndim=2, align=4)
    dev = hit_rows.device
    r, d = hit_rows.shape
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
    cost = torch.empty((r, d), dtype=f32, device=dev)
    best = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return cost, best  # nothing to launch
    lib = _lib()
    rc = lib.netkv_score_cohort_launch(
        free_mem.data_ptr(), queued.data_ptr(), batch.data_ptr(),
        hit_rows.data_ptr(), tier_rows.data_ptr(), healthy.data_ptr(),
        iter_scale.data_ptr(), s_r.data_ptr(), input_len.data_ptr(),
        infl_rows.data_ptr(),
        *_four(tier_bw, "tier_bw"), *_four(tier_lat, "tier_lat"),
        *_four(congestion, "congestion"),
        float(iter_a), float(iter_b), float(m_min), float(beta_max),
        r, d, cost.data_ptr(), best.data_ptr(), build.stream_ptr(hit_rows))
    build.check(lib, rc, "netkv_score_cohort")
    build.LAUNCHES["netkv_score_cohort"] += 1
    return cost, best


def score_cohort_snapshot(free_mem, queued, batch, hit_rows, tier_rows, healthy,
                          iter_scale, tier_bw, tier_lat, congestion, infl_rows, *,
                          s_r, input_len, iter_a: float, iter_b: float,
                          m_min: float, beta_max: int, device: torch.device):
    """R requests against a host (NumPy) snapshot of the pool: the columns
    (D,), the hit and tier rows (R, D), the self-contention rows (R, 4) and
    the per-request s_r and input_len (R,) are rounded to f32 on the host,
    packed into one buffer and moved to ``device`` in one copy, then scored
    in one launch through ``ops.netkv_score_cohort``.

    Returns (costs (R, D) f32, best (R,) int32), both NumPy on the host."""
    from . import ops

    d = len(free_mem)
    hit_rows = np.asarray(hit_rows).reshape(-1, d)
    r = hit_rows.shape[0]
    rd = r * d
    host = np.empty(5 * d + 2 * rd + 6 * r, np.float32)
    for i, col in enumerate((free_mem, queued, batch, healthy, iter_scale)):
        host[i * d:(i + 1) * d] = col
    o = 5 * d
    host[o:o + rd] = hit_rows.ravel()
    host[o + rd:o + 2 * rd].view(np.int32)[:] = np.asarray(tier_rows).ravel()
    o += 2 * rd
    host[o:o + 4 * r] = np.asarray(infl_rows, np.float64).ravel()
    host[o + 4 * r:o + 5 * r] = s_r
    host[o + 5 * r:o + 6 * r] = input_len
    buf = torch.from_numpy(host).to(device)
    pool = buf[:5 * d].view(5, d)
    rows = buf[5 * d:o]
    costs, best = ops.netkv_score_cohort(
        pool[0], pool[1], pool[2], rows[:rd].view(r, d),
        rows[rd:].view(torch.int32).view(r, d), pool[3], pool[4],
        tier_bw, tier_lat, congestion, buf[o:o + 4 * r].view(r, 4),
        s_r=buf[o + 4 * r:o + 5 * r], input_len=buf[o + 5 * r:o + 6 * r],
        iter_a=iter_a, iter_b=iter_b, m_min=m_min, beta_max=beta_max)
    return costs.cpu().numpy(), best.cpu().numpy()
