"""Plain PyTorch versions of the port's kernels.

Each computes what its CUDA kernel computes, with ordinary tensor ops: the
CPU tests hold them against the JAX package, ``ops`` runs them for tensors
on the CPU, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  Nothing on the main path calls them when the tensors
lie on a CUDA device.
"""

from __future__ import annotations

import torch

BIG = 3.0e38


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """q: (B, H, dh); k/v: (B, S, KV, dh); pos: valid length -> (B, H, dh),
    computed in f32 (``repro/kernels/ref.py::flash_decode_ref``)."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dh).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * dh ** -0.5
    mask = torch.arange(s, device=q.device) < pos
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def kv_pack_ref(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """out[i] = pool[table[i]]."""
    return pool.index_select(0, block_table.to(pool.device, torch.long))


def kv_unpack_ref(pool: torch.Tensor, buf: torch.Tensor,
                  block_table: torch.Tensor) -> torch.Tensor:
    """pool[table[i]] = buf[i], in place; returns ``pool``."""
    return pool.index_copy_(0, block_table.to(pool.device, torch.long), buf)


def netkv_score_cohort_ref(free_mem, queued, batch, hit_rows, tier_rows,
                           healthy, iter_scale, tier_bw, tier_lat, congestion,
                           infl_rows, *, s_r, input_len, iter_a, iter_b,
                           m_min, beta_max):
    """f32 copy of ``repro/kernels/netkv_score.py::_netkv_score_cohort_np``
    with the same operation order, so that its cost rows equal the twin's
    bit for bit.  Tensors: pool columns (D,), hit/tier rows (R, D),
    infl_rows (R, 4), s_r/input_len (R,); tier tables are 4 numbers.
    Returns (costs (R, D) f32, best (R,) int32)."""
    f32 = torch.float32
    dev = hit_rows.device if isinstance(hit_rows, torch.Tensor) else torch.device("cpu")

    def col(x):
        return torch.as_tensor(x, device=dev).to(f32)

    def scalar(x):
        return torch.tensor(float(x), dtype=f32, device=dev)

    free = col(free_mem)[None, :]
    que = col(queued)[None, :]
    bat = col(batch)[None, :]
    hlt = col(healthy)[None, :]
    scl = col(iter_scale)[None, :]
    hit_rows = col(hit_rows)
    tier = torch.as_tensor(tier_rows, device=dev).to(torch.int32)
    bw = col(tier_bw)
    lat4 = col(tier_lat)
    cong = col(congestion)
    infl = col(infl_rows).reshape(-1, 4)
    s_rv = col(s_r).reshape(-1)[:, None]
    l_rv = col(input_len).reshape(-1)[:, None]
    a, b = scalar(iter_a), scalar(iter_b)
    mm, bm = scalar(m_min), scalar(float(beta_max))
    one = scalar(1.0)

    hit = torch.minimum(hit_rows, l_rv)
    s_eff = s_rv * (one - hit / torch.maximum(l_rv, one))
    beff = torch.zeros_like(s_eff)
    lat = torch.zeros_like(s_eff)
    for t in range(4):
        sel = (tier == t).to(f32)
        bt = bw[t] * (one - cong[t]) / (one + infl[:, t:t + 1])
        beff = beff + sel * bt
        lat = lat + sel * lat4[t]
    t_xfer = s_eff / torch.maximum(beff, scalar(1e-9)) + lat
    t_iter = (a + b * bat) * scl
    blocked = torch.maximum(scalar(0.0), que - (bm - bat))
    t_queue = blocked * t_iter
    t_dec = (a + b * (bat + one)) * scl
    cost = t_xfer + t_queue + t_dec
    feasible = (hlt > 0.5) & (free >= s_eff + mm)
    cost = torch.where(feasible, cost, scalar(BIG))
    return cost, torch.argmin(cost, dim=1).to(torch.int32)
