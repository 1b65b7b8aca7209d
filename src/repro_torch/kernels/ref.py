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


# ------------------------------------------------------------ water-filling
def waterfill_prep(paths: torch.Tensor, caps: torch.Tensor, active: torch.Tensor):
    """The first-encounter link order of ``FlowPlane._recompute_rates``
    (``repro/kernels/waterfill.py:119-129``), shared by the plain version
    and the kernel's wrapper.  No op reads a value back to the host.

    paths (F, H) link ids, short paths padded with the pad link L; caps
    (L + 1,); active (F,) bool.  Returns ``(P, perm, counts0, caps_p0)``:
    P (F, H) int64 permuted ids with inactive rows on the pad link, perm
    (L + 1,) int64 (permuted -> original id), the unfixed-flow hop counts
    (L + 1,) int64 with the pad's zeroed, and caps in permuted order."""
    dev = caps.device
    lp1 = caps.shape[0]
    pad_link = lp1 - 1
    p0 = torch.where(active[:, None], paths.to(dev, torch.int64), pad_link)
    flat = p0.reshape(-1)
    npos = flat.numel()
    enc = torch.full((lp1,), npos + 1, dtype=torch.int64, device=dev)
    enc = enc.scatter_reduce(0, flat, torch.arange(npos, device=dev), reduce="amin")
    perm = torch.argsort(enc, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(lp1, device=dev)
    p = inv[p0]
    counts0 = torch.zeros(lp1, dtype=torch.int64, device=dev).index_add_(
        0, p.reshape(-1), torch.ones(npos, dtype=torch.int64, device=dev))
    counts0 = torch.where(torch.arange(lp1, device=dev) == inv[pad_link], 0, counts0)
    return p, perm, counts0, caps[perm]


def waterfill_fixed_point_ref(paths: torch.Tensor, caps: torch.Tensor,
                              active: torch.Tensor | None = None):
    """Progressive max-min water-filling, one bottleneck link a round
    (``repro/kernels/waterfill.py::waterfill_fixed_point``), in the dtype of
    ``caps``.  In f64 it is the port of the jitted f64 route and equals
    ``FlowPlane._recompute_rates`` bit for bit; in f32 it is the plain
    version of the ``waterfill_progressive`` kernel (K5).  The loop's
    condition is read on the host every round.

    Returns ``(rates (F,), trace_links (max(F, 1),) int32 in original link
    ids, trace_shares (max(F, 1),), n_rounds)``; the trace is -1 / inf past
    ``n_rounds``."""
    dtype, dev = caps.dtype, caps.device
    n_flows = paths.shape[0]
    active = (torch.ones(n_flows, dtype=torch.bool, device=dev) if active is None
              else active.to(dev, torch.bool))
    p, perm, counts, caps_p = waterfill_prep(paths, caps, active)
    caps_p = caps_p.clone()
    inf = float("inf")
    rates = torch.zeros(n_flows, dtype=dtype, device=dev)
    unfixed = active.clone()
    tl = torch.full((max(n_flows, 1),), -1, dtype=torch.int32, device=dev)
    ts = torch.full((max(n_flows, 1),), inf, dtype=dtype, device=dev)
    r = 0
    nuf = int(active.sum())
    while nuf > 0:
        # A link no unfixed flow crosses has share inf (the kernels write
        # BIG = 3e38 there; no real share comes near either).
        ok = counts > 0
        shares = torch.where(ok, caps_p / torch.where(ok, counts, 1).to(dtype),
                             torch.full((), inf, dtype=dtype, device=dev))
        lid = int(torch.argmin(shares))
        share = shares[lid]
        if float(share) == inf:
            # No finite share left: strand the rest at inf, as the plane does.
            rates[unfixed] = inf
            break
        onb = unfixed & (p == lid).any(dim=1)
        rates[onb] = share
        # Fixed rows subtract along their whole padded path; every target
        # gets the same share, so the order of the additions is immaterial.
        idx = p[onb].reshape(-1)
        caps_p.index_add_(0, idx, (-share).expand(idx.numel()))
        caps_p.clamp_(min=0.0)
        counts.index_add_(0, idx, torch.full_like(idx, -1))
        nuf -= int(onb.sum())
        unfixed &= ~onb
        tl[r] = perm[lid].to(torch.int32)
        ts[r] = share
        r += 1
    return rates, tl, ts, r


def waterfill_rates_fast_ref(caps: torch.Tensor, active: torch.Tensor,
                             nhops: torch.Tensor) -> torch.Tensor:
    """Parallel-bottleneck max-min water-filling over a batch of flow
    tables (``repro/kernels/waterfill.py::waterfill_rates_fast`` with
    ``nhops=``, vmapped), in the dtype of ``caps``.  In f64 it is the port
    of the jitted f64 route; in f32 the plain version of the
    ``waterfill_fast`` kernel (K6).  The loop's condition is read on the
    host every round; a lane that has converged idles.

    caps (S, L + 1); active (S, F) bool; nhops (S, F, L + 1) hops of flow f
    on link l (inactive rows and the pad column are zeroed here).
    Returns rates (S, F)."""
    dtype, dev = caps.dtype, caps.device
    lp1 = caps.shape[-1]
    active = active.to(torch.bool)
    nh = torch.where(active[..., None], nhops.to(dtype), torch.zeros((), dtype=dtype, device=dev))
    nh[..., lp1 - 1] = 0.0
    on_f = nh > 0.5
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    rates = torch.zeros(active.shape, dtype=dtype, device=dev)
    unfixed = active.clone()
    nuf = active.sum(dim=-1)
    while bool((nuf > 0).any()):
        counts = torch.matmul(unfixed.to(dtype)[..., None, :], nh)[..., 0, :]
        used = torch.matmul(torch.where(torch.isfinite(rates), rates, zero)[..., None, :],
                            nh)[..., 0, :]
        caps_c = torch.clamp(caps - used, min=0.0)
        shares = torch.where(counts > 0.5, caps_c / counts, inf)
        live = on_f & unfixed[..., None]
        s_f = torch.where(live, shares[..., None, :], inf).amin(dim=-1)
        # Link l is a level bottleneck iff share_l <= the least bottleneck
        # share of its unfixed flows.
        lfm = torch.where(live, s_f[..., None], inf).amin(dim=-2)
        fixable = (counts > 0.5) & (shares <= lfm)
        fix = unfixed & torch.isfinite(s_f) & (
            live & fixable[..., None, :] & (shares[..., None, :] <= s_f[..., None])
        ).any(dim=-1)
        anyfix = fix.any(dim=-1)
        rates = torch.where(fix, s_f, rates)
        rates = torch.where(~anyfix[..., None] & unfixed, inf, rates)
        nuf = torch.where(anyfix, nuf - fix.sum(dim=-1), torch.zeros_like(nuf))
        unfixed = unfixed & ~fix & anyfix[..., None]
    return rates
