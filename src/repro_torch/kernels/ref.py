"""Plain PyTorch versions of the port's kernels.

Each computes what its CUDA kernel computes, with ordinary tensor ops: the
CPU tests hold them against the JAX package, ``ops`` runs them for tensors
on the CPU, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  Nothing on the main path calls them when the tensors
lie on a CUDA device, but for the MoE routing and its aux loss
(:func:`route_ref`, :func:`moe_aux_loss`): ``models/moe.py``'s ``bmm`` path
(prefill, training) routes with them, so that K9's twin and that path share
one routing.
"""

from __future__ import annotations

import torch

BIG = 3.0e38


def _decode_logits(q, k_cache, pos):
    """(q grouped (B, KV, G, dh) f32, masked logits (B, KV, G, S) f32)."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, dh).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * dh ** -0.5
    if isinstance(pos, torch.Tensor):
        pos = pos.to(q.device).reshape(-1, 1, 1, 1)
    mask = torch.arange(s, device=q.device) < pos
    return qg, logits.masked_fill(~mask, float("-inf"))


def _with_self(qg, logits, k_new):
    """The logits with the self term's (B, KV, G, 1) appended last."""
    if k_new is None:
        return logits
    self_logit = torch.einsum("bkgd,bkd->bkg", qg, k_new.float()) * qg.shape[-1] ** -0.5
    return torch.cat([logits, self_logit[..., None]], dim=-1)


def _values(k_cache, v_cache, v_new):
    v = v_cache.float()
    return v if v_new is None else torch.cat([v, v_new.float()[:, None]], dim=1)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, k_new: torch.Tensor | None = None,
                     v_new: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, dh); k/v: (B, S, KV, dh); pos: the valid length, an int, or
    a (B,) integer tensor of each row's -> (B, H, dh), computed in f32
    (``repro/kernels/ref.py::flash_decode_ref``; a vector masks as
    ``repro/models/attention.py::decode_attention`` does).  ``k_new``/
    ``v_new`` (B, KV, dh): the current token's key and value as one more
    key in the same softmax (``decode_attention(k_new=, v_new=)``), with
    which a length of 0 attends to the token alone."""
    b, h, dh = q.shape
    qg, logits = _decode_logits(q, k_cache, pos)
    p = torch.softmax(_with_self(qg, logits, k_new), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, _values(k_cache, v_cache, v_new))
    return out.reshape(b, h, dh).to(q.dtype)


def flash_decode_partials_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                              pos: int, lengths: torch.Tensor | None = None, *,
                              start: int = 0, k_new: torch.Tensor | None = None,
                              v_new: torch.Tensor | None = None):
    """The plain version of ``flash_decode.flash_decode_partials``: a
    sequence shard's (acc (B, H, dh), m (B, H), l (B, H)) in f32 over its
    local rows ``[0, min(pos, lengths - start))`` and the self term where
    given; a row with no key gives m = -1e30, l = 0, acc = 0."""
    b, h, dh = q.shape
    valid = pos if lengths is None else torch.clamp(lengths.to(q.device).long() - start,
                                                    max=int(pos))
    qg, logits = _decode_logits(q, k_cache, valid)
    logits = _with_self(qg, logits, k_new)
    m = logits.amax(dim=-1)
    m = torch.where(torch.isinf(m), torch.full_like(m, -1e30), m)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkgs,bskd->bkgd", p, _values(k_cache, v_cache, v_new))
    return acc.reshape(b, h, dh), m.reshape(b, h), p.sum(dim=-1).reshape(b, h)


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
    Returns (costs (R, D) f32, result (R, 4) int32): per row the first
    argmin ``best`` and its cost, and ``second``, the first argmin with
    ``best`` masked to +inf, and its cost; ``second`` is -1 when D is 1 or
    its cost is not below BIG / 2.  Costs are float bits in the int32 words
    (``netkv_score.unpack_result``)."""
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
    best = torch.argmin(cost, dim=1, keepdim=True)
    masked = cost.scatter(1, best, float("inf"))
    second = torch.argmin(masked, dim=1, keepdim=True)
    second_cost = masked.gather(1, second)
    second = torch.where(second_cost.double() < BIG / 2, second, -1)
    res = torch.cat([best.to(torch.int32), cost.gather(1, best).view(torch.int32),
                     second.to(torch.int32), second_cost.view(torch.int32)], dim=1)
    return cost, res


# ------------------------------------------------------------ water-filling
def waterfill_prep(paths: torch.Tensor, caps: torch.Tensor, active: torch.Tensor):
    """The first-encounter link order of ``FlowPlane._recompute_rates``
    (``repro/kernels/waterfill.py:119-129``) for the plain version; the
    kernel builds the same order in its block.  No op reads a value back to
    the host.

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


# ------------------------------------------------------------------ WKV-6
def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor):
    """Sequential WKV-6 from a zero state (``repro/kernels/ref.py::
    rwkv_scan_ref``).  r/k/v/w (B, T, H, dh) in any float dtype, w the
    per-step decay; u (H, dh).  Everything is upcast to f32; the state
    (B, H, dh, dh) is indexed [k_idx, v_idx] and each step computes
    ``y = sum_k r_k (S + u_k k_k v) ; S = S * w_k + k v``.

    Returns (y (B, T, H, dh) in r's dtype, final state f32)."""
    b, t, h, dh = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    ys = torch.empty((b, t, h, dh), dtype=torch.float32, device=r.device)
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        ys[:, i] = (rf[:, i, :, :, None] * (state + uf * kv)).sum(dim=-2)
        state = state * wf[:, i, :, :, None] + kv
    return ys.to(r.dtype), state


def moe_decode_ref(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """x (T, d); experts and gates (T, k); w_gate, w_up (E, d, f), w_down
    (E, f, d) -> (T, d) in x's dtype: each (token, kk) slot through its
    expert's SwiGLU over the gathered weights of the routed experts alone,
    products in f32, each rounded to x's dtype where ``models/moe.py``'s
    ``bmm`` path rounds (its gate and up outputs, silu, their product, the
    down output, the gated term); a token's k terms added in k order, each
    sum rounded."""
    t, k = experts.shape
    flat = experts.reshape(-1)

    def rnd(v):
        return v.to(x.dtype).float()

    xs = x.float().repeat_interleave(k, dim=0)[:, None]             # (T k, 1, d)
    g = rnd(torch.bmm(xs, w_gate[flat].float()))
    u = rnd(torch.bmm(xs, w_up[flat].float()))
    h = rnd(rnd(torch.nn.functional.silu(g)) * u)
    y = rnd(torch.bmm(h, w_down[flat].float())[:, 0])               # (T k, d)
    terms = rnd(y * rnd(gates.reshape(-1, 1).float())).view(t, k, -1)
    out = terms[:, 0]
    for j in range(1, k):
        out = rnd(out + terms[:, j])
    return out.to(x.dtype)


def route_ref(xf: torch.Tensor, router: torch.Tensor, top_k: int, renormalize: bool = True):
    """xf (T, d); router (d, E) -> (probs (T, E), gates (T, k), experts (T,
    k)) in f32 from the up-cast operands.  Experts are in descending
    probability, the lower index first on a tie (``lax.top_k``'s order),
    which a stable sort gives.  The gates are the k probabilities over their
    sum, or, without ``renormalize``, the probabilities themselves."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    if renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def moe_aux_loss(counts: torch.Tensor, probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The load-balancing loss of T tokens, f32: sum_e count_e / (T k) *
    mean_t probs[t, e] * E, from each expert's count of slots (E,) and the
    probabilities (T, E)."""
    t, e = probs.shape
    return (counts.float() / (t * top_k) * probs.mean(dim=0)).sum() * e


def moe_route_ref(x: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
                  renormalize: bool = True):
    """x (T, d); router (d, E) -> (experts (T, k) int64, gates_kept (T, k)
    f32, aux () f32): the top k of softmax(x router) in f32 from the up-cast
    operands, in descending probability, the lower index first on a tie (a
    stable sort's order); their gates over their sum, or as they are
    without ``renormalize``; a slot's gate set to 0 where ``cap`` earlier
    tokens already route to its expert (a token's k experts are distinct, so
    that count is its position in the token-major order); the load-balancing
    loss (:func:`moe_aux_loss`)."""
    probs, gates, experts = route_ref(x, router, top_k, renormalize)
    member = torch.zeros(probs.shape, dtype=torch.int32, device=x.device).scatter_(1, experts, 1)
    pos = (torch.cumsum(member, dim=0) - member).gather(1, experts)
    aux = moe_aux_loss(member.sum(dim=0), probs, top_k)
    return experts, torch.where(pos < cap, gates, 0.0), aux
