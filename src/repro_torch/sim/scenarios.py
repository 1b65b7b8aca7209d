"""ScenarioPlane: fleet-scale what-if sweeps as one batched PyTorch program
(the port of ``repro/sim/scenarios.py``).

The JAX module ``vmap``s a jitted fixed-timestep fluid scenario model over a
leading scenario axis.  Here that axis is written out: every state tensor
of a step is (S, ...) for S scenarios, and the ``fori_loop`` over steps is a
Python loop whose step is a fixed sequence of tensor ops on the sweep's
device.  The two fixed points the JAX module fuses in are

* the max-min transfer drain: ``backend="torch"`` runs the f64 plain loop
  (``kernels/ref.py::waterfill_rates_fast_ref``, the port of the jitted f64
  route); ``backend="kernel"`` runs the ``waterfill_fast`` CUDA kernel
  (K6) in f32, one launch a step for all S scenarios, or its plain f32
  version for tensors on the CPU;
* the continuous-batching cohort step, :func:`cohort_step`.

Modelling contract, as in the JAX module: the surrounding engine is a
*fluid* (dt-stepped) approximation of the event loop, which stays the
ground truth for absolute paper numbers.  Batched row ``i`` equals a solo
run of scenario ``i`` at the same padding: every op of a step acts on each
scenario's row alone, and a converged water-filling lane idles.

Where the port differs from the JAX arithmetic, and why:

* the tie-break jitter is JAX's ``random.uniform`` on the scenario's
  ``PRNGKey(seed)``, reproduced bit for bit by :func:`threefry_uniform`;
* XLA contracts f64 ``a + b * c`` into one FMA on the CPU; PyTorch rounds the
  product and the sum apart.  So ``t_it``, ``t_dec``, ``cost_cla``,
  ``grown``, ``xfer_rem`` and the percentile interpolation may differ by an
  ulp from the JAX sweep, and the float summaries agree to a tolerance.
  The step end ``k * dt + dt``, which ``t_first`` and ``t_fin`` record, is
  rounded once as the FMA does (:func:`_step_end`);
* scatter-adds with unequal addends (pinned KV at admission, the release at
  finish) are sequential sums in row order, as XLA's scatter on the CPU:
  :func:`_seg_add` takes them as one cumulative sum, sequential on the CPU and
  deterministic on the card (where the scan's association differs).
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Sequence

import numpy as np
import torch

from ..core.cost import (
    H100_TP4_ITER, H100_TP4_PREFILL, IterTimeModel, LLAMA3_70B_KV,
    ModelKVSpec, PrefillTimeModel,
)
from ..cluster.topology import FatTree, MAX_PATH_LEN, make_instances, make_nic_policy
from ..traces.mooncake import generate_trace

BIG = 1e30
_SEQ_LIM = 1 << 32
F64 = torch.float64


# ------------------------------------------------------------ PRNG jitter
def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 counter pairs (Salmon et al.,
    SC'11), JAX's default PRNG."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = x0 ^ _rotl(x1, r)
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_uniform(seed: int, shape: tuple) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, float64)`` bit
    for bit, for a seed below 2**32: the key is (0, seed), the counters the
    row-major index split into (high, low) words (JAX's partitionable
    threefry), the 64 bits (out0 << 32 | out1) fill the mantissa of a
    float in [1, 2), and 1 is subtracted."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32((0, int(seed)), hi, lo)
    bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    one = np.uint64(0x3FF0000000000000)
    return (((bits >> np.uint64(12)) | one).view(np.float64) - 1.0).reshape(shape)


# --------------------------------------------------------- segment sums
def _seg_count(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """(..., R) -> (..., n) int64: how many masked rows target each slot."""
    tgt = torch.where(mask, idx.clamp(0, n - 1), n)
    return (tgt[..., None] == torch.arange(n, device=idx.device)).sum(dim=-2)


def _seg_add(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].add(vals)`` along the last axis of base (..., n) for
    rows (..., R), summed in row order: ((base + v0) + v1) + ... per slot,
    as XLA's scatter on the CPU.  One cumulative sum over the rows, with
    base as row 0 and zeros where a row targets another slot."""
    n = base.shape[-1]
    hit = idx[..., None] == torch.arange(n, device=idx.device)
    terms = torch.where(hit, vals[..., None], torch.zeros((), dtype=vals.dtype,
                                                          device=vals.device))
    return torch.cat([base[..., None, :], terms], dim=-2).cumsum(dim=-2)[..., -1, :]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., n) gathered at idx (..., R) along the last axis."""
    return torch.gather(x, -1, idx)


# ----------------------------------------------------------- cohort step
def cohort_step(tokens, out_len, inst, seq, grown, live, inst_cohort, pinned,
                *, kv_per_token: float, exact_clamp: bool = True):
    """One continuous-batching iteration over the request table
    (``repro/sim/scenarios.py::cohort_step``).

    Every live row of an iterating instance gains one token, pins
    ``kv_per_token`` more bytes on its instance, and rows reaching
    ``out_len`` finish, releasing ``grown`` bytes clamped at zero.
    ``exact_clamp=True`` applies the releases one row at a time in
    (instance, seq) order, the reference engine's float sequence;
    ``exact_clamp=False`` subtracts each instance's summed release once.

    Rows are (..., R); ``inst_cohort`` (..., K) bool; ``pinned`` (..., K + 1)
    with a pad slot; ``kv_per_token`` a number or one per leading index.
    Leading axes are independent scenarios.
    Returns ``(tokens, live, pinned, first, fin, fin_per_inst)``."""
    k = inst_cohort.shape[-1]
    inst_c = inst.clamp(0, k - 1)
    rows = live & _take(inst_cohort, inst_c)
    tokens = torch.where(rows, tokens + 1, tokens)
    first = rows & (tokens == 1)
    kpt = torch.as_tensor(kv_per_token, dtype=pinned.dtype, device=pinned.device)
    pinned = _seg_add(pinned, torch.where(rows, inst_c, k),
                      kpt[..., None].expand(grown.shape))
    fin = rows & (tokens >= out_len)
    if exact_clamp:
        pinned = pinned.clone()
        flat_p = pinned.reshape(-1, k + 1)
        flat_fin = fin.reshape(-1, fin.shape[-1])
        key = inst_c.to(torch.int64) * _SEQ_LIM + seq.to(torch.int64)
        flat_key = key.reshape(-1, key.shape[-1])
        flat_inst = inst_c.reshape(-1, inst_c.shape[-1])
        flat_grown = grown.reshape(-1, grown.shape[-1])
        for b in range(flat_p.shape[0]):
            rows_b = torch.nonzero(flat_fin[b]).flatten()
            order = rows_b[torch.argsort(flat_key[b, rows_b], stable=True)]
            for r in order.tolist():
                s = int(flat_inst[b, r])
                flat_p[b, s] = torch.clamp(flat_p[b, s] - flat_grown[b, r], min=0.0)
        pinned = flat_p.reshape(pinned.shape)
    else:
        rel = _seg_add(torch.zeros_like(pinned), torch.where(fin, inst_c, k), grown)
        pinned = torch.clamp(pinned - rel, min=0.0)
    live = live & ~fin
    fin_per_inst = _seg_count(inst_c, fin, k)
    return tokens, live, pinned, first, fin, fin_per_inst


# ------------------------------------------------------------- scenarios
@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One cell of a what-if grid (mirrors the SimConfig knobs the fluid
    engine models).  ``rewires`` is a schedule of ``(time, {tier: scale})``
    multiplicative capacity edits (the OCS timeline)."""

    seed: int = 0
    scheduler: str = "netkv-full"   # "cla" | "netkv-static" | "netkv-full"
    profile: str = "chatbot"
    target_rps: float = 16.0
    warmup: float = 2.0
    measure: float = 8.0
    drain: float = 4.0
    chunk_tokens: int | None = None
    kv_streaming: bool = False
    nic_policy: str = "hash"
    background: float = 0.0
    rewires: Sequence[tuple] = ()
    # cluster shape (must match across one sweep: one batched program)
    n_pods: int = 2
    racks_per_pod: int = 2
    servers_per_rack: int = 2
    gpus_per_server: int = 8
    nics_per_server: int = 1
    tp: int = 4
    n_prefill: int = 4
    beta_max: int = 64
    hbm_free_per_gpu: float = 45e9
    m_min: float = 2e9
    kv_spec: ModelKVSpec = LLAMA3_70B_KV
    iter_model: IterTimeModel = H100_TP4_ITER
    prefill_model: PrefillTimeModel = H100_TP4_PREFILL
    # CacheLoadAware weights (only read when scheduler == "cla")
    w_cache: float = 1.0
    w_load: float = 1.0

    @property
    def duration(self) -> float:
        return self.warmup + self.measure

    @property
    def horizon(self) -> float:
        return self.duration + self.drain

    def tree_shape(self) -> tuple:
        return (self.n_pods, self.racks_per_pod, self.servers_per_rack,
                self.gpus_per_server, self.nics_per_server, self.tp,
                self.n_prefill)


_SCHED_FLAGS = {
    # (use_xfer, use_cong): cla scores load only; netkv-static prices
    # transfers at raw tier bandwidth; netkv-full adds congestion +
    # self-contention (Eq. (4)).
    "cla": (0.0, 0.0),
    "netkv-static": (1.0, 0.0),
    "netkv-full": (1.0, 1.0),
}


class ScenarioPlane:
    """Batched fluid scenario engine: prep on the host, sweep on ``device``.

    ``backend="torch"`` (the default) drains transfers with the f64 plain
    water-filling loop, the counterpart of the JAX ``"jax"`` backend;
    ``backend="kernel"`` with the f32 ``waterfill_fast`` kernel, the
    counterpart of ``"pallas"``.  ``device=None`` means the CUDA card.
    """

    def __init__(self, scenarios: Sequence[ScenarioSpec], *, dt: float = 0.01,
                 backend: str = "torch", max_requests: int | None = None,
                 device=None):
        from ..kernels.build import resolve_device

        if not scenarios:
            raise ValueError("need at least one scenario")
        if backend not in ("torch", "kernel"):
            raise ValueError(f"unknown ScenarioPlane backend {backend!r}")
        shapes = {s.tree_shape() for s in scenarios}
        if len(shapes) != 1:
            raise ValueError("all scenarios in one sweep must share a "
                             f"cluster shape; got {sorted(shapes)}")
        horizons = {s.horizon for s in scenarios}
        if len(horizons) != 1:
            raise ValueError("all scenarios in one sweep must share "
                             "warmup+measure+drain (one step count)")
        self.scenarios = list(scenarios)
        self.dt = float(dt)
        self.backend = backend
        self.device = resolve_device(device)
        self.n_steps = int(math.ceil(scenarios[0].horizon / self.dt))
        self._prep(max_requests)

    # ------------------------------------------------------------- host prep
    def _prep(self, max_requests: int | None) -> None:
        s0 = self.scenarios[0]
        tree = FatTree(
            s0.n_pods, s0.racks_per_pod, s0.servers_per_rack,
            s0.gpus_per_server, nics_per_server=s0.nics_per_server)
        pre_meta, dec_meta = make_instances(tree, tp=s0.tp,
                                            n_prefill=s0.n_prefill)
        self.tree = tree
        self.n_prefill = len(pre_meta)
        self.n_decode = len(dec_meta)
        p_srv = [i.server for i in pre_meta]
        d_srv = [i.server for i in dec_meta]
        p_idx = np.array([tree.server_index(s) for s in p_srv], np.int64)
        d_idx = np.array([tree.server_index(s) for s in d_srv], np.int64)
        self.tier_pd = tree.tier_vec(p_idx[:, None], d_idx[None, :])

        per_scn = []
        for spec in self.scenarios:
            reqs = generate_trace(spec.profile, duration=spec.duration,
                                  target_rps=spec.target_rps, seed=spec.seed)
            per_scn.append(self._prep_one(spec, reqs, tree, p_srv, d_srv))
        r_max = max(p["arrival"].size for p in per_scn)
        if max_requests is not None:
            if max_requests < r_max:
                raise ValueError(
                    f"max_requests={max_requests} < largest trace {r_max}")
            r_max = max_requests
        self.max_requests = r_max

        def pad(key, fill, dtype):
            out = np.full((len(per_scn), r_max), fill, dtype)
            for i, p in enumerate(per_scn):
                out[i, : p[key].size] = p[key]
            return out

        self.arrival = pad("arrival", np.inf, np.float64)
        self.s_eff = pad("s_eff", 0.0, np.float64)
        self.out_len = pad("out_len", 1, np.int64)
        self.slo = pad("slo", np.inf, np.float64)
        self.src_p = pad("src_p", 0, np.int64)
        self.prefill_end = pad("prefill_end", np.inf, np.float64)
        self.xfer_ready = pad("xfer_ready", np.inf, np.float64)
        self.path_table = np.stack([p["path_table"] for p in per_scn])
        self.bw_mult = np.stack([p["bw_mult"] for p in per_scn])
        self.bg_util = np.stack([p["bg_util"] for p in per_scn])
        self.link_cap = np.stack([p["link_cap"] for p in per_scn])
        self.tier_lat = np.stack([p["tier_lat"] for p in per_scn])
        # Compact the link axis to links the prefill->decode paths actually
        # cross, keeping one representative link per populated tier so the
        # derived p50 tier-bandwidth summary stays defined (capacities are
        # uniform per tier here, so the p50 is unchanged by the subset).
        used = np.unique(self.path_table)
        used = used[used < tree.n_links].astype(np.int64)
        for t in range(4):
            tier_ids = np.nonzero(tree.link_tier == t)[0]
            if tier_ids.size and not np.any(np.isin(tier_ids, used)):
                used = np.append(used, tier_ids[:1])
        used = np.unique(used)
        remap = np.full(tree.n_links + 1, used.size, np.int64)
        remap[used] = np.arange(used.size)
        self.link_ids = used                       # compact -> global id
        self.path_table = remap[self.path_table].astype(np.int32)
        self.link_cap = self.link_cap[:, used]
        self._link_tier_c = np.asarray(tree.link_tier)[used]
        flags = np.array([_SCHED_FLAGS[s.scheduler] for s in self.scenarios],
                         np.float64)
        self.use_xfer, self.use_cong = flags[:, 0], flags[:, 1]
        as_arr = lambda f, d=np.float64: np.array(
            [f(s) for s in self.scenarios], d)
        self.beta_max = as_arr(lambda s: s.beta_max)
        self.mem_total = as_arr(lambda s: s.hbm_free_per_gpu * s.tp)
        self.m_min = as_arr(lambda s: s.m_min)
        self.kpt = as_arr(lambda s: float(s.kv_spec.kv_bytes_per_token))
        self.iter_a = as_arr(lambda s: s.iter_model.a)
        self.iter_b = as_arr(lambda s: s.iter_model.b)
        self.w_cache = as_arr(lambda s: s.w_cache)
        self.w_load = as_arr(lambda s: s.w_load)
        self.warmup_arr = as_arr(lambda s: s.warmup)
        self.measure_arr = as_arr(lambda s: s.measure)
        self.seeds = np.array([s.seed for s in self.scenarios], np.uint32)
        # Per-scenario tie-break jitter on the (request, decode) cost surface
        # (JAX: uniform(PRNGKey(seed), (R, D)) * 1e-9).
        self.jitter = np.stack([threefry_uniform(int(s), (r_max, self.n_decode))
                                for s in self.seeds]) * 1e-9

    def _prep_one(self, spec, reqs, tree, p_srv, d_srv) -> dict:
        """Host-side per-scenario tables: trace columns, serial prefill
        queueing, chunk-streamed transfer readiness, ECMP path table."""
        n = len(reqs)
        arrival = np.array([r.arrival for r in reqs], np.float64)
        in_len = np.array([r.input_len for r in reqs], np.int64)
        out_len = np.maximum(
            np.array([r.output_len for r in reqs], np.int64), 1)
        slo = np.array([r.slo for r in reqs], np.float64)
        s_eff = np.array(
            [float(spec.kv_spec.kv_bytes(int(l))) for l in in_len], np.float64)
        # Round-robin prefill assignment; serial per-instance prefill queue
        # (chunking changes *readiness*, not total prefill seconds).
        src_p = np.arange(n, dtype=np.int64) % len(p_srv)
        busy = np.zeros(len(p_srv), np.float64)
        pf_start = np.zeros(n, np.float64)
        pf_end = np.zeros(n, np.float64)
        pm = spec.prefill_model
        for j in range(n):
            p = src_p[j]
            pf_start[j] = max(arrival[j], busy[p])
            busy[p] = pf_start[j] + pm(int(in_len[j]))
            pf_end[j] = busy[p]
        if spec.chunk_tokens:
            # ChunkPlane semantics: the decode instance is selected (and,
            # when streaming, bytes start moving) at first-chunk readiness.
            first_chunk = pf_start + np.array(
                [pm(min(int(l), int(spec.chunk_tokens))) for l in in_len])
            ready = first_chunk if spec.kv_streaming else pf_end
        else:
            ready = pf_end
        # ECMP path table: one uplink draw per (prefill, decode) pair from
        # the scenario's RNG stream, NIC pair from the scenario's policy.
        rng = np.random.default_rng(spec.seed)
        policy = make_nic_policy(spec.nic_policy)
        policy.bind(lambda lids: np.zeros(np.shape(lids), np.int64))
        pt = np.full((len(p_srv), len(d_srv), MAX_PATH_LEN), tree.n_links,
                     np.int32)
        for pi, ps in enumerate(p_srv):
            for di, ds in enumerate(d_srv):
                t = tree.tier(ps, ds)
                nics = (0, 0) if t == 0 else policy.pick(
                    tree, tree.server_index(ps), tree.server_index(ds), rng)
                row, _ = tree.path_row(ps, ds, rng, nics=nics)
                pt[pi, di] = np.where(row < 0, tree.n_links, row)
        # Capacity timeline: cumulative multiplicative tier scaling per step.
        mult = np.ones((self.n_steps, 4), np.float64)
        cur = np.ones(4, np.float64)
        edits = sorted((float(t), dict(sc)) for t, sc in spec.rewires)
        k0 = 0
        for t_ev, sc in edits:
            k1 = min(self.n_steps, max(0, int(math.ceil(t_ev / self.dt))))
            mult[k0:k1] = cur
            for tier, f in sc.items():
                cur[int(tier)] *= float(f)
            k0 = k1
        mult[k0:] = cur
        bg = np.array([
            0.0 if t == 0 else min(max(float(spec.background), 0.0), 0.95)
            for t in range(4)], np.float64)
        return dict(
            arrival=arrival, s_eff=s_eff, out_len=out_len, slo=slo,
            src_p=src_p, prefill_end=pf_end, xfer_ready=ready,
            path_table=pt, bw_mult=mult, bg_util=bg,
            link_cap=tree.link_capacity.copy(),
            tier_lat=np.array([tree.tier_latency[t] for t in range(4)],
                              np.float64),
        )

    # ------------------------------------------------------------- the sweep
    def sweep(self, *, detail: bool = False) -> dict:
        """Run every scenario, batched over the scenario axis on ``device``.

        Returns a dict of per-scenario summary arrays (``ttft_mean``,
        ``ttft_p50/p95/p99``, ``tbt_mean``, ``slo_attainment``,
        ``goodput_rps``, ``n_measured``, ``n_served``); with
        ``detail=True`` adds per-request ``t_first``/``t_fin``/``tokens``
        and the decode instance ``inst``.
        """
        dev = self.device
        t = {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k))).to(dev)
             for k in ("arrival", "s_eff", "out_len", "slo", "src_p",
                       "prefill_end", "xfer_ready", "path_table", "bw_mult",
                       "bg_util", "link_cap", "tier_lat", "use_xfer",
                       "use_cong", "beta_max", "mem_total", "m_min", "kpt",
                       "iter_a", "iter_b", "w_cache", "w_load", "warmup_arr",
                       "measure_arr", "jitter")}
        out = _run_batch(**t, tier_pd=torch.from_numpy(self.tier_pd).to(dev),
                         link_tier=torch.from_numpy(self._link_tier_c).to(dev),
                         dt=self.dt, n_steps=self.n_steps,
                         wf_dtype=torch.float32 if self.backend == "kernel" else F64)
        res = {k: v.cpu().numpy() for k, v in out.items()}
        if not detail:
            for k in ("t_first", "t_fin", "tokens", "inst"):
                res.pop(k)
        return res


def _run_batch(arrival, s_eff, out_len, slo, src_p, prefill_end, xfer_ready,
               path_table, bw_mult, bg_util, link_cap, tier_lat, use_xfer,
               use_cong, beta_max, mem_total, m_min, kpt, iter_a, iter_b,
               w_cache, w_load, warmup_arr, measure_arr, jitter, *, tier_pd,
               link_tier, dt, n_steps, wf_dtype):
    """Every scenario's fluid run (``repro/sim/scenarios.py::_run_one``
    with the scenario axis S leading every tensor)."""
    from ..kernels import ops, ref

    dev = arrival.device
    S, R = arrival.shape
    P, D, _ = path_table.shape[1:]
    L = link_cap.shape[1]
    sc = torch.arange(S, device=dev)[:, None]          # scenario row index
    col = lambda x: x[:, None]                         # (S,) -> (S, 1)
    valid = torch.isfinite(arrival)
    base_bw = _tier_base_bw(link_cap, link_tier)       # (S, 4) p50 per tier
    resid_base = link_cap * (1.0 - bg_util[:, link_tier])
    # Flow->link hop counts per (prefill, decode) pair, built once: a step's
    # routing is then a gather of (S, R, L + 1) rows.
    inc_pd = (path_table[..., None].long() == torch.arange(L + 1, device=dev)).sum(dim=3)
    inc_pd[..., L] = 0
    inc_pd = inc_pd.to(wf_dtype)
    tier_rd = tier_pd.long()[src_p]                    # (S, R, D)
    lat_rd = torch.gather(tier_lat, 1, tier_rd.reshape(S, -1)).reshape(S, R, D)
    use_x = col(use_xfer > 0.5)[..., None]             # (S, 1, 1)
    use_c = col(use_cong > 0.5)
    zero4 = torch.zeros((S, 4), dtype=F64, device=dev)
    cong = torch.where(use_c, bg_util, zero4)
    inf_col = torch.full((S, 1), float("inf"), dtype=F64, device=dev)
    r_idx = torch.arange(R, dtype=torch.int64, device=dev).expand(S, R)
    d_ar = torch.arange(D, device=dev)
    big = torch.full((), BIG, dtype=F64, device=dev)

    tokens = torch.zeros((S, R), dtype=torch.int64, device=dev)
    live = torch.zeros((S, R), dtype=torch.bool, device=dev)
    inst = torch.full((S, R), -1, dtype=torch.int64, device=dev)
    r_tier = torch.zeros((S, R), dtype=torch.int64, device=dev)
    xfer_rem = s_eff.clone()
    xfer_on = torch.zeros((S, R), dtype=torch.bool, device=dev)
    arrived = torch.zeros_like(xfer_on)
    admitted = torch.zeros_like(xfer_on)
    t_first = torch.full((S, R), -1.0, dtype=F64, device=dev)
    t_fin = torch.full((S, R), -1.0, dtype=F64, device=dev)
    pinned = torch.zeros((S, D + 1), dtype=F64, device=dev)
    credit = torch.zeros((S, D), dtype=F64, device=dev)
    d_queued = torch.zeros((S, D), dtype=torch.int64, device=dev)
    tier_infl = torch.zeros((S, 4), dtype=torch.int64, device=dev)
    grown = s_eff + out_len * col(kpt)

    for k in range(n_steps):
        t0 = k * dt
        t1 = _step_end(k, dt)
        d_active = _seg_count(inst, live, D).to(F64)
        # --- A: decode-instance selection (Eqs. (2)-(7)) ------------------
        ready = valid & (xfer_ready <= t0) & (inst < 0)
        free_d = col(mem_total) - pinned[:, :D]
        feas = free_d[:, None, :] >= (s_eff + col(m_min))[..., None]
        tier_bw = base_bw * bw_mult[:, k]              # derived p50 summary
        infl = torch.where(use_c, tier_infl.to(F64), zero4)
        beff = tier_bw * (1.0 - cong) / (1.0 + infl)   # Eq. (4), per tier
        beff_rd = torch.gather(beff, 1, tier_rd.reshape(S, -1)).reshape(S, R, D)
        t_xfer = s_eff[..., None] / beff_rd.clamp(min=1e-9) + lat_rd   # Eq. (3)
        t_it = col(iter_a) + col(iter_b) * d_active    # (S, D)
        blocked = torch.clamp((d_queued + d_active) - col(beta_max), min=0.0)  # Eq. (6)
        t_queue = blocked * t_it
        t_dec = col(iter_a) + col(iter_b) * (d_active + 1.0)   # Eq. (7)
        cost_net = t_xfer + (t_queue + t_dec)[:, None, :]
        cost_cla = col(w_cache) * 1.0 + col(w_load) * (
            (d_active + d_queued) / col(beta_max).clamp(min=1.0))
        cost = torch.where(use_x, cost_net, cost_cla[:, None, :]) + jitter
        cost = torch.where(feas, cost, big)
        best = torch.argmin(cost, dim=2)               # (S, R)
        ok = ready & (torch.gather(cost, 2, best[..., None])[..., 0] < BIG * 0.5)
        # Sequential-decision emulation: at most max(1, open slots) new
        # dispatches per instance per dt; the rest retry next step.
        onehot = ok[..., None] & (best[..., None] == d_ar)
        rank = torch.gather(torch.cumsum(onehot, dim=1) - onehot.long(), 2,
                            best[..., None])[..., 0]
        slots = torch.clamp(col(beta_max) - d_active - d_queued, min=1.0)
        take = ok & (rank < _take(slots, best))
        inst = torch.where(take, best, inst)
        new_tier = torch.gather(tier_rd, 2, best[..., None])[..., 0]
        r_tier = torch.where(take, new_tier, r_tier)
        xfer_on = xfer_on | take
        d_queued = d_queued + _seg_count(best, take, D)
        tier_infl = tier_infl + _seg_count(new_tier, take, 4)
        # --- B: max-min fair transfer drain (K6 or the f64 loop) ----------
        caps = torch.cat([resid_base * bw_mult[:, k][:, link_tier], inf_col], dim=1)
        nhops = inc_pd[sc, src_p, inst.clamp(0, D - 1)]
        if wf_dtype == F64:
            rates = ref.waterfill_rates_fast_ref(caps, xfer_on, nhops)
        else:
            rates = ops.waterfill_fast(caps.to(wf_dtype), xfer_on, nhops)
        xfer_rem = torch.where(
            xfer_on, torch.clamp(xfer_rem - rates.to(F64) * dt, min=0.0), xfer_rem)
        done = xfer_on & (xfer_rem <= 1.0) & (t1 >= prefill_end)
        xfer_on = xfer_on & ~done
        arrived = arrived | done
        tier_infl = tier_infl - _seg_count(r_tier, done, 4)
        # --- C: FCFS admission into the decode batch ----------------------
        wait = arrived & ~admitted
        inst_c = inst.clamp(0, D - 1)
        oh_w = wait[..., None] & (inst_c[..., None] == d_ar)
        rank_w = torch.gather(torch.cumsum(oh_w, dim=1) - oh_w.long(), 2,
                              inst_c[..., None])[..., 0]
        mem_w = oh_w * s_eff[..., None]
        cum_mem = torch.gather(torch.cumsum(mem_w, dim=1) - mem_w, 2,
                               inst_c[..., None])[..., 0]
        admit = wait & (rank_w < _take(col(beta_max) - d_active, inst_c)) & (
            _take(pinned, inst_c) + cum_mem + s_eff <= col(mem_total - m_min))
        admitted = admitted | admit
        live = live | admit
        pinned = _seg_add(pinned, torch.where(admit, inst_c, D),
                          torch.where(admit, s_eff, torch.zeros((), dtype=F64, device=dev)))
        d_queued = d_queued - _seg_count(inst_c, admit, D)
        d_active = _seg_count(inst, live, D).to(F64)
        # --- D: continuous-batching iteration clock + cohort step ---------
        t_it = col(iter_a) + col(iter_b) * d_active
        credit = credit + dt
        fire = (credit >= t_it) & (d_active > 0)
        credit = torch.where(fire, credit - t_it, credit)
        tokens, live, pinned, first, fin, _ = cohort_step(
            tokens, out_len, inst, r_idx, grown, live, fire, pinned,
            kv_per_token=kpt, exact_clamp=False)
        t_first = torch.where(first & (t_first < 0), t1, t_first)
        t_fin = torch.where(fin, t1, t_fin)

    out = _summarize(arrival, slo, out_len, t_first, t_fin, tokens,
                     warmup_arr, measure_arr, valid)
    out["inst"] = inst
    return out


def _step_end(k: int, dt: float) -> float:
    """The end of step k, ``k * dt + dt`` rounded once: XLA contracts the
    JAX sweep's ``t0 + dt`` with ``t0 = k * dt`` into one FMA, and the step
    times are what ``t_first`` and ``t_fin`` record, so they are held bit
    for bit to the JAX sweep."""
    return float(Fraction(k) * Fraction(dt) + Fraction(dt))


def _tier_base_bw(link_cap: torch.Tensor, link_tier: torch.Tensor) -> torch.Tensor:
    """p50 per-tier capacity of the columnar link table, (S, L) -> (S, 4):
    ``jnp.nanmedian``'s linear interpolation (the mean of the two middle
    values for an even count), NaN for a tier with no link."""
    out = []
    for t in range(4):
        vals = link_cap[:, link_tier == t]
        n = vals.shape[1]
        if n == 0:
            out.append(torch.full((link_cap.shape[0],), float("nan"), dtype=link_cap.dtype,
                                  device=link_cap.device))
            continue
        s = torch.sort(vals, dim=1).values
        q = 0.5 * (n - 1)
        lo, hi = math.floor(q), math.ceil(q)
        hw = q - lo
        out.append(s[:, lo] * (1.0 - hw) + s[:, hi] * hw)
    return torch.stack(out, dim=1)


def _masked_pct(x, mask, q, r):
    """Row-wise linear percentile of x over mask, (S, R) -> (S,)."""
    n = mask.sum(dim=1)
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=1).values
    pos = (q / 100.0) * torch.clamp(n - 1, min=0).to(x.dtype)
    lo = torch.clamp(torch.floor(pos).long(), 0, r - 1)
    hi = torch.clamp(torch.ceil(pos).long(), 0, r - 1)
    frac = pos - torch.floor(pos)
    v = _take(s, lo[:, None])[:, 0] * (1.0 - frac) + _take(s, hi[:, None])[:, 0] * frac
    return torch.where(n > 0, v, torch.full_like(v, float("nan")))


def _summarize(arrival, slo, out_len, t_first, t_fin, tokens, warmup, measure, valid):
    r = arrival.shape[1]
    warmup, measure = warmup[:, None], measure[:, None]
    inf = torch.full_like(arrival, float("inf"))
    meas = valid & (arrival >= warmup) & (arrival < warmup + measure)
    served = meas & (t_first >= 0)
    ttft = torch.where(served, t_first - arrival, inf)
    fin_ok = meas & (t_fin >= 0) & (out_len > 1)
    tbt = torch.where(fin_ok, (t_fin - t_first)
                      / torch.clamp(out_len - 1, min=1).to(arrival.dtype), inf)
    n_meas = meas.sum(dim=1)
    n_served = served.sum(dim=1)
    slo_ok = (served & (ttft <= slo)).sum(dim=1)
    nan = torch.full((), float("nan"), dtype=arrival.dtype, device=arrival.device)

    def mean(v, m):
        cnt = m.sum(dim=1)
        tot = torch.where(m, v, torch.zeros_like(v)).sum(dim=1)
        return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), nan)

    return dict(
        n_measured=n_meas,
        n_served=n_served,
        ttft_mean=mean(ttft, served),
        ttft_p50=_masked_pct(ttft, served, 50.0, r),
        ttft_p95=_masked_pct(ttft, served, 95.0, r),
        ttft_p99=_masked_pct(ttft, served, 99.0, r),
        tbt_mean=mean(tbt, fin_ok),
        slo_attainment=torch.where(
            n_meas > 0, slo_ok.to(arrival.dtype) / torch.clamp(n_meas, min=1), nan),
        goodput_rps=slo_ok / torch.clamp(measure[:, 0], min=1e-9),
        t_first=t_first,
        t_fin=t_fin,
        tokens=tokens,
    )
