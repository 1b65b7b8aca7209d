#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; every check asserts and any failure exits non-zero:

  1. device   name, count, ``nvidia-smi`` name and power limit
  2. build    nvcc every kernel source in parallel; ptxas registers/spills
  3. kernels  each kernel against its plain PyTorch version at the shapes of
              the serving path, with times for the kernel, the plain version
              and the one PyTorch call that computes the same function
  4. match    the serving path on the card against the same path on the CPU
              (the plain versions), smoke config in f32: every result equal
  5. serve    qwen3-14b at full width (bf16, random weights from a seed):
              2 prefill + 4 decode instances, 8 requests of 2048 tokens, 16
              new tokens each; launch counts of kv_pack/kv_unpack/flash_decode
  6. trace    where the time of that path goes: one decode engine of the
              served cluster with its 4 slots full, decode steps on the host
              clock and under ``torch.profiler`` (device time by kernel class,
              the device's busy share of the traced window), and one prefill
  7. decide   200 netkv-full decisions through the netkv_score_cohort kernel
              over a 2048-instance pool, each within rtol 1e-5 of the NumPy
              minimum; launch count of netkv_score_cohort
  8. sweep    exp11's FULL grid (54 scenarios, 1400 steps of 0.01 s) through
              ScenarioPlane(backend="kernel"): first waterfill_fast against
              its plain version at the grid's shape, then the sweep twice
              (waterfill_fast launched once a step; the second call's wall
              and scenarios/s), sanity, and the summaries against the f64
              backend="torch" sweep on the card
  9. simulate run_sim on the 64-GPU cluster, netkv-full scored by
              netkv_score_cohort, over a Mooncake chatbot trace (one row a
              launch) and a same-arrival burst trace (cohorts of R > 1 rows):
              on the card every RunMetrics field equals the CPU run's but the
              host-clock decision latencies; each FlowPlane fixed point of
              the card runs is recomputed by waterfill_progressive and held
              to the plane's rates (rtol 1e-4); then waterfill_progressive
              against its plain version on those tables
 10. one JSON line ``{"kernels": [...]}``
 11. last line ``{"ok": true, "device": {...}}``

It imports nothing of JAX and nothing of the JAX package.  Without a CUDA
device, or without the repository's ``src/`` beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# FLOP/s by operand type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPLACES = {
    "netkv_score_cohort": "src/repro/kernels/netkv_score.py:49",
    "kv_pack": "src/repro/kernels/kv_pack.py:21",
    "kv_unpack": "src/repro/kernels/kv_pack.py:51",
    "flash_decode": "src/repro/kernels/flash_decode.py:33",
    "waterfill_progressive": "src/repro/kernels/waterfill.py:52",
    "waterfill_fast": "src/repro/kernels/waterfill.py:182",
}
SOURCE = {
    "netkv_score_cohort": "src/repro_torch/csrc/netkv_score.cu",
    "kv_pack": "src/repro_torch/csrc/kv_pack.cu",
    "kv_unpack": "src/repro_torch/csrc/kv_pack.cu",
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
    "waterfill_progressive": "src/repro_torch/csrc/waterfill.cu",
    "waterfill_fast": "src/repro_torch/csrc/waterfill.cu",
}
KERNELS = ("netkv_score_cohort", "kv_pack", "kv_unpack", "flash_decode",
           "waterfill_progressive", "waterfill_fast")
# The FULL grid of benchmarks/exp11_scenario_sweep.py (defined here: that
# module imports the JAX package).
EXP11 = dict(schedulers=("cla", "netkv-static", "netkv-full"), chunks=(None, 256, 1024),
             nic_policies=("hash", "rail-affine"), seeds=3, warmup=2.0, measure=8.0,
             drain=4.0, rps=12.0, background=0.25, dt=0.01)
# TTFT summaries of the f32 kernel sweep against the f64 sweep, relative.
SWEEP_RTOL = 0.02
# flash_decode (rtol, atol) by dtype.  Kernel and plain version both sum in
# f32 and round once to the output dtype, so in bf16 they may differ by one
# rounding step of the output, at most 2^-7 of its magnitude; a kernel that
# kept p, l or the accumulator in bf16 errs by more on the small outputs.
FD_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (0.0, 2e-5)}


def say(msg: str) -> None:
    print(msg, flush=True)


def ensure(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_time_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn``: the stream is held by a
    spin kernel while the host enqueues ``iters`` calls, so the events
    bracket the device work back to back and not the host's enqueue rate.
    The spin lasts twice as long as an untimed enqueue of the calls took,
    so a wrapper of many small ops is held too."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(200_000_000, int(2 * enqueue_s * 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_time_ms(fn, iters: int) -> float:
    """Host-clock milliseconds per call of ``fn`` that ends in a synchronise:
    for the plain water-filling loops, which read their loop condition back
    every round and so cannot be enqueued ahead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(name, err, ms, plain_ms, library_ms, bound_ms, bound_by, **extra):
    return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                launches=0, max_abs_err=err, max_err=err, ms=ms, kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **extra)


# ---------------------------------------------------------------- phase 1
def phase_device() -> tuple[str, int, str]:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    say(smi)
    return name, count, smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    say(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f}s wall")
    for name, log in logs.items():
        say(f"[build] {name}.cu: {log['seconds']:.1f}s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def check_kv_pack(rows: dict) -> None:
    from repro_torch.kernels import kv_pack as kp, ref

    periods, pages_per_period, pt, kv, dh = 40, 256, 16, 8, 128
    table = torch.tensor([p * pages_per_period + pg for p in range(periods)
                          for pg in range(64, 128)], dtype=torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn((periods * pages_per_period, pt, kv, dh), generator=gen,
                           device="cuda", dtype=torch.float32).to(dtype)
        buf = kp.kv_pack(pool, table)
        want = ref.kv_pack_ref(pool, table)
        ensure(torch.equal(buf, want), f"kv_pack {dtype} differs from index_select")
        dst = kp.kv_unpack(torch.zeros_like(pool), buf, table)
        want_u = ref.kv_unpack_ref(torch.zeros_like(pool), buf, table)
        ensure(torch.equal(dst, want_u), f"kv_unpack {dtype} differs from index_copy_")
        say(f"[kernels] kv_pack/kv_unpack {dtype}: bit-exact over {table.numel()} pages")
        if dtype != torch.bfloat16:
            continue
        idx32 = table.cuda()
        idx64 = idx32.long()
        moved = 2 * buf.numel() * buf.element_size() + idx32.numel() * 4
        b_ms, b_by = bound(moved, 0.0, dtype)
        scratch = torch.zeros_like(pool)
        k_ms = device_time_ms(lambda: kp.kv_pack(pool, idx32), 50)
        p_ms = device_time_ms(lambda: ref.kv_pack_ref(pool, idx64), 50)
        l_ms = device_time_ms(lambda: pool.index_select(0, idx64), 50)
        rows["kv_pack"] = row("kv_pack", 0.0, k_ms, p_ms, l_ms, b_ms, b_by,
                              shape=f"pool {tuple(pool.shape)} bf16, {table.numel()} pages")
        k_ms = device_time_ms(lambda: kp.kv_unpack(scratch, buf, idx32), 50)
        p_ms = device_time_ms(lambda: ref.kv_unpack_ref(scratch, buf, idx64), 50)
        l_ms = device_time_ms(lambda: scratch.index_copy_(0, idx64, buf), 50)
        rows["kv_unpack"] = row("kv_unpack", 0.0, k_ms, p_ms, l_ms, b_ms, b_by,
                                shape=f"pool {tuple(pool.shape)} bf16, {table.numel()} pages")
        del scratch
    torch.cuda.empty_cache()


def flash_decode_error(out, want) -> tuple[float, float]:
    """(max abs error, max excess over FD_TOL); the check holds when the
    excess is <= 0."""
    rtol, atol = FD_TOL[want.dtype]
    want = want.float()
    err = (out.float() - want).abs()
    return err.max().item(), (err - rtol * want.abs() - atol).max().item()


def check_flash_decode(rows: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd, ref

    b, h, kv, dh, s = 4, 40, 8, 128, 4096
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
        worst = 0.0
        for pos in (1, 16, 2049, 4096):
            err, excess = flash_decode_error(fd.flash_decode(q, k, v, pos),
                                             ref.flash_decode_ref(q, k, v, pos))
            ensure(excess <= 0, f"flash_decode {dtype} pos={pos}: max err {err}, "
                   f"{excess} over (rtol, atol) {FD_TOL[dtype]}")
            worst = max(worst, err)
        say(f"[kernels] flash_decode {dtype}: max abs err {worst:.3g} "
            f"((rtol, atol) {FD_TOL[dtype]})")
        if dtype != torch.bfloat16:
            continue
        pos = 2056  # a decode step of a 2048-token prompt
        es = q.element_size()
        moved = 2 * b * pos * kv * dh * es + 2 * q.numel() * es
        b_ms, b_by = bound(moved, 4.0 * b * h * pos * dh, dtype)
        qs = q[:, :, None, :]
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(s, device="cuda") < pos)[None, None, None, :]
        k_ms = device_time_ms(lambda: fd.flash_decode(q, k, v, pos), 100)
        p_ms = device_time_ms(lambda: ref.flash_decode_ref(q, k, v, pos), 20)
        l_ms = device_time_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True), 100)
        rows["flash_decode"] = row(
            "flash_decode", worst, k_ms, p_ms, l_ms, b_ms, b_by,
            shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 pos {pos}")
        del kt, vt
    torch.cuda.empty_cache()


def pool_2048(n: int = 2048, seed: int = 0):
    """The scheduler benchmark's seeded pool (benchmarks/sched_latency.py::_pool)."""
    from repro_torch.core import CandidateState, ClusterView, OracleView
    from repro_torch.core.oracle import PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY

    rng = np.random.default_rng(seed)
    cands = [CandidateState(i, float(rng.uniform(1e10, 4e11)), int(rng.integers(0, 8)),
                            int(rng.integers(0, 64)), float(rng.integers(0, 8192)))
             for i in range(n)]
    tiers = rng.integers(0, 4, n)
    view = OracleView(lambda p, d: int(tiers[d % n]), PAPER_TIER_BANDWIDTH,
                      PAPER_TIER_LATENCY, {t: 0.2 for t in range(4)})
    cv = ClusterView.from_candidates(cands, tier_fn=view.tier_of)
    cv.tier_row(0)
    return cv, view


def check_netkv_score(rows: dict) -> None:
    from repro_torch.core import H100_TP4_ITER, PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY
    from repro_torch.kernels import netkv_score as ns, ref

    cv, view = pool_2048()
    d = cv.n
    kv_bytes, input_len = 8192 * 320 * 1024, 8192
    timed = {}
    for r in (1, 64):
        rng = np.random.default_rng(7 * d + r)
        cols = [cv.column(c).astype(np.float32) for c in
                ("free_memory", "queued", "batch", "healthy", "iter_scale")]
        args = dict(
            free_mem=cols[0], queued=cols[1], batch=cols[2],
            hit_rows=rng.integers(0, input_len, (r, d)).astype(np.float32),
            tier_rows=rng.integers(0, 4, (r, d)).astype(np.int32),
            healthy=cols[3], iter_scale=cols[4])
        infl = rng.integers(0, 4, (r, 4)).astype(np.float32)
        sr = np.full(r, kv_bytes, np.float32)
        lr = np.full(r, input_len, np.float32)
        tables = ([PAPER_TIER_BANDWIDTH[t] for t in range(4)],
                  [PAPER_TIER_LATENCY[t] for t in range(4)],
                  [0.2, 0.1, 0.3, 0.05])
        kw = dict(iter_a=H100_TP4_ITER.a, iter_b=H100_TP4_ITER.b, m_min=2e9, beta_max=64)
        on_card = {k: torch.from_numpy(a).cuda() for k, a in args.items()}
        infl_c, sr_c, lr_c = (torch.from_numpy(a).cuda() for a in (infl, sr, lr))

        def kernel():
            return ns.netkv_score_cohort(*on_card.values(), *tables, infl_c,
                                         s_r=sr_c, input_len=lr_c, **kw)

        def plain():
            return ref.netkv_score_cohort_ref(*on_card.values(), *tables, infl_c,
                                              s_r=sr_c, input_len=lr_c, **kw)

        cost, best = kernel()
        p_cost, p_best = plain()
        h_cost, h_best = ref.netkv_score_cohort_ref(
            *(torch.from_numpy(a) for a in args.values()), *tables,
            torch.from_numpy(infl), s_r=torch.from_numpy(sr),
            input_len=torch.from_numpy(lr), **kw)
        ensure(torch.equal(cost, p_cost), f"R={r}: cost rows differ from the plain version")
        ensure(torch.equal(cost.cpu(), h_cost), f"R={r}: cost rows differ from the host twin")
        ensure(torch.equal(best, p_best) and torch.equal(best.cpu(), h_best), f"R={r}: argmin")
        single = ns.netkv_score_cohort(
            *(t for t in (on_card["free_mem"], on_card["queued"], on_card["batch"],
                          on_card["hit_rows"][-1:], on_card["tier_rows"][-1:],
                          on_card["healthy"], on_card["iter_scale"])),
            *tables, infl_c[-1:], s_r=sr_c[-1:], input_len=lr_c[-1:], **kw)
        ensure(torch.equal(single[0][0], cost[-1]), f"R={r}: last row != single-row call")
        say(f"[kernels] netkv_score_cohort R={r} D={d}: cost rows bitwise, argmins equal")
        moved = (5 * d * 4 + r * d * (4 + 4 + 4) + r * (4 * 4 + 4 + 4 + 4))
        timed[r] = (device_time_ms(kernel, 200), device_time_ms(plain, 20),
                    *bound(moved, 26.0 * r * d, torch.float32))
    # The decide path launches R = 1 (one request a decision); R = 64 is the
    # cohort shape of the simulator's batched selection, kept for comparison.
    k_ms, p_ms, b_ms, b_by = timed[1]
    rows["netkv_score_cohort"] = row(
        "netkv_score_cohort", 0.0, k_ms, p_ms, None, b_ms, b_by,
        shape=f"R 1 x D {d} f32", r64_ms=timed[64][0], r64_plain_ms=timed[64][1],
        r64_bound_ms=timed[64][2])


# ---------------------------------------------------------------- phase 4
def phase_match() -> None:
    """Serve a small workload twice from one set of weights: on the card
    through the kernels and on the CPU through their plain versions, which
    the CPU tests hold equal to the JAX package.  Every result field (tokens,
    decisions, bytes, simulated times) must be equal."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import SMOKE, build_cluster, make_requests
    from repro_torch.models import Model, init_random_

    cfg = dataclasses.replace(get_spec("qwen3-14b").smoke, compute_dtype=torch.float32)
    workload = dict(SMOKE, prefix_len=16)  # the even requests hit one page
    on_cpu = init_random_(Model(cfg, device="cpu"), 0)
    on_card = Model(cfg, device="cuda")
    on_card.load_state_dict(on_cpu.state_dict())
    out = {}
    for device, model in (("cpu", on_cpu), ("cuda", on_card)):
        cluster = build_cluster(cfg, workload, scheduler="netkv-full", seed=0,
                                device=device, params=model)
        out[device] = [dataclasses.asdict(r) for r in
                       cluster.serve(make_requests(cfg.vocab_size, 8, 0, **workload))]
    ensure(out["cuda"] == out["cpu"], ("card and CPU results differ", out))
    ensure(any(r["transfer_bytes"] < out["cpu"][0]["transfer_bytes"] for r in out["cpu"]),
           "no prefix hit in the small workload")
    say(f"[match] {cfg.name} f32: {len(out['cpu'])} requests, every result field equal "
        f"on the card and on the CPU")


# ---------------------------------------------------------------- phase 5
def phase_serve():
    """Serve the full-width workload; returns the launch counts of the run,
    the served cluster and its prompts."""
    from repro_torch.configs import get_spec
    from repro_torch.core.cost import B_TOK
    from repro_torch.kernels import build
    from repro_torch.launch.serve import FULL, build_cluster, make_requests
    from repro_torch.serving import engine

    cfg, workload = get_spec("qwen3-14b").model, FULL
    t0 = time.perf_counter()
    cluster = build_cluster(cfg, workload, scheduler="netkv-full", seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    reqs = make_requests(cfg.vocab_size, 8, 0, **workload)

    # Every prefill and decode logit must be finite: wrap the model calls the
    # engines make and keep one device flag per call.
    finite = []
    prefill_fn, decode_fn = engine.prefill, engine.decode_step

    def prefill_checked(*a, **k):
        logits, cache = prefill_fn(*a, **k)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    def decode_checked(*a, **k):
        logits, cache = decode_fn(*a, **k)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    engine.prefill, engine.decode_step = prefill_checked, decode_checked
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        results = cluster.serve(reqs)
    finally:
        engine.prefill, engine.decode_step = prefill_fn, decode_fn
    launches = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    ensure(all(bool(f) for f in finite), "a non-finite logit")
    page_bytes = B_TOK * cfg.n_kv_heads * cfg.d_head * 2
    prompt_pages = workload["prompt_len"] // B_TOK
    seen: dict[int, list] = {}
    shipping = 0
    for r, req in zip(results, sorted(reqs, key=lambda x: x.arrival)):
        ensure(r.request_id == req.request_id, ("order", r.request_id, req.request_id))
        ensure(len(r.tokens) == workload["max_new"], (r.request_id, len(r.tokens)))
        hit = 0
        for prev in seen.get(r.decode_instance, []):
            same = 0
            while same < prompt_pages and np.array_equal(
                    prev[same * B_TOK:(same + 1) * B_TOK], req.prompt[same * B_TOK:(same + 1) * B_TOK]):
                same += 1
            hit = max(hit, same)
        seen.setdefault(r.decode_instance, []).append(req.prompt)
        want = 2 * cfg.n_layers * (prompt_pages - hit) * page_bytes
        ensure(r.transfer_bytes == want, (r.request_id, r.transfer_bytes, want))
        shipping += want > 0
    full_bytes = 2 * cfg.n_layers * prompt_pages * page_bytes
    ensure(any(r.transfer_bytes < full_bytes for r in results), "no repeat prefix hit")
    steps = sum(w["decode_steps"] for w in cluster.walls)
    ensure(steps == len(results) * (workload["max_new"] - 1), ("decode steps", steps))
    want_launches = dict.fromkeys(build.LAUNCHES, 0) | {
        "flash_decode": cfg.n_layers * steps, "kv_pack": 2 * shipping,
        "kv_unpack": 2 * shipping}
    ensure(launches == want_launches, (launches, want_launches))
    for r, w in zip(results, cluster.walls):
        say(f"[serve] req{r.request_id}: decode@{r.decode_instance} tier{r.tier} "
            f"xfer={r.transfer_bytes / 1e6:.1f}MB prefill={w['prefill_s'] * 1e3:.1f}ms "
            f"transfer={w['transfer_s'] * 1e3:.1f}ms decode={w['decode_s'] * 1e3:.1f}ms "
            f"({w['decode_steps']} steps, {w['decode_s'] / w['decode_steps'] * 1e3:.2f}ms/step) "
            f"tokens={r.tokens[:6]}")
    say(f"[serve] {len(results)} requests in {wall:.2f}s wall; peak memory "
        f"{peak / 1e9:.2f} GB; launches {launches}")
    return launches, cluster, [r.prompt for r in reqs]


# ---------------------------------------------------------------- phase 6
def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_decode" in low:
        return "flash_decode"
    if "kv_pack" in low or "kv_unpack" in low:
        return "kv_pack"
    if "waterfill" in low:
        return "waterfill"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def traced(fn, n: int) -> dict:
    """Run ``fn`` ``n`` times under ``torch.profiler``: device time by kernel
    class, summed over device-side events only (kernels, copies, fills) so
    that the time a host op attributes to its kernel is not counted twice,
    and the device's busy share of the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict[str, float] = {}
    top = []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0 or ev.key == "Command Buffer Full":
            continue
        by_class[kernel_class(ev.key)] = by_class.get(kernel_class(ev.key), 0.0) + us
        top.append((us, ev.count, ev.key))
    busy_ms = sum(by_class.values()) / 1e3
    ensure(busy_ms > 0, "the trace holds no device time")
    return dict(wall_ms=wall_ms / n, device_ms=busy_ms / n, busy_share=busy_ms / wall_ms,
                by_class_ms={k: v / 1e3 / n for k, v in sorted(by_class.items())},
                top=sorted(top, reverse=True)[:8])


def phase_trace(cluster, prompts) -> None:
    """Where the time of the serving path goes, on the served cluster's
    first prefill and decode engines: the decode engine's 4 slots are filled
    with 2048-token prompts (the batch of the serve phase's decode steps),
    10 steps are timed on the host clock untraced, 4 more and one prefill
    under the profiler.  Each step ends in the host read of its tokens."""
    pe, de = cluster.prefill[0], cluster.decode[0]
    for i, p in enumerate(prompts[:de.n_slots]):
        de.admit(i, pe.run(i, p), max_new=64)
    for _ in range(3):
        de.step()
    t0 = time.perf_counter()
    for _ in range(10):
        de.step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    decode = traced(de.step, 4)
    prefill = traced(lambda: pe.run(0, prompts[0]), 1)
    say(f"[trace] decode step (batch {de.n_slots}, pos ~{len(prompts[0])}): "
        f"{step_ms:.2f} ms wall untraced")
    for label, tr in (("decode step", decode), ("prefill", prefill)):
        say(f"[trace] traced {label}: wall {tr['wall_ms']:.2f} ms, device busy "
            f"{tr['device_ms']:.2f} ms ({tr['busy_share']:.1%}); by class "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in tr["by_class_ms"].items()))
        for us, count, key in tr.pop("top"):
            say(f"[trace]     {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    say("[trace] " + json.dumps(dict(decode_step_ms=step_ms, decode_trace=decode,
                                     prefill_trace=prefill)))


# ---------------------------------------------------------------- phase 7
def phase_decide() -> int:
    """200 kernel-scored decisions; returns the kernel's launch count."""
    from repro_torch.core import H100_TP4_ITER, RequestInfo, make_scheduler
    from repro_torch.kernels import build

    cv, view = pool_2048()
    n = cv.n
    req = RequestInfo(0, 8192, 8192 * 320 * 1024)
    rng = np.random.default_rng(11)
    hits = rng.integers(0, req.input_len, (200, n)).astype(np.float64)
    kern = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel",
                          device="cuda")
    plain = make_scheduler("netkv-full", H100_TP4_ITER, 64)
    cv.hit_tokens[:n] = hits[0]
    kern.select(req, 0, cv, view, None)  # warm the library and the allocator
    build.reset_launches()
    picks, t_kernel = [], 0.0
    for k in range(200):
        cv.hit_tokens[:n] = hits[k]
        t0 = time.perf_counter()
        picks.append(kern.select(req, 0, cv, view, None))
        t_kernel += time.perf_counter() - t0
    launches = build.LAUNCHES["netkv_score_cohort"]
    ensure(launches == 200, ("netkv_score_cohort launches", launches))
    t_np = 0.0
    for k, dec in enumerate(picks):
        cv.hit_tokens[:n] = hits[k]
        s_eff, mask = plain._prep(req, cv)
        tier_row = cv.tier_row(0)
        cost = (plain._xfer_vec(req, cv, 0, view, None, s_eff, tier_row)
                + plain._t_queue_vec(cv) + plain._t_decode_vec(cv))
        best = float(cost[mask].min())
        got = float(cost[cv.slot_of(dec.instance_id)])
        ensure(abs(got - best) <= 1e-5 * abs(best), (k, got, best))
        t0 = time.perf_counter()
        plain.select(req, 0, cv, view, None)
        t_np += time.perf_counter() - t0
    say(f"[decide] 200 netkv-full decisions over D={n}: kernel backend "
        f"{t_kernel / 200 * 1e6:.1f} us/decision, NumPy backend "
        f"{t_np / 200 * 1e6:.1f} us/decision; every pick within rtol 1e-5 of the "
        f"NumPy minimum")
    return launches


# ---------------------------------------------------------------- phase 8
def exp11_grid():
    from repro_torch.sim import ScenarioSpec

    g = EXP11
    return [ScenarioSpec(seed=seed, scheduler=sched, target_rps=g["rps"], warmup=g["warmup"],
                         measure=g["measure"], drain=g["drain"], chunk_tokens=chunk,
                         kv_streaming=chunk is not None, nic_policy=nic,
                         background=g["background"])
            for sched in g["schedulers"] for chunk in g["chunks"]
            for nic in g["nic_policies"] for seed in range(g["seeds"])]


def fast_inputs(plane, seed: int = 0):
    """One sweep step's K6 inputs at the grid's shape: link capacities of
    step 0, and per-request incidence rows gathered from the plane's path
    tables at a random decode instance, under a random active mask."""
    rng = np.random.default_rng(seed)
    s, r = plane.arrival.shape
    lt = plane._link_tier_c
    l1 = plane.link_cap.shape[1] + 1
    caps = plane.link_cap * (1.0 - plane.bg_util[:, lt]) * plane.bw_mult[:, 0][:, lt]
    caps = np.concatenate([caps, np.full((s, 1), np.inf)], axis=1)
    inc = (plane.path_table[..., None] == np.arange(l1)).sum(axis=3).astype(np.float32)
    inst = rng.integers(0, plane.n_decode, (s, r))
    nh = inc[np.arange(s)[:, None], plane.src_p, inst]
    active = (rng.random((s, r)) < 0.6) & np.isfinite(plane.arrival)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in (caps.astype(np.float32), active, nh))


def check_waterfill_fast(rows: dict, plane) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.waterfill import waterfill_fast

    caps, active, nh = fast_inputs(plane)
    s, f = active.shape
    l1 = caps.shape[1]
    got = waterfill_fast(caps, active, nh)
    want = ref.waterfill_rates_fast_ref(caps, active, nh)
    f64 = ref.waterfill_rates_fast_ref(caps.double(), active, nh.double())
    ensure(torch.equal(torch.isinf(got), torch.isinf(want)), "waterfill_fast: inf pattern")
    fin = torch.isfinite(want)
    err = (got - want)[fin].abs()
    rel = (err / want[fin].abs().clamp(min=1e-30)).max().item()
    rel64 = ((got.double() - f64)[fin].abs() / f64[fin].abs().clamp(min=1e-30)).max().item()
    ensure(rel <= 1e-4 and rel64 <= 1e-4, f"waterfill_fast rel err {rel} / f64 {rel64} > 1e-4")
    ensure(bool((got[~active] == 0).all()), "waterfill_fast: inactive rows carry a rate")
    say(f"[kernels] waterfill_fast S {s} x F {f} x L+1 {l1}: {int(active.sum())} active flows, "
        f"max rel err {rel:.3g} vs plain f32, {rel64:.3g} vs f64 (rtol 1e-4)")
    moved = caps.numel() * 4 + active.numel() + nh.numel() * 4 + got.numel() * 4
    # Operations: at least one round's pass over the incidence table (a
    # multiply and an add per entry for the used capacity).
    b_ms, b_by = bound(moved, 2.0 * nh.numel(), torch.float32)
    k_ms = device_time_ms(lambda: waterfill_fast(caps, active, nh), 200)
    p_ms = wall_time_ms(lambda: ref.waterfill_rates_fast_ref(caps, active, nh), 10)
    tr = traced(lambda: waterfill_fast(caps, active, nh), 20)
    only = tr["by_class_ms"].get("waterfill", 0.0)
    say(f"[kernels] waterfill_fast: {k_ms:.4f} ms a call on the device (kernel {only:.4f} ms, "
        f"the wrapper's masking the rest), plain version {p_ms:.3f} ms wall")
    rows["waterfill_fast"] = row("waterfill_fast", err.max().item(), k_ms, p_ms, None,
                                 b_ms, b_by, shape=f"S {s} x F {f} x L+1 {l1} f32",
                                 kernel_only_ms=only,
                                 library="none: no single PyTorch call computes the fixed point")


def phase_sweep(rows: dict) -> int:
    """exp11's FULL grid on the card; returns waterfill_fast launches of the
    second (timed) sweep."""
    from repro_torch.kernels import build
    from repro_torch.sim import ScenarioPlane

    specs = exp11_grid()
    t0 = time.perf_counter()
    plane = ScenarioPlane(specs, dt=EXP11["dt"], backend="kernel", device="cuda")
    prep_s = time.perf_counter() - t0
    s, r = plane.arrival.shape
    say(f"[sweep] exp11 FULL grid: {s} scenarios x {plane.n_steps} steps; R {r}, "
        f"{plane.n_prefill}P+{plane.n_decode}D instances, {plane.link_cap.shape[1]} links "
        f"+ pad; host prep {prep_s:.2f}s")
    check_waterfill_fast(rows, plane)
    walls, launches = [], []
    for _ in range(2):
        build.reset_launches()
        t0 = time.perf_counter()
        out = plane.sweep(detail=True)
        walls.append(time.perf_counter() - t0)
        launches.append(build.LAUNCHES["waterfill_fast"])
        ensure(launches[-1] == plane.n_steps, ("waterfill_fast launches", launches[-1]))
        ensure(sum(build.LAUNCHES.values()) == launches[-1], ("other kernels", build.LAUNCHES))
    for key in ("n_measured", "n_served", "ttft_mean", "ttft_p50", "ttft_p95", "ttft_p99",
                "tbt_mean", "slo_attainment", "goodput_rps"):
        ensure(out[key].shape == (s,), key)
    ensure(bool(np.all(out["n_measured"] > 0)), "a scenario measured nothing")
    ensure(bool(np.all(out["n_served"] <= out["n_measured"])), "served > measured")
    served = out["n_served"] > 0
    ensure(bool(np.all(np.isfinite(out["ttft_p50"][served]))), "non-finite p50")
    att = out["slo_attainment"]
    ensure(bool(np.all(((att >= 0.0) & (att <= 1.0)) | np.isnan(att))), "slo_attainment range")
    say(f"[sweep] backend=kernel on the card: first call {walls[0]:.2f}s, steady second call "
        f"{walls[1]:.2f}s = {s / walls[1]:.2f} scenarios/s; waterfill_fast launches "
        f"{launches[1]} (= steps)")
    plane64 = ScenarioPlane(specs, dt=EXP11["dt"], backend="torch", device="cuda")
    t0 = time.perf_counter()
    ref64 = plane64.sweep(detail=True)
    wall64 = time.perf_counter() - t0
    # The f32 kernel sums a link's used capacity in another order than the
    # f64 loop, so a transfer may complete a step apart and move later
    # admissions.  Held: the measured set is the same, and every per-
    # scheduler TTFT summary agrees within SWEEP_RTOL; reported: how many
    # requests moved, and by how much.
    ensure(np.array_equal(out["n_measured"], ref64["n_measured"]), "sweep n_measured")
    moved = {k: int(np.sum(out[k] != ref64[k])) for k in ("inst", "t_first", "t_fin", "n_served")}
    diffs = {k: float(np.nanmax(np.abs(out[k] - ref64[k]), initial=0.0))
             for k in ("t_first", "t_fin", "ttft_mean", "ttft_p50", "ttft_p95", "ttft_p99",
                       "tbt_mean", "slo_attainment", "goodput_rps")}
    for k in ("ttft_mean", "ttft_p50", "ttft_p95", "ttft_p99"):
        rel = float(np.nanmax(np.abs(out[k] - ref64[k]) / np.abs(ref64[k]), initial=0.0))
        ensure(rel <= SWEEP_RTOL, (f"sweep {k} off the f64 sweep", rel))
    say(f"[sweep] backend=torch (f64) on the card: {wall64:.2f}s = {s / wall64:.2f} "
        f"scenarios/s; kernel vs f64: entries that differ {moved}; max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    for sched in EXP11["schedulers"]:
        idx = [i for i, sp in enumerate(specs) if sp.scheduler == sched]
        say(f"[sweep] {sched:>12}: mean TTFT {np.mean(out['ttft_mean'][idx]) * 1e3:.1f} ms, "
            f"p95 {np.mean(out['ttft_p95'][idx]) * 1e3:.1f} ms, SLO "
            f"{np.mean(out['slo_attainment'][idx]):.3f} (mean over {len(idx)} scenarios)")
    tr = traced(plane.sweep, 1)
    say(f"[sweep] traced kernel sweep: wall {tr['wall_ms'] / 1e3:.2f}s, device busy "
        f"{tr['device_ms']:.1f} ms ({tr['busy_share']:.1%}); by class "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in tr["by_class_ms"].items()))
    for us, count, key in tr.pop("top"):
        say(f"[sweep]     {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    say("[sweep] " + json.dumps(dict(scenarios=s, steps=plane.n_steps, first_s=walls[0],
                                     steady_s=walls[1], scenarios_per_s=s / walls[1],
                                     torch_f64_s=wall64, differ_vs_f64=moved,
                                     max_abs_diff_vs_f64=diffs, sweep_trace=tr)))
    return launches[1]


# ---------------------------------------------------------------- phase 9
def burst_trace(bursts: int = 12, width: int = 4):
    """Same-arrival bursts (tests/test_dispatchplane.py::_burst_trace): their
    prefills finish at one instant, so the dispatch plane scores cohorts."""
    from repro_torch.traces import Request

    trace, rid = [], 0
    for b in range(bursts):
        for i in range(width):
            trace.append(Request(rid, 0.1 + 0.4 * b, 1024, 64,
                                 tuple(f"b{b}-{i}-{j}" for j in range(8)), rid, 1.0))
            rid += 1
    return trace


def phase_simulate():
    """run_sim with K1 scoring on the card and on the CPU; the card runs also
    recompute every FlowPlane fixed point through waterfill_progressive.
    Returns the card runs' launch counts and the captured flow tables."""
    import dataclasses

    from repro_torch.cluster import FlowPlane
    from repro_torch.kernels import build
    from repro_torch.kernels import netkv_score as ns
    from repro_torch.kernels.waterfill import waterfill_rates
    from repro_torch.sim import SimConfig, run_sim
    from repro_torch.traces import generate_trace

    traces = {
        "mooncake": (generate_trace("chatbot", duration=EXP11["warmup"] + EXP11["measure"],
                                    target_rps=EXP11["rps"], seed=0),
                     dict(warmup=EXP11["warmup"], measure=EXP11["measure"],
                          background=EXP11["background"], seed=0)),
        "burst": (burst_trace(), dict(warmup=0.5, measure=4.0, seed=3)),
    }
    tables, worst = [], [0.0]
    recompute = FlowPlane._recompute_rates

    def shadowed(plane, dirty_links=None):
        recompute(plane, dirty_links)
        slots = plane._ordered_slots()
        if not len(slots):
            return
        paths = plane.f_path[slots].astype(np.int32)
        caps = plane._resid_caps.copy()
        want = plane.f_rate[slots].copy()
        rates, _, _, _ = waterfill_rates(paths, caps, backend="kernel", device="cuda")
        got = rates.double().cpu().numpy()
        fin = np.isfinite(want)
        ensure(np.array_equal(np.isinf(got), np.isinf(want)), "K5 inf pattern vs FlowPlane")
        rel = float(np.max(np.abs(got[fin] - want[fin]) / want[fin], initial=0.0))
        ensure(rel <= 1e-4, ("waterfill_progressive vs FlowPlane.f_rate", rel))
        worst[0] = max(worst[0], rel)
        tables.append((paths, caps))

    rows_per_launch: list[int] = []
    card_kernel = ns.netkv_score_cohort

    def counted(*a, **k):
        rows_per_launch.append(int(a[3].shape[0]))
        return card_kernel(*a, **k)

    launches = {}
    for name, (trace, kw) in traces.items():
        out = {}
        for device in ("cuda", "cpu"):
            cfg = SimConfig(scheduler="netkv-full", dispatch_mode="plane",
                            scheduler_kwargs=dict(backend="kernel", device=device), **kw)
            rows_per_launch.clear()
            if device == "cuda":
                FlowPlane._recompute_rates, ns.netkv_score_cohort = shadowed, counted
                build.reset_launches()
            t0 = time.perf_counter()
            try:
                m = run_sim(cfg, trace)
            finally:
                FlowPlane._recompute_rates, ns.netkv_score_cohort = recompute, card_kernel
            wall = time.perf_counter() - t0
            out[device] = dataclasses.asdict(m)
            if device == "cuda":
                launches[name] = dict(build.LAUNCHES)
                hist = {r: rows_per_launch.count(r) for r in sorted(set(rows_per_launch))}
                say(f"[simulate] {name} on the card: {len(trace)} requests, {wall:.2f}s wall; "
                    f"launches {launches[name]}; netkv_score_cohort rows per launch {hist}")
                ensure(launches[name]["netkv_score_cohort"] > 0, f"{name}: K1 not launched")
                ensure(launches[name]["waterfill_progressive"] > 0, f"{name}: K5 not launched")
                if name == "burst":
                    ensure(max(rows_per_launch) > 1, "burst: no cohort of R > 1 rows")
            else:
                say(f"[simulate] {name} on the CPU: {wall:.2f}s wall")
        clock = {"decision_latency_mean", "decision_latency_p99"}
        diff = {k: (out["cuda"][k], out["cpu"][k]) for k in out["cpu"]
                if k not in clock and not (out["cuda"][k] == out["cpu"][k] or (
                    isinstance(out["cpu"][k], float) and np.isnan(out["cpu"][k])
                    and np.isnan(out["cuda"][k])))}
        ensure(not diff, (f"{name}: card and CPU RunMetrics differ", diff))
        m = out["cuda"]
        ensure(m["n_measured"] > 0 and np.isfinite(m["ttft_mean"]), f"{name}: no TTFT")
        say(f"[simulate] {name}: every RunMetrics field equal on the card and the CPU "
            f"(but decision latency); TTFT mean {m['ttft_mean'] * 1e3:.1f} ms p99 "
            f"{m['ttft_p99'] * 1e3:.1f} ms, SLO {m['slo_attainment']:.3f}, "
            f"decision latency {m['decision_latency_mean'] * 1e6:.1f} us (card) / "
            f"{out['cpu']['decision_latency_mean'] * 1e6:.1f} us (CPU)")
    say(f"[simulate] {len(tables)} FlowPlane fixed points recomputed by "
        f"waterfill_progressive, max rel err vs the plane's f64 rates {worst[0]:.3g} (rtol 1e-4)")
    return launches, tables


def check_waterfill_progressive(rows: dict, tables) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.waterfill import waterfill_progressive

    def on_card(paths, caps):
        return (torch.from_numpy(paths).cuda(), torch.from_numpy(caps).float().cuda(),
                torch.ones(len(paths), dtype=torch.bool).cuda())

    for paths, caps in tables[::max(1, len(tables) // 200)]:
        args = on_card(paths, caps)
        rates, tl, ts, rounds = waterfill_progressive(*args)
        p_rates, p_tl, p_ts, p_r = ref.waterfill_fixed_point_ref(*args)
        ensure(int(rounds[0]) == p_r, ("rounds", int(rounds[0]), p_r))
        ensure(torch.equal(rates, p_rates) and torch.equal(ts, p_ts),
               "waterfill_progressive rates/shares differ from the plain version")
        ensure(torch.equal(tl, p_tl), "waterfill_progressive trace links differ")
    paths, caps = max(tables, key=lambda t: len(t[0]))
    args = on_card(paths, caps)
    f, h = paths.shape
    l1 = len(caps)
    say(f"[kernels] waterfill_progressive: {min(len(tables), 200)} FlowPlane tables "
        f"(up to F {f} x H {h}, L+1 {l1}): rates, shares, trace links and rounds bitwise "
        f"equal to the plain version")
    moved = paths.size * 4 + l1 * 4 + f + f * 4 + 2 * f * 4 + 4
    b_ms, b_by = bound(moved, float(l1 * f), torch.float32)
    k_ms = device_time_ms(lambda: waterfill_progressive(*args), 200)
    p_ms = wall_time_ms(lambda: ref.waterfill_fixed_point_ref(*args), 5)
    tr = traced(lambda: waterfill_progressive(*args), 20)
    rounds = int(waterfill_progressive(*args)[3][0])
    say(f"[kernels] waterfill_progressive on that table: {rounds} rounds; traced device "
        f"time {tr['device_ms']:.3f} ms a call, of which the kernel "
        f"{tr['by_class_ms'].get('waterfill', 0.0):.3f} ms and the wrapper's prep ops the rest")
    rows["waterfill_progressive"] = row(
        "waterfill_progressive", 0.0, k_ms, p_ms, None, b_ms, b_by,
        shape=f"F {f} x H {h}, L+1 {l1} f32 (largest FlowPlane table), {rounds} rounds",
        kernel_only_ms=tr["by_class_ms"].get("waterfill", 0.0),
        library="none: no single PyTorch call computes the fixed point")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    rows: dict = {}
    check_kv_pack(rows)
    check_flash_decode(rows)
    check_netkv_score(rows)
    phase_match()
    launches, cluster, prompts = phase_serve()
    phase_trace(cluster, prompts)
    del cluster
    torch.cuda.empty_cache()
    decide = phase_decide()
    launches["waterfill_fast"] = phase_sweep(rows)
    sim_launches, tables = phase_simulate()
    check_waterfill_progressive(rows, tables)
    # K1 runs on two paths: the decide phase and the simulator's scoring.
    launches["netkv_score_cohort"] = decide + sum(
        v["netkv_score_cohort"] for v in sim_launches.values())
    launches["waterfill_progressive"] = sum(
        v["waterfill_progressive"] for v in sim_launches.values())
    kernels = []
    for k in KERNELS:
        entry = rows[k]
        entry["launches"] = launches[k]
        ensure(entry["launches"] > 0, f"{k} was not launched on its path")
        kernels.append(entry)
    say(f"[done] {time.perf_counter() - t_start:.1f}s")
    say(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
