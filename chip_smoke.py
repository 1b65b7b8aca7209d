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
  8. one JSON line ``{"kernels": [...]}``
  9. last line ``{"ok": true, "device": {...}}``

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
}
SOURCE = {
    "netkv_score_cohort": "src/repro_torch/csrc/netkv_score.cu",
    "kv_pack": "src/repro_torch/csrc/kv_pack.cu",
    "kv_unpack": "src/repro_torch/csrc/kv_pack.cu",
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
}
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
    bracket the device work back to back and not the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    want_launches = {"flash_decode": cfg.n_layers * steps, "kv_pack": 2 * shipping,
                     "kv_unpack": 2 * shipping, "netkv_score_cohort": 0}
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
    launches["netkv_score_cohort"] = phase_decide()
    kernels = []
    for k in ("netkv_score_cohort", "kv_pack", "kv_unpack", "flash_decode"):
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
