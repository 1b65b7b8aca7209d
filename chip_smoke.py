#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --k1   # K1 and the decision path alone (phases 1, 9
                                 # and profile_k1): to compare two trees in one
                                 # call, run it from a copy of each
    python3 chip_smoke.py --train   # phases 1-2, K4's checks, the per-slot
                                    # decode at qwen3-14b's width and phase 12
    python3 chip_smoke.py --dryrun  # phases 1-2, K4's checks (its self term and
                                    # partials too), phase 5b and phase 12c
    python3 chip_smoke.py --moe     # phases 1-2, K8's and K9's checks and times,
                                    # granite-moe served (8b), jamba-v0.1 served
                                    # (8c), phase 8f

Phases, in order; every check asserts and any failure exits non-zero:

  1. device   name, count, ``nvidia-smi`` name and power limit
  2. build    nvcc every kernel source in parallel; ptxas registers/spills,
              and the whole -Xptxas -v of netkv_score.cu, flash_decode.cu,
              rwkv_scan.cu, moe_decode.cu and moe_route.cu
  3. kernels  each kernel against its plain PyTorch version at the shapes of
              the serving path, with times for the kernel, the plain version
              and the one PyTorch call that computes the same function;
              netkv_score_cohort at R 1 x D 1-8192 and R 64 x D 2048, on rows
              of equal costs across its cluster's ranks and rows with no or
              one feasible lane (cost rows bitwise, packed results equal, two
              calls bitwise equal), its plans, and from the profiler one
              runtime launch a call and the kernel's time;
              flash_decode also where its split over the cache shows (one
              range, a range's edge and one past it, G 8, dh 16-256), with
              its ranges, grid and launches a call, and at the decode shapes
              of granite-moe (G 2, dh 64; timed too), phi3 (G 4), internlm2
              (G 6), smollm (G 3, dh 64), jamba (G 4, dh 128), seamless's
              self-attention (G 1, dh 64, pos 264) and cross-attention (S
              2048, pos 2048) and internvl2 (G 8, dh 128, pos 2312), each
              timed but phi3's, internlm2's and smollm's; and through the
              padded-head path (H 6 over KV 4, timed); with per-row lengths
              (the per-slot decode) at qwen3-14b's shape, (2056, 1031, 17, 1),
              rows shorter than a range and on a range's edge, bf16 and f32,
              equal lengths bitwise the scalar launch (timed beside it); with
              the self term (pos 0-S, a row of length 0) and in partials mode
              on 4 sequence shards (one empty) with their merge, each timed
              at pos 2056 beside the scalar launch and SDPA;
              rwkv_scan also at ragged
              T, B 2, dh 16-128 across its column groups and in bf16; both
              deterministic (two calls bitwise equal); moe_decode (K8) at
              Jamba2-Mini's decode shape on routings of 2, 4, 8 and 16
              experts (timed beside the routed experts' bytes and the bmm
              path over all 16), NaN in the unrouted experts' weights
              unread, and at ragged shapes in bf16 and f32; K8 at granite's
              decode shape (T 4, d 1024, f 512, E 32, top 8) on K9's kept
              gates at capacity 1 (timed beside the bmm path at capacity 1);
              moe_route (K9) at granite's and Jamba2-Mini's decode widths, T
              1-8, against its plain version (timed beside the plain version
              and the routing chain of the bmm path), ties to the lower index
  4. match    the serving path on the card against the same path on the CPU
              (the plain versions), the smoke configs of qwen3-14b, rwkv6,
              granite-moe, arctic (MoE with a dense residual), phi3,
              internlm2, smollm, jamba (Mamba, attention and MoE in one
              8-layer period) and internvl2 (text only) in f32: every result
              equal; the seamless smoke model's encode, prefill and 6 decode
              steps: tokens equal, memory and logits within 1e-4
  5. serve    qwen3-14b at full width (bf16, random weights from a seed):
              2 prefill + 4 decode instances, 8 requests of 2048 tokens, 16
              new tokens each; launch counts of kv_pack/kv_unpack/flash_decode;
              after phase 6, ``decode_step`` with a vector ``pos``: equal
              entries bitwise the scalar step's logits and cache, ragged
              entries (2055, 1030, 16, 0): each row's cache changed at its
              position only, layer 0's new K/V and the longest row's logits
              bitwise those of the row at its own scalar pos, every row's
              logits within twice a scalar step's own batch-vs-alone
              difference of the row alone at batch 1
 5b. readonly on the same model: ``decode_step(update_cache=False)``, 4 slots
              after 2048-token prompts, 16 greedy steps beside the writing
              step on a copy of the cache: the input cache bitwise unchanged
              after each step, the first period's fragments bitwise the
              written rows, logits and greedy tokens held to the writing
              step's; both steps' wall and device ms
  6. trace    where the time of that path goes: one decode engine of the
              served cluster with its 4 slots full, decode steps on the host
              clock and under ``torch.profiler`` (device time by kernel class,
              the device's busy share of the traced window), and one prefill
  7. serve    rwkv6-3b at full width on the same workload, after the qwen3
              cluster is freed: 21,299,200 state bytes a request, rwkv_scan
              launched 32 times a prefill, no attention kernel launched
  8. trace    phase 6 on the rwkv6-3b cluster
 8b. serve    granite-moe-1b-a400m at full width (MoE FFN: 32 experts, top 8)
              on the same workload, moe_route (K9) and moe_decode (K8) each
              launched 24 MoE layers x decode steps (capacity 1: slots drop),
              then phase 6 on its cluster (the MoE dispatch's kernels, K9's
              and K8's as classes of their own) and two prefills
              and two decode steps on the same inputs, bitwise equal; then
              phi3-medium-14b, internlm2-20b and smollm-135m at full width
              with 4 requests each, each cluster freed before the next
 8c. serve    jamba-v0.1-52b at full width with 16 of its 32 layers (two
              whole periods; 32 layers' bf16 weights do not fit one card) on
              the same workload: each request ships its un-hit attention
              pages (8,192 B a token) and the whole Mamba state (8,028,160
              B); flash_decode launched 2 x decode steps, moe_route (K9) and
              moe_decode (K8) 8 MoE layers x decode steps; then phase 6 on
              its cluster, two prefills and two decode steps bitwise equal,
              and the Mamba mixer alone at full width (a 2048-token prefill
              and a 4-slot decode step: device and wall ms, runtime
              launches a call, bound)
 8f. serve    the published Jamba block (no drop) at the same 16 layers,
              after phase 8c's cluster is freed, on the same workload
              (lane 0 of a 4-lane decode engine active, lanes 1-3 idle as
              serve() leaves them): phase 5's checks, and moe_decode (K8)
              and moe_route (K9) launched 8 MoE layers x decode steps, as in
              phase 8c's capacity factor 1.25, where slots drop; the distinct
              experts each decode MoE layer routed to
 8d. model    seamless-m4t-medium at full width, nothing cut (12 encoder and
              12 decoder layers, 977,758,208 parameters): encode 4 x 2048
              stub frames, prefill 4 x 256 tokens with that memory at
              cache_len 4096, 16 decode steps (8 on the host clock, 4 warm-up
              and 4 traced); flash_decode 24 calls a step (self- and
              cross-attention); the encode, prefill and step traced; two
              prefills and two decode steps bitwise equal
 8e. serve    internvl2-76b at full width with 24 of its 80 layers (80 do not
              fit one card): the cluster serves 4 requests of 2048 tokens,
              text only as the JAX cluster (201,326,592 B a request,
              100,663,296 on a 64-page hit); then on its weights phase 8d's
              run with 4 x (256 stub patch embeddings + 2048 tokens)
  9. decide   200 netkv-full decisions through the netkv_score_cohort kernel
              and 200 on the NumPy backend over pools of 16-8192 instances,
              each kernel pick within rtol 1e-5 of the NumPy minimum; µs a
              decision of both and the crossover; at D 2048 the runtime calls
              of one decision from the profiler: 1 copy in, 1 launch, 1 copy
              out, 1 sync
 10. sweep    exp11's FULL grid (54 scenarios, 1400 steps of 0.01 s) through
              ScenarioPlane(backend="kernel"): first waterfill_fast against
              its plain version at the grid's shape and on three tables past
              its shared-memory layout, in both its device-memory layouts
              (f32 and f64, rtol 1e-4; two calls
              bitwise equal; its plan, and one device op a call in the
              profiler), then the sweep twice
              (waterfill_fast launched once a step; the second call's wall
              and scenarios/s), sanity, and the summaries against the f64
              backend="torch" sweep on the card
 11. simulate run_sim on the 64-GPU cluster, netkv-full scored by
              netkv_score_cohort, over a Mooncake chatbot trace (one row a
              launch) and a same-arrival burst trace (cohorts of R > 1 rows):
              on the card every RunMetrics field equals the CPU run's but the
              host-clock decision latencies, and traced, every decision's
              forensics row equals the CPU run's; each FlowPlane fixed point of
              the card runs is recomputed by waterfill_progressive and held
              to the plane's rates (rtol 1e-4); then waterfill_progressive
              bitwise against its plain version on those tables and on its
              shape edges (one flow, F and L+1 past 256, no active flow,
              pad-only paths, both layouts past shared memory), two calls
              bitwise equal, one device op a call in the profiler, and its
              device_time_ms beside the traced device time
 12. train    (a) one train step of every registered arch's smoke config in
              f32 on the card against the CPU (loss, grad_norm, parameters);
              (b) smollm-135m at full width, nothing cut: 20 steps of global
              batch 8 x 4096, 4 microbatches, AdamW, f32 master, bf16
              compute, remat, under deterministic algorithms: losses finite
              and falling, wall ms a step, tokens/s, peak memory, the bound;
              a checkpoint at step 10 restored and steps 10-20 run again,
              parameters bitwise equal; one step under ``torch.profiler``
 12c. dryrun  ``python -m repro_torch.launch.dryrun --arch qwen3-14b --shape
              decode_32k --mesh both`` as a subprocess on the CPU, after
              every timed phase (meta tensors, a fake process group of 512
              ranks): both cells ok
 13. one JSON line ``{"kernels": [...]}``
 14. last line ``{"ok": true, "device": {...}}``

It imports nothing of JAX and nothing of the JAX package.  Without a CUDA
device, or without the repository's ``src/`` beside it, it fails.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Phase 12's restart drill runs under torch.use_deterministic_algorithms,
# which needs cuBLAS's workspace fixed before CUDA starts (":4096:8", 32 MiB,
# the size PyTorch gives Hopper by default).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    "rwkv_scan": "src/repro/kernels/rwkv_scan.py:28",
    "moe_decode": "none: src/repro/models/moe.py:113 runs the experts as XLA einsums",
    "moe_route": "none: src/repro/models/moe.py routes with XLA ops (softmax, top_k, cumsum)",
}
SOURCE = {
    "netkv_score_cohort": "src/repro_torch/csrc/netkv_score.cu",
    "kv_pack": "src/repro_torch/csrc/kv_pack.cu",
    "kv_unpack": "src/repro_torch/csrc/kv_pack.cu",
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
    "waterfill_progressive": "src/repro_torch/csrc/waterfill.cu",
    "waterfill_fast": "src/repro_torch/csrc/waterfill.cu",
    "rwkv_scan": "src/repro_torch/csrc/rwkv_scan.cu",
    "moe_decode": "src/repro_torch/csrc/moe_decode.cu",
    "moe_route": "src/repro_torch/csrc/moe_route.cu",
}
KERNELS = ("netkv_score_cohort", "kv_pack", "kv_unpack", "flash_decode",
           "waterfill_progressive", "waterfill_fast", "rwkv_scan", "moe_decode", "moe_route")
# The FULL grid of benchmarks/exp11_scenario_sweep.py (defined here: that
# module imports the JAX package).
EXP11 = dict(schedulers=("cla", "netkv-static", "netkv-full"), chunks=(None, 256, 1024),
             nic_policies=("hash", "rail-affine"), seeds=3, warmup=2.0, measure=8.0,
             drain=4.0, rps=12.0, background=0.25, dt=0.01)
# TTFT summaries of the f32 kernel sweep against the f64 sweep, relative.
SWEEP_RTOL = 0.02
# A row of a bf16 decode batch against the same row decoded by other means
# with the same products, x the largest |logit|: a few rounding steps (the
# CPU tests' bound for a bf16 model).
BF16_ROW = 2.0 ** -6
# flash_decode (rtol, atol) by dtype.  Kernel and plain version both sum in
# f32 and round once to the output dtype, so in bf16 they may differ by one
# rounding step of the output, at most 2^-7 of its magnitude; a kernel that
# kept p, l or the accumulator in bf16 errs by more on the small outputs.
FD_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (0.0, 2e-5)}
# rwkv_scan y (rtol, atol) by dtype: in f32 the atol tests/test_kernels.py
# holds the TPU kernel to (the kernel sums over k in another order than the
# plain version); in bf16 one rounding step of the output, as FD_TOL.  The
# final state is f32 either way and held to atol 1e-4.
RWKV_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (0.0, 1e-4)}
# moe_decode (rtol, atol over the largest |output|) by dtype, and the share of
# bf16 elements it must give bit for bit.  Kernel and plain version take f32
# products and round at the same places, in other orders of the f32 sums: a
# rounded intermediate moves by one step in rare elements, and a token's two
# gated terms may cancel, so one step of a term shows on a small output.
MOE_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -7), torch.float32: (1e-5, 1e-5)}
MOE_EQUAL_SHARE = 0.9


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
    for name in ("netkv_score", "flash_decode", "rwkv_scan", "moe_decode", "moe_route"):
        say(f"[build] -Xptxas -v of {name}.cu:")
        for line in logs[name]["ptxas"].splitlines():
            say(f"[build]   {line.rstrip()}")


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


def range_edges(q, k, s: int) -> list[int]:
    """pos values at which K4's last range is exactly full, and one past:
    the first and last such pos up to S."""
    from repro_torch.kernels.flash_decode import plan_for

    full = [p for p in range(2, s + 1)
            if (pl := plan_for(q, k, p)).n_split > 1 and pl.n_split * pl.range_len == p]
    return sorted({p + d for p in (full[0], full[-1]) for d in (0, 1) if p + d <= s})


def time_flash_decode(q, k, v, pos: int) -> dict:
    """K4 at one decode shape: the kernel, its plain version and SDPA on the
    same inputs, and its bound (the first ``pos`` key and value rows read
    once, q read and the output written once)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd, ref

    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    es = q.element_size()
    moved = 2 * b * pos * kv * dh * es + 2 * q.numel() * es
    b_ms, b_by = bound(moved, 4.0 * b * h * pos * dh, q.dtype)
    qs = q[:, :, None, :]
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda") < pos)[None, None, None, :]
    return dict(ms=device_time_ms(lambda: fd.flash_decode(q, k, v, pos), 100),
                plain_ms=device_time_ms(lambda: ref.flash_decode_ref(q, k, v, pos), 20),
                library_ms=device_time_ms(lambda: F.scaled_dot_product_attention(
                    qs, kt, vt, attn_mask=mask, enable_gqa=True), 100),
                bound_ms=b_ms, bound_by=b_by,
                shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype} pos {pos}")


# The decode shapes (B 4 slots) of the other attention models run at full
# width: (H, KV, dh, S), S the cache_len 4096 but for seamless's
# cross-attention, which reads the encoder's 2048 frames whole.
K4_DECODE_SHAPES = {"granite-moe-1b-a400m": (16, 8, 64, 4096),
                    "phi3-medium-14b": (40, 10, 128, 4096),
                    "internlm2-20b": (48, 8, 128, 4096), "smollm-135m": (9, 3, 64, 4096),
                    "jamba-v0.1-52b": (32, 8, 128, 4096),
                    "seamless-m4t-medium": (16, 16, 64, 4096),
                    "seamless-m4t-medium cross": (16, 16, 64, 2048),
                    "internvl2-76b": (64, 8, 128, 4096)}
# Those timed too, by their name in the kernel row: (shape, pos).  seamless
# decodes at pos 256-272 after its 256-token prefill, its cross-attention at
# pos S_enc; internvl2 at 2304-2320 after 256 patches and 2048 tokens.
TIMED = {"granite": ("granite-moe-1b-a400m", 2056), "jamba": ("jamba-v0.1-52b", 2056),
         "seamless_self": ("seamless-m4t-medium", 264),
         "seamless_cross": ("seamless-m4t-medium cross", 2048),
         "internvl2": ("internvl2-76b", 2312)}
# The padded-head path (H % KV != 0, no registered config): (H, KV, dh, S).
K4_PADDED = (6, 4, 128, 4096)


def check_padded_heads(inputs, held) -> dict:
    """K4 where H % KV != 0: ``kernel_decode_attention`` pads q with zero
    heads to KV * ceil(H/KV) and keeps the first H outputs.  Held to the
    head-expanded plain reference (``decode_attention``, f32) and to K4's
    plain version on the padded q; timed as the kernel on the padded q, and
    as the whole wrapper with its pad and slice."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.models.attention import decode_attention, kernel_decode_attention

    h, kv, dh, s = K4_PADDED
    g = -(-h // kv)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(4, h, kv, dh, s, dtype)
        qp = torch.cat([q, q.new_zeros((4, kv * g - h, dh))], dim=1)
        for pos in (1, 2056, s):
            before = build.LAUNCHES["flash_decode"]
            out = kernel_decode_attention(q, k, v, pos)
            ensure(build.LAUNCHES["flash_decode"] == before + 1, "padded heads: one K4 call")
            ensure(torch.equal(out, kernel_decode_attention(q, k, v, pos)),
                   "padded heads: two calls differ")
            held(qp, k, v, pos, f"padded heads H {h} KV {kv} {dtype}")
            if dtype == torch.float32:
                plain = decode_attention(q[:, None], k, v, pos)[:, 0]
                err = (out - plain).abs().max().item()
                ensure(err <= FD_TOL[dtype][1], f"padded heads vs decode_attention: {err}")
    q, k, v = inputs(4, h, kv, dh, s, torch.bfloat16)
    qp = torch.cat([q, q.new_zeros((4, kv * g - h, dh))], dim=1)
    t = time_flash_decode(qp, k, v, 2056)
    t["wrapper_ms"] = device_time_ms(lambda: kernel_decode_attention(q, k, v, 2056), 100)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda") < 2056)[None, None, None, :]
    t["library_ms"] = device_time_ms(lambda: F.scaled_dot_product_attention(
        qp[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True), 100)
    t["shape"] = (f"q (4, {h}, {dh}) padded to {kv * g} heads, k/v (4, {s}, {kv}, {dh}) "
                  "bf16, pos 2056")
    say(f"[kernels] flash_decode, padded heads (H {h} over KV {kv}, G {g}, dh {dh}, pos 2056): "
        f"{t['ms']:.4f} ms the kernel, {t['wrapper_ms']:.4f} ms with pad and slice, SDPA on "
        f"the padded q {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}); bf16 and f32 held at pos 1, 2056, {s}")
    return t


# K4 with per-row lengths at qwen3-14b's decode shape (B 4, H 40, KV 8, dh
# 128, S 4096): a row past the decode step of a 2048-token prompt, one at
# half of it, one shorter than a range and one of length 1.
RAGGED = (2056, 1031, 17, 1)


def check_ragged(inputs) -> dict:
    """K4 with a (B,) vector of lengths (the per-slot decode) against its
    plain version on the same lengths, in bf16 and f32: ``RAGGED``; rows
    shorter than one range of the longest row's plan; rows that end on a
    range's edge and one past it; a row at S; every row at 1.  Two calls
    bitwise equal; a vector of equal lengths bitwise the scalar launch.
    Timed at ``RAGGED`` beside the scalar launch at 2056, against its bound
    (the rows' own keys and values read once) and SDPA with a per-row mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd, ref

    b, h, kv, dh, s = 4, 40, 8, 128, 4096
    longest = max(RAGGED)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(b, h, kv, dh, s, dtype)
        r = fd.plan_for(q, k, longest).range_len
        cases = [RAGGED, (longest, r, r + 1, 2 * r), (longest, r - 1, 1, 2 * r - 1),
                 (s, s - 1, r, 3), (1, 1, 1, 1)]
        worst = 0.0
        for lengths in cases:
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = fd.flash_decode(q, k, v, max(lengths), lens)
            err, excess = flash_decode_error(out, ref.flash_decode_ref(q, k, v, lens))
            ensure(excess <= 0, f"flash_decode lengths {lengths} {dtype}: max err {err}, "
                   f"{excess} over (rtol, atol) {FD_TOL[dtype]}")
            ensure(torch.equal(out, fd.flash_decode(q, k, v, max(lengths), lens)),
                   f"flash_decode lengths {lengths} {dtype}: two calls differ")
            worst = max(worst, err)
        for pos in (1, 17, r, longest, s):
            lens = torch.full((b,), pos, dtype=torch.int32, device="cuda")
            ensure(torch.equal(fd.flash_decode(q, k, v, pos, lens), fd.flash_decode(q, k, v, pos)),
                   f"flash_decode {dtype}: equal lengths {pos} differ from the scalar launch")
        say(f"[kernels] flash_decode with per-row lengths {dtype}: {cases} (ranges of {r} keys "
            f"over the longest row), max abs err {worst:.3g}; two calls bitwise equal; equal "
            "lengths bitwise the scalar launch")
    q, k, v = inputs(b, h, kv, dh, s, torch.bfloat16)
    lens = torch.tensor(RAGGED, dtype=torch.int32, device="cuda")
    es = q.element_size()
    keys = sum(RAGGED)
    b_ms, b_by = bound(2 * keys * kv * dh * es + 2 * q.numel() * es + 4 * b,
                       4.0 * h * keys * dh, q.dtype)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    scalar_ms = device_time_ms(lambda: fd.flash_decode(q, k, v, longest), 100)
    t = dict(ms=device_time_ms(lambda: fd.flash_decode(q, k, v, longest, lens), 100),
             scalar_ms=scalar_ms,
             plain_ms=device_time_ms(lambda: ref.flash_decode_ref(q, k, v, lens), 20),
             library_ms=device_time_ms(lambda: F.scaled_dot_product_attention(
                 q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True), 100),
             bound_ms=b_ms, bound_by=b_by,
             shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, lengths {list(RAGGED)}")
    say(f"[kernels] flash_decode with lengths {list(RAGGED)}: {t['ms']:.4f} ms a call (the "
        f"scalar launch at pos {longest}: {scalar_ms:.4f} ms), SDPA with a per-row mask "
        f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']})")
    return t


def check_flash_decode(rows: dict) -> None:
    from repro_torch.kernels import build, flash_decode as fd, ref

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(b, h, kv, dh, s, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh))]

    def held(q, k, v, pos, what) -> float:
        err, excess = flash_decode_error(fd.flash_decode(q, k, v, pos),
                                         ref.flash_decode_ref(q, k, v, pos))
        ensure(excess <= 0, f"flash_decode {what} pos={pos}: max err {err}, "
               f"{excess} over (rtol, atol) {FD_TOL[q.dtype]}")
        return err

    # The split's edges at small shapes: one (batch, KV head) over many
    # ranges, G 8, dh 16, 64 and 256; pos 1, on the last range's edge and
    # one past it, and S.
    # (4, 64, 8, 128, 2100): llama3-70b's decode shape, G 8.
    for b, h, kv, dh, s in ((1, 1, 1, 128, 4096), (2, 16, 2, 64, 1024), (3, 24, 3, 16, 600),
                            (2, 12, 4, 256, 700), (4, 64, 8, 128, 2100)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(b, h, kv, dh, s, dtype)
            poss = [1, *range_edges(q, k, s), s]
            err = max(held(q, k, v, pos, f"{(b, h, kv, dh, s)} {dtype}") for pos in poss)
            say(f"[kernels] flash_decode B {b} H {h} KV {kv} dh {dh} S {s} {dtype}: pos {poss}, "
                f"up to {fd.plan_for(q, k, s).n_split} ranges, max abs err {err:.3g}")
    timed = {}
    for arch, (h, kv, dh, s) in K4_DECODE_SHAPES.items():
        b = 4
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(b, h, kv, dh, s, dtype)
            poss = sorted({1, *range_edges(q, k, s), *(p for _, p in TIMED.values() if p <= s), s})
            err = max(held(q, k, v, pos, f"{arch} {dtype}") for pos in poss)
            say(f"[kernels] flash_decode at {arch}'s decode shape (B {b} H {h} KV {kv} G "
                f"{h // kv} dh {dh} S {s}) {dtype}: pos {poss}, max abs err {err:.3g}")
            if dtype != torch.bfloat16:
                continue
            for name, (shape, pos) in TIMED.items():
                if shape == arch:
                    t = timed[name] = time_flash_decode(q, k, v, pos)
                    say(f"[kernels] flash_decode at {name}'s decode shape: {t['ms']:.4f} ms a "
                        f"call, SDPA {t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                        f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    timed["padded"] = check_padded_heads(inputs, held)
    timed["ragged"] = check_ragged(inputs)
    b, h, kv, dh, s = 4, 40, 8, 128, 4096
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(b, h, kv, dh, s, dtype)
        worst = 0.0
        for pos in (1, 16, *range_edges(q, k, s), 2049, 2056, 4096):
            worst = max(worst, held(q, k, v, pos, str(dtype)))
        ensure(torch.equal(fd.flash_decode(q, k, v, 2056), fd.flash_decode(q, k, v, 2056)),
               f"flash_decode {dtype}: two calls differ")
        say(f"[kernels] flash_decode {dtype}: max abs err {worst:.3g} "
            f"((rtol, atol) {FD_TOL[dtype]}); two calls bitwise equal")
        if dtype != torch.bfloat16:
            continue
        pos = 2056  # a decode step of a 2048-token prompt
        plan = fd.plan_for(q, k, pos)
        grid = (b * kv, plan.n_split)
        tr = traced(lambda: fd.flash_decode(q, k, v, pos), 20)
        mine = [(us, n, key) for us, n, key in tr["top"] if kernel_class(key) == "flash_decode"]
        per_call = sum(n for _, n, _ in mine) / 20
        say(f"[kernels] flash_decode at pos {pos}: n_split {plan.n_split} ranges of "
            f"{plan.range_len} keys, grid {grid} = {grid[0] * grid[1]} blocks on "
            f"{build.sm_count(q.device)} SMs, {per_call:g} kernel launches a call (profiler: "
            + ", ".join(f"{re.search(r'flash_decode_[a-z]+', key).group()} {us / n:.2f} us"
                        for us, n, key in mine)
            + ")")
        t = time_flash_decode(q, k, v, pos)
        say(f"[kernels] flash_decode: {t['ms']:.4f} ms a call, SDPA {t['library_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        rows["flash_decode"] = row(
            "flash_decode", worst, t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
            t["bound_by"], shape=t["shape"], n_split=plan.n_split, range_len=plan.range_len,
            grid=list(grid), kernel_launches_per_call=per_call,
            **{f"{model}_{key}": value for model, t in timed.items() for key, value in t.items()})
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


# K1's shapes: one decision over pools from 1 lane to past a cluster of 8
# full blocks, lanes around warp and block edges, and a 64-row cohort; then
# rows of equal costs whose feasible lanes sit across the cluster's ranks,
# and rows with no or one feasible lane.
K1_SHAPES = [(1, d) for d in (1, 2, 16, 31, 32, 33, 255, 256, 257, 2048, 2049, 8192)] + [
    (64, 2048)]
K1_KINDS = ("edge", "ranks", "none", "one")


def k1_held(case: dict) -> np.ndarray:
    """K1 on the card against its plain version on the card and on the host:
    cost rows bitwise, packed results equal, two calls bitwise equal.
    Returns the packed result."""
    from repro_torch.kernels import netkv_score as ns, ref

    def on(dev):
        return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
                for k, v in case.items()}

    card = on("cuda")
    cost, res = ns.netkv_score_cohort(**card)
    cost2, res2 = ns.netkv_score_cohort(**card)
    p_cost, p_res = ref.netkv_score_cohort_ref(**card)
    h_cost, h_res = ref.netkv_score_cohort_ref(**on("cpu"))
    shape = case["hit_rows"].shape
    ensure(torch.equal(cost, cost2) and torch.equal(res, res2), f"K1 {shape}: two calls differ")
    ensure(torch.equal(cost, p_cost) and torch.equal(cost.cpu(), h_cost),
           f"K1 {shape}: cost rows differ from the plain version")
    ensure(torch.equal(res, p_res) and torch.equal(res.cpu(), h_res),
           f"K1 {shape}: packed result differs from the plain version")
    return res.cpu().numpy()


def check_netkv_score(rows: dict) -> None:
    from repro_torch.core import H100_TP4_ITER, PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY
    from repro_torch.kernels import build, netkv_score as ns, ref

    n_sm = build.sm_count(torch.device("cuda"))
    plans = []
    for r, d in K1_SHAPES:
        k1_held(ns.score_case(r, d, n_sm=n_sm))
        plan = ns.score_plan(r, d, n_sm)
        plans.append(f"R {r} x D {d}: cluster {plan.cluster} x {plan.threads} threads, "
                     f"grid {plan.grid}")
    say("[kernels] netkv_score_cohort: cost rows bitwise equal to the plain version on the "
        "card and the host, packed results equal, two calls bitwise equal; plans: "
        + "; ".join(plans))
    for kind in K1_KINDS:
        for d in (257, 2048, 2049, 8192):
            case = ns.score_case(2, d, kind, n_sm=n_sm)
            best, best_cost, second, _ = ns.unpack_result(k1_held(case))
            lanes = np.flatnonzero(case["healthy"])
            want = (0 if kind == "none" else lanes[0], lanes[1] if len(lanes) > 1 else -1)
            ensure((best == want[0]).all() and (second == want[1]).all(),
                   (f"K1 {kind} D {d}", best, second, lanes))
            ensure((best_cost == np.float32(ns.BIG)).all() == (kind == "none"),
                   (f"K1 {kind} D {d}: best cost", best_cost))
    say(f"[kernels] netkv_score_cohort: equal-cost lanes across cluster ranks ({', '.join(K1_KINDS)}"
        f" at D 257, 2048, 2049, 8192): lowest index best, next second, none where no lane "
        f"or one lane is feasible")

    cv, _ = pool_2048()
    d = cv.n
    kv_bytes, input_len = 8192 * 320 * 1024, 8192
    timed = {}
    for r in (1, 64):
        rng = np.random.default_rng(7 * d + r)
        cols = [torch.from_numpy(cv.column(c).astype(np.float32)).cuda() for c in
                ("free_memory", "queued", "batch", "healthy", "iter_scale")]
        args = dict(
            free_mem=cols[0], queued=cols[1], batch=cols[2],
            hit_rows=torch.from_numpy(rng.integers(0, input_len, (r, d)).astype(np.float32)).cuda(),
            tier_rows=torch.from_numpy(rng.integers(0, 4, (r, d)).astype(np.int32)).cuda(),
            healthy=cols[3], iter_scale=cols[4],
            tier_bw=[PAPER_TIER_BANDWIDTH[t] for t in range(4)],
            tier_lat=[PAPER_TIER_LATENCY[t] for t in range(4)], congestion=[0.2, 0.1, 0.3, 0.05],
            infl_rows=torch.from_numpy(rng.integers(0, 4, (r, 4)).astype(np.float32)).cuda(),
            s_r=torch.full((r,), kv_bytes, dtype=torch.float32, device="cuda"),
            input_len=torch.full((r,), input_len, dtype=torch.float32, device="cuda"),
            iter_a=H100_TP4_ITER.a, iter_b=H100_TP4_ITER.b, m_min=2e9, beta_max=64)
        # Each input read once, the cost rows and the (R, 4) result written once.
        moved = 5 * d * 4 + r * d * (4 + 4) + r * (4 * 4 + 4 + 4) + r * d * 4 + r * 16
        timed[r] = (device_time_ms(lambda: ns.netkv_score_cohort(**args), 200),
                    device_time_ms(lambda: ref.netkv_score_cohort_ref(**args), 20),
                    *bound(moved, 26.0 * r * d, torch.float32))
    prof = profile_k1()
    launches = sum(v for k, v in prof["runtime_per_call"].items() if "Launch" in k)
    ensure(launches == 1.0 and not any("Memcpy" in k or "Memset" in k
                                       for k in prof["runtime_per_call"]),
           ("K1 runtime calls a call", prof["runtime_per_call"]))
    # The decide path launches R = 1 (one request a decision); R = 64 is the
    # cohort shape of the simulator's batched selection, kept for comparison.
    k_ms, p_ms, b_ms, b_by = timed[1]
    say(f"[kernels] netkv_score_cohort R 1 x D {d}: {k_ms:.5f} ms a call, the kernel "
        f"{prof['kernel_ms']:.5f} ms, plain {p_ms:.4f} ms, bound {b_ms:.7f} ms ({b_by}); "
        f"R 64: {timed[64][0]:.5f} ms, bound {timed[64][2]:.6f} ms")
    rows["netkv_score_cohort"] = row(
        "netkv_score_cohort", 0.0, k_ms, p_ms, None, b_ms, b_by,
        shape=f"R 1 x D {d} f32", kernel_only_ms=prof["kernel_ms"],
        plan=ns.score_plan(1, d, n_sm)._asdict(), launches_a_call=launches,
        r64_ms=timed[64][0], r64_plain_ms=timed[64][1], r64_bound_ms=timed[64][2],
        library="none: no one PyTorch call computes Eq. (2)-(7) and the two minima")


def profile_k1(r: int = 1, d: int = 2048) -> dict:
    """K1 at the decide path's shape: ``device_time_ms`` of the wrapper
    beside the kernel's own time and the runtime calls a call, read from
    the profiler."""
    from repro_torch.core import H100_TP4_ITER, PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY
    from repro_torch.kernels import netkv_score as ns

    cv, _ = pool_2048(d)
    rng = np.random.default_rng(7 * d + r)
    cols = [torch.from_numpy(cv.column(c).astype(np.float32)).cuda() for c in
            ("free_memory", "queued", "batch", "healthy", "iter_scale")]
    hit = torch.from_numpy(rng.integers(0, 8192, (r, d)).astype(np.float32)).cuda()
    tier = torch.from_numpy(rng.integers(0, 4, (r, d)).astype(np.int32)).cuda()
    infl = torch.from_numpy(rng.integers(0, 4, (r, 4)).astype(np.float32)).cuda()
    sr = torch.full((r,), 8192 * 320 * 1024, dtype=torch.float32, device="cuda")
    lr = torch.full((r,), 8192, dtype=torch.float32, device="cuda")
    tables = ([PAPER_TIER_BANDWIDTH[t] for t in range(4)],
              [PAPER_TIER_LATENCY[t] for t in range(4)], [0.2, 0.1, 0.3, 0.05])

    def kernel():
        return ns.netkv_score_cohort(cols[0], cols[1], cols[2], hit, tier, cols[3], cols[4],
                                     *tables, infl, s_r=sr, input_len=lr,
                                     iter_a=H100_TP4_ITER.a, iter_b=H100_TP4_ITER.b,
                                     m_min=2e9, beta_max=64)

    ms = device_time_ms(kernel, 200)
    tr = traced(kernel, 20)
    out = dict(r=r, d=d, device_time_ms=ms, kernel_ms=tr["ms_per_event"]["netkv"],
               runtime_per_call=tr["runtime_per_call"], events_per_call=tr["events_per_call"])
    say(f"[kernels] netkv_score_cohort R {r} x D {d}: device_time_ms {ms:.5f} ms a call "
        f"over 200 calls; traced, the kernel {out['kernel_ms']:.5f} ms a launch; runtime "
        f"calls a call {out['runtime_per_call']}, device events a call "
        f"{out['events_per_call']}")
    return out


def rwkv_inputs(b: int, t: int, h: int, dh: int, dtype, gen):
    """tests/test_kernels.py's distributions: r, k, v, u ~ 0.3 N(0, 1), w in
    (0.45, 0.95); u stays f32, as the model passes it."""
    r, k, v = (0.3 * torch.randn((b, t, h, dh), generator=gen, device="cuda")
               for _ in range(3))
    w = 0.5 * torch.sigmoid(torch.randn((b, t, h, dh), generator=gen, device="cuda")) + 0.45
    u = 0.3 * torch.randn((h, dh), generator=gen, device="cuda")
    return [a.to(dtype) for a in (r, k, v, w)] + [u]


def check_rwkv_scan(rows: dict) -> None:
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.rwkv_scan import column_plan, rwkv_scan

    gen = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {f32: 0.0, bf16: 0.0}
    # The serving shape (B 1 x T 2048 x H 40 x dh 64, f32) first, then ragged
    # T (1, a smoke prompt of 24 tokens, 2047), B 2, dh 128 and bf16 inputs;
    # then the column groups: 16 wide at dh 16 (one), 40 (a short last
    # group, rows padded to 64) and 128 (eight), dh 20 in bf16 (rows padded
    # to whole 16-byte pieces by the wrapper), 24 wide at dh 40 (as at the
    # serving shape, a short last group) and 32 wide at dh 128.
    for b, t, h, dh, dtype in ((1, 2048, 40, 64, f32), (1, 24, 40, 64, f32),
                               (1, 2047, 40, 64, f32), (2, 24, 40, 64, f32),
                               (2, 300, 4, 128, f32), (1, 2048, 40, 64, bf16),
                               (2, 2047, 8, 64, bf16), (1, 1, 40, 64, f32),
                               (2, 2048, 4, 16, f32), (1, 2047, 4, 40, f32),
                               (2, 24, 4, 40, bf16), (1, 2048, 4, 128, f32),
                               (2, 2047, 2, 128, bf16), (1, 50, 2, 20, bf16),
                               (1, 2047, 50, 40, f32), (1, 512, 40, 128, bf16)):
        args = rwkv_inputs(b, t, h, dh, dtype, gen)
        y, s = rwkv_scan(*args)
        want_y, want_s = ref.rwkv_scan_ref(*args)
        ensure(y.dtype == dtype and s.dtype == f32, ("rwkv_scan dtypes", y.dtype, s.dtype))
        rtol, atol = RWKV_TOL[dtype]
        err = (y.float() - want_y.float()).abs()
        excess = (err - rtol * want_y.float().abs() - atol).max().item()
        s_err = (s - want_s).abs().max().item()
        ensure(excess <= 0 and s_err <= 1e-4,
               f"rwkv_scan {(b, t, h, dh)} {dtype}: y max err {err.max().item()} "
               f"({excess} over (rtol, atol) {RWKV_TOL[dtype]}), state max err {s_err}")
        worst[dtype] = max(worst[dtype], err.max().item(), s_err)
        say(f"[kernels] rwkv_scan B {b} x T {t} x H {h} x dh {dh} {dtype}: y max abs err "
            f"{err.max().item():.3g}, state {s_err:.3g}")
    b, t, h, dh = 1, 2048, 40, 64
    args = rwkv_inputs(b, t, h, dh, f32, gen)
    n = b * t * h * dh
    # Bytes: r, k, v, w read once, y written once, u read, the state written.
    # Operations: 5 f32 a state element a step that the function needs: one
    # FMA for sum_i r_i S_ij, and S w + k v (a multiply and an FMA).  The u
    # term factors to v_j sum_i r_i u_i k_i, O(dh) a step, and is left out.
    moved = 5 * n * 4 + h * dh * 4 + b * h * dh * dh * 4
    b_ms, b_by = bound(moved, 5.0 * n * dh, f32)
    first, second = rwkv_scan(*args), rwkv_scan(*args)
    ensure(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
           "rwkv_scan: two calls differ")
    k_ms = device_time_ms(lambda: rwkv_scan(*args), 20)
    p_ms = device_time_ms(lambda: ref.rwkv_scan_ref(*args), 2)
    cols = column_plan(b, h, dh, build.sm_count(args[0].device))
    say(f"[kernels] rwkv_scan at the serving shape: two calls bitwise equal; "
        f"{b * h * -(-dh // cols)} blocks of {cols} state columns; {k_ms:.4f} ms a launch, plain "
        f"version {p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
    rows["rwkv_scan"] = row(
        "rwkv_scan", worst[f32], k_ms, p_ms, None, b_ms, b_by,
        shape=f"r/k/v/w ({b}, {t}, {h}, {dh}) f32", bf16_max_abs_err=worst[bf16],
        library="none: no single PyTorch call computes the WKV-6 recurrence")
    torch.cuda.empty_cache()


# K8 at Jamba2-Mini's decode shape (d 4096, f 14,336, E 16, top 2, bf16), on
# routings of T 4 lanes that touch 2 experts (every lane alike), 4 (the active
# lane and three idle lanes alike, as serve() decodes), 8 (every lane
# distinct), and of T 8 lanes that touch all 16.  Then ragged shapes
# (T, d, f, E, k): T no power of two and widths no multiple of the column
# tile, every expert of every token (8 rows a block), one lane.
MOE_SHAPE = (4096, 14336, 16, 2)
MOE_ROUTINGS = {2: [[0, 1]] * 4, 4: [[0, 1], [2, 3], [2, 3], [2, 3]],
                8: [[2 * i, 2 * i + 1] for i in range(4)],
                16: [[2 * i, 2 * i + 1] for i in range(8)]}
MOE_RAGGED = ((3, 200, 328, 5, 2), (8, 96, 40, 3, 3), (1, 64, 16, 2, 1))


def moe_error(got, want) -> tuple[float, float]:
    """(largest error over the largest |want|, share of elements equal);
    raises past MOE_TOL or, in bf16, below MOE_EQUAL_SHARE."""
    rtol, atol = MOE_TOL[want.dtype]
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    err = (g - w).abs()
    same = (got == want).float().mean().item()
    ensure(bool(torch.isfinite(g).all()) and (err - rtol * w.abs()).max().item() <= atol * scale
           and (want.dtype != torch.bfloat16 or same >= MOE_EQUAL_SHARE),
           f"moe_decode {tuple(want.shape)} {want.dtype}: max err {err.max().item()} of "
           f"{scale}, {same:.4f} equal")
    return err.max().item() / scale, same


def check_moe_decode(rows: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_decode import moe_decode, plan
    from repro_torch.models.moe import dispatch_bmm, route, slot_positions

    bf16 = torch.bfloat16
    d, f, e, k = MOE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = {n: (torch.randn(s, generator=gen, device="cuda") * s[-2] ** -0.5).to(bf16)
         for n, s in (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d)))}
    timed, worst, kept = {}, 0.0, None
    for n_e, routing in MOE_ROUTINGS.items():
        experts = torch.tensor(routing, device="cuda")
        t = experts.shape[0]
        x = torch.randn((t, d), generator=gen, device="cuda").to(bf16)
        gates = torch.softmax(torch.randn((t, k), generator=gen, device="cuda"), dim=-1)
        args = (x, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
        got = moe_decode(*args)
        err, same = moe_error(got, ref.moe_decode_ref(*args))
        ensure(torch.equal(got, moe_decode(*args)), f"moe_decode {n_e} experts: two calls differ")
        pos, _ = slot_positions(experts, e)
        lib_err = ((dispatch_bmm(x, experts, gates, pos, t, p).float() - got.float()).abs().max()
                   / got.float().abs().max()).item()
        k_ms = device_time_ms(lambda: moe_decode(*args), 50)
        p_ms = device_time_ms(lambda: ref.moe_decode_ref(*args), 3)
        l_ms = device_time_ms(lambda: dispatch_bmm(x, experts, gates, pos, t, p), 10)
        # Bytes: the routed experts' weights, x and the output; operations:
        # 3 d f multiply-adds a (token, slot).
        b_ms, b_by = bound(n_e * 3 * d * f * 2 + 2 * t * d * 2, 2 * 3 * t * k * d * f, bf16)
        worst = max(worst, err)
        timed[n_e] = dict(tokens=t, ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                          bound_by=b_by, roofline_pct=100 * b_ms / k_ms, max_err=err,
                          equal_share=same, bmm_path_err=lib_err, plan=plan(t, d, f, bf16))
        say(f"[kernels] moe_decode T {t}, {n_e} experts routed of {e} (d {d}, f {f}, bf16): "
            f"{k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / k_ms:.1f}%); plain "
            f"{p_ms:.3f} ms; bmm path over all {e} {l_ms:.4f} ms; err {err:.3g} of the largest "
            f"output, {same:.4f} of elements equal (the bmm path: {lib_err:.3g}); "
            f"{plan(t, d, f, bf16)}")
        if n_e == 4:
            kept = (args, got)
    # The weights of the experts no token routes to, set to NaN, are never read.
    args, want = kept
    unrouted = sorted(set(range(e)) - set(args[1].unique().tolist()))
    for w in args[3:]:
        w[unrouted] = float("nan")
    ensure(torch.equal(moe_decode(*args), want), "moe_decode read an unrouted expert")
    say(f"[kernels] moe_decode: NaN in the {len(unrouted)} unrouted experts' weights leaves "
        f"the output bitwise equal")
    del p, args, kept
    torch.cuda.empty_cache()
    granite = check_moe_decode_granite(gen)
    for t, dd, ff, ee, kk in MOE_RAGGED:
        for dtype in (bf16, torch.float32):
            w = {n: (torch.randn(s, generator=gen, device="cuda") * s[-2] ** -0.5).to(dtype)
                 for n, s in (("router", (dd, ee)), ("w_gate", (ee, dd, ff)),
                              ("w_up", (ee, dd, ff)), ("w_down", (ee, ff, dd)))}
            x = torch.randn((t, dd), generator=gen, device="cuda").to(dtype)
            _, gates, experts = route(x, w["router"], kk, False)
            args = (x, experts, gates, w["w_gate"], w["w_up"], w["w_down"])
            got = moe_decode(*args)
            err, same = moe_error(got, ref.moe_decode_ref(*args))
            ensure(torch.equal(got, moe_decode(*args)), "moe_decode: two calls differ")
            say(f"[kernels] moe_decode T {t}, d {dd}, f {ff}, E {ee}, top {kk}, {dtype}: err "
                f"{err:.3g}, {same:.4f} equal; {plan(t, dd, ff, dtype)}")
    served = timed[4]
    rows["moe_decode"] = row(
        "moe_decode", worst, served["ms"], served["plain_ms"], served["library_ms"],
        served["bound_ms"], served["bound_by"],
        shape=f"x ({served['tokens']}, {d}) bf16, E {e} of ({d}, {f}), top {k}, 4 experts routed",
        timed={str(n): v for n, v in timed.items()}, granite=granite,
        library="the bmm path over all 16 experts (models/moe.py dispatch_bmm, cuBLAS)")


# K8 at granite-moe-1b-a400m's decode shape: T 4 lanes, d 1024, f 512, E 32,
# top 8, routed by K9 at granite's capacity of 1 slot an expert (so slots
# drop), the lanes as serve() decodes them: one active, three idle alike.
GRANITE_MOE = (4, 1024, 512, 32, 8)


def check_moe_decode_granite(gen) -> dict:
    """K8 on K9's kept gates against its plain version and against the bmm
    path at capacity 1 (the same function: a dropped slot's term is 0 on
    both), and both timed; returns the timings."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_decode import moe_decode
    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.models.moe import dispatch_bmm, route, slot_positions

    bf16 = torch.bfloat16
    t, d, f, e, k = GRANITE_MOE
    p = {n: (torch.randn(s, generator=gen, device="cuda") * s[-2] ** -0.5).to(bf16)
         for n, s in (("router", (d, e)), ("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                      ("w_down", (e, f, d)))}
    x = torch.randn((2, d), generator=gen, device="cuda").to(bf16)[[0, 1, 1, 1]].contiguous()
    experts, kept, _ = moe_route(x, p["router"], k, 1, True)
    args = (x, experts, kept, p["w_gate"], p["w_up"], p["w_down"])
    got = moe_decode(*args)
    err, same = moe_error(got, ref.moe_decode_ref(*args))
    _, gates, w_experts = route(x, p["router"], k, True)
    pos, _ = slot_positions(w_experts, e)
    bmm = dispatch_bmm(x, w_experts, gates, pos, 1, p)
    lib_err = ((bmm.float() - got.float()).abs().max() / got.float().abs().max()).item()
    # On a near tie of the k-th probability K9 and route may pick apart.
    ensure(not torch.equal(experts, w_experts) or lib_err <= MOE_TOL[bf16][1],
           f"K8 on kept gates against the bmm path: {lib_err}")
    n_routed = int(experts.unique().numel())
    k_ms = device_time_ms(lambda: moe_decode(*args), 100)
    l_ms = device_time_ms(lambda: dispatch_bmm(x, w_experts, gates, pos, 1, p), 50)
    b_ms, b_by = bound(n_routed * 3 * d * f * 2 + 2 * t * d * 2, 2 * 3 * t * k * d * f, bf16)
    out = dict(tokens=t, experts_routed=n_routed, dropped=int((kept == 0).sum()), ms=k_ms,
               library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, max_err=err, equal_share=same,
               bmm_path_err=lib_err)
    say(f"[kernels] moe_decode at granite's decode (T {t}, d {d}, f {f}, E {e}, top {k}, cap "
        f"1, {n_routed} experts routed, {out['dropped']} of {t * k} slots dropped): {k_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}); bmm path at capacity 1 {l_ms:.4f} ms; err "
        f"{err:.3g}, {same:.4f} equal (the bmm path: {lib_err:.3g})")
    return out


# K9 at the decode widths of the served MoE models: (d, E, k, capacity
# factor, renormalize).  Probabilities agree within f32 rounding (the kernel
# sums the logits in another order than cuBLAS); experts are compared on rows
# whose k-th and (k+1)-th probabilities lie further apart.
ROUTE_SHAPES = {"granite": (1024, 32, 8, 1.25, True), "jamba2-mini": (4096, 16, 2, 8.0, False)}
ROUTE_RTOL = 1e-5


def check_moe_route(rows: dict) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.models.moe import MoEConfig, capacity, route, slot_positions

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(13)
    timed, worst, ties = {}, 0.0, []
    for name, (d, e, k, cf, renorm) in ROUTE_SHAPES.items():
        cfg = MoEConfig(n_experts=e, top_k=k, d_expert=8, capacity_factor=cf,
                        renormalize=renorm)
        router = (torch.randn((d, e), generator=gen, device="cuda") * d ** -0.5).to(bf16)
        for t in range(1, 9):
            x = torch.randn((t, d), generator=gen, device="cuda").to(bf16)
            cap = capacity(t, cfg)
            got = moe_route(x, router, k, cap, renorm)
            want = ref.moe_route_ref(x, router, k, cap, renorm)
            probs = torch.softmax(x.float() @ router.float(), -1).sort(-1, descending=True)[0]
            apart = bool(((probs[:, k - 1] - probs[:, k]) > ROUTE_RTOL * probs[:, k - 1]).all())
            if apart:
                ensure(torch.equal(got[0], want[0]), f"moe_route {name} T {t}: experts")
                for g, w in zip(got[1:], want[1:]):
                    ensure(torch.allclose(g, w, rtol=ROUTE_RTOL, atol=0),
                           f"moe_route {name} T {t}: gates or aux")
                    # allclose at atol 0: a zero of the plain version is a zero here
                    rel = (g - w).abs() / w.abs().clamp_min(torch.finfo(torch.float32).tiny)
                    worst = max(worst, rel.max().item())
            else:
                ties.append(f"{name} T {t}")
            ensure(all(torch.equal(a, b) for a, b in zip(got, moe_route(x, router, k, cap,
                                                                         renorm))),
                   f"moe_route {name} T {t}: two calls differ")
            if t != 4:
                continue

            def chain():
                probs, gates, experts = route(x, router, k, renorm)
                pos, counts = slot_positions(experts, e)
                aux = ref.moe_aux_loss(counts, probs, k)
                return experts, torch.where(pos < cap, gates.reshape(-1), 0.0), aux

            k_ms = device_time_ms(lambda: moe_route(x, router, k, cap, renorm), 200)
            p_ms = device_time_ms(lambda: ref.moe_route_ref(x, router, k, cap, renorm), 50)
            c_ms = device_time_ms(chain, 50)
            # Bytes: the router, x and the outputs; operations: 2 d E a token.
            b_ms, b_by = bound(d * e * 2 + t * d * 2 + t * k * 12 + 4, 2 * t * d * e, bf16)
            timed[name] = dict(tokens=t, d=d, experts=e, top_k=k, cap=cap, ms=k_ms,
                               plain_ms=p_ms, library_ms=c_ms, bound_ms=b_ms, bound_by=b_by,
                               experts_equal=apart)
            say(f"[kernels] moe_route {name} (T {t}, d {d}, E {e}, top {k}, cap {cap}, bf16): "
                f"{k_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); plain {p_ms:.4f} ms; the bmm "
                f"path's routing chain {c_ms:.4f} ms")
        say(f"[kernels] moe_route {name}: T 1-8 against the plain version, two calls bitwise")
    n_cases = 8 * len(ROUTE_SHAPES)
    ensure(len(ties) < n_cases, "moe_route: every case a near tie, no error measured")
    say(f"[kernels] moe_route: gates and aux within {worst:.3g} of the plain version "
        f"(relative, largest); {n_cases - len(ties)} of {n_cases} cases compared, near ties "
        f"skipped: {', '.join(ties) or 'none'}")
    # Planted ties: every router column equal gives experts 0..k-1 to every
    # token; tokens past the capacity keep no gate.
    d, e, k, _, renorm = ROUTE_SHAPES["granite"]
    same = (torch.randn((d, 1), generator=gen, device="cuda") * d ** -0.5).to(bf16)
    x = torch.randn((8, d), generator=gen, device="cuda").to(bf16)
    experts, kept, _ = moe_route(x, same.expand(d, e).contiguous(), k, 2, renorm)
    ensure(experts.tolist() == [list(range(k))] * 8 and bool((kept[2:] == 0).all())
           and bool((kept[:2] > 0).all()), "moe_route: ties to the lower index")
    say("[kernels] moe_route: equal router columns route every token to experts 0..k-1")
    served = timed["granite"]
    rows["moe_route"] = row(
        "moe_route", worst, served["ms"], served["plain_ms"], served["library_ms"],
        served["bound_ms"], served["bound_by"],
        shape=f"x (4, 1024) bf16, router (1024, 32), top 8, cap {served['cap']}", timed=timed,
        err_is="largest relative error of gates_kept and aux, both widths, T 1-8",
        near_ties_skipped=ties,
        library="the bmm path's routing chain: route, slot_positions, aux, kept gates "
                "(models/moe.py, PyTorch ops)")


# ---------------------------------------------------------------- phase 4
def phase_match(arch: str) -> None:
    """Serve a small workload twice from one set of weights: on the card
    through the kernels and on the CPU through their plain versions, which
    the CPU tests hold equal to the JAX package.  Every result field (tokens,
    decisions, bytes, simulated times) must be equal."""
    from repro_torch.configs import get_spec
    from repro_torch.kernels import build
    from repro_torch.launch.serve import SMOKE, build_cluster, make_requests
    from repro_torch.models import Model, init_random_, make_decode_cache

    cfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32)
    workload = dict(SMOKE, prefix_len=16)  # the even requests hit one page
    on_cpu = init_random_(Model(cfg, device="cpu"), 0)
    on_card = Model(cfg, device="cuda")
    on_card.load_state_dict(on_cpu.state_dict())
    out = {}
    for device, model in (("cpu", on_cpu), ("cuda", on_card)):
        cluster = build_cluster(cfg, workload, scheduler="netkv-full", seed=0,
                                device=device, params=model)
        build.reset_launches()
        out[device] = [dataclasses.asdict(r) for r in
                       cluster.serve(make_requests(cfg.vocab_size, 8, 0, **workload))]
    ensure(out["cuda"] == out["cpu"], ("card and CPU results differ", out))
    sent = [r["transfer_bytes"] for r in out["cpu"]]
    # The fixed state (f32 here: RWKV's, or a hybrid's Mamba layers') ships
    # whole, prefix hit or not (ROADMAP §3).
    state = sum(v.numel() * v.element_size()
                for k, v in make_decode_cache(cfg, 1, 0, "cpu").items() if k != "pos")
    if cfg.is_attention_free:
        ensure(sent == [state] * len(sent), ("state bytes", sent, state))
        ensure(build.LAUNCHES["rwkv_scan"] == cfg.n_layers * len(sent),
               ("rwkv_scan launches on the card", build.LAUNCHES))
    else:
        ensure(all(n > state for n in sent), ("pages and state bytes", sent, state))
        ensure(any(n < sent[0] for n in sent), "no prefix hit in the small workload")
    say(f"[match] {cfg.name} f32: {len(sent)} requests, every result field equal "
        f"on the card and on the CPU; transfer bytes {sorted(set(sent))}")


def match_encdec() -> None:
    """The seamless smoke model in f32 through its entry points, on the card
    (self- and cross-attention on K4) and on the CPU (the plain versions):
    encode, prefill with the memory and 6 greedy decode steps; the memory
    and every logit within 1e-4, the greedy tokens equal."""
    from repro_torch.configs import get_spec
    from repro_torch.models import Model, decode_step, encode, init_random_, prefill

    cfg = dataclasses.replace(get_spec("seamless-m4t-medium").smoke, compute_dtype=torch.float32)
    on_cpu = init_random_(Model(cfg, device="cpu"), 0)
    on_card = Model(cfg, device="cuda")
    on_card.load_state_dict(on_cpu.state_dict())
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    out = {}
    for device, model in (("cpu", on_cpu), ("cuda", on_card)):
        memory = encode(model, frames.to(device))
        logits, cache = prefill(model, prompt.to(device), memory=memory, cache_len=64)
        seen, tokens = [logits], []
        for _ in range(6):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            tokens.append(tok.cpu())
            logits, cache = decode_step(model, tok, cache)
            seen.append(logits)
        out[device] = (memory.cpu(), torch.cat(seen, 1).cpu(), torch.cat(tokens, 1))
    (mc, lc, tc), (mg, lg, tg) = out["cpu"], out["cuda"]
    ensure(torch.equal(tc, tg), ("seamless smoke tokens differ", tc, tg))
    err = max((mg - mc).abs().max().item(), (lg - lc).abs().max().item())
    ensure(err <= 1e-4, f"seamless smoke: card and CPU differ by {err}")
    say(f"[match] {cfg.name} f32: encode, prefill and 6 decode steps, tokens equal on the "
        f"card and on the CPU, memory and logits within {err:.3g}")


# ---------------------------------------------------------- phases 5, 7
def phase_serve(cfg, n_requests: int = 8):
    """Serve the full-width workload on ``cfg``; returns the launch counts
    of the run, the served cluster and its prompts."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import FULL, build_cluster, make_requests
    from repro_torch.models import state_bytes
    from repro_torch.serving import engine

    workload = FULL
    t0 = time.perf_counter()
    cluster = build_cluster(cfg, workload, scheduler="netkv-full", seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name}: weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    reqs = make_requests(cfg.vocab_size, n_requests, 0, **workload)

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
    steps = sum(w["decode_steps"] for w in cluster.walls)
    ensure(steps == len(results) * (workload["max_new"] - 1), ("decode steps", steps))
    for r in results:
        ensure(len(r.tokens) == workload["max_new"], (r.request_id, len(r.tokens)))
    if cfg.is_attention_free:
        # The fixed decode state ships whole for every request; the prefill
        # runs the WKV recurrence on rwkv_scan, once a layer.
        for r in results:
            ensure(r.transfer_bytes == state_bytes(cfg, 0), (r.request_id, r.transfer_bytes))
        want_launches = dict.fromkeys(build.LAUNCHES, 0) | {
            "rwkv_scan": cfg.n_layers * len(results)}
    else:
        want_launches = attn_launches(cfg, workload, results, reqs, steps)
    ensure(launches == want_launches, (launches, want_launches))
    for r, w in zip(results, cluster.walls):
        say(f"[serve] req{r.request_id}: decode@{r.decode_instance} tier{r.tier} "
            f"xfer={r.transfer_bytes / 1e6:.1f}MB prefill={w['prefill_s'] * 1e3:.1f}ms "
            f"transfer={w['transfer_s'] * 1e3:.1f}ms decode={w['decode_s'] * 1e3:.1f}ms "
            f"({w['decode_steps']} steps, {w['decode_s'] / w['decode_steps'] * 1e3:.2f}ms/step) "
            f"tokens={r.tokens[:6]}")
    say(f"[serve] {cfg.name}: {len(results)} requests in {wall:.2f}s wall; peak memory "
        f"{peak / 1e9:.2f} GB; launches {launches}; transfer bytes "
        f"{sorted({r.transfer_bytes for r in results})}")
    return launches, cluster, [r.prompt for r in reqs]


def attn_launches(cfg, workload, results, reqs, steps) -> dict:
    """Checks the bytes each request of a serve with attention layers
    shipped: the pages of its attention layers (repeats of a prefix on one
    decode instance skip their hit pages) and, for a hybrid, the whole fixed
    state of its Mamba layers; returns the launch counts the run must show
    (one pack and one unpack a K/V leaf of a request with pages to ship,
    one flash_decode an attention layer a step, and one moe_route and one
    moe_decode a MoE layer a step where ``moe.decodes_routed`` holds for the
    engine's lanes: K8 holds that many rows and K9 takes the experts)."""
    from repro_torch.core.cost import B_TOK
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_decode import held_rows
    from repro_torch.kernels.moe_route import routes
    from repro_torch.models import state_bytes

    page_bytes = B_TOK * cfg.n_kv_heads * cfg.d_head * 2
    prompt_pages = workload["prompt_len"] // B_TOK
    fixed = state_bytes(cfg, 0)
    kv_leaves = 2 * sum(b == "attn" for b in cfg.block_pattern)
    seen: dict[int, list] = {}
    shipping = 0
    for r, req in zip(results, sorted(reqs, key=lambda x: x.arrival)):
        ensure(r.request_id == req.request_id, ("order", r.request_id, req.request_id))
        hit = 0
        for prev in seen.get(r.decode_instance, []):
            same = 0
            while same < prompt_pages and np.array_equal(
                    prev[same * B_TOK:(same + 1) * B_TOK], req.prompt[same * B_TOK:(same + 1) * B_TOK]):
                same += 1
            hit = max(hit, same)
        seen.setdefault(r.decode_instance, []).append(req.prompt)
        want = 2 * cfg.n_attn_layers * (prompt_pages - hit) * page_bytes + fixed
        ensure(r.transfer_bytes == want, (r.request_id, r.transfer_bytes, want))
        shipping += hit < prompt_pages
    full_bytes = 2 * cfg.n_attn_layers * prompt_pages * page_bytes + fixed
    ensure(any(r.transfer_bytes < full_bytes for r in results), "no repeat prefix hit")
    lanes = workload["n_slots"]
    n_moe = cfg.n_periods * sum(f in ("moe", "moe_res") for f in cfg.ffn_pattern)
    routed = n_moe > 0 and (routes(cfg.moe.n_experts, cfg.moe.top_k)
                            and lanes <= held_rows(cfg.d_model, cfg.compute_dtype))
    return dict.fromkeys(build.LAUNCHES, 0) | {
        "flash_decode": cfg.n_attn_layers * steps, "kv_pack": kv_leaves * shipping,
        "kv_unpack": kv_leaves * shipping, "moe_decode": n_moe * steps if routed else 0,
        "moe_route": n_moe * steps if routed else 0}


# ---------------------------------------------------------- phases 6, 8
def kernel_class(name: str, moe: bool = False, fine: bool = False) -> str:
    """A kernel's class by its name; ``moe`` splits out the MoE dispatch's
    kernels of a MoE model's trace (elsewhere they are "other"); ``fine``
    (a training step) splits "other" into softmax, reductions, copies and
    casts, index kernels (gathers and their backward) and elementwise."""
    low = name.lower()
    if "rwkv" in low:
        return "rwkv"
    if "flash_decode" in low:
        return "flash_decode"
    if "moe_route" in low:
        return "moe_route"
    if any(k in low for k in ("moe_gate_up", "moe_down", "moe_combine")):
        return "moe_decode"
    if "kv_pack" in low or "kv_unpack" in low:
        return "kv_pack"
    if "waterfill" in low:
        return "waterfill"
    if "netkv" in low:
        return "netkv"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if fine:
        for cls, keys in (("softmax", ("softmax",)), ("reduce", ("reduce",)),
                          ("copy", ("copy", "memcpy", "memset", "fill", "cat")),
                          ("index", ("index", "gather", "scatter", "sort"))):
            if any(k in low for k in keys):
                return cls
        return "elementwise"
    if not moe:
        return "other"
    # The MoE dispatch: top-k's sort, the slot count's scan, the slot
    # position's gather, the scatter into the expert rows and the gathers
    # of tokens and expert outputs (index kernels; in a decode step the
    # embedding's gather is the one index kernel of another op).  The
    # router's product is a matmul.
    if any(k in low for k in ("sort", "scan", "scatter_gather", "index")):
        return "moe_dispatch"
    # In a decode step only the MoE router's softmax; in a prefill also
    # the attention's.
    if "softmax" in low:
        return "softmax"
    return "other"


def traced(fn, n: int, moe: bool = False, fine: bool = False) -> dict:
    """Run ``fn`` ``n`` times under ``torch.profiler``, after ``n`` untraced
    warm-up calls under it: device time by kernel
    class, summed over device-side events only (kernels, copies, fills) so
    that the time a host op attributes to its kernel is not counted twice;
    the device events and the runtime's launch, copy and fill calls a call,
    its stream synchronisations a call and the device's copies a call by
    direction; the device time of each class a device event; and the
    device's busy share of the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # One warm-up step of n calls before the traced one: a trace started cold
    # lost the device events of short calls (all 20 of waterfill_progressive
    # once).  A warm trace may still lose a few (3 of 20), so ms_per_event
    # gives a kernel's time a launch.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in range(2):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    by_class: dict[str, float] = {}
    count: dict[str, int] = {}
    calls: dict[str, int] = {}
    syncs: dict[str, int] = {}
    copies: dict[str, int] = {}
    top = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.key.startswith("cuda") and any(
                k in ev.key for k in ("Launch", "Memset", "Memcpy")):
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
        if ev.device_type == DeviceType.CPU and ev.key == "cudaStreamSynchronize":
            syncs[ev.key] = syncs.get(ev.key, 0) + ev.count
        if ev.device_type == DeviceType.CUDA and ev.key.startswith("Memcpy"):
            copies[ev.key] = copies.get(ev.key, 0) + ev.count
        us = ev.self_device_time_total
        if (ev.device_type != DeviceType.CUDA or us <= 0 or ev.key == "Command Buffer Full"
                or ev.key.startswith("ProfilerStep")):
            continue
        cls = kernel_class(ev.key, moe, fine)
        by_class[cls] = by_class.get(cls, 0.0) + us
        count[cls] = count.get(cls, 0) + ev.count
        top.append((us, ev.count, ev.key))
    busy_ms = sum(by_class.values()) / 1e3
    ensure(busy_ms > 0, "the trace holds no device time")
    return dict(wall_ms=wall_ms / n, device_ms=busy_ms / n, busy_share=busy_ms / wall_ms,
                by_class_ms={k: v / 1e3 / n for k, v in sorted(by_class.items())},
                events_per_call={k: v / n for k, v in sorted(count.items())},
                ms_per_event={k: by_class[k] / 1e3 / count[k] for k in sorted(count)},
                runtime_per_call={k: v / n for k, v in sorted(calls.items())},
                syncs_per_call={k: v / n for k, v in sorted(syncs.items())},
                copies_per_call={k: v / n for k, v in sorted(copies.items())},
                top=sorted(top, reverse=True)[:8])


def phase_trace(cluster, prompts) -> None:
    """Where the time of the serving path goes, on the served cluster's
    first prefill and decode engines: the decode engine's 4 slots are filled
    with 2048-token prompts (the batch of the serve phase's decode steps),
    10 steps are timed on the host clock untraced, 4 more and one prefill
    under the profiler.  Each step ends in the host read of its tokens."""
    pe, de = cluster.prefill[0], cluster.decode[0]
    name = cluster.cfg.name
    for i, p in enumerate(prompts[:de.n_slots]):
        de.admit(i, pe.run(i, p), max_new=64)
    for _ in range(3):
        de.step()
    t0 = time.perf_counter()
    for _ in range(10):
        de.step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    moe = cluster.cfg.moe is not None
    decode = traced(de.step, 4, moe)
    prefill = traced(lambda: pe.run(0, prompts[0]), 1, moe)
    say(f"[trace] {name} decode step (batch {de.n_slots}, pos ~{len(prompts[0])}): "
        f"{step_ms:.2f} ms wall untraced")
    say_traces(cluster.cfg, {"decode step": decode, "prefill": prefill})
    say("[trace] " + json.dumps(dict(model=name, decode_step_ms=step_ms, decode_trace=decode,
                                     prefill_trace=prefill)))


def say_traces(cfg, traces: dict) -> None:
    """Print traces of ``cfg``'s model: the decode step's runtime launches
    a step and a (decoder) layer, then each trace's wall, device busy time
    by class and its 8 longest kernels (popped from the trace)."""
    name = cfg.name
    launches = sum(v for k, v in traces["decode step"]["runtime_per_call"].items()
                   if "Launch" in k)
    say(f"[trace] {name} decode step: {launches:g} runtime launches a step, "
        f"{launches / cfg.n_layers:.1f} a layer")
    for label, tr in traces.items():
        say(f"[trace] {name} traced {label}: wall {tr['wall_ms']:.2f} ms, device busy "
            f"{tr['device_ms']:.2f} ms ({tr['busy_share']:.1%}); by class "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in tr["by_class_ms"].items()))
        for us, count, key in tr.pop("top"):
            say(f"[trace]     {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def check_bitwise_steps(cluster, prompts) -> None:
    """Two prefills of one prompt, and two decode steps of the first decode
    engine's slots from copies of one cache: logits and caches bitwise
    equal (the MoE dispatch and combine use no atomics)."""
    from repro_torch.models import decode_step

    pe, de = cluster.prefill[0], cluster.decode[0]
    first, second = pe.run(0, prompts[0]), pe.run(0, prompts[0])
    ensure(torch.equal(first.last_logits, second.last_logits)
           and all(torch.equal(first.cache[k], second.cache[k])
                   for k in first.cache if k != "pos"), "two prefills differ")
    tokens = torch.as_tensor(de._tokens, device=cluster.device)[:, None]
    steps = []
    for _ in range(2):
        cache = {k: v if k == "pos" else v.clone() for k, v in de.cache.items()}
        steps.append(decode_step(cluster.model, tokens, cache))
    (l1, c1), (l2, c2) = steps
    ensure(torch.equal(l1, l2) and all(torch.equal(c1[k], c2[k]) for k in c1 if k != "pos"),
           "two decode steps differ")
    say(f"[serve] {cluster.cfg.name}: two prefills of a {len(prompts[0])}-token prompt and "
        f"two decode steps of {de.n_slots} slots at pos {de.cache['pos']}: logits and caches "
        f"bitwise equal")


# The per-slot decode at full width: 4 rows prefilled with 2048 tokens, then
# decoded from the positions of RAGGED less one (each row writes its new K/V
# at its position and attends to pos + 1 keys).
SLOT_POS = tuple(n - 1 for n in RAGGED)
TIMED_STEPS = 5   # of each, scalar and ragged, on the host clock


def check_slot_decode(model) -> int:
    """``decode_step`` with a (B,) vector ``pos`` on ``model`` at full
    width.  All entries equal give bitwise the scalar step's logits and
    cache.  With ragged entries (``SLOT_POS``): every cache leaf changes
    only at each row's own position; layer 0's new K/V rows (RoPE at each
    row's position, the write index) and the longest row's logits (K4's
    split is the scalar launch's) are bitwise those of the row decoded at
    its own scalar position in a batch of 4 copies of it; each other row's
    logits are held to its copies and to the row decoded alone at batch 1
    within twice what a row of the scalar step differs from itself decoded
    alone (a random bf16 model of 40 layers turns a last-bit difference
    into a few percent of its logits), or BF16_ROW if more.  Then
    TIMED_STEPS ragged and scalar steps each on the host clock (medians).
    Returns K4's
    calls (one a layer a step, counted as the path's)."""
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, prefill

    cfg = model.cfg
    b, s = len(SLOT_POS), 2048
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device="cuda")
    _, cache = prefill(model, prompt, cache_len=s + 8)
    before = build.LAUNCHES["flash_decode"]

    def at(pos, rows=slice(None)):
        return {k: pos if k == "pos" else v[:, rows].clone() for k, v in cache.items()}

    def timed_step(pos):
        c = at(pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_step(model, tok, c)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def median_ms(pos) -> float:
        return sorted(timed_step(pos)[1] for _ in range(TIMED_STEPS))[TIMED_STEPS // 2]

    def rel(got, want) -> float:
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    def alone(row, pos):
        return decode_step(model, tok[row:row + 1], at(pos, slice(row, row + 1)))[0][0]

    (ls, cs), _ = timed_step(s)
    (lv, cv), _ = timed_step(torch.full((b,), s, dtype=torch.int32))
    ensure(torch.equal(ls, lv) and all(torch.equal(cs[k], cv[k]) for k in cs if k != "pos"),
           f"{cfg.name}: a vector pos of equal entries differs from the scalar step")
    ensure(cv["pos"].tolist() == [s + 1] * b, ("pos", cv["pos"]))
    del cs, cv
    baseline = max(rel(ls[row], alone(row, s)) for row in range(b))
    tol = max(2 * baseline, BF16_ROW)
    (lr, cr), _ = timed_step(torch.tensor(SLOT_POS))
    ensure(bool(torch.isfinite(lr).all()), "a non-finite logit")
    written = torch.zeros((b, s + 8), dtype=torch.bool, device="cuda")
    written[torch.arange(b), torch.tensor(SLOT_POS)] = True
    for key in ("k0", "v0"):
        changed = (cr[key] != cache[key]).flatten(3).any(dim=-1)   # (P, B, S)
        ensure(not bool((changed & ~written).any()), f"{key}: a row changed past its position")
    copies, single = [], []
    for row, p in enumerate(SLOT_POS):
        same, cc = decode_step(model, tok[[row] * b], at(p, [row] * b))
        for key in ("k0", "v0"):
            ensure(torch.equal(cr[key][0, row, p], cc[key][0, 0, p]),
                   f"row {row}: layer 0's new {key[0]} row differs from its scalar step's")
        ensure(row != 0 or torch.equal(lr[0], same[0]),
               "the longest row's logits differ from its scalar step's")
        copies.append(rel(lr[row], same[0]))
        single.append(rel(lr[row], alone(row, p)))
        ensure(copies[-1] <= tol and single[-1] <= tol,
               (cfg.name, "row", row, copies[-1], single[-1], "baseline", baseline))
        del cc
    del cr
    scalar_ms, ragged_ms = median_ms(s), median_ms(torch.tensor(SLOT_POS))
    calls = build.LAUNCHES["flash_decode"] - before
    ensure(calls == cfg.n_attn_layers * (3 + 3 * b + 2 * TIMED_STEPS), ("flash_decode calls", calls))
    say(f"[serve] {cfg.name} per-slot decode (B {b}, prompts of {s}): a vector pos of equal "
        f"entries gives bitwise the scalar step's logits and cache; at pos {list(SLOT_POS)} "
        f"each row's cache changes at its position only, layer 0's new K/V rows and the "
        f"longest row's logits are bitwise the scalar steps'; the rows' logits within "
        f"{[round(x, 4) for x in copies]} x max|logit| of the row at its own scalar pos in a "
        f"batch of its copies and {[round(x, 4) for x in single]} of the row alone at batch 1 "
        f"(a scalar step's rows against themselves alone: {baseline:.4f}; held at {tol:.4f}); "
        f"a step {ragged_ms:.2f} ms wall (scalar pos: {scalar_ms:.2f} ms; medians of "
        f"{TIMED_STEPS}); {calls} K4 calls")
    return calls


# The read-only decode (phase 5b): K4 with a self term, its partials mode
# over sequence shards and their merge at qwen3-14b's decode shape (B 4, H
# 40, KV 8, dh 128, S 4096), timed at pos 2056; then READONLY_STEPS
# read-only decode steps of the full-width model.
READONLY_POS = 2056
SHARDS = 4            # 1024 rows each: shard 3 holds no row below 2056
READONLY_STEPS = 16


def check_readonly_kernels(rows: dict) -> None:
    """K4 with ``k_new``/``v_new`` (the self term) against its plain
    version: pos 0 (exactly v_new), 1, a range's edge, 2056 and S, and
    per-row lengths with a row of 0, bf16 and f32; two calls bitwise equal.
    Its partials mode on SHARDS shards (row slices of the cache, the self
    term on shard 0, shard 3 empty: m -1e30, l 0) against the plain
    partials, and the merge against the plain version of the whole.  Timed:
    the self-term launch beside the scalar launch at READONLY_POS, its plain
    version, SDPA over the cache with the self key appended, and the four
    partial launches with the merge; each against the bytes it must move."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd, ref
    from repro_torch.models.attention import EMPTY_M, merge_partials

    b, h, kv, dh, s = 4, 40, 8, 128, 4096
    step = s // SHARDS
    gen = torch.Generator(device="cuda").manual_seed(31)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def held(out, want, what) -> float:
        err, excess = flash_decode_error(out, want)
        ensure(excess <= 0, f"flash_decode {what}: max err {err}, {excess} over "
               f"(rtol, atol) {FD_TOL[want.dtype]}")
        return err

    def partials(q, k, v, pos, kn, vn, lens=None):
        return [fd.flash_decode_partials(q, k[:, lo:lo + step], v[:, lo:lo + step],
                                         min(max(pos - lo, 0), step), lens, start=lo,
                                         **(dict(k_new=kn, v_new=vn) if lo == 0 else {}))
                for lo in range(0, s, step)]

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = rand(b, h, dh, dtype=dtype), rand(b, s, kv, dh, dtype=dtype), \
            rand(b, s, kv, dh, dtype=dtype)
        kn, vn = rand(b, kv, dh, dtype=dtype), rand(b, kv, dh, dtype=dtype)
        worst = 0.0
        r = fd.plan_for(q, k, READONLY_POS).range_len
        for pos in (0, 1, r, r + 1, READONLY_POS, s):
            out = fd.flash_decode(q, k, v, pos, k_new=kn, v_new=vn)
            worst = max(worst, held(out, ref.flash_decode_ref(q, k, v, pos, kn, vn),
                                    f"self term {dtype} pos {pos}"))
            ensure(torch.equal(out, fd.flash_decode(q, k, v, pos, k_new=kn, v_new=vn)),
                   f"self term {dtype} pos {pos}: two calls differ")
        ensure(torch.equal(fd.flash_decode(q, k, v, 0, k_new=kn, v_new=vn),
                           vn.repeat_interleave(h // kv, dim=1)), "pos 0 is not v_new")
        lengths = (READONLY_POS, 1031, 17, 0)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        worst = max(worst, held(fd.flash_decode(q, k, v, max(lengths), lens, kn, vn),
                                ref.flash_decode_ref(q, k, v, lens, kn, vn),
                                f"self term {dtype} lengths {lengths}"))
        for pos, ln in ((READONLY_POS, None), (max(lengths), lens)):
            got = partials(q, k, v, pos, kn, vn, ln)
            for i, lo in enumerate(range(0, s, step)):
                want = ref.flash_decode_partials_ref(
                    q, k[:, lo:lo + step], v[:, lo:lo + step], min(max(pos - lo, 0), step), ln,
                    start=lo, **(dict(k_new=kn, v_new=vn) if lo == 0 else {}))
                gm, wm = got[i][1], want[1]
                ensure(bool(torch.where(wm == EMPTY_M, gm == EMPTY_M,
                                        (gm - wm).abs() <= 1e-5 * wm.abs() + 1e-5).all()),
                       f"partials {dtype} shard {i}: m")
                ensure(torch.allclose(got[i][2], want[2], rtol=1e-5, atol=1e-5),
                       f"partials {dtype} shard {i}: l")
                ensure(torch.allclose(got[i][0], want[0], rtol=1e-5, atol=1e-4),
                       f"partials {dtype} shard {i}: acc")
            ensure(bool((got[-1][1] == EMPTY_M).all()) and not bool(got[-1][2].any()),
                   f"partials {dtype}: shard {SHARDS - 1} is not empty")
            worst = max(worst, held(merge_partials(got, dtype), ref.flash_decode_ref(
                q, k, v, pos if ln is None else ln, kn, vn), f"merge of {SHARDS} {dtype}"))
        say(f"[kernels] flash_decode self term {dtype}: pos 0 (v_new exactly), 1, {r}, {r + 1}, "
            f"{READONLY_POS}, {s} and lengths {list(lengths)}; partials on {SHARDS} shards of "
            f"{step} rows (shard {SHARDS - 1} empty) and their merge; max abs err {worst:.3g}; "
            "two calls bitwise equal")
    q, k, v = rand(b, h, dh, dtype=torch.bfloat16), rand(b, s, kv, dh, dtype=torch.bfloat16), \
        rand(b, s, kv, dh, dtype=torch.bfloat16)
    kn, vn = rand(b, kv, dh, dtype=torch.bfloat16), rand(b, kv, dh, dtype=torch.bfloat16)
    es, pos = q.element_size(), READONLY_POS
    # K and V: the pos cache rows and the self row, each read once; q read, out written
    b_ms, b_by = bound(2 * b * (pos + 1) * kv * dh * es + 2 * q.numel() * es,
                       4.0 * b * h * (pos + 1) * dh, q.dtype)
    kc = torch.cat([k[:, :pos], kn[:, None]], dim=1).transpose(1, 2).contiguous()
    vc = torch.cat([v[:, :pos], vn[:, None]], dim=1).transpose(1, 2).contiguous()
    t = dict(
        self_ms=device_time_ms(lambda: fd.flash_decode(q, k, v, pos, k_new=kn, v_new=vn), 100),
        self_scalar_ms=device_time_ms(lambda: fd.flash_decode(q, k, v, pos), 100),
        self_plain_ms=device_time_ms(lambda: ref.flash_decode_ref(q, k, v, pos, kn, vn), 20),
        self_library_ms=device_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kc, vc, enable_gqa=True), 100),
        self_bound_ms=b_ms, self_bound_by=b_by,
        partials_launches_ms=device_time_ms(lambda: partials(q, k, v, pos, kn, vn), 100),
        partials_plain_ms=device_time_ms(lambda: merge_partials(
            [ref.flash_decode_partials_ref(q, k[:, lo:lo + step], v[:, lo:lo + step],
                                           min(max(pos - lo, 0), step), start=lo,
                                           **(dict(k_new=kn, v_new=vn) if lo == 0 else {}))
             for lo in range(0, s, step)], q.dtype), 20),
        partials_bound_ms=b_ms, partials_bound_by=b_by,
        self_shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, pos {pos} + the self key; "
                   f"partials on {SHARDS} shards of {step} rows")
    # The merge's ~40 small launches outpace device_time_ms's hold on the
    # stream: the partials with their merge are timed from the profiler.
    tr = traced(lambda: merge_partials(partials(q, k, v, pos, kn, vn), q.dtype), 20)
    t["partials_ms"] = tr["device_ms"]
    t["partials_wall_ms"] = tr["wall_ms"]
    t["partials_by_class_ms"] = tr["by_class_ms"]
    t["partials_runtime_per_call"] = tr["runtime_per_call"]
    say(f"[kernels] flash_decode with the self term at pos {pos}: {t['self_ms']:.4f} ms a call "
        f"(the scalar launch at pos {pos}: {t['self_scalar_ms']:.4f} ms), SDPA over the cache "
        f"with the self key appended {t['self_library_ms']:.4f} ms, plain "
        f"{t['self_plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {SHARDS} partial launches "
        f"and the merge {t['partials_ms']:.4f} ms device in {tr['wall_ms']:.4f} ms wall "
        f"(traced; by class {tr['by_class_ms']}, runtime calls {tr['runtime_per_call']}), the "
        f"launches alone {t['partials_launches_ms']:.4f} ms (plain, with the merge: "
        f"{t['partials_plain_ms']:.4f} ms)")
    rows.update(t)
    torch.cuda.empty_cache()


def check_readonly_decode(model) -> tuple[int, dict]:
    """``decode_step(update_cache=False)`` on ``model`` at full width: 4
    slots after 2048-token prompts, READONLY_STEPS greedy steps, each beside
    the writing step on its own copy of the same cache.  After each
    read-only step every tensor of its input cache is bitwise what it was
    (held against a shadow copy); the caller then lands the step's
    ``kf``/``vf`` fragments at ``pos``.  The first period's fragments are
    bitwise the rows the writing step writes (the same projections and
    RoPE).  The two steps' logits differ only by K4's order of summation
    (the self key in range 0 against the last range), which 40 random bf16
    layers amplify: each row is held within twice what a writing step's row
    differs from itself decoded alone at batch 1, or BF16_ROW if more, and
    the greedy tokens are equal except in rows whose top-2 gap is under that
    tolerance.  Then both steps on the host clock and the device (medians).
    Returns (K4's calls in the READONLY_STEPS steps, the walls)."""
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, prefill

    cfg = model.cfg
    b, s = 4, 2048
    gen = torch.Generator(device="cuda").manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    logits, cache = prefill(model, prompt, cache_len=s + READONLY_STEPS)
    writing = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    shadow = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
    attn = [i for i, blk in enumerate(cfg.block_pattern) if blk == "attn"]
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]

    def rel(got, want) -> float:
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    lw0, _ = decode_step(model, tok, {**{k: v.clone() for k, v in shadow.items()}, "pos": s})
    baseline = max(rel(lw0[row], decode_step(model, tok[row:row + 1], {
        **{k: v[:, row:row + 1].clone() for k, v in shadow.items()}, "pos": s})[0][0])
        for row in range(b))
    tol = max(2 * baseline, BF16_ROW)
    del lw0
    worst, flipped, calls = 0.0, 0, 0
    for step in range(READONLY_STEPS):
        pos = s + step
        before = build.LAUNCHES["flash_decode"]
        lr, out = decode_step(model, tok, cache, update_cache=False)
        calls += build.LAUNCHES["flash_decode"] - before
        ensure(out["pos"] == pos + 1 and cache["pos"] == pos, ("pos", out["pos"], cache["pos"]))
        ensure(all(torch.equal(cache[k], v) for k, v in shadow.items()),
               f"step {step}: the read-only step wrote its input cache")
        lw, writing = decode_step(model, tok, writing)
        ensure(bool(torch.isfinite(lr).all()), "a non-finite logit")
        for i in attn:
            ensure(torch.equal(out[f"kf{i}"][0, :, 0], writing[f"k{i}"][0, :, pos]) and
                   torch.equal(out[f"vf{i}"][0, :, 0], writing[f"v{i}"][0, :, pos]),
                   f"step {step}: the first period's fragments differ from the written rows")
        top2 = torch.topk(lw[:, -1].float(), 2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) / lw.float().abs().amax(dim=(1, 2))).tolist()
        tr, tw = torch.argmax(lr[:, -1], -1).tolist(), torch.argmax(lw[:, -1], -1).tolist()
        for row in range(b):
            err = rel(lr[row], lw[row])
            worst = max(worst, err)
            ensure(err <= tol, (cfg.name, "step", step, "row", row, err, "tol", tol))
            if tr[row] != tw[row]:
                ensure(gap[row] < tol, ("greedy token differs", step, row, gap[row], tol))
                flipped += 1
        for i in attn:   # the caller lands the fragments
            for key in (f"k{i}", f"v{i}"):
                cache[key][:, :, pos] = out[key[0] + "f" + key[1:]][:, :, 0]
                shadow[key][:, :, pos] = out[key[0] + "f" + key[1:]][:, :, 0]
        cache["pos"] = pos + 1
        tok = torch.argmax(lw[:, -1], dim=-1)[:, None]
        del out
    ensure(calls == cfg.n_attn_layers * READONLY_STEPS, ("flash_decode calls", calls))
    pos = s + READONLY_STEPS - 1
    frozen = {**cache, "pos": pos}

    def wall_ms(fn) -> float:
        times = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[TIMED_STEPS // 2]

    def ro():
        decode_step(model, tok, dict(frozen), update_cache=False)

    def wr():
        decode_step(model, tok, {**writing, "pos": pos})

    tro, twr = traced(ro, 3), traced(wr, 3)
    walls = dict(readonly_wall_ms=wall_ms(ro), writing_wall_ms=wall_ms(wr),
                 readonly_device_ms=tro["device_ms"], writing_device_ms=twr["device_ms"],
                 readonly_traced_wall_ms=tro["wall_ms"], writing_traced_wall_ms=twr["wall_ms"])
    say(f"[trace] {cfg.name} read-only step: {tro['device_ms']:.2f} ms device in "
        f"{tro['wall_ms']:.2f} ms wall, by class {tro['by_class_ms']}, syncs "
        f"{tro['syncs_per_call']}; writing step: {twr['device_ms']:.2f} ms device in "
        f"{twr['wall_ms']:.2f} ms wall, by class {twr['by_class_ms']}, syncs "
        f"{twr['syncs_per_call']}")
    say(f"[serve] {cfg.name} read-only decode (B {b}, prompts of {s}, {READONLY_STEPS} steps): "
        f"the input cache bitwise unchanged after every step, the first period's fragments "
        f"bitwise the writing step's rows; logits within {worst:.4f} x max|logit| of the "
        f"writing step's (held at {tol:.4f}; a writing step's rows against themselves alone: "
        f"{baseline:.4f}); {flipped} greedy tokens differ, each in a row with a top-2 gap under "
        f"the tolerance; a read-only step {walls['readonly_wall_ms']:.2f} ms wall, "
        f"{walls['readonly_device_ms']:.2f} ms device; a writing step "
        f"{walls['writing_wall_ms']:.2f} ms wall, {walls['writing_device_ms']:.2f} ms device "
        f"(walls: medians of {TIMED_STEPS} on the host clock; device: traced, 3 steps); "
        f"{calls} K4 calls")
    del cache, writing, shadow, frozen
    return calls, walls


DRYRUN_ARGS = ("--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh", "both")


def phase_dryrun() -> None:
    """Phase 12c, after every timed phase (it would share the host with
    them): the dry run of qwen3-14b's decode_32k cell on both meshes as a
    subprocess on this machine's CPU (meta tensors, a fake process group of
    512 ranks; nothing runs on the card).  It must end in 0 with both cells
    ok."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS, "--out",
         os.path.join(ROOT, "build", "dryrun")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        timeout=600)
    out = proc.stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("qwen3-14b")]
    for ln in lines:
        say(f"[dryrun] {ln}")
    ensure(proc.returncode == 0 and len(lines) == 2 and all(": OK " in ln for ln in lines),
           f"the dry run ended {proc.returncode}: {out[-2000:]}")
    for mesh in ("pod", "multipod"):
        with open(os.path.join(ROOT, "build", "dryrun", f"qwen3-14b__decode_32k__{mesh}.json")) as f:
            rec = json.load(f)
        ensure(rec["status"] == "ok", rec)


def mamba_bound(p: dict, b: int, s: int) -> tuple[float, str, float, float]:
    """The mixer's bound for (B, S) tokens: the layer's weights, x, the
    output and the f32 state (read at decode, written always) and the conv
    tail moved once; the products' operations in bf16 and the scan's in f32
    (exp(dt*A), dt*x*B, the multiply-add, the readout: 6 a state element a
    step).  Returns (bound ms, by, bytes ms, operations ms)."""
    es = p["in_proj"].element_size()
    d, di = p["in_proj"].shape[0], p["conv_w"].shape[1]
    n = p["a_log"].shape[1]
    weights = sum(t.numel() * t.element_size() for t in p.values())
    state = b * (di * n * 4 + 3 * di * es)
    moved = weights + 2 * b * s * d * es + (2 if s == 1 else 1) * state
    macs = sum(p[k].numel() for k in ("in_proj", "x_proj", "dt_proj", "out_proj"))
    t_bytes = moved / HBM_BYTES_S * 1e3
    t_ops = (2 * b * s * macs / PEAK_FLOPS[torch.bfloat16]
             + 6 * b * s * di * n / PEAK_FLOPS[torch.float32]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def time_mamba(model) -> None:
    """The Mamba mixer alone at full width, on the served model's first
    Mamba layer: a 2048-token prefill (B 1) and a decode step of 4 slots,
    each traced (device time, runtime launches a call) and on the host
    clock, beside its bound."""
    from repro_torch.models import mamba_decode_step, mamba_forward

    i = model.cfg.block_pattern.index("mamba")
    p = {k: v[0] for k, v in model.layers[f"b{i}"].items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, di = model.cfg.d_model, 2 * model.cfg.d_model
    cd = model.cfg.compute_dtype
    x = torch.randn((1, 2048, d), generator=gen, device="cuda").to(cd)
    xd = torch.randn((4, 1, d), generator=gen, device="cuda").to(cd)
    state = {"ssm": 0.01 * torch.randn((4, di, 16), generator=gen, device="cuda"),
             "conv": torch.randn((4, 3, di), generator=gen, device="cuda").to(cd)}
    out = {}
    for label, fn, (b, s), n in (("prefill", lambda: mamba_forward(p, x), (1, 2048), 2),
                                 ("decode", lambda: mamba_decode_step(p, xd, state), (4, 1), 20)):
        y, st = fn()
        ensure(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st["ssm"]).all()),
               f"mamba {label}: a non-finite value")
        wall = wall_time_ms(fn, n)
        tr = traced(fn, n)
        launches = sum(v for k, v in tr["runtime_per_call"].items() if "Launch" in k)
        b_ms, b_by, t_bytes, t_ops = mamba_bound(p, b, s)
        out[label] = dict(shape=f"x ({b}, {s}, {d}) {cd}", wall_ms=wall, device_ms=tr["device_ms"],
                          traced_wall_ms=tr["wall_ms"], busy_share=tr["busy_share"],
                          launches_per_call=launches, bound_ms=b_ms, bound_by=b_by,
                          bytes_ms=t_bytes, operations_ms=t_ops, by_class_ms=tr["by_class_ms"])
        say(f"[mamba] {label} x ({b}, {s}, {d}) {cd}: {wall:.2f} ms wall, device "
            f"{tr['device_ms']:.3f} ms ({tr['busy_share']:.1%} busy traced), {launches:g} "
            f"runtime launches a call; bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, "
            f"operations {t_ops:.4f} ms); by class "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in tr["by_class_ms"].items()))
    say("[mamba] " + json.dumps(out))


# Phase 8f: the published Jamba block (no token dropped) at JAMBA_LAYERS of
# Jamba2-Mini's (and jamba-v0.1's) widths, served as phase 8c serves
# jamba-v0.1: one request at a time in lane 0 of a 4-lane decode engine,
# lanes 1-3 idle, every decode MoE layer on K8.
def serve_moe() -> dict:
    """Serve the published Jamba block through :func:`phase_serve` (whose
    launch counts hold K8 to one launch a MoE layer a decode step) and
    report the distinct experts each decode MoE layer routed to: an eager
    step's routing (K9's experts) as it is made, a graphed step's read from
    the captured routing after each replay.  Returns the serve's launch
    counts."""
    from collections import Counter

    from repro_torch.configs.jamba_v01_52b import published
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import FULL
    from repro_torch.models import decode_graph

    cfg = published(full_config(JAMBA))
    n_moe = cfg.n_periods * sum(f == "moe" for f in cfg.ffn_pattern)
    seen, pending, captured = [], [], {}
    real = ops.moe_route, decode_graph.DecodeGraphs._capture, torch.cuda.CUDAGraph.replay

    def route(xf, *a):
        out = real[0](xf, *a)     # K9 runs at decode only
        (pending if torch.cuda.is_current_stream_capturing() else seen).append(out[0])
        return out

    def capture(self, top):
        pending.clear()
        graph, calls = real[1](self, top)
        captured[id(graph)] = list(pending)
        return graph, calls

    def replay(self):
        real[2](self)
        seen.extend(e.clone() for e in captured.get(id(self), ()))

    say(f"[serve] the published Jamba block (no drop, capacity factor "
        f"{cfg.moe.capacity_factor:g}) at {cfg.n_layers} layers, {n_moe} of them MoE")
    ops.moe_route, decode_graph.DecodeGraphs._capture, torch.cuda.CUDAGraph.replay = (
        route, capture, replay)
    try:
        launches, cluster, _ = phase_serve(cfg)
    finally:
        ops.moe_route, decode_graph.DecodeGraphs._capture, torch.cuda.CUDAGraph.replay = real
    steps = sum(w["decode_steps"] for w in cluster.walls)
    ensure(len(seen) == n_moe * steps, f"{len(seen)} decode MoE layers routed, {steps} steps")
    for name in ("moe_decode", "moe_route"):
        ensure(launches[name] == n_moe * steps, (name, launches[name]))
    distinct = [int(e.unique().numel()) for e in seen]
    hist = dict(sorted(Counter(distinct).items()))
    say(f"[moe] published jamba served, lane 0 active of {FULL['n_slots']}: distinct experts a "
        f"decode MoE layer over {steps} steps x {n_moe} layers: {hist}, mean "
        f"{sum(distinct) / len(distinct):.3f}; K8 {launches['moe_decode']}, K9 "
        f"{launches['moe_route']} launches; graphs "
        f"{[d.graph_stats for d in cluster.decode]}")
    del cluster
    return launches


# ---------------------------------------------------------- phases 8d, 8e
SEAMLESS = "seamless-m4t-medium"
INTERNVL2 = "internvl2-76b"
# internvl2 runs with 24 of its 80 layers: 80 hold 141.1 GB of bf16 weights,
# more than one 80 GB card; 24 hold 45.3 GB and leave room for the four
# decode engines' caches (6.44 GB) and a 4 x 2304-token prefill.
INTERNVL2_LAYERS = 24
# The model-level runs: batch 4; seamless encodes 2048 stub frames and
# prefills 256 decoder tokens (ArchSpec.input_specs' prefill shape of an
# encoder-decoder); internvl2 prefills 256 stub patch embeddings and 2048
# tokens; then 16 greedy decode steps, 8 on the host clock and traced(4)
# (4 warm-up steps and 4 traced).
MODEL_BATCH, ENC_FRAMES, DEC_TOKENS, VISION_TOKENS = 4, 2048, 256, 2048
DECODE_STEPS = 16


def model_decode(model, cache, logits):
    """DECODE_STEPS greedy decode steps of the batch in ``cache`` after the
    prefill's ``logits``, each ending in the host read of its tokens, as the
    decode engine's: returns (host ms a step of the 8 untraced, the trace)."""
    from repro_torch.models import decode_step

    tok = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
    finite = []

    def step():
        out, _ = decode_step(model, tok[0], cache)
        finite.append(torch.isfinite(out).all())
        tok[0] = torch.argmax(out[:, -1], dim=-1)[:, None]
        tok[0].tolist()

    t0 = time.perf_counter()
    for _ in range(8):
        step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    tr = traced(step, 4)
    ensure(len(finite) == DECODE_STEPS and all(bool(f) for f in finite), "a non-finite logit")
    return step_ms, tr


def model_bounds(model, b: int, s: int, s_enc: int) -> dict:
    """Least times (ms) of the run's two device calls at the card's peaks.
    A decode step at ``s`` cached positions reads every weight it uses once
    (all but the embedding, the encoder and the cross K/V projections,
    which run once a prefill), the self K/V of ``s`` positions and the
    cross K/V of ``s_enc``.  A prefill of ``s`` positions does 2 operations
    a weight a position in its products (the decoder's; the cross
    projections over ``s_enc`` frames; ``lm_head`` at the last position)
    and 4·H·dh a (query, key) pair in attention: the causal half of S² for
    self-attention, S·S_enc for cross-attention."""
    cfg = model.cfg
    es = torch.tensor([], dtype=cfg.compute_dtype).element_size()
    cross_kv = [f"cross_layers.c{i}.w{kv}" for i in range(len(cfg.block_pattern)) for kv in "kv"]
    step = flops = 0
    for name, t in model.named_parameters():
        if name == "embed" or name.startswith("enc_"):
            continue
        if name in cross_kv:
            flops += 2 * b * s_enc * t.numel()
            continue
        step += t.numel() * t.element_size()
        if t.dim() > 1 and not name.endswith(("ln", "norm")):   # stacked norms: (P, d)
            flops += 2 * b * (1 if name == "lm_head" else s) * t.numel()
    kv_row = cfg.n_kv_heads * cfg.d_head * es
    step += 2 * cfg.n_attn_layers * b * (s + (s_enc if cfg.is_enc_dec else 0)) * kv_row
    pairs = cfg.n_attn_layers * (s * (s + 1) // 2 + (s * s_enc if cfg.is_enc_dec else 0))
    flops += 4 * b * pairs * cfg.n_heads * cfg.d_head
    return dict(step_bytes=step, step_bound_ms=step / HBM_BYTES_S * 1e3, prefill_flop=flops,
                prefill_bound_ms=flops / PEAK_FLOPS[cfg.compute_dtype] * 1e3)


def phase_model(model, prompt, *, frames=None, prefix=None) -> int:
    """A model's own entry points at full width: ``encode`` of stub frames
    (an encoder-decoder), ``prefill`` of the prompt (behind stub patch
    embeddings for a vision model) at ``cache_len`` 4096, and DECODE_STEPS
    decode steps, with the launch counts set to 0 before and read after:
    K4 carries every self-attention layer a step, and an encoder-decoder's
    cross-attention too.  Then the encode (if any) and the prefill traced,
    and two prefills and two decode steps on the same inputs bitwise equal.
    Returns K4's calls."""
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, encode, prefill

    cfg = model.cfg
    name = cfg.name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    memory = None if frames is None else encode(model, frames)
    ensure(memory is None or bool(torch.isfinite(memory).all()), "a non-finite memory")
    t1 = time.perf_counter()

    def run_prefill():
        return prefill(model, prompt, prefix_embeds=prefix, memory=memory, cache_len=4096)

    logits, cache = run_prefill()
    ensure(bool(torch.isfinite(logits).all()), f"{name}: a non-finite prefill logit")
    t2 = time.perf_counter()
    s = prompt.shape[1] + (0 if prefix is None else prefix.shape[1])
    ensure(cache["pos"] == s, ("pos", cache["pos"], s))
    if memory is not None:
        want = (cfg.n_periods, prompt.shape[0], frames.shape[1], cfg.n_kv_heads, cfg.d_head)
        ensure(all(tuple(cache[f"c{kv}0"].shape) == want for kv in "kv"), "cross K/V shape")
    step_ms, decode = model_decode(model, cache, logits)
    launches = dict(build.LAUNCHES)
    calls = cfg.n_attn_layers * (2 if cfg.is_enc_dec else 1) * DECODE_STEPS
    ensure(launches == dict.fromkeys(launches, 0) | {"flash_decode": calls},
           (name, launches, calls))
    peak = torch.cuda.max_memory_allocated()
    bounds = model_bounds(model, prompt.shape[0], s, 0 if frames is None else frames.shape[1])
    say(f"[model] {name} (B {prompt.shape[0]}, {s} prompt positions"
        + ("" if memory is None else f", {frames.shape[1]} encoder frames")
        + f"): encode {(t1 - t0) * 1e3:.1f} ms, prefill {(t2 - t1) * 1e3:.1f} ms wall; "
        f"decode step {step_ms:.2f} ms wall untraced at pos {s}-{s + DECODE_STEPS}; "
        f"flash_decode {calls} calls in {DECODE_STEPS} steps; peak memory {peak / 1e9:.2f} GB")
    say(f"[model] {name} bounds: a decode step reads {bounds['step_bytes']:,} B, "
        f"{bounds['step_bound_ms']:.3f} ms (bytes); the prefill does "
        f"{bounds['prefill_flop'] / 1e12:.1f} TFLOP, {bounds['prefill_bound_ms']:.1f} ms "
        "(operations)")
    traces = {"decode step": decode, "prefill": traced(run_prefill, 1)}
    if memory is not None:
        traces["encode"] = traced(lambda: encode(model, frames), 1)
    say_traces(cfg, traces)
    say("[model] " + json.dumps(dict(model=name, encode_ms=(t1 - t0) * 1e3,
                                     prefill_ms=(t2 - t1) * 1e3, decode_step_ms=step_ms,
                                     peak_gb=peak / 1e9, flash_decode_calls=calls,
                                     bounds=bounds, traces=traces)))
    del cache
    first, second = run_prefill(), run_prefill()
    ensure(torch.equal(first[0], second[0])
           and all(torch.equal(first[1][k], second[1][k]) for k in first[1] if k != "pos"),
           f"{name}: two prefills differ")
    del second
    tok = torch.argmax(first[0][:, -1], dim=-1)[:, None]
    steps = [decode_step(model, tok, {k: v if k == "pos" else v.clone()
                                      for k, v in first[1].items()}) for _ in range(2)]
    (l1, c1), (l2, c2) = steps
    ensure(torch.equal(l1, l2) and all(torch.equal(c1[k], c2[k]) for k in c1 if k != "pos"),
           f"{name}: two decode steps differ")
    say(f"[model] {name}: two prefills and two decode steps on the same inputs: logits and "
        "caches bitwise equal")
    return calls


def phase_encdec() -> int:
    """8d: seamless-m4t-medium at full width, nothing cut: its entry points
    on 4 x 2048 stub frames and 4 x 256 decoder tokens."""
    from repro_torch.configs import get_spec
    from repro_torch.models import Model, init_random_

    cfg = get_spec(SEAMLESS).model
    model = init_random_(Model(cfg, device="cuda"), 0)
    n = sum(p.numel() for p in model.parameters())
    say(f"[model] {SEAMLESS}: {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
        f"{n:,} parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    gen = torch.Generator(device="cuda").manual_seed(6)
    frames = torch.randn((MODEL_BATCH, ENC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.compute_dtype)
    prompt = torch.randint(0, cfg.vocab_size, (MODEL_BATCH, DEC_TOKENS), generator=gen,
                           device="cuda")
    return phase_model(model, prompt, frames=frames)


def phase_vision() -> tuple[dict, int]:
    """8e: internvl2-76b at full width with INTERNVL2_LAYERS of its 80
    layers: (a) the cluster serves 4 requests of 2048 tokens, text only, as
    the JAX cluster does; (b) on its weights, the entry points on 4 x (256
    stub patch embeddings + 2048 tokens).  Returns (the serve's launch
    counts, K4's calls of (b))."""
    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import weight_bytes

    full = get_spec(INTERNVL2).model
    cfg = dataclasses.replace(full, n_layers=INTERNVL2_LAYERS)
    say(f"[serve] {INTERNVL2}: {cfg.n_layers} of its {full.n_layers} layers; the published "
        f"depth's {weight_bytes(full):,} B of bf16 weights do not fit one "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB card, "
        f"{cfg.n_layers} layers take {weight_bytes(cfg):,} B")
    launches, cluster, _ = phase_serve(cfg, 4)
    model = cluster.model
    del cluster
    free()
    gen = torch.Generator(device="cuda").manual_seed(7)
    prefix = torch.randn((MODEL_BATCH, cfg.n_prefix_embeds, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.compute_dtype)
    prompt = torch.randint(0, cfg.vocab_size, (MODEL_BATCH, VISION_TOKENS), generator=gen,
                           device="cuda")
    return launches, phase_model(model, prompt, prefix=prefix)


# ---------------------------------------------------------------- phase 9
DECIDE_POOLS = (16, 64, 256, 1024, 2048, 8192)


def decide_at(n: int, decisions: int = 200) -> dict:
    """``decisions`` netkv-full decisions over an ``n``-instance pool on the
    kernel backend (the card) and on the NumPy backend: µs a decision of
    each, and every kernel pick within rtol 1e-5 of the NumPy minimum."""
    from repro_torch.core import H100_TP4_ITER, RequestInfo, make_scheduler
    from repro_torch.kernels import build

    cv, view = pool_2048(n)
    req = RequestInfo(0, 8192, 8192 * 320 * 1024)
    rng = np.random.default_rng(11)
    hits = rng.integers(0, req.input_len, (decisions, n)).astype(np.float64)
    kern = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel",
                          device="cuda")
    plain = make_scheduler("netkv-full", H100_TP4_ITER, 64)
    cv.hit_tokens[:n] = hits[0]
    kern.select(req, 0, cv, view, None)  # warm the library and the allocator
    plain.select(req, 0, cv, view, None)
    build.reset_launches()
    picks, t_kernel = [], []
    for k in range(decisions):
        cv.hit_tokens[:n] = hits[k]
        t0 = time.perf_counter()
        picks.append(kern.select(req, 0, cv, view, None))
        t_kernel.append(time.perf_counter() - t0)
    launches = build.LAUNCHES["netkv_score_cohort"]
    ensure(launches == decisions, ("netkv_score_cohort launches", launches))
    t_np = []
    for k, dec in enumerate(picks):
        cv.hit_tokens[:n] = hits[k]
        s_eff, mask = plain._prep(req, cv)
        tier_row = cv.tier_row(0)
        cost = (plain._xfer_vec(req, cv, 0, view, None, s_eff, tier_row)
                + plain._t_queue_vec(cv) + plain._t_decode_vec(cv))
        best = float(cost[mask].min())
        got = float(cost[cv.slot_of(dec.instance_id)])
        ensure(abs(got - best) <= 1e-5 * abs(best), (n, k, got, best))
        t0 = time.perf_counter()
        plain.select(req, 0, cv, view, None)
        t_np.append(time.perf_counter() - t0)
    # The host is shared and its pace varies: the median a decision beside
    # the mean.
    out = dict(d=n, kernel_us=np.mean(t_kernel) * 1e6, numpy_us=np.mean(t_np) * 1e6,
               kernel_p50_us=np.median(t_kernel) * 1e6, numpy_p50_us=np.median(t_np) * 1e6,
               launches=launches)
    if n == 2048:
        # What one decision asks of the runtime: copies, launches, syncs.
        tr = traced(lambda: kern.select(req, 0, cv, view, None), 20)
        out.update(runtime_per_decision=tr["runtime_per_call"],
                   syncs_per_decision=tr["syncs_per_call"],
                   copies_per_decision=tr["copies_per_call"],
                   device_ms_per_decision=tr["device_ms"])
    return out


def phase_decide() -> tuple[int, dict]:
    """Kernel-scored decisions against the NumPy backend at each pool size of
    DECIDE_POOLS; returns K1's launches over the timed decisions and the
    numbers of D 2048."""
    rows = [decide_at(n) for n in DECIDE_POOLS]
    for r in rows:
        say(f"[decide] D={r['d']}: kernel backend {r['kernel_us']:.1f} us/decision "
            f"(median {r['kernel_p50_us']:.1f}), NumPy backend {r['numpy_us']:.1f} "
            f"(median {r['numpy_p50_us']:.1f}); every pick within rtol 1e-5 of the NumPy "
            f"minimum")
    wins = [r["d"] for r in rows if r["kernel_p50_us"] < r["numpy_p50_us"]]
    say(f"[decide] crossover (medians): the card's decision beats NumPy's from D={wins[0]}"
        if wins and all(r["kernel_p50_us"] < r["numpy_p50_us"]
                        for r in rows if r["d"] >= wins[0])
        else f"[decide] crossover (medians): the card wins at D in {wins} of "
             f"{list(DECIDE_POOLS)}")
    at = next(r for r in rows if r["d"] == 2048)
    say(f"[decide] D=2048, one decision read from the profiler: runtime calls "
        f"{at['runtime_per_decision']}, stream syncs {at['syncs_per_decision']}, device "
        f"copies {at['copies_per_decision']}, device {at['device_ms_per_decision']:.4f} ms")
    say("[decide] " + json.dumps(rows))
    return sum(r["launches"] for r in rows), at


def decision_calls(at: dict) -> None:
    """A kernel-scored decision asks the runtime for one copy in, one launch
    and one copy out (the packed result, from pinned memory), and one
    synchronisation.  Runtime calls are read on the host, where the
    profiler drops none; the device's copies, where it may drop a few, are
    held to at most one each way, both pinned."""
    rt, copies = at["runtime_per_decision"], at["copies_per_decision"]
    launches = sum(v for k, v in rt.items() if "Launch" in k)
    ensure(launches == 1.0 and rt.get("cudaMemcpyAsync") == 2.0 and len(rt) == 2,
           ("runtime calls a decision", rt))
    ensure(at["syncs_per_decision"] == {"cudaStreamSynchronize": 1.0},
           ("syncs a decision", at["syncs_per_decision"]))
    ensure(set(copies) <= {"Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pinned)"}
           and all(v <= 1.0 for v in copies.values()), ("device copies a decision", copies))
    say(f"[decide] one decision: 1 copy in, {launches:g} launch, 1 copy out, 1 sync")


# ---------------------------------------------------------------- phase 10
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


def one_launch(per_call: dict, tr: dict, name: str) -> float:
    """A wrapper's call is one kernel launch and no other device op: one
    runtime launch call a call and no copy or fill, and no device event but
    its kernel's (the profiler may drop a few of those, so they are not
    counted).  Returns the launches a call the profiler read."""
    ensure(per_call == {"cudaLaunchKernel": 1.0}, (f"{name}: runtime calls a call", per_call))
    events = tr["events_per_call"]
    ensure(set(events) == {"waterfill"} and 0.0 < events["waterfill"] <= 1.0,
           (f"{name}: device events a call", events))
    say(f"[kernels] {name}: kernel launches a call, read from the profiler: "
        f"{per_call['cudaLaunchKernel']} (device events of the kernel a call: "
        f"{events['waterfill']})")
    return per_call["cudaLaunchKernel"]


def fast_error(got, caps, active, nh) -> tuple[float, float, float]:
    """K6 against its plain version in f32 and f64: the inf pattern and zero
    inactive rows held; returns (max abs err, max rel err f32, f64)."""
    from repro_torch.kernels import ref

    want = ref.waterfill_rates_fast_ref(caps, active, nh)
    f64 = ref.waterfill_rates_fast_ref(caps.double(), active, nh.double())
    ensure(torch.equal(torch.isinf(got), torch.isinf(want)), "waterfill_fast: inf pattern")
    ensure(torch.equal(torch.isinf(got), torch.isinf(f64)), "waterfill_fast: inf pattern (f64)")
    ensure(bool((got[~active] == 0).all()), "waterfill_fast: inactive rows carry a rate")
    fin = torch.isfinite(want)
    err = (got - want)[fin].abs()
    rel = (err / want[fin].abs().clamp(min=1e-30)).max().item() if err.numel() else 0.0
    d64 = (got.double() - f64)[fin].abs() / f64[fin].abs().clamp(min=1e-30)
    rel64 = d64.max().item() if d64.numel() else 0.0
    ensure(rel <= 1e-4 and rel64 <= 1e-4, f"waterfill_fast rel err {rel} / f64 {rel64} > 1e-4")
    return (err.max().item() if err.numel() else 0.0), rel, rel64


def check_waterfill_fast(rows: dict, plane) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.waterfill import fast_plan_for, random_incidence, waterfill_fast

    caps, active, nh = fast_inputs(plane)
    s, f = active.shape
    l1 = caps.shape[1]
    plan = fast_plan_for(caps, active)
    got = waterfill_fast(caps, active, nh)
    err, rel, rel64 = fast_error(got, caps, active, nh)
    ensure(torch.equal(got, waterfill_fast(caps, active, nh)), "waterfill_fast: two calls differ")
    say(f"[kernels] waterfill_fast S {s} x F {f} x L+1 {l1}: {int(active.sum())} active flows, "
        f"max rel err {rel:.3g} vs plain f32, {rel64:.3g} vs f64 (rtol 1e-4); two calls "
        f"bitwise equal; plan {plan._asdict()}")
    # Tables past shared memory: the slab, then the state and masks, in
    # device memory.
    seen = set()
    for shape in ((2, 1100, 300), (1, 3000, 1500), (1, 64, 14000)):
        caps_b, active_b, nh_b = random_incidence(*shape, seed=sum(shape))
        big = tuple(torch.from_numpy(a).cuda() for a in (caps_b.astype(np.float32), active_b, nh_b))
        big_plan = fast_plan_for(big[0], big[1])
        seen.add(big_plan.layout)
        out = waterfill_fast(*big)
        ensure(bool((torch.isfinite(out) & (out > 0)).any()), "waterfill_fast: no finite rate")
        _, b_rel, b_rel64 = fast_error(out, *big)
        ensure(torch.equal(out, waterfill_fast(*big)), "waterfill_fast: two calls differ (large)")
        say(f"[kernels] waterfill_fast S {shape[0]} x F {shape[1]} x L+1 {shape[2]}: layout "
            f"{big_plan.layout}, max rel err {b_rel:.3g} vs plain f32, {b_rel64:.3g} vs f64 "
            f"(rtol 1e-4); two calls bitwise equal")
    ensure(seen == {"masks", "global"}, ("a layout went untested", seen))
    moved = caps.numel() * 4 + active.numel() + nh.numel() * 4 + got.numel() * 4
    # Operations: at least one round's pass over the incidence table (a
    # multiply and an add per entry for the used capacity).
    b_ms, b_by = bound(moved, 2.0 * nh.numel(), torch.float32)
    k_ms = device_time_ms(lambda: waterfill_fast(caps, active, nh), 200)
    p_ms = wall_time_ms(lambda: ref.waterfill_rates_fast_ref(caps, active, nh), 10)
    tr = traced(lambda: waterfill_fast(caps, active, nh), 20)
    per_call = tr["runtime_per_call"]
    launches = one_launch(per_call, tr, "waterfill_fast")
    only = tr["ms_per_event"]["waterfill"]
    say(f"[kernels] waterfill_fast: {k_ms:.4f} ms a call on the device (kernel {only:.4f} ms in "
        f"the profiler); runtime calls a call {per_call}, device events a call "
        f"{tr['events_per_call']}; plain version {p_ms:.3f} ms wall")
    rows["waterfill_fast"] = row("waterfill_fast", err, k_ms, p_ms, None,
                                 b_ms, b_by, shape=f"S {s} x F {f} x L+1 {l1} f32",
                                 kernel_only_ms=only, layout=plan.layout,
                                 launches_a_call=launches,
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


# ---------------------------------------------------------------- phase 11
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
    from repro_torch.cluster import FlowPlane
    from repro_torch.kernels import build
    from repro_torch.kernels import netkv_score as ns
    from repro_torch.kernels.waterfill import waterfill_rates
    from repro_torch.sim import SimConfig, Simulation, run_sim
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
    card_launch = ns._launch

    def counted(ptrs, params, r, *rest):
        rows_per_launch.append(r)
        card_launch(ptrs, params, r, *rest)

    launches = {}
    for name, (trace, kw) in traces.items():
        out = {}
        for device in ("cuda", "cpu"):
            cfg = SimConfig(scheduler="netkv-full", dispatch_mode="plane",
                            scheduler_kwargs=dict(backend="kernel", device=device), **kw)
            rows_per_launch.clear()
            if device == "cuda":
                FlowPlane._recompute_rates, ns._launch = shadowed, counted
                build.reset_launches()
            t0 = time.perf_counter()
            try:
                m = run_sim(cfg, trace)
            finally:
                FlowPlane._recompute_rates, ns._launch = recompute, card_launch
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
    # The card's wall without the K5 shadow: K1 scoring alone.
    for name, (trace, kw) in traces.items():
        cfg = SimConfig(scheduler="netkv-full", dispatch_mode="plane",
                        scheduler_kwargs=dict(backend="kernel", device="cuda"), **kw)
        t0 = time.perf_counter()
        run_sim(cfg, trace)
        say(f"[simulate] {name} on the card without the K5 shadow: "
            f"{time.perf_counter() - t0:.2f}s wall")
    # Decision forensics: every decision's row (winner, runner-up, their
    # costs, hits, loads and transfer times) on the card and on the CPU.
    for name, (trace, kw) in traces.items():
        rows = {}
        for device in ("cuda", "cpu"):
            cfg = SimConfig(scheduler="netkv-full", dispatch_mode="plane", trace=True,
                            trace_decisions=1,
                            scheduler_kwargs=dict(backend="kernel", device=device), **kw)
            sim = Simulation(cfg)
            sim.run(trace)
            rows[device] = sim.trace.forensics_rows()
        same = len(rows["cuda"]) == len(rows["cpu"]) and all(
            all(x == y or (isinstance(x, float) and np.isnan(x) and np.isnan(y))
                for x, y in zip(a, b)) for a, b in zip(rows["cuda"], rows["cpu"]))
        ensure(same and rows["cpu"], f"{name}: forensics rows differ on the card and the CPU")
        ran = sum(r[5] >= 0 for r in rows["cpu"])
        say(f"[simulate] {name}, traced: {len(rows['cpu'])} forensics rows ({ran} with a "
            f"runner-up) equal row for row on the card and the CPU")
    say(f"[simulate] {len(tables)} FlowPlane fixed points recomputed by "
        f"waterfill_progressive, max rel err vs the plane's f64 rates {worst[0]:.3g} (rtol 1e-4)")
    return launches, tables


def progressive_bitwise(args) -> int:
    """K5 against its plain version, bit for bit; returns the rounds."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.waterfill import waterfill_progressive

    rates, tl, ts, rounds = waterfill_progressive(*args)
    p_rates, p_tl, p_ts, p_r = ref.waterfill_fixed_point_ref(*args)
    ensure(int(rounds[0]) == p_r, ("rounds", int(rounds[0]), p_r))
    ensure(torch.equal(rates, p_rates) and torch.equal(ts, p_ts),
           "waterfill_progressive rates/shares differ from the plain version")
    ensure(torch.equal(tl, p_tl), "waterfill_progressive trace links differ")
    ensure(bool((rates[~args[2]] == 0).all()), "waterfill_progressive: inactive rows carry a rate")
    return p_r


def check_waterfill_progressive(rows: dict, tables) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.waterfill import (random_flow_table, waterfill_progressive,
                                               waterfill_progressive_plan)

    def on_card(paths, caps, active=None):
        active = np.ones(len(paths), bool) if active is None else active
        return (torch.from_numpy(paths).cuda(), torch.from_numpy(caps).float().cuda(),
                torch.from_numpy(active).cuda())

    for paths, caps in tables[::max(1, len(tables) // 200)]:
        progressive_bitwise(on_card(paths, caps))
    # The shape edges: one flow, more flows and links than threads, every
    # flow inactive, flows only on the pad link, and the two layouts past
    # shared memory.
    edges = {"F 1": random_flow_table(20, n_flows=1),
             "F 300 x L+1 281": random_flow_table(21, 300, 280),
             "inactive": random_flow_table(22), "pad only": random_flow_table(23),
             "paths layout": random_flow_table(24, 9000, 2000),
             "global layout": random_flow_table(25, 500, 15000)}
    edges["inactive"][2][:] = False
    edges["pad only"][0][:] = len(edges["pad only"][1]) - 1
    seen = []
    for label, (paths, caps, active) in edges.items():
        plan = waterfill_progressive_plan(*paths.shape, len(caps))
        r = progressive_bitwise(on_card(paths, caps, active))
        seen.append(f"{label} ({plan.layout}, {r} rounds)")
    ensure({"paths", "global"} <= {waterfill_progressive_plan(*p.shape, len(c)).layout
                                   for p, c, _ in edges.values()}, "a layout went untested")
    paths, caps = max(tables, key=lambda t: len(t[0]))
    args = on_card(paths, caps)
    first, second = waterfill_progressive(*args), waterfill_progressive(*args)
    ensure(all(torch.equal(a, b) for a, b in zip(first, second)),
           "waterfill_progressive: two calls differ")
    f, h = paths.shape
    l1 = len(caps)
    plan = waterfill_progressive_plan(f, h, l1)
    say(f"[kernels] waterfill_progressive: {min(len(tables), 200)} FlowPlane tables "
        f"(up to F {f} x H {h}, L+1 {l1}) and the edges {', '.join(seen)}: rates, shares, "
        f"trace links and rounds bitwise equal to the plain version; two calls bitwise "
        f"equal; plan {plan._asdict()}")
    moved = paths.size * 4 + l1 * 4 + f + f * 4 + 2 * f * 4 + 4
    b_ms, b_by = bound(moved, float(l1 * f), torch.float32)
    k_ms = device_time_ms(lambda: waterfill_progressive(*args), 200)
    k_ms20 = device_time_ms(lambda: waterfill_progressive(*args), 20)
    p_ms = wall_time_ms(lambda: ref.waterfill_fixed_point_ref(*args), 5)
    tr = traced(lambda: waterfill_progressive(*args), 20)
    per_call = tr["runtime_per_call"]
    launches = one_launch(per_call, tr, "waterfill_progressive")
    rounds = int(waterfill_progressive(*args)[3][0])
    say(f"[kernels] waterfill_progressive on that table: {rounds} rounds; device_time_ms "
        f"{k_ms:.4f} ms a call over 200 calls ({k_ms20:.4f} over 20); traced, the kernel "
        f"{tr['ms_per_event']['waterfill']:.4f} ms a launch; runtime calls a call {per_call}, "
        f"device events a call {tr['events_per_call']}")
    rows["waterfill_progressive"] = row(
        "waterfill_progressive", 0.0, k_ms, p_ms, None, b_ms, b_by,
        shape=f"F {f} x H {h}, L+1 {l1} f32 (largest FlowPlane table), {rounds} rounds",
        kernel_only_ms=tr["ms_per_event"]["waterfill"], ms_20_calls=k_ms20,
        layout=plan.layout, launches_a_call=launches,
        library="none: no single PyTorch call computes the fixed point")


# ---------------------------------------------------------------- phase 12
# smollm-135m trained at full width, nothing cut: the train_4k shape's
# sequence of 4096 at a global batch of 8 (of its 256), 4 microbatches (its
# train_microbatches), AdamW on f32 master parameters, bf16 compute, remat.
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT, TRAIN_LR = 8, 4096, 20, 10, 1e-3


def train_step_fn(spec, lr: float, microbatches: int | None = None):
    from repro_torch.models.model import dtype_of
    from repro_torch.train import make_optimizer, make_train_step

    opt = make_optimizer(spec.optimizer, lr=lr)
    return opt, make_train_step(opt, microbatches=microbatches or spec.train_microbatches,
                                accum_dtype=dtype_of(spec.grad_accum_dtype))


def phase_train_smoke() -> None:
    """12a: one train step (2 microbatches of 2 x 24 tokens, the arch's
    optimizer) of every registered arch's smoke config in f32 on the card
    against the same step on the CPU from the same weights: loss and
    grad_norm rtol 1e-5 (rwkv6's grad_norm 1e-4), parameters as
    tests/test_torch_train.py holds them against JAX (at most 1% of a
    leaf's elements outside rtol 1e-5 + atol 1e-6, the difference's norm
    within 1e-2 of the step's)."""
    from repro_torch.configs import ALL, get_spec
    from repro_torch.models import Model, init_random_
    from repro_torch.train import synth_batch

    worst = {}
    for arch in ALL:
        spec = get_spec(arch)
        cfg = dataclasses.replace(spec.smoke, compute_dtype=torch.float32)
        cpu = init_random_(Model(cfg, device="cpu", train_dtype="float32"), 0)
        start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
        card = copy.deepcopy(cpu).to("cuda")
        opt, step = train_step_fn(dataclasses.replace(spec, grad_accum_dtype="float32"), 1e-3, 2)
        metrics = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            batch = synth_batch(cfg, global_batch=4, seq_len=24, seed=1, step=0, device=dev)
            metrics.append(step(model, opt.init(dict(model.named_parameters())), batch)[2])
        (mc, mg) = [{k: v.item() for k, v in m.items()} for m in metrics]
        gn_rtol = 1e-4 if arch == "rwkv6-3b" else 1e-5
        ensure(abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"]), (arch, mg, mc))
        ensure(abs(mg["grad_norm"] - mc["grad_norm"]) <= gn_rtol * mc["grad_norm"], (arch, mg, mc))
        ratio = 0.0
        for (name, pc), pg in zip(cpu.named_parameters(), card.parameters()):
            got, want = pg.detach().cpu(), pc.detach()
            off = ((got - want).abs() > 1e-5 * want.abs() + 1e-6).float().mean().item()
            update = (want - start[name]).norm().item()
            r = (got - want).norm().item() / max(update, 1e-12)
            ensure(off <= 1e-2 and r <= 1e-2, (arch, name, off, r))
            ratio = max(ratio, r)
        worst[arch] = (abs(mg["loss"] / mc["loss"] - 1), abs(mg["grad_norm"] / mc["grad_norm"] - 1),
                       ratio)
    say("[train] one step of every smoke config, card against CPU (f32): " + ", ".join(
        f"{a} loss {l:.2g} gnorm {g:.2g} params {r:.2g}" for a, (l, g, r) in worst.items()))


def train_bound(model, b: int, s: int) -> dict:
    """A full-width step's least time at the card's bf16 peak: the products
    6 operations a weight a token (forward and backward; the embedding is a
    gather, not a product) and the causal half of each layer's attention
    square, 4·H·dh a (query, key) pair in the forward and twice that in the
    backward.  What runs is more: remat repeats each layer's forward (2 a
    weight a token, and its attention), and the plain attention scores the
    whole square; both are given beside the bound."""
    cfg = model.cfg
    t = b * s
    layer = sum(p.numel() for n, p in model.named_parameters()
                if n.startswith("layers.") and p.dim() > 2)
    head = model.lm_head.numel()
    pairs = b * s * (s + 1) // 2 * cfg.n_attn_layers
    attn = 4 * pairs * cfg.n_heads * cfg.d_head
    need = 6 * (layer + head) * t + 3 * attn
    squares = 4 * b * s * s * cfg.n_attn_layers * cfg.n_heads * cfg.d_head   # one pass
    run = 6 * (layer + head) * t + 2 * layer * t + 4 * squares
    return dict(flop=need, bound_ms=need / PEAK_FLOPS[torch.bfloat16] * 1e3, flop_run=run,
                product_flop=6 * (layer + head) * t, attention_flop=3 * attn)


def phase_train() -> None:
    """12b: smollm-135m at full width, nothing cut, through the port's
    training entry points (``Model(train_dtype=...)``, ``make_train_step``,
    ``synth_batch``, ``save_checkpoint``/``restore_latest``), under
    ``torch.use_deterministic_algorithms(True)``: TRAIN_STEPS steps from
    ``init_random_`` seed 0 with a checkpoint at TRAIN_CKPT; every loss and
    grad_norm finite, the last loss below the first; wall ms a step on the
    host clock (each step ends in the host read of its loss), tokens/s, peak
    memory, the bound; the checkpoint restored and steps TRAIN_CKPT to
    TRAIN_STEPS run again: every parameter bitwise equal to the
    uninterrupted run's; then one step under the profiler."""
    from repro_torch.configs import get_spec
    from repro_torch.models import Model, init_random_
    from repro_torch.train import restore_latest, save_checkpoint, synth_batch

    spec = get_spec(TRAIN_ARCH)
    cfg = spec.model
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        model = init_random_(Model(cfg, device="cuda", train_dtype=spec.train_param_dtype), 0)
        n_params = sum(p.numel() for p in model.parameters())
        opt, step = train_step_fn(spec, TRAIN_LR)
        state = opt.init(dict(model.named_parameters()))

        def run(model, state, start, end, ckpt_at=None):
            losses, gnorms, walls = [], [], []
            for i in range(start, end):
                batch = synth_batch(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0,
                                    step=i, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model, state, m = step(model, state, batch)
                losses.append(m["loss"].item())
                walls.append((time.perf_counter() - t0) * 1e3)
                gnorms.append(m["grad_norm"].item())
                if i + 1 == ckpt_at:
                    save_checkpoint(ckpt, i + 1, {"params": model, "opt": state})
            return state, losses, gnorms, walls

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, losses, gnorms, walls = run(model, state, 0, TRAIN_STEPS, TRAIN_CKPT)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ensure(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms))
        ensure(losses[-1] < losses[0], ("the loss did not fall", losses))
        final = {n: p.detach().clone() for n, p in model.named_parameters()}
        step0, tree = restore_latest(ckpt, {"params": model, "opt": state})
        ensure(step0 == TRAIN_CKPT and tree["params"] is model, ("restored", step0))
        state, again, _, _ = run(model, tree["opt"], step0, TRAIN_STEPS)
        ensure(again == losses[TRAIN_CKPT:], ("the restarted losses differ", again, losses))
        same = [n for n, p in model.named_parameters() if torch.equal(p, final[n])]
        ensure(len(same) == len(final), ("restart not bitwise", set(final) - set(same)))
        del final
        batch = synth_batch(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0,
                            step=TRAIN_STEPS, device="cuda")
        tr = traced(lambda: step(model, state, batch)[2]["loss"].item(), 1, fine=True)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    steady = sorted(walls[1:])
    step_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bnd = train_bound(model, TRAIN_BATCH, TRAIN_SEQ)
    say(f"[train] {TRAIN_ARCH} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params:,} parameters, {spec.train_param_dtype} master, "
        f"{str(cfg.compute_dtype).removeprefix('torch.')} compute, remat {cfg.remat}), "
        f"global batch {TRAIN_BATCH} x {TRAIN_SEQ}, {spec.train_microbatches} microbatches, "
        f"{spec.optimizer} lr {TRAIN_LR}: {TRAIN_STEPS} steps in {total_s:.1f} s")
    say(f"[train] losses {[round(x, 4) for x in losses]}")
    say(f"[train] grad norms {[round(x, 3) for x in gnorms]}")
    say(f"[train] step wall {step_ms:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
        f"{walls[0]:.1f} ms), {tokens / step_ms * 1e3:,.0f} tokens/s, peak memory "
        f"{peak / 1e9:.2f} GB; bound {bnd['bound_ms']:.1f} ms ({bnd['flop'] / 1e12:.1f} TFLOP: "
        f"products {bnd['product_flop'] / 1e12:.1f}, causal attention "
        f"{bnd['attention_flop'] / 1e12:.1f}; {bnd['flop_run'] / 1e12:.1f} TFLOP run with remat "
        f"and whole squares)")
    say(f"[train] checkpoint at step {TRAIN_CKPT} restored under deterministic algorithms, "
        f"steps {TRAIN_CKPT}-{TRAIN_STEPS} again: losses equal, parameters bitwise equal")
    say(f"[train] traced step: wall {tr['wall_ms']:.1f} ms, device busy {tr['device_ms']:.1f} ms "
        f"({tr['busy_share']:.1%}); by class " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in tr["by_class_ms"].items()))
    for us, count, key in tr.pop("top"):
        say(f"[train]     {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    say("[train] " + json.dumps(dict(arch=TRAIN_ARCH, step_ms=step_ms, walls_ms=walls,
                                     tokens_per_s=tokens / step_ms * 1e3, peak_gb=peak / 1e9,
                                     losses=losses, grad_norms=gnorms, bound=bnd, trace=tr)))


# The dense models served at full width after granite-moe, with their
# request counts: 4, half the workload's 8, to hold the script's time
# (the first 4 decisions, the third request's prefix hit among them, are
# those of an 8-request serve).
DENSE_SERVES = {"phi3-medium-14b": 4, "internlm2-20b": 4, "smollm-135m": 4}
JAMBA = "jamba-v0.1-52b"
# jamba is served with 16 of its 32 layers: two whole 8-layer periods, every
# block kind and ratio kept; its 32 layers' bf16 weights (~103.1 GB) do not
# fit one 80 GB card, and 24 (~77.6 GB) would leave too little for the rest.
JAMBA_LAYERS = 16


def full_config(arch: str):
    from repro_torch.configs import get_spec

    cfg = get_spec(arch).model
    return dataclasses.replace(cfg, n_layers=JAMBA_LAYERS) if arch == JAMBA else cfg


def free() -> None:
    """Return the memory of a dropped cluster to the card."""
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[free] {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    last = [t_start]

    def lap(what: str) -> None:
        now = time.perf_counter()
        say(f"[time] {what}: {now - last[0]:.1f}s")
        last[0] = now

    name, count, smi = phase_device()
    if (sys.argv[1:] if argv is None else argv) == ["--k1"]:
        # API-neutral: the wrapper's call and select() only, so that a copy
        # of an earlier tree times its own K1 with this script.
        print(json.dumps({"k1": profile_k1(), "decide": phase_decide()[1],
                          "src": os.path.join(ROOT, "src")}))
        return 0
    phase_build()
    lap("build")
    if (sys.argv[1:] if argv is None else argv) == ["--dryrun"]:
        # This slice alone: K4's checks, its self term and partials, the
        # read-only decode at qwen3-14b's width, the dry run.  No kernels
        # line and no ok line.
        check_flash_decode({})
        check_readonly_kernels({})
        lap("kernels")
        from repro_torch.models import Model, init_random_

        check_readonly_decode(init_random_(Model(full_config("qwen3-14b"), device="cuda"), 0))
        free()
        lap("read-only decode")
        phase_dryrun()
        lap("dry run")
        return 0
    if (sys.argv[1:] if argv is None else argv) == ["--moe"]:
        # This slice alone: K8's and K9's checks and times, granite-moe served
        # and traced (phase 8b's), jamba-v0.1 served (phase 8c's serve), phase
        # 8f.  No kernels line and no ok line.
        check_moe_decode({})
        check_moe_route({})
        lap("kernels")
        for arch in ("granite-moe-1b-a400m", JAMBA):
            more, cluster, prompts = phase_serve(full_config(arch))
            if arch != JAMBA:
                phase_trace(cluster, prompts)
                check_bitwise_steps(cluster, prompts)
            say(f"[moe] {arch}: K9 {more['moe_route']}, K8 {more['moe_decode']} launches, "
                f"{sum(w['decode_steps'] for w in cluster.walls)} decode steps")
            del cluster
            free()
            lap(f"serve {arch}")
        serve_moe()
        free()
        lap("serve published jamba")
        return 0
    if (sys.argv[1:] if argv is None else argv) == ["--train"]:
        # This slice alone: K4's checks, the per-slot decode at qwen3-14b's
        # width, phase 12.  No kernels line and no ok line.
        check_flash_decode({})
        lap("kernels")
        from repro_torch.models import Model, init_random_

        check_slot_decode(init_random_(Model(full_config("qwen3-14b"), device="cuda"), 0))
        free()
        lap("per-slot decode")
        phase_train_smoke()
        phase_train()
        lap("train")
        return 0
    rows: dict = {}
    check_kv_pack(rows)
    check_flash_decode(rows)
    check_readonly_kernels(rows["flash_decode"])
    check_netkv_score(rows)
    check_rwkv_scan(rows)
    check_moe_decode(rows)
    check_moe_route(rows)
    lap("kernels")
    for arch in ("qwen3-14b", "rwkv6-3b", "granite-moe-1b-a400m", "arctic-480b",
                 *DENSE_SERVES, JAMBA, INTERNVL2):
        phase_match(arch)
    match_encdec()
    lap("match")
    launches, cluster, prompts = phase_serve(full_config("qwen3-14b"))
    phase_trace(cluster, prompts)
    launches["flash_decode"] += check_slot_decode(cluster.model)
    calls, walls = check_readonly_decode(cluster.model)
    launches["flash_decode"] += calls
    rows["flash_decode"].update(walls)
    del cluster
    free()
    rwkv_launches, cluster, prompts = phase_serve(full_config("rwkv6-3b"))
    phase_trace(cluster, prompts)
    del cluster
    free()
    launches["rwkv_scan"] = rwkv_launches["rwkv_scan"]
    lap("serve qwen3, rwkv6")
    # The attention models' launches of K2-K4 add up over their serves.
    for arch in ("granite-moe-1b-a400m", *DENSE_SERVES, JAMBA):
        cfg = full_config(arch)
        if arch == JAMBA:
            from repro_torch.configs import get_spec
            from repro_torch.launch.serve import weight_bytes

            say(f"[serve] {arch}: {cfg.n_layers} of its {get_spec(arch).model.n_layers} "
                f"layers ({cfg.n_periods} whole periods of {len(cfg.block_pattern)}); the "
                f"published depth's {weight_bytes(get_spec(arch).model) / 1e9:.1f} GB of bf16 "
                f"weights do not fit one {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}"
                f" GB card, {cfg.n_layers} layers take {weight_bytes(cfg) / 1e9:.1f} GB")
        more, cluster, prompts = phase_serve(cfg, DENSE_SERVES.get(arch, 8))
        if arch in ("granite-moe-1b-a400m", JAMBA):
            phase_trace(cluster, prompts)
            check_bitwise_steps(cluster, prompts)
        if arch == JAMBA:
            time_mamba(cluster.model)
        del cluster
        free()
        for k in ("kv_pack", "kv_unpack", "flash_decode", "moe_decode", "moe_route"):
            launches[k] += more[k]
        lap(f"serve {arch}")
    more = serve_moe()
    free()
    for k in ("kv_pack", "kv_unpack", "flash_decode", "moe_decode", "moe_route"):
        launches[k] += more[k]
    lap("serve published jamba")
    launches["flash_decode"] += phase_encdec()
    free()
    lap(f"model {SEAMLESS}")
    more, calls = phase_vision()
    free()
    for k in ("kv_pack", "kv_unpack", "flash_decode"):
        launches[k] += more[k]
    launches["flash_decode"] += calls
    lap(f"serve and model {INTERNVL2}")
    decide, at = phase_decide()
    decision_calls(at)
    lap("decide")
    launches["waterfill_fast"] = phase_sweep(rows)
    lap("sweep")
    sim_launches, tables = phase_simulate()
    check_waterfill_progressive(rows, tables)
    lap("simulate")
    # K1 runs on two paths: the decide phase and the simulator's scoring.
    launches["netkv_score_cohort"] = decide + sum(
        v["netkv_score_cohort"] for v in sim_launches.values())
    launches["waterfill_progressive"] = sum(
        v["waterfill_progressive"] for v in sim_launches.values())
    phase_train_smoke()
    phase_train()
    lap("train")
    phase_dryrun()
    lap("dry run")
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
