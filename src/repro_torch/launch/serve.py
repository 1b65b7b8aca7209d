"""Serving launcher of the port: the paper-scale disaggregated cluster
simulation, or the real-model executable cluster.

    python -m repro_torch.launch.serve --profile rag --scheduler netkv-full
    python -m repro_torch.launch.serve --profile rag --device cpu
    python -m repro_torch.launch.serve --real --arch qwen3-14b --requests 8
    python -m repro_torch.launch.serve --real --width full --requests 8

Without ``--real`` it runs ``run_sim`` on the 64-GPU default cluster with
the ``--arch`` KV-size model and prints the JAX launcher's lines.  The
netkv rungs score through the ``netkv_score_cohort`` kernel on
``--device`` (default: the CUDA card); ``--device cpu`` scores through its
plain PyTorch version.

With ``--real``, ``--width smoke`` (the default) serves the smoke config in
f32 with the JAX launcher's workload; ``--width full`` serves the full-width
config in its bf16 compute dtype with 2048-token prompts, the even ones
sharing a 1024-token prefix.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

FULL = dict(n_prefill=2, n_decode=4, n_slots=4, cache_len=4096, background=0.2,
            prompt_len=2048, prefix_len=1024, max_new=16, gap=0.05)
SMOKE = dict(n_prefill=2, n_decode=4, n_slots=4, cache_len=64, background=0.2,
             prompt_len=24, prefix_len=0, max_new=8, gap=0.02)


def model_config(arch: str, width: str):
    from ..configs import get_spec

    spec = get_spec(arch)
    if width == "full":
        return spec.model
    return dataclasses.replace(spec.smoke, compute_dtype=torch.float32)


def make_requests(vocab: int, n: int, seed: int, *, prompt_len: int,
                  prefix_len: int, max_new: int, gap: float, **_):
    """``n`` requests at ``arrival = gap * i``; with ``prefix_len`` > 0 the
    even ones share a prefix of that many tokens."""
    from ..serving import ServeRequest

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=prefix_len)
    reqs = []
    for i in range(n):
        if prefix_len and i % 2 == 0:
            prompt = np.concatenate([shared, rng.integers(0, vocab, prompt_len - prefix_len)])
        else:
            prompt = rng.integers(0, vocab, size=prompt_len)
        reqs.append(ServeRequest(i, prompt, max_new=max_new, arrival=i * gap))
    return reqs


def build_cluster(cfg, workload: dict, *, scheduler: str, seed: int, device=None,
                  params=None):
    from ..serving import DisaggregatedCluster

    return DisaggregatedCluster(
        cfg, scheduler=scheduler, n_prefill=workload["n_prefill"],
        n_decode=workload["n_decode"], n_slots=workload["n_slots"],
        cache_len=workload["cache_len"], seed=seed,
        background=workload["background"], params=params, device=device)


def simulate(args) -> int:
    """The JAX launcher's simulator branch (``repro/launch/serve.py:52-73``)."""
    from ..configs import get_spec
    from ..kernels import build
    from ..sim import FaultEvent, SimConfig, run_sim
    from ..traces import generate_trace, profile_capacity

    kv = get_spec(args.arch).kv_spec()
    cap = profile_capacity(args.profile, kv_bytes_per_token=kv.kv_bytes_per_token or 1.0)
    trace = generate_trace(args.profile, duration=22.0,
                           target_rps=cap * args.rate, seed=args.seed)
    faults = [FaultEvent(time=8.0, kind="kill_decode", instance_id=5)] if args.faults else []
    device = build.resolve_device(args.device)
    # Every netkv rung is a NetKVFull and takes the kernel scoring backend.
    sched_kw = dict(backend="kernel", device=device) if args.scheduler.startswith("netkv") else {}
    cfg = SimConfig(scheduler=args.scheduler, seed=args.seed, kv_spec=kv,
                    background=args.background, faults=faults,
                    scheduler_kwargs=sched_kw)
    launches = build.LAUNCHES["netkv_score_cohort"]
    m = run_sim(cfg, trace)
    print(f"{args.scheduler} on {args.profile} ({args.arch} KV) @ {args.rate:.0%}:")
    print(f"  TTFT mean={m.ttft_mean*1e3:.0f}ms p99={m.ttft_p99*1e3:.0f}ms")
    print(f"  TBT  mean={m.tbt_mean*1e3:.2f}ms  SLO={m.slo_attainment:.3f} "
          f"goodput={m.goodput_rps:.2f}rps")
    print(f"  transfer mean={m.xfer_mean*1e3:.0f}ms  tiers "
          f"2:{m.tier_fraction[2]:.2f} 3:{m.tier_fraction[3]:.2f}")
    if args.faults:
        print(f"  requeues after failure: {m.requeues}")
    if sched_kw and device.type == "cuda":
        print(f"  netkv_score_cohort launches on {device}: "
              f"{build.LAUNCHES['netkv_score_cohort'] - launches}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="serve real models end to end instead of simulating")
    ap.add_argument("--arch", default="qwen3-14b",
                    help="the model served with --real; the KV-size model of "
                         "the simulator")
    ap.add_argument("--width", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="netkv-full")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--profile", default="rag",
                    choices=["chatbot", "rag", "long_context"])
    ap.add_argument("--rate", type=float, default=1.0, help="fraction of capacity")
    ap.add_argument("--background", type=float, default=0.2)
    ap.add_argument("--faults", action="store_true",
                    help="inject a decode-instance failure mid-run")
    args = ap.parse_args(argv)
    if not args.real:
        return simulate(args)

    workload = FULL if args.width == "full" else SMOKE
    cfg = model_config(args.arch, args.width)
    cluster = build_cluster(cfg, workload, scheduler=args.scheduler,
                            seed=args.seed, device=args.device)
    reqs = make_requests(cfg.vocab_size, args.requests, args.seed, **workload)
    t0 = time.perf_counter()
    results = cluster.serve(reqs)
    wall = time.perf_counter() - t0
    for r in results:
        print(f"req{r.request_id}: decode@{r.decode_instance} tier{r.tier} "
              f"xfer={r.transfer_bytes / 1e3:.0f}KB ttft={r.ttft * 1e3:.0f}ms "
              f"tokens={r.tokens[:8]}")
    print(f"served {len(results)} requests on {cluster.device} in {wall:.2f}s wall")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
