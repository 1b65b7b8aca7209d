"""Serving launcher of the port: the real-model executable cluster.

    python -m repro_torch.launch.serve --real --arch qwen3-14b --requests 8
    python -m repro_torch.launch.serve --real --width full --requests 8

``--width smoke`` (the default) serves the smoke config in f32 with the JAX
launcher's workload; ``--width full`` serves the full-width config in its
bf16 compute dtype with 2048-token prompts, the even ones sharing a
1024-token prefix.  Without ``--real`` the launcher would run the
paper-scale simulator, which is not ported yet (ROADMAP §1).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="serve real models end to end (the only ported mode)")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--width", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="netkv-full")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    if not args.real:
        print("the simulator is not ported yet (ROADMAP §1: simulator stack); "
              "use --real", file=sys.stderr)
        return 2

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
