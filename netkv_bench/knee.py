"""The sweep that finds an open-loop cell's knee: the highest rate whose
backlog does not grow over the window.  Run once when a cell is defined;
the rate chosen is written into the cell's workload file as a number.

    python3 netkv_bench/knee.py --workload <cell> --rates 0.5,0.6,0.7,100 --seconds 40

One process draws the weights once and serves the cell's sequence at each
rate on a fresh cluster (a rate of 100 req/s has every request due at
once: its completions a second are the sequential server's capacity).
Prints one JSON line a rate: requests due, started and finished in the
window, the backlog (due and not yet started) at each tenth of it, and the
mean service time from prefill start to last token.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
    import torch

    from nkb import harness, program, spec, traffic, weights
    from nkb.spans import Recorder, Req

    dev = torch.device(args.device)
    w = spec.workload(args.workload)
    cfg, mix, deploy = w["cfg"], w["mix"], w["cfg"]["deployment"]
    wts = weights.draw(cfg, args.seed, dev)
    mcfg = program.model_config(cfg)
    model = program.model_with(mcfg, wts)
    for rate in (float(r) for r in args.rates.split(",")):
        reqs = traffic.sequence(mix, rate)
        prompts = traffic.prompt_tokens(args.seed, [r.prompt_len for r in reqs],
                                        int(cfg["vocab_size"]))
        c = program.cluster(mcfg, model, deploy, args.seed, dev)
        rec = Recorder(args.seconds)
        rec.install(c, program.cluster_module, program.engine_module)
        warm = prompts[:2]
        for i, p in enumerate(warm):
            rec.reqs[harness.WARMUP_ID + i] = Req(harness.WARMUP_ID + i, len(p), 4, 0.0)
        program.serve(c, [(harness.WARMUP_ID + i, p, 4, 0.0) for i, p in enumerate(warm)])
        rec.reqs.clear()
        rec.start_window()
        harness._open_loop(rec, c, program.serve, reqs, prompts, args.seconds,
                           int(deploy["n_decode"]) * int(deploy["n_slots"]))
        rec.uninstall()
        program.free_of(c)
        rs = list(rec.reqs.values())
        started = [r for r in rs if r.prefill_start is not None]
        done = [r for r in rs if r.finished and r.token_times]
        marks = [args.seconds * k / 10 for k in range(1, 11)]
        backlog = [sum(1 for r in rs if r.due_s <= t and (r.prefill_start is None
                                                          or r.prefill_start > t))
                   for t in marks]
        service = [r.token_times[-1] - r.prefill_start for r in done]
        print(json.dumps(dict(rate=rate, due=len(rs), started=len(started), finished=len(done),
                              backlog=backlog,
                              mean_service_s=sum(service) / len(service) if service else None,
                              finished_per_s=len(done) / args.seconds)), flush=True)
        del c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
