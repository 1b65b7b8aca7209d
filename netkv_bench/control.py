"""Readings that set a cell's limits: the program's ``logit_gap`` over many
seeds (the lower reading) and the fp8 control's on some of them (the upper
reading), in one process, each run at the cell's own load with a shorter
window than the benchmark's.  Not run by the benchmark's own runs.

    python3 netkv_bench/control.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 20

Prints one JSON line a seed: the program's widest gap, its per-request
gaps, the control's widest gap where asked, the requests and tokens
compared, the decision and transfer mismatches and, for a MoE model with
the control, where the program's largest errors sit against the float32
router's margins at the top-k edge.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def _summary(pair):
    """Over every compared position: the gaps' widest, 99th percentile and
    share of positions whose token is not the reference's best; the logits'
    relative error's widest, 99th and 90th percentile and median."""
    if not pair or not pair[0]:
        return None
    import numpy as np

    g, e = np.concatenate(pair[0]), np.concatenate(pair[1])
    return dict(gap_max=float(g.max()), gap_p99=float(np.percentile(g, 99)),
                off_share=float((g > 0).mean()), err_max=float(e.max()),
                err_p99=float(np.percentile(e, 99)), err_p90=float(np.percentile(e, 90)),
                err_median=float(np.median(e)),
                n=int(g.size))


def _outliers(errs, margins):
    """Where the program's logits' error passes twice its median: how many
    positions, and the float32 router's smallest margin there against the
    other positions' (a MoE model only)."""
    import numpy as np

    if not margins or not errs:
        return None
    e, m = np.concatenate(errs), np.concatenate(margins)
    out = e > 2.0 * np.median(e)
    low = m < np.percentile(m, 10)
    return dict(n_out=int(out.sum()), n=int(e.size),
                margin_median_out=float(np.median(m[out])) if out.any() else None,
                margin_median_rest=float(np.median(m[~out])),
                out_in_lowest_tenth=float(low[out].mean()) if out.any() else None,
                err_median_lowest_tenth=float(np.median(e[low])),
                err_median_rest=float(np.median(e[~low])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
    from nkb import harness

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                             control=seed in controls)
        r.setdefault("readings", {"program": None, "control": None, "margins": None})
        c = r["checks"]
        print(json.dumps(dict(
            seed=seed, logit_gap=c["logit_gap"]["value"],
            logit_rel_err=c["logit_rel_err"]["value"],
            logit_rel_err_median=c["logit_rel_err_median"]["value"], gaps=r["_detail"]["gaps"],
            errs=r["_detail"]["errs"], program=_summary(r["readings"]["program"]),
            control=_summary(r["readings"]["control"]),
            outliers=_outliers((r["readings"]["program"] or (None, None))[1],
                               r["readings"]["margins"]),
            requests=c["logit_gap"]["requests"], tokens=c["logit_gap"]["tokens"],
            decision_mismatches=c["decision_mismatches"]["value"],
            transfer_mismatches=c["transfer_mismatches"]["value"],
            peak=r["device"]["memory_peak_bytes"], wall_s=time.perf_counter() - t0)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
