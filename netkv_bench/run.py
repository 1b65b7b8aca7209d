"""Run one cell of the port's serving benchmark once.

    python3 netkv_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a workload file under
``netkv_bench/workloads/``; its configuration and traffic files are read by
name.  The last line of standard output is the result as one JSON object;
the last lines of standard error are the numbers compared for ``correct``,
each beside its limit.  Exits non-zero, printing no result, without a CUDA
device (or with fewer than the cell asks for), without the program, or
with JAX or the JAX package loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own kernels build into ``build/kernels/`` there); one thread
    for the host's numerical libraries, so that the process that launches
    the host-paced decode steps does not share the host's cores with its
    own idle worker threads."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    _environment()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    torch.set_num_threads(1)

    from nkb import harness, spec

    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = int(cells[args.workload]["chips"]) if args.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    detail = result.pop("_detail")
    print(json.dumps({"detail": detail}, default=str), file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
