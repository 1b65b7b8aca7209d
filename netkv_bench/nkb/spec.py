"""Reading the benchmark's own files by name."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent      # netkv_bench/
ROOT = BENCH.parent                                   # the checkout


def _load(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


WORKLOAD_KEYS = {"config", "traffic", "rate_rps", "clients"}


def workload(name: str) -> dict:
    """A cell's file with its configuration and traffic files loaded
    beside it (``cfg``, ``mix``) and its own ``name``.  The file holds
    exactly ``WORKLOAD_KEYS``: an open loop's rate or a closed loop's
    clients, the other null."""
    w = _load("workloads", name)
    if set(w) != WORKLOAD_KEYS:
        raise ValueError(f"workload {name!r} holds {sorted(w)}, not {sorted(WORKLOAD_KEYS)}")
    w = dict(w, name=name)
    w["cfg"] = config(w["config"])
    w["mix"] = traffic(w["traffic"])
    return w


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a ``workloads`` key
    only in the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]
