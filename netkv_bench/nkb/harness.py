"""One run of one cell: set-up, the measured window, the checks, the metrics.

Set-up (``setup_s``, from process start to the window's first due request):
the weights drawn on the device, the cluster built, and a warm-up of two
requests through ``serve()`` at the shortest and longest prompt of the
cell's sequence, which loads the kernels and grows the allocator to the
cell's working set.  The window then hands requests to ``serve()`` as they
come due: all that are due in one call, at most one per decode slot of the
cluster.  It hands none past its end; the request decoding then is served
to its end (``nkb.spans``), its tokens past the end counted nowhere.  An open loop's requests come due on its schedule; a closed
loop's clients each send their next request the moment the last one
finished (no think time).
After the window: the peak memory is read, the program's state freed, and
the checks of ``nkb.correct`` run.
"""

from __future__ import annotations

import gc
import importlib.util
import sys
import time

import numpy as np
import torch

from . import correct, spec, trace, traffic, weights
from .roofline import Dims
from .spans import Recorder, Req, WindowClosed

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_ID = 1_000_000_000
WARMUP_NEW = 4


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = spec.BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(f"nkb_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metric_entries(cell: str, trace_on: bool) -> list[dict]:
    bench = spec.benchmark()
    listed = any(w["name"] == cell for w in bench["workloads"])
    if listed:
        return spec.metrics_of(bench, cell, trace_on)
    # a cell BENCHMARK.json does not list (a rehearsal): every metric of the kind
    return bench["per_layer"] if trace_on else bench["end_to_end"]


class Run:
    """What the window and the trace recorded, as the metric readers read it."""

    def __init__(self, rec, cfg, window_s, setup_s, walls, summary):
        self.rec, self.cfg, self.dims = rec, cfg, Dims(cfg)
        self.deploy = cfg["deployment"]
        self.window_s, self.setup_s = window_s, setup_s
        self.walls = walls
        self.trace = summary

    @property
    def requests(self) -> list[Req]:
        return [r for r in self.rec.reqs.values() if r.due_s < self.window_s]

    def clean_steps(self):
        """The window's decode steps before the profiler's session began
        (all of them in an untraced run): launches after it run slower
        (``nkb.trace``)."""
        st = self.rec.stretch
        start = st.t_warm if st is not None and st.t_warm is not None else float("inf")
        return [s for s in self.window_steps(traced=False) if s.t1 <= start]

    def window_steps(self, traced: bool | None = None):
        return [s for s in self.rec.steps if s.t1 <= self.window_s
                and (traced is None or s.traced == traced)]


def _mean_ms(steps) -> float | None:
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps) if steps else None


def _timeline(rec) -> dict:
    """Where the window's time went, for the run's log: when requests
    finished, the longest gap between two decode steps, the stretch's
    times and the host seconds its profiler took to start and stop."""
    ends = sorted(r.token_times[-1] for r in rec.reqs.values() if r.finished)
    steps = sorted(rec.steps, key=lambda s: s.t0)
    gap = max(((b.t0 - a.t1, a.t1) for a, b in zip(steps, steps[1:])), default=None)
    st = rec.stretch
    split = {}
    if st is not None and st.t_warm is not None:
        inside = [s for s in steps if s.t1 <= rec.window_s]
        split = {"step_ms_before": _mean_ms([s for s in inside if s.t1 <= st.t_warm]),
                 "step_ms_after": _mean_ms([s for s in inside if st.t_off is not None
                                            and s.t0 >= st.t_off])}
    return {**split, "finished_s": [round(x, 3) for x in ends],
            "steps": len(steps), "last_step_s": steps[-1].t1 if steps else None,
            "widest_step_gap": gap,
            "stretch": None if st is None else dict(
                warm=st.t_warm, on=st.t_on, off=st.t_off,
                start_cost_s=st.start_cost_s, stop_cost_s=st.stop_cost_s)}


def _warmup_prompts(seed: int, lengths, vocab: int):
    return traffic.prompt_tokens(int(seed) + WARMUP_ID, lengths, vocab)


def _open_loop(rec, cluster, serve, reqs, prompts, window_s, max_batch):
    due = traffic.open_due_times(reqs)
    n = int(np.searchsorted(due, window_s, side="left"))
    for i in range(n):
        rec.reqs[i] = Req(i, reqs[i].prompt_len, reqs[i].max_new, float(due[i]))
    nxt = 0
    while True:
        t = rec.now()
        if t >= window_s:
            return
        batch = []
        while nxt < n and due[nxt] <= t and len(batch) < max_batch:
            batch.append(nxt)
            nxt += 1
        if not batch:
            wake = due[nxt] if nxt < n else window_s
            time.sleep(max(0.0, min(wake, window_s) - t))
            continue
        for i in batch:
            rec.reqs[i].handed_s = t
        try:
            serve(cluster, [(i, prompts[i], reqs[i].max_new, float(due[i])) for i in batch])
        except WindowClosed:
            return


def _closed_loop(rec, cluster, serve, reqs, prompts, window_s, max_batch, clients):
    next_due = [0.0] * clients
    holding = [None] * clients
    nxt = 0
    while True:
        t = rec.now()
        if t >= window_s:
            return
        batch = []
        for c in range(clients):
            if holding[c] is None and len(batch) < max_batch and next_due[c] <= t:
                if nxt >= len(reqs):
                    raise RuntimeError("the mix's sequence ran out: lengthen schedule_length")
                r = reqs[nxt]
                rec.reqs[nxt] = Req(nxt, r.prompt_len, r.max_new, next_due[c], handed_s=t)
                holding[c] = nxt
                batch.append(nxt)
                nxt += 1
        if not batch:
            time.sleep(max(0.0, min(min(next_due), window_s) - t))
            continue
        try:
            serve(cluster, [(i, prompts[i], reqs[i].max_new, rec.reqs[i].due_s) for i in batch])
        except WindowClosed:
            return
        for c in range(clients):
            r = rec.reqs.get(holding[c]) if holding[c] is not None else None
            if r is not None and r.finished:
                next_due[c] = r.token_times[-1]
                holding[c] = None


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, *, device: str = "cuda",
             t_start: float | None = None, corrupt=None, control: bool = False) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``corrupt``, for the tests of the check, is called with the built cluster
    before the window to break the timed path underneath.  ``control`` also
    reads the fp8 control's gap on the same sample (``control.py``)."""
    from . import program

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    w = spec.workload(cell)
    cfg, mix, deploy = w["cfg"], w["mix"], w["cfg"]["deployment"]
    dims = Dims(cfg)
    reqs = traffic.sequence(mix, w.get("rate_rps"))
    prompts = traffic.prompt_tokens(seed, [r.prompt_len for r in reqs], dims.vocab)

    wts = weights.draw(cfg, seed, dev)
    mcfg = program.model_config(cfg)
    model = program.model_with(mcfg, wts)
    cluster = program.cluster(mcfg, model, deploy, int(seed) % (2 ** 31), dev)
    if corrupt is not None:
        corrupt(cluster)
    rec = Recorder(seconds)
    rec.install(cluster, program.cluster_module, program.engine_module)
    if trace_on:
        start = 0.35 * seconds
        rec.stretch = trace.Stretch(start, min(4.0, 0.2 * seconds), dev.type,
                                    warm_s=min(1.0, 0.1 * seconds))
        rec.stretch.prime()

    lens = [r.prompt_len for r in reqs]
    warm_lens = [min(lens), max(lens)]
    warm = _warmup_prompts(seed, warm_lens, dims.vocab)
    for i, p in enumerate(warm):
        rec.reqs[WARMUP_ID + i] = Req(WARMUP_ID + i, len(p), WARMUP_NEW, 0.0)
    program.serve(cluster, [(WARMUP_ID + i, p, WARMUP_NEW, 0.0) for i, p in enumerate(warm)])
    for i in range(len(warm)):
        del rec.reqs[WARMUP_ID + i]
    n_warm_walls = len(cluster.walls)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    rec.start_window()
    max_batch = int(deploy["n_decode"]) * int(deploy["n_slots"])
    if mix["loop"] == "open":
        _open_loop(rec, cluster, program.serve, reqs, prompts, seconds, max_batch)
    else:
        _closed_loop(rec, cluster, program.serve, reqs, prompts, seconds, max_batch,
                     int(w["clients"]))
    if rec.stretch is not None:
        rec.stretch.off(rec.now())
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    walls = [dict(x) for x in cluster.walls[n_warm_walls:]]
    rec.uninstall()
    program.free_of(cluster)
    del cluster, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = trace.summarize(rec.stretch, rec, bool(dims.experts)) if trace_on else None
    run = Run(rec, cfg, float(seconds), setup_s, walls, summary)
    metrics = {}
    for entry in metric_entries(cell, trace_on):
        value = load_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    # checks
    window_reqs = run.requests
    picked = correct.sample(window_reqs, seed)
    (pos_gaps, pos_errs), ctrl = correct.position_gaps(
        wts, cfg, picked, prompts, dev, control=control) if picked else (([], []), None)
    bad_dec = correct.decision_mismatches(rec.decisions, deploy)
    bad_xfer = correct.transfer_mismatches(rec.packs, rec.unpacks, cfg, set(lens))
    limits = cfg["limits"]
    per_request = {"logit_gap": [float(g.max()) for g in pos_gaps],
                   "logit_rel_err": [float(e.max()) for e in pos_errs]}
    readings = {k: max(v, default=None) for k, v in per_request.items()}
    every_err = np.concatenate(pos_errs) if pos_errs else None
    readings["logit_rel_err_median"] = None if every_err is None else float(np.median(every_err))
    readings["logit_rel_err_p90"] = None if every_err is None else \
        float(np.percentile(every_err, 90))
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}
    checks["logit_gap"].update(requests=len(picked), tokens=sum(len(r.tokens) for r in picked))
    checks["decision_mismatches"] = {"value": len(bad_dec), "limit": 0}
    checks["transfer_mismatches"] = {"value": len(bad_xfer), "limit": 0}
    compared = [c for c in checks.values() if c["limit"] is not None]
    ok = bool(picked) and len(compared) > 2 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in compared)
    # requests whose own readings pass a limit, and every wrong decision or transfer
    failed = len(bad_dec) + len(bad_xfer) + sum(
        any(limits.get(k) is not None and v[i] > limits[k] for k, v in per_request.items())
        for i in range(len(picked)))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": len(window_reqs), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    if control:
        result["readings"] = {"program": (pos_gaps, pos_errs),
                              "control": ctrl[:2] if ctrl else None,
                              "margins": ctrl[2] if ctrl else None}
    result["_detail"] = {"bad_decisions": bad_dec[:5], "bad_transfers": bad_xfer[:5],
                         "gaps": per_request["logit_gap"], "errs": per_request["logit_rel_err"],
                         "sample": [r.rid for r in picked],
                         "step_ms": _mean_ms(run.window_steps(traced=False)),
                         "traced_step_ms": _mean_ms(run.window_steps(traced=True)),
                         **_timeline(rec)}
    return result
