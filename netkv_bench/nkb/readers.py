"""The arithmetic behind the metric readers in ``metrics/``: each reader
file names its metric and calls one of these.  A reader that finds nothing
to read returns None, and the harness leaves the metric out."""

from __future__ import annotations

from . import stacks, stats
from .roofline import HBM_BYTES_S, bound, k4_call_bytes


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _outside_stretch(run, t0: float, t1: float) -> bool:
    st = run.rec.stretch
    if st is None or st.t_warm is None:
        return True
    off = st.t_off if st.t_off is not None else float("inf")
    return t1 <= st.t_warm or t0 >= off


# ---------------------------------------------------------------- end to end
def out_tok_s(run):
    return stats.tokens_in_window(run.requests, run.window_s) / run.window_s


def setup_s(run):
    return run.setup_s


# ---------------------------------------------------------------- per layer
def _walls(run, key):
    """Mean of ``cluster.walls[*][key]`` over the window's finished requests
    whose prefill, transfer and first step lie outside the traced stretch."""
    reqs = run.rec.reqs
    keep = []
    for w in run.walls:
        r = reqs.get(w["request_id"])
        if r is None or r.prefill_start is None:
            continue
        end = r.token_times[0] if r.token_times else r.prefill_end
        if _outside_stretch(run, r.prefill_start, end):
            keep.append(w[key])
    v = _mean(keep)
    return None if v is None else v * 1e3


def prefill_ms(run):
    return _walls(run, "prefill_s")


def transfer_ms(run):
    return _walls(run, "transfer_s")


def decode_step_ms(run):
    v = _mean(s.t1 - s.t0 for s in run.clean_steps())
    return None if v is None else v * 1e3


def flash_decode_roofline(run):
    """K4 of the traced steps: bytes of each call's inputs (all lanes, the
    rows the step's position gives each; one call an attention layer) over
    K4's device time."""
    if run.trace is None:
        return None
    dev = run.trace["kernel_s_by_class"].get("flash_decode", 0.0)
    steps = run.window_steps(traced=True)
    if not steps or dev <= 0:
        return None
    nbytes = 0
    for s in steps:
        if isinstance(s.rows, list):
            call = k4_call_bytes(run.dims, s.lanes, 0) + \
                2 * sum(s.rows) * run.dims.kv_row_bytes
        else:
            call = k4_call_bytes(run.dims, s.lanes, s.rows)
        nbytes += run.dims.attn_layers * call
    return 100.0 * nbytes / HBM_BYTES_S / dev


def decode_mfu(run):
    """The decode steps' useful work (the layer stack's ``decode_step_work``)
    at the published peaks over their walls (the window's steps before the
    profiler's session): the least time of each step's bytes or operations,
    whichever binds, summed, over the summed walls."""
    steps = [s for s in run.clean_steps() if s.positions]
    if not steps:
        return None
    work = stacks.of(run.cfg).decode_step_work
    least = sum(bound(*work(run.cfg, s.positions))[0] for s in steps)
    return 100.0 * least / sum(s.t1 - s.t0 for s in steps)


def device_idle(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
