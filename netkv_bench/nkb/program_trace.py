"""The program's own spans of the decode path on the device trace's clock.

The program (``repro_torch.hosttrace``) records its decode steps' host spans
while a ``torch.profiler`` session records, so a traced run's stretch holds
them for exactly the steps whose kernels its device trace holds; untraced
runs, and the steps before the stretch, record nothing.  The record is
reached through ``nkb.program`` (the engine module it imports holds the
recorder's module); with a program that has no recorder every reader here
returns None and the metric is left out.

Two clocks are joined.  The spans' ``perf_counter_ns`` times are laid onto
the trace's host clock as ``trace._host_spans_us`` lays the harness's:
through a pair of ``perf_counter`` and wall-clock reads and kineto's trace
start (wall-clock ns).  The pair is the record's own (``HostTrace.clock``,
the narrowest of a few bracketed reads), not the stretch's single read,
which a host interruption between its two reads shifts
(``stretch_anchor_off_us`` reports how far the two lie apart).  The trace's
device timestamps are then laid onto its host clock: on the card they can
drift against it, a kernel read to start up to 1.9 ms before the runtime
call that launched it by the end of a 4-s stretch (~450 ppm).  Each device
event is tied to its launch call by the trace's correlation id, and the
device times are shifted by a line fitted to the lower envelope of the
events' start less their launch call (``device_clock``: the line's offset
at the stretch's start and its drift), so that the promptest starts follow
their launch at once.  A window whose promptest event queued behind
device-bound work (a long prefill in the stretch) lies far above that
envelope and is left out of the fit.

The count of device events a step launched needs none of that: each
event's launching call, found by its correlation id, lies on the host clock
(``decode_ops_step``).  The mapping is checked before the idle is read by
device time: the i-th ``k4.launch`` stamp is paired with the i-th K4 split
kernel (the first kernel of each K4 call), both taken after the stretch's
first step (kineto drops device events that read earlier than its start,
and the first step's can), and every kernel must start after its own stamp.
Where the counts differ, or a kernel starts before its stamp, the idle is
left unattributed, as ``trace.summarize`` leaves gaps.

:func:`analyze` also writes one line to standard error, ``{"program_trace":
...}``: the K4 lag from stamp to start (least, median), the line, the
stretch's idle seconds by the innermost program span holding each gap's
midpoint (the self time of ``decode.enqueue`` and ``decode.step`` apart,
and ``outside any span``), and beside them the harness's own ``idle in
decode_step`` and its mean span of the same steps.
"""

from __future__ import annotations

import bisect
import json
import statistics
import sys

import numpy as np

from . import program

K4_FIRST = "flash_decode_split"     # the first kernel of every K4 call
OUTSIDE = "outside any span"
ENVELOPE_WINDOWS = 20               # stretches of launch time the clock line is fitted over
QUEUED_US = 1000.0                  # a window's least lag this far above the median: queued


def _hosttrace():
    return getattr(program.engine_module, "hosttrace", None)


def _device_events(prof) -> list[tuple[float, float, str, float | None]]:
    """The trace's device events as ``trace.summarize`` counts them
    (kernels, copies, fills), by start, in microseconds from its start, each
    with the start of the runtime or driver call that launched it (None
    where the trace holds none)."""
    from torch.autograd import DeviceType

    events = prof.events()
    calls = {ev.id: ev.time_range.start for ev in events
             if ev.device_type == DeviceType.CPU and ev.name.startswith("cu")}
    return sorted((ev.time_range.start, ev.time_range.end, ev.name, calls.get(ev.id))
                  for ev in events
                  if ev.device_type == DeviceType.CUDA and ev.name != "Command Buffer Full"
                  and not ev.name.startswith("ProfilerStep"))


def _device_clock(events) -> tuple[float, float]:
    """``(a, b)`` of the line ``a + b * t`` that the device times run ahead
    of the host's: fitted to each window's least start-after-launch, leaving
    out the windows whose least lies more than ``QUEUED_US`` above the
    windows' median; (0, 0) where too few events have a launch call."""
    pairs = np.array([(s, s - c) for s, _, _, c in events if c is not None])
    if len(pairs) < 2 * ENVELOPE_WINDOWS:
        return 0.0, 0.0
    launch = pairs[:, 0] - pairs[:, 1]
    window = np.minimum(((launch - launch.min()) / (np.ptp(launch) or 1.0)
                         * ENVELOPE_WINDOWS).astype(int), ENVELOPE_WINDOWS - 1)
    least = np.array([pairs[window == w][np.argmin(pairs[window == w, 1])]
                      for w in range(ENVELOPE_WINDOWS) if (window == w).any()])
    # a window whose promptest event queued behind device-bound work (a long
    # prefill's GEMMs: ~125 ms) is no point of the envelope
    least = least[least[:, 1] <= np.median(least[:, 1]) + QUEUED_US]
    if len(least) < 2:
        return 0.0, 0.0
    b, a = np.polyfit(*least.T, 1)
    return float(a), float(b)


def _ops_a_step(events, steps_us) -> float | None:
    """Device events whose launching runtime call (tied by the trace's
    correlation id; a replayed graph's kernels by their ``cudaGraphLaunch``)
    starts inside one of the steps' spans, a step: on the host clock alone,
    so no device clock line is needed.  None without a step or without an
    event tied to its launch."""
    calls = sorted(c for *_, c in events if c is not None)
    if not steps_us or not calls:
        return None
    return sum(bisect.bisect_right(calls, e) - bisect.bisect_left(calls, s)
               for s, e in steps_us) / len(steps_us)


def _gaps(events, window_us: float) -> list[tuple[float, float]]:
    """The stretch's idle intervals, as ``trace.summarize`` cuts them."""
    gaps, cur_e = [], None
    for s, e, *_ in events:
        if cur_e is None or s > cur_e:
            gaps.append((0.0 if cur_e is None else cur_e, s))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        gaps.append((cur_e, window_us))
    return [(a, b) for a, b in gaps if b > a]


class StepSpans:
    """The record's complete decode steps inside the stretch, each with its
    children: ``steps[k]`` is the span index of step k, ``enqueue[k]`` and
    ``readback[k]`` its children's, ``layers[k]`` the enqueue's children."""

    def __init__(self, ht, rec, lo_ns: float, hi_ns: float):
        self.ht, self.rec = ht, rec
        kids: dict[int, list[int]] = {}
        for j, p in enumerate(rec.parent):
            kids.setdefault(p, []).append(j)
        self.kids = kids
        self.steps, self.enqueue, self.readback, self.layers = [], [], [], []
        for i in kids.get(-1, []):
            if rec.name[i] != ht.STEP or rec.t1[i] < 0 or rec.t0[i] < lo_ns or rec.t1[i] > hi_ns:
                continue
            by = {rec.name[j]: j for j in kids.get(i, [])}
            if ht.ENQUEUE not in by or ht.READBACK not in by:
                continue
            self.steps.append(i)
            self.enqueue.append(by[ht.ENQUEUE])
            self.readback.append(by[ht.READBACK])
            self.layers.append(kids.get(by[ht.ENQUEUE], []))

    def dur_ms(self, i: int) -> float:
        return (self.rec.t1[i] - self.rec.t0[i]) / 1e6

    def mean_ms(self, spans) -> float:
        return sum(self.dur_ms(i) for i in spans) / len(spans)

    def layer_ms(self, name: int) -> float:
        """Per step, the sum of the enqueue's ``name`` children; their mean."""
        rec = self.rec
        return sum(self.dur_ms(j) for layers in self.layers for j in layers
                   if rec.name[j] == name) / len(self.steps)

    def segments(self, to_us) -> list[tuple[float, float, str]]:
        """Each step's time cut by the innermost span holding it, by start."""
        out: list[tuple[float, float, str]] = []
        rec, names = self.rec, self.ht.NAMES

        def walk(i):
            label = names[rec.name[i]]
            inner = [j for j in self.kids.get(i, []) if rec.t1[j] >= 0]
            if inner and rec.name[i] in (self.ht.STEP, self.ht.ENQUEUE):
                label += " (self)"
            t = rec.t0[i]
            for j in inner:
                out.append((to_us(t), to_us(rec.t0[j]), label))
                walk(j)
                t = rec.t1[j]
            out.append((to_us(t), to_us(rec.t1[i]), label))

        for i in self.steps:
            walk(i)
        return sorted(s for s in out if s[1] > s[0])


def _label(segments, starts, x: float) -> str:
    k = bisect.bisect_right(starts, x) - 1
    if k >= 0 and segments[k][0] <= x <= segments[k][1]:
        return segments[k][2]
    return OUTSIDE


def _device_side(run, st: StepSpans, ht, hi_ns: float) -> dict:
    stretch = run.rec.stretch
    try:
        start_ns = stretch.prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        return {"trusted": False}
    rec = st.rec
    offset = rec.clock[1] - rec.clock[0]          # wall minus perf_counter, ns
    moved = (stretch.wall_ns_on - stretch.perf_on * 1e9 - offset) / 1e3
    shift = offset - start_ns

    def to_us(t_ns):
        return (t_ns + shift) / 1e3

    raw = _device_events(stretch.prof)
    ops = _ops_a_step(raw, [(to_us(rec.t0[i]), to_us(rec.t1[i])) for i in st.steps[1:]])
    a, b = _device_clock(raw)
    events = [(s - a - b * s, e - a - b * e, name, c) for s, e, name, c in raw]
    # the K4 calls after the first step, by stamp and by launch call
    after_ns = rec.t1[st.steps[0]]
    stamps = [to_us(t) for t, n in zip(rec.stamp_t, rec.stamp_name)
              if n == ht.K4_LAUNCH and after_ns <= t <= hi_ns]
    k4 = [s for s, _, name, c in events
          if K4_FIRST in name and (c is None or c >= to_us(after_ns))]
    lags = [k - s for s, k in zip(stamps, k4)]
    out = {"ops_a_step": ops,
           "trusted": bool(stamps) and len(stamps) == len(k4) and min(lags) > 0,
           "k4_lag_us": {"least": min(lags, default=None),
                         "median": statistics.median(lags) if lags else None,
                         "stamps": len(stamps), "kernels": len(k4)},
           "stretch_anchor_off_us": moved,
           "device_clock": {"offset_us": a + b * raw[0][0] if raw else None,
                            "drift_ppm": b * 1e6}}
    gaps = _gaps(events, (stretch.t_off - stretch.t_on) * 1e6)
    if not out["trusted"]:
        out["idle_by_program_span"] = {"unattributed": sum(e - s for s, e in gaps) / 1e6}
        return out
    segments = st.segments(to_us)
    seg_starts = [s[0] for s in segments]
    idle: dict[str, float] = {}
    for s, e in gaps:
        name = _label(segments, seg_starts, 0.5 * (s + e))
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    out["idle_by_program_span"] = idle
    return out


def analyze(run) -> dict | None:
    """The program's spans of the run's traced stretch, read once a run
    (kept on it) and reported on standard error; None where the run has no
    stretch that recorded, the program no recorder, or the record no step
    inside the stretch."""
    if "_program_trace" in vars(run):
        return run._program_trace
    run._program_trace = None
    ht, stretch = _hosttrace(), run.rec.stretch
    rec = ht.last_profiled() if ht is not None else None
    if rec is None or stretch is None or stretch.t_on is None or stretch.t_off is None:
        return None
    lo_ns, hi_ns = stretch.perf_on * 1e9, (run.rec.t0 + stretch.t_off) * 1e9
    st = StepSpans(ht, rec, lo_ns, hi_ns)
    if not st.steps:
        return None
    dev = _device_side(run, st, ht, hi_ns) if stretch.prof is not None else \
        {"trusted": False}
    harness = run.window_steps(traced=True)
    note = {"steps": len(st.steps), **dev,
            "program_step_ms": st.mean_ms(st.steps),
            "enqueue_plus_readback_ms": st.mean_ms(st.enqueue) + st.mean_ms(st.readback),
            "harness_step_ms": 1e3 * sum(s.t1 - s.t0 for s in harness) / len(harness)
            if harness else None,
            "harness_idle_in_decode_step": (run.trace or {}).get("idle_s_by_span", {})
            .get("decode_step")}
    print(json.dumps({"program_trace": note}, default=str), file=sys.stderr)
    run._program_trace = {"stretch": st, "device": dev}
    return run._program_trace


# ---------------------------------------------------------------- readers
def decode_enqueue_ms(run):
    a = analyze(run)
    return None if a is None else a["stretch"].mean_ms(a["stretch"].enqueue)


def decode_readback_ms(run):
    a = analyze(run)
    return None if a is None else a["stretch"].mean_ms(a["stretch"].readback)


def attn_host_ms(run):
    a = analyze(run)
    return None if a is None else a["stretch"].layer_ms(a["stretch"].ht.ATTN)


def ffn_host_ms(run):
    a = analyze(run)
    return None if a is None else a["stretch"].layer_ms(a["stretch"].ht.FFN)


def decode_lane_use_pct(run):
    a = analyze(run)
    if a is None:
        return None
    st = a["stretch"]
    lanes = sum(st.rec.b[i] for i in st.steps)
    return 100.0 * sum(st.rec.a[i] for i in st.steps) / lanes if lanes else None


def decode_ops_step(run):
    """Device events launched inside a ``decode.step`` span, a step, over
    the stretch's steps but its first (whose first events kineto may
    drop)."""
    a = analyze(run)
    return None if a is None else a["device"].get("ops_a_step")
