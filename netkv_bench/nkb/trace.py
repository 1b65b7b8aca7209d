"""The traced run's profiler stretch and what is read from it.

A traced run (``--trace 1``) starts ``torch.profiler`` at a decode step's
end (the step has read its tokens back, so the device is idle) once the
stretch's start is reached, in a warm-up phase that records nothing (a
trace started cold loses the device events of its first calls, as
``chip_smoke.traced`` found), begins recording at a step's end ``warm_s``
later (a second in a benchmark's window), and stops at a step's end once
it has recorded for its length (or at the window's end).  On the card it records device activity only: recording the host's
operators too made a host-paced decode step 1.7-1.8× slower (52 → 89 ms
for internlm2-20b, 57 → 102 ms for granite-moe), which would read as
device idle time.  Device time comes from the trace's device-side events
only (kernels, copies, fills), as ``chip_smoke.traced`` sums it.  Idle gaps
are named by the benchmark's own host span (``Recorder.spans``) that holds
the gap's midpoint, the host clock mapped onto the trace's clock through
the wall-clock time read when recording began; where that mapping puts
less than half of the busy time inside a span, the gaps are left
unattributed rather than named wrongly.

A process's first session with device activity costs 7.5-9.5 s to start
on the card (CUPTI's set-up) and leaves every later kernel launch slower:
untraced decode steps of granite-moe read 49-50 ms before it and 60-70 ms
after it, and 60-65 ms all through a window whose set-up had opened one.
A session of host activity only, opened in set-up, set CUPTI up as well
(the stretch's start then took 0.002 s) and is not cheaper for launches.
So on the card set-up opens no session: the stretch is the only one, its
cold start falls inside the window, and the step metrics read the steps
before it (``harness.Run.clean_steps``).  Off the card set-up opens one
(``prime``), which loads the profiler's library (1.4-2.0 s cold on a CPU).
"""

from __future__ import annotations

import bisect
import collections
import time

from .roofline import kernel_class


class Stretch:
    def __init__(self, start_s: float, length_s: float, device_type: str,
                 warm_s: float = 1.0):
        self.start_s, self.length_s = start_s, length_s
        self.warm_s = warm_s
        self.device_type = device_type
        self.prof = None
        self.warming = False
        self.active = False
        self.done = False
        self.t_warm = self.t_on = self.t_off = None
        self.start_cost_s = self.stop_cost_s = None   # host seconds of start() and stop()
        self.wall_ns_on = self.perf_on = None     # the two clocks, read together

    def poll(self, rec, t: float) -> None:
        """Called at a step's end with the window's time ``t``."""
        if self.done:
            return
        if t >= rec.window_s:                    # the window has closed
            self.off(t)
            return
        if self.warming:
            if t - self.t_warm >= self.warm_s:
                self.perf_on, self.wall_ns_on = time.perf_counter(), time.time_ns()
                self.prof.step()                 # warm-up over: record from here
                self.warming, self.active, self.t_on = False, True, t
        elif not self.active and t >= self.start_s:
            self._on(t)
        elif self.active and t - self.t_on >= self.length_s:
            self.off(t)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CUDA] if self.device_type == "cuda" else [ProfilerActivity.CPU]
        return profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))

    def prime(self) -> None:
        """Off the card, start and stop a profiler once in set-up, which
        loads its library; on the card, nothing (see above)."""
        if self.device_type == "cuda":
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            torch.ones(8).sum()

    def _on(self, t: float) -> None:
        self.prof = self._profiler()
        c0 = time.perf_counter()
        self.prof.start()
        self.start_cost_s = time.perf_counter() - c0
        self.warming, self.t_warm = True, t

    def off(self, t: float) -> None:
        if self.warming:                         # the window closed while warming
            self.prof.stop()
            self.warming, self.done, self.prof = False, True, None
            return
        if not self.active:
            return
        import torch

        if self.device_type == "cuda":
            torch.cuda.synchronize()
        c0 = time.perf_counter()
        self.prof.stop()
        self.stop_cost_s = time.perf_counter() - c0
        self.active, self.done, self.t_off = False, True, t


def _host_spans_us(stretch: Stretch, rec) -> list[tuple[float, float, str]] | None:
    """The recorder's spans on the trace's clock (microseconds from the
    trace's start), or None where that clock cannot be read."""
    try:
        start_ns = stretch.prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        return None
    shift = stretch.wall_ns_on - start_ns - (stretch.perf_on - rec.t0) * 1e9
    return sorted(((t0 * 1e9 + shift) / 1e3, (t1 * 1e9 + shift) / 1e3, name)
                  for name, t0, t1 in rec.spans)


def _inside(spans, x: float):
    """The span holding x (the host's spans do not overlap), or None."""
    i = bisect.bisect_right(spans, (x, float("inf"), ""))
    if i and spans[i - 1][0] <= x <= spans[i - 1][1]:
        return spans[i - 1]
    return None


def summarize(stretch: Stretch, rec, moe: bool) -> dict | None:
    """Device intervals, busy and idle time, time by kernel, and the idle
    time by the host span its gaps fell in; None without a stretch that
    recorded."""
    if stretch is None or stretch.prof is None or stretch.t_off is None:
        return None
    from torch.autograd import DeviceType

    window_us = (stretch.t_off - stretch.t_on) * 1e6
    kernels = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                     for ev in stretch.prof.events()
                     if ev.device_type == DeviceType.CUDA and ev.name != "Command Buffer Full"
                     and not ev.name.startswith("ProfilerStep"))
    by_name: dict[str, float] = collections.defaultdict(float)
    by_class: dict[str, float] = collections.defaultdict(float)
    for s, e, name in kernels:
        by_name[name] += e - s
        by_class[kernel_class(name, moe)] += e - s
    # busy: the union of the device intervals; the gaps between them
    busy, gaps, runs = 0.0, [], []
    cur_s = cur_e = None
    for s, e, _ in kernels:
        if cur_e is None or s > cur_e:
            gaps.append((0.0 if cur_e is None else cur_e, s))
            if cur_e is not None:
                runs.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        runs.append((cur_s, cur_e))
        gaps.append((cur_e, window_us))
    busy = sum(e - s for s, e in runs)
    gaps = [(a, b) for a, b in gaps if b > a]
    spans = _host_spans_us(stretch, rec)
    if spans and busy > 0:
        covered = sum(e - s for s, e in runs if _inside(spans, 0.5 * (s + e)))
        if covered < 0.5 * busy:
            spans = None
    idle_by_span: dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        hit = _inside(spans, 0.5 * (a + b)) if spans else None
        name = hit[2] if hit else ("harness" if spans else "unattributed")
        idle_by_span[name] += b - a
    return dict(
        window_s=window_us / 1e6,
        busy_s=min(busy, window_us) / 1e6,
        kernel_s_by_name={k: v / 1e6 for k, v in by_name.items()},
        kernel_s_by_class={k: v / 1e6 for k, v in by_class.items()},
        idle_s_by_span={k: v / 1e6 for k, v in idle_by_span.items()},
    )


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by host span, each [name, seconds]."""
    ops = sorted(summary["kernel_s_by_name"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle_s_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [["idle in " + k, v] for k, v in idle]}
