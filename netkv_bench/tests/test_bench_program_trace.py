"""The readers of the program's own decode spans (``nkb.program_trace``):
on hand-made span records and kernel lists (self time, device events
launched inside and outside steps, the clock check refused, the clock line
past a window queued behind a prefill, nothing without a stretch), in a
traced rehearsal on the CPU, and the rule that only ``nkb.program``
imports the program."""

import ast
import types

import numpy as np
import pytest
from torch.autograd import DeviceType

import _paths
from nkb import harness, program, program_trace

ht = program.engine_module.hosttrace
PERF_ON_S = 1.0                   # the stretch began recording at perf_counter 1.0 s
WALL_NS_ON = 7_000                # ... and at wall clock 7 us, the trace's start
SPANS = ("decode_enqueue_ms.batch", "decode_readback_ms.batch", "attn_host_ms.batch",
         "ffn_host_ms.batch", "decode_lane_use_pct.batch")
OPS = "decode_ops_step.batch"


def _ns(us):
    """A perf_counter_ns time ``us`` microseconds after the stretch began."""
    return int(PERF_ON_S * 1e9 + us * 1e3)


def _record(steps, stamps=()):
    """A record of decode steps, each (t0, t1, enqueue, readback, layers,
    active) in microseconds, ``layers`` as (name, t0, t1); and K4 stamps."""
    rec = ht.HostTrace()
    rec.clock = (int(PERF_ON_S * 1e9), WALL_NS_ON)

    def span(name, t0, t1, parent, a=0, b=0):
        rec.name.append(name)
        rec.t0.append(_ns(t0))
        rec.t1.append(_ns(t1))
        rec.parent.append(parent)
        rec.a.append(a)
        rec.b.append(b)
        return len(rec.t0) - 1

    for t0, t1, enq, rb, layers, active in steps:
        i = span(ht.STEP, t0, t1, -1, active, 4)
        e = span(ht.ENQUEUE, *enq, i)
        for k, (name, a, b) in enumerate(layers):
            span(name, a, b, e, k // 2)
        span(ht.READBACK, *rb, i)
    for s in stamps:
        rec.stamp_name.append(ht.K4_LAUNCH)
        rec.stamp_t.append(_ns(s))
        rec.stamp_parent.append(-1)
    return rec


def _events(kernels, late_us=0.0, drift=0.0):
    """Device events and their launch calls (5 us before each start, on the
    host clock); the device clock reads ``late_us + drift * t`` ahead."""
    out = []
    for i, (name, start, end) in enumerate(kernels):
        dev = [t + late_us + drift * t for t in (start, end)]
        out.append(types.SimpleNamespace(name=name, device_type=DeviceType.CUDA, id=i,
                                         time_range=types.SimpleNamespace(start=dev[0],
                                                                          end=dev[1])))
        out.append(types.SimpleNamespace(name="cudaLaunchKernel", device_type=DeviceType.CPU,
                                         id=i, time_range=types.SimpleNamespace(
                                             start=start - 5, end=start - 2)))
    return out


def _run(kernels, window_us=2000.0, profiled=True, late_ns=0, **device_clock):
    """A run whose stretch read its wall clock ``late_ns`` after its
    perf_counter."""
    prof = types.SimpleNamespace(
        events=lambda: _events(kernels, **device_clock),
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: WALL_NS_ON)))
    stretch = types.SimpleNamespace(perf_on=PERF_ON_S, wall_ns_on=WALL_NS_ON + late_ns, t_on=0.5,
                                    t_off=0.5 + window_us / 1e6, prof=prof if profiled else None)
    rec = types.SimpleNamespace(stretch=stretch, t0=PERF_ON_S - 0.5)
    return types.SimpleNamespace(rec=rec, trace=None, window_steps=lambda traced=None: [])


@pytest.fixture
def recorded(monkeypatch):
    def use(rec):
        fake = types.SimpleNamespace(**{k: getattr(ht, k) for k in
                                        ("NAMES", "STEP", "ENQUEUE", "READBACK", "ATTN", "FFN",
                                         "K4_LAUNCH")}, last_profiled=lambda: rec)
        monkeypatch.setattr(program_trace, "_hosttrace", lambda: fake)
    return use


def _read(run):
    return {name: harness.load_reader(name)(run) for name in SPANS + (OPS,)}


# Two steps: [0, 1000) and [1200, 1900) us; the first holds its enqueue
# [100, 800) with attention [200, 400) and FFN [400, 700), then its readback
# [800, 950); the second likewise, shifted by 1200.
LAYERS = [(ht.ATTN, 200, 400), (ht.FFN, 400, 700)]
STEPS = [(0, 1000, (100, 800), (800, 950), LAYERS, 1),
         (1200, 1900, (1250, 1700), (1700, 1850), [(ht.ATTN, 1300, 1400), (ht.FFN, 1400, 1600)],
          2)]
STAMPS = [210, 1310]
KERNELS = [("void flash_decode_split_kernel<float, 8>", 230, 260),
           ("void flash_decode_combine_kernel<float>", 260, 270),
           ("gemv", 500, 600), ("argmax", 790, 900),         # busy through enqueue's end
           ("copy", 940, 955), ("fill", 985, 1005),
           ("void flash_decode_split_kernel<float, 8>", 1330, 1350),
           ("gemv", 1450, 1460), ("gemv", 1950, 1960)]        # the last outside any step


def test_span_readers_and_self_time(recorded, capsys):
    recorded(_record(STEPS, STAMPS))
    run = _run(KERNELS)
    got = _read(run)
    assert got["decode_enqueue_ms.batch"] == pytest.approx((0.7 + 0.45) / 2)
    assert got["decode_readback_ms.batch"] == pytest.approx(0.15)
    assert got["attn_host_ms.batch"] == pytest.approx((0.2 + 0.1) / 2)
    assert got["ffn_host_ms.batch"] == pytest.approx((0.3 + 0.2) / 2)
    assert got["decode_lane_use_pct.batch"] == pytest.approx(100 * 3 / 8)
    # the second step (the first is not counted) launched 2 of the 9 kernels
    assert got[OPS] == pytest.approx(2)
    dev = program_trace.analyze(run)["device"]
    # the K4 call after the first step; too few events to fit a clock line
    assert dev["k4_lag_us"] == {"least": 20, "median": 20, "stamps": 1, "kernels": 1}
    assert dev["device_clock"] == {"offset_us": 0.0, "drift_ppm": 0.0}
    idle = {k: round(v * 1e6, 6) for k, v in dev["idle_by_program_span"].items()}
    # the gaps, each named by the span holding its midpoint
    assert idle == {
        "decode.enqueue (self)": 230,        # [0, 230)
        "layer.attn": 230,                   # [270, 500)
        "layer.ffn": 190 + 100,              # [600, 790), [1350, 1450)
        "decode.readback": 40 + 490,         # [900, 940), [1460, 1950)
        "decode.step (self)": 30,            # [955, 985)
        "outside any span": 325 + 40,        # [1005, 1330), [1960, 2000)
    }
    assert "program_trace" in capsys.readouterr().err


def test_the_records_clock_pair_maps_the_spans(recorded):
    """A stretch whose two clock reads an interruption split 100 us apart
    moves nothing: the record's own pair maps the spans."""
    recorded(_record(STEPS, STAMPS))
    run = _run(KERNELS, late_ns=100_000)
    assert _read(run)[OPS] == pytest.approx(2)
    dev = program_trace.analyze(run)["device"]
    assert dev["trusted"] and dev["stretch_anchor_off_us"] == pytest.approx(100)


# 48 short copies between the steps, launched 5 us before each starts
COPIES = [("copy", t, t + 2) for t in range(1008, 1200, 4)]


@pytest.mark.parametrize("late_us,drift", [(-300.0, -0.002), (250.0, 0.0005)])
def test_a_drifting_device_clock_is_laid_on_the_host_clock(recorded, late_us, drift):
    """Device timestamps that run ahead of or behind the host's by an offset
    and a rate read as if they had not: the line fitted to each event's
    start after its launch call takes both out."""
    recorded(_record(STEPS, STAMPS))
    plain = program_trace.analyze(_run(KERNELS + COPIES))["device"]
    recorded(_record(STEPS, STAMPS))
    run = _run(KERNELS + COPIES, late_us=late_us, drift=drift)
    got = program_trace.analyze(run)["device"]
    assert plain["trusted"] and got["trusted"]
    assert got["ops_a_step"] == plain["ops_a_step"] == 2
    assert got["k4_lag_us"]["least"] == pytest.approx(plain["k4_lag_us"]["least"]) == 15
    assert set(got["idle_by_program_span"]) == set(plain["idle_by_program_span"])
    for k, v in plain["idle_by_program_span"].items():
        assert got["idle_by_program_span"][k] == pytest.approx(v, abs=1e-9 + abs(drift) * v)
    assert got["device_clock"]["drift_ppm"] == pytest.approx(drift * 1e6, rel=1e-2)
    assert plain["device_clock"] == pytest.approx({"offset_us": 5.0, "drift_ppm": 0.0})


def test_refused_clock_leaves_the_device_metric_out(recorded):
    """The second K4 kernel, the one after the first step, starts before its
    stamp: the idle by program span is left unattributed, while the count of
    device events a step, on the host clock alone, still reads."""
    recorded(_record(STEPS, [210, 1340]))
    run = _run(KERNELS)
    got = _read(run)
    assert got[OPS] == pytest.approx(2)
    assert all(got[name] is not None for name in SPANS)
    dev = program_trace.analyze(run)["device"]
    assert not dev["trusted"] and set(dev["idle_by_program_span"]) == {"unattributed"}


def test_unequal_counts_leave_the_device_metric_out(recorded):
    recorded(_record(STEPS, STAMPS + [1500]))
    run = _run(KERNELS)
    assert _read(run)[OPS] == pytest.approx(2)
    dev = program_trace.analyze(run)["device"]
    assert not dev["trusted"] and set(dev["idle_by_program_span"]) == {"unattributed"}


@pytest.mark.parametrize("late_us", [-300.0, 2000.0])
def test_ops_are_counted_where_the_device_clock_is_off(recorded, late_us):
    """A device clock shifted by hundreds of microseconds or by 2 ms, with
    too few events to fit its line.  Shifted back, the K4 kernel starts
    before its stamp and the check refuses: the reader that counted device
    starts inside the steps, where the check held, read None.  Shifted on,
    the check holds but no start lies inside the second step: it read 0.
    The count by each event's launching call reads the step's 2 events."""
    recorded(_record(STEPS, STAMPS))
    run = _run(KERNELS, late_us=late_us)
    dev = program_trace.analyze(run)["device"]
    assert dev["device_clock"] == {"offset_us": 0.0, "drift_ppm": 0.0}
    assert dev["trusted"] is (late_us > 0)
    if dev["trusted"]:
        assert not any(1200 <= s + late_us <= 1900 for _, s, _ in KERNELS)
    assert _read(run)[OPS] == pytest.approx(2)


def test_clock_line_leaves_out_a_window_queued_behind_a_prefill():
    """Forty events in each of 20 windows of a 4-s stretch, each started
    10-22 us after its launch on a device clock 250 us ahead and drifting
    450 ppm; in one window every event waited 125 ms behind a prefill's
    GEMMs.  The line is the one fitted without that window; fitted with it,
    it would be far off."""
    a0, b0 = 250.0, 450e-6
    events = []
    for i in range(800):
        c = 5000.0 * i                                   # launches 5 ms apart
        lag = 10.0 + 3 * (i % 5) + (125_000.0 if 7 * 40 <= i < 8 * 40 else 0.0)
        s = c + lag + a0 + b0 * c
        events.append((s, s + 2.0, "gemv", c))
    a, b = program_trace._device_clock(events)
    clean = [e for k, e in enumerate(events) if not 7 * 40 <= k < 8 * 40]
    assert (a, b) == pytest.approx(program_trace._device_clock(clean))
    assert b * 1e6 == pytest.approx(b0 * 1e6, rel=1e-2)
    least = np.array([(s, s - c) for k, (s, _, _, c) in enumerate(events) if k % 40 == 0])
    b_all, _ = np.polyfit(*least.T, 1)
    assert abs(b_all - b0) * 1e6 > 1000                  # the fit it replaced: off by ms/s


def test_nothing_without_a_stretch_or_a_recorder(recorded, monkeypatch):
    recorded(_record(STEPS, STAMPS))
    run = _run(KERNELS)
    run.rec.stretch = None
    assert all(v is None for v in _read(run).values())
    run = _run(KERNELS, profiled=False)                # a stretch that never recorded
    run.rec.stretch.t_off = None
    assert all(v is None for v in _read(run).values())
    monkeypatch.setattr(program_trace, "_hosttrace", lambda: None)   # a program without it
    assert all(v is None for v in _read(_run(KERNELS)).values())


def test_steps_outside_the_stretch_are_not_read(recorded):
    late = [(2500, 2600, (2510, 2580), (2580, 2590), LAYERS[:0], 4)]
    recorded(_record(STEPS + late, STAMPS))
    assert _read(_run(KERNELS))["decode_lane_use_pct.batch"] == pytest.approx(100 * 3 / 8)


@pytest.mark.parametrize("cell", ["dense-smoke.smoke-open", "moe-smoke.smoke-closed"])
def test_rehearsal_reports_the_program_spans(cell):
    before = ht.last_profiled()
    r = harness.run_cell(cell, 2 ** 31 + 101, 1.5, False, device="cpu")
    assert r["correct"] and ht.last_profiled() is before   # untraced: nothing recorded
    r = harness.run_cell(cell, 2 ** 31 + 101, 1.5, True, device="cpu")
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(SPANS) <= set(m)
    assert m["decode_lane_use_pct.batch"] == 25.0          # one request on 4 slots
    assert m["attn_host_ms.batch"] + m["ffn_host_ms.batch"] <= m["decode_enqueue_ms.batch"]
    assert 0 < m["decode_readback_ms.batch"] < m["decode_enqueue_ms.batch"]
    assert ht.RECORDER is None or ht.RECORDER is ht.last_profiled()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_only_the_program_module_imports_the_program():
    sources = [p for p in _paths.BENCH.rglob("*.py") if "tests" not in p.parts]
    importers = sorted(str(p.relative_to(_paths.BENCH)) for p in sources
                       if "repro_torch" in set(_imports(p)))
    assert importers == ["nkb/program.py"]
