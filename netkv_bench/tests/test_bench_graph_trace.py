"""The reader of the decode engine's CUDA graph spans (``nkb.graph_trace``)
on hand-made span records: the share of steps that replayed a graph, and
nothing from a program without the span or a run without a stretch."""

import types

import pytest

import _paths  # noqa: F401
from nkb import harness, program, program_trace

ht = program.engine_module.hosttrace
READER = "decode_graph_pct.batch"


def _record(steps):
    """Decode steps of 1 ms each, 2 ms apart; a step holds a graph span or
    two layer spans inside its enqueue."""
    rec = ht.HostTrace()
    rec.clock = (0, 0)

    def span(name, t0, t1, parent, a=0, b=0):
        for col, v in zip((rec.name, rec.t0, rec.t1, rec.parent, rec.a, rec.b),
                          (name, int(1e9 + t0 * 1e3), int(1e9 + t1 * 1e3), parent, a, b)):
            col.append(v)
        return len(rec.t0) - 1

    for k, graphed in enumerate(steps):
        t = 2000 * k
        i = span(ht.STEP, t, t + 1000, -1, 1, 4)
        e = span(ht.ENQUEUE, t + 10, t + 800, i)
        if graphed:
            span(ht.GRAPH, t + 20, t + 60, e, 256, int(k == 0))
        else:
            span(ht.ATTN, t + 20, t + 300, e)
            span(ht.FFN, t + 300, t + 700, e)
        span(ht.READBACK, t + 800, t + 990, i)
    return rec


def _run():
    stretch = types.SimpleNamespace(perf_on=1.0, wall_ns_on=0, t_on=0.5, t_off=0.5 + 1.0,
                                    prof=None)
    rec = types.SimpleNamespace(stretch=stretch, t0=0.5)
    return types.SimpleNamespace(rec=rec, trace=None, window_steps=lambda traced=None: [])


@pytest.fixture
def recorded(monkeypatch):
    def use(rec, names=("NAMES", "STEP", "ENQUEUE", "READBACK", "ATTN", "FFN", "K4_LAUNCH",
                        "GRAPH")):
        fake = types.SimpleNamespace(**{k: getattr(ht, k) for k in names},
                                     last_profiled=lambda: rec)
        monkeypatch.setattr(program_trace, "_hosttrace", lambda: fake)
    return use


@pytest.mark.parametrize("steps,want", [([True, True, False, True], 75.0),
                                        ([False, False], 0.0), ([True] * 5, 100.0)])
def test_share_of_steps_that_replayed_a_graph(recorded, steps, want):
    recorded(_record(steps))
    assert harness.load_reader(READER)(_run()) == pytest.approx(want)


def test_nothing_from_a_program_without_the_span(recorded):
    recorded(_record([False, False]), names=("NAMES", "STEP", "ENQUEUE", "READBACK", "ATTN",
                                             "FFN", "K4_LAUNCH"))
    assert harness.load_reader(READER)(_run()) is None


def test_nothing_without_a_stretch(recorded):
    recorded(_record([True]))
    run = _run()
    run.rec.stretch = None
    assert harness.load_reader(READER)(run) is None
