"""Host spans of the port's decode path and prefill, on the host's ``perf_counter_ns``
clock, for laying onto a device trace.

A span is a name id (an index into ``NAMES``), a start and an end from
``time.perf_counter_ns()``, the index of its parent span (-1 at the top)
and two numeric attributes ``a`` and ``b``; a stamp is a name id, a time
and the span open when it was taken.  Both are kept in columns, one list a
field and one append a span, as ``sim/trace.py`` keeps its TracePlane.

What the serving path records:

    decode.step      DecodeEngine.step, the whole call        a = active lanes, b = lanes decoded
    decode.enqueue   the step's start through its argmax launch (child of decode.step)
    decode.readback  the step's token read, the host waiting for the device (child of decode.step)
    layer.attn       an attention block of models/model.py::_period_decode   a = layer
    layer.ffn        an FFN of _period_decode and its residual   a = layer, b = 1 for MoE
    k4.launch        (stamp) K4's launch, just before the call into the library; in a
                     replayed step one a K4 call of the graph, just before the replay
    decode.graph     the staging copy and the replay of a decode step's CUDA graph
                     (models/decode_graph.py; child of decode.enqueue)   a = the K4 plan
                     bucket's top, b = 1 where the step captured the graph first
    layer.mamba      a Mamba block (its norm, mixer and residual) of _period_seq (prefill)
                     or of the eager _period_decode   a = layer, b = tokens mixed
    prefill.run      PrefillEngine.run: the forward and its first token's read
                     (the parent of that prefill's layer.mamba spans)   a = prompt tokens

``RECORDER`` is None while recording is off.  Every site reads it once and
guards on ``is not None``, so with recording off a step pays one branch a
site and allocates nothing.  Recording is on between :func:`enable` and
:func:`disable`, and, without an explicit :func:`enable`, while a
``torch.profiler`` session records: ``DecodeEngine.step`` and
``PrefillEngine.run`` ask :func:`for_step` at their start, which follows the
profiler's state, so that the spans cover the steps and prefills whose
kernels the device trace holds.
:func:`last_profiled` returns the record of the last such session.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler

NAMES = ("decode.step", "decode.enqueue", "decode.readback", "layer.attn", "layer.ffn",
         "k4.launch", "decode.graph", "layer.mamba", "prefill.run")
STEP, ENQUEUE, READBACK, ATTN, FFN, K4_LAUNCH, GRAPH, MAMBA, PREFILL = range(len(NAMES))

_now = time.perf_counter_ns


def clock_pair(reads: int = 5) -> tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair read together, for laying the
    spans on a wall-clock trace: the middle of the narrowest of ``reads``
    ``perf_counter_ns`` brackets around a ``time_ns`` read, so that a read
    the host interrupts does not shift the pair."""
    best = None
    for _ in range(reads):
        lo = _now()
        wall = time.time_ns()
        hi = _now()
        if best is None or hi - lo < best[0]:
            best = (hi - lo, (lo + hi) // 2, wall)
    return best[1], best[2]


class HostTrace:
    """Columnar spans and stamps of one recording, and the clock pair read
    when it began (:func:`clock_pair`)."""

    __slots__ = ("name", "t0", "t1", "parent", "a", "b",
                 "stamp_name", "stamp_t", "stamp_parent", "clock", "_open")

    def __init__(self):
        self.clock = clock_pair()
        self.name: list[int] = []
        self.t0: list[int] = []
        self.t1: list[int] = []       # -1 while the span is open
        self.parent: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self.stamp_name: list[int] = []
        self.stamp_t: list[int] = []
        self.stamp_parent: list[int] = []
        self._open = -1               # the innermost open span

    def begin(self, name: int, a: int = 0, b: int = 0) -> int:
        """Open a span inside the innermost open one; returns its index."""
        t = _now()
        i = len(self.t0)
        self.name.append(name)
        self.t0.append(t)
        self.t1.append(-1)
        self.parent.append(self._open)
        self.a.append(a)
        self.b.append(b)
        self._open = i
        return i

    def end(self, i: int) -> None:
        self.t1[i] = _now()
        self._open = self.parent[i]

    def stamp(self, name: int) -> None:
        self.stamp_t.append(_now())
        self.stamp_name.append(name)
        self.stamp_parent.append(self._open)

    def __len__(self) -> int:
        return len(self.t0)


RECORDER: HostTrace | None = None
_by_profiler = False               # RECORDER was switched on by a profiler session
_profiled: HostTrace | None = None  # the record of the last profiler session


def enable() -> HostTrace:
    """Switch recording on, into a new record, until :func:`disable`."""
    global RECORDER, _by_profiler
    RECORDER, _by_profiler = HostTrace(), False
    return RECORDER


def disable() -> HostTrace | None:
    """Switch recording off; returns the record (None if it was off)."""
    global RECORDER, _by_profiler
    rec, RECORDER, _by_profiler = RECORDER, None, False
    return rec


def for_step() -> HostTrace | None:
    """The recorder for a decode step or a prefill about to start.  An explicit
    :func:`enable` holds until :func:`disable`; otherwise recording follows
    ``torch.profiler``: on, into a new record, once a session records, and
    off at the first step after it stopped."""
    global RECORDER, _by_profiler, _profiled
    on = _profiler._is_profiler_enabled
    if on and RECORDER is None:
        RECORDER = _profiled = HostTrace()
        _by_profiler = True
    elif not on and _by_profiler:
        RECORDER, _by_profiler = None, False
    return RECORDER


def last_profiled() -> HostTrace | None:
    """The record of the last ``torch.profiler`` session that decode steps
    or prefills ran in (still growing while the session records), or None."""
    return _profiled
