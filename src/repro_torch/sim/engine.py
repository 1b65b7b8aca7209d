# The port's own copy of repro/sim/engine.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Deterministic discrete-event engines: heap-based ``EventLoop`` (the
bit-exact reference) and the typed-lane, horizon-batched ``EventPlane``.

Both engines expose one **lane API** so client code is engine-agnostic:

* ``at``/``after``/``cancel`` — the classic per-event interface (the
  *generic* lane; callers may tag a lane for telemetry).
* ``load_cursor(lane, times, payloads, handler)`` — bulk-load a presorted
  event stream (trace arrivals, fault/rewire schedules).  On the plane the
  lane becomes an array cursor: no heap entries, no closures.
* ``arm(lane, time, fn)`` / ``disarm(lane)`` — single-slot re-armable
  timers (net completion, net tick, the instance-iteration clock).  With
  ``dedupe=True`` re-arming at the unchanged requested time is a no-op
  that draws no sequence number — exactly the short-circuit the clock's
  old cancel/re-add path performed.
* ``arm_slot(lane, idx, time, fn)`` — per-index one-shot timers
  (prefill/chunk iteration finish); ``fn(idx, now)`` at fire time.
* ``lane_horizon(lane)`` / ``lane_tick`` / ``lane_ticks`` — the horizon
  batching hooks: a cohort handler dispatched from lane L may keep
  processing its own future work up to the earliest event pending on any
  *other* lane (or the run's ``until``), reporting the work it absorbed so
  ``processed`` counts and the event-order trace stay comparable.

**Sequence parity.**  Every enqueue draws one monotone sequence number in
API-call order on both engines, and ties on time break by sequence — so
two engines driven through the identical call sequence dispatch pending
events in the identical relative order.  ``tests/test_eventplane_parity``
and the hypothesis property test in ``tests/test_engine.py`` enforce this,
including same-timestamp cohorts, cancellations and the backwards-rounding
``at()`` clamp.

**Event-order trace.**  Setting ``loop.trace_log = []`` records one
``(time, lane)`` entry per dispatched event.  Horizon-batched cohort steps
buffer their entries and flush them time-sorted with same-time entries
merged — matching the reference engine, which pops one heap event per
same-timestamp cohort.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Callable, Sequence

# ---------------------------------------------------------------- lanes
LANE_GENERIC = 0   # plain at()/after() events (completions, timers, ...)
LANE_ARRIVAL = 1   # trace arrivals (cursor)
LANE_FAULT = 2     # fault schedule (cursor)
LANE_REWIRE = 3    # OCS rewire schedule (cursor)
LANE_NET = 4       # next flow-completion timer (slot)
LANE_TICK = 5      # fixed-interval network rate refresh (slot)
LANE_CLOCK = 6     # instance-iteration cohort clock (slot, horizon-batched)
LANE_ROLE = 7      # RolePlane P:D imbalance controller timer (slot)
LANE_PREFILL = 8   # per-instance prefill/chunk iteration timers (multi-slot)
N_LANES = 9
LANE_NAMES = ("generic", "arrival", "fault", "rewire", "net", "tick",
              "clock", "role", "prefill")

_CURSOR_LANES = (LANE_ARRIVAL, LANE_FAULT, LANE_REWIRE)
_SLOT_LANES = (LANE_NET, LANE_TICK, LANE_CLOCK, LANE_ROLE)

_INF = float("inf")

# ------------------------------------------------------------- profiling


class ProfileSession:
    """Per-lane / per-handler cumulative dispatch time for one profiled run.

    Each event loop binds the session active at its construction, so
    back-to-back benchmark arms in one process each debit their own
    session — ``select``-lane credit cannot leak across runs the way the
    old module-global accumulator allowed.  ``rows``: (lane name,
    handler qualname) -> [count, seconds]; the select accumulator lets
    run loops debit scheduler-select time from the owning handler's row
    and credit a dedicated ("select", ...) row instead."""

    __slots__ = ("rows", "select_s", "select_n")

    def __init__(self) -> None:
        self.rows: dict[tuple[str, str], list] = {}
        self.select_s = 0.0
        self.select_n = 0

    def note_select(self, seconds: float, name: str = "scheduler.select") -> None:
        self.select_s += seconds
        self.select_n += 1
        key = ("select", name)
        ent = self.rows.get(key)
        if ent is None:
            self.rows[key] = [1, seconds]
        else:
            ent[0] += 1
            ent[1] += seconds

    def add(self, lane: str, handler: str, dt: float) -> None:
        key = (lane, handler)
        ent = self.rows.get(key)
        if ent is None:
            self.rows[key] = [1, dt]
        else:
            ent[0] += 1
            ent[1] += dt

    def profile_rows(self) -> list[dict]:
        rows = [
            dict(lane=lane, handler=handler, events=cnt, seconds=sec,
                 us_per_event=sec / cnt * 1e6 if cnt else 0.0)
            for (lane, handler), (cnt, sec) in self.rows.items()
        ]
        rows.sort(key=lambda r: -r["seconds"])
        return rows


# The session new loops bind (``benchmarks/run.py --profile`` enables one
# for the whole process; tests create scoped ones per run).
_CURRENT: ProfileSession | None = None


def enable_profiling(on: bool = True) -> ProfileSession | None:
    """Start a fresh process-wide ProfileSession (or stop profiling).

    Returns the new session; loops constructed while it is current bind
    it for their lifetime, so re-enabling mid-process starts clean totals
    without retroactively crediting already-running loops."""
    global _CURRENT
    _CURRENT = ProfileSession() if on else None
    return _CURRENT


def note_select(seconds: float, name: str = "scheduler.select") -> None:
    """Report one scheduler-select's wall time to the current session.

    Compat shim — the simulator reports through its own loop's
    ``note_select`` so credit lands in the session that loop debits."""
    if _CURRENT is not None:
        _CURRENT.note_select(seconds, name)


def profile_rows() -> list[dict]:
    """Current session's dispatch profile as CSV-ready rows (slowest first)."""
    if _CURRENT is None:
        return []
    return _CURRENT.profile_rows()


def _handler_name(fn) -> str:
    return getattr(fn, "__qualname__", None) or repr(fn)


class Event:
    __slots__ = ("time", "seq", "fn", "cancelled", "lane",
                 "slot_idx", "slot_fn")

    def __init__(self, time: float, seq: int, fn: Callable[[float], None],
                 lane: int = LANE_GENERIC):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.cancelled = False
        self.lane = lane
        # arm_slot() wraps the handler in a closure; drain_due() needs the
        # raw (idx, fn) pair to recognise same-handler events, so arm_slot
        # records them here.  None for every other enqueue path.
        self.slot_idx = None
        self.slot_fn = None

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventLoop:
    """Single-heap engine: one entry per event, lazy cancellation.

    Kept as the bit-exact parity oracle (``SimConfig.event_engine=
    "reference"``); the lane methods below translate one-for-one into the
    same ``at``/``cancel`` sequences the pre-lane call sites performed, so
    the heap sees identical (time, seq) streams.
    """

    batched = False   # no horizon batching: lane_horizon() yields nothing

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.processed = 0
        self._live = 0  # pending non-cancelled events (O(1) empty())
        self.profile = _CURRENT  # ProfileSession bound for this loop's life
        # Single-slot lanes: lane -> (requested_time, Event).  The event is
        # consumed in-place by run() (cancelled=True), so arm() after a
        # fire re-arms without a cancel — the behaviour the old per-site
        # ``self._net_event = None`` bookkeeping implemented by hand.
        self._slots: list[tuple[float, Event] | None] = [None] * N_LANES
        self.trace_log: list[tuple[float, int]] | None = None

    def at(self, time: float, fn: Callable[[float], None],
           lane: int = LANE_GENERIC) -> Event:
        if time < self.now - 1e-12:
            time = self.now  # clamp: callbacks may round slightly backwards
        ev = Event(max(time, self.now), next(self._seq), fn, lane)
        heapq.heappush(self._heap, ev)
        self._live += 1
        return ev

    def after(self, delay: float, fn: Callable[[float], None],
              lane: int = LANE_GENERIC) -> Event:
        return self.at(self.now + max(delay, 0.0), fn, lane)

    def cancel(self, ev: Event) -> None:
        if not ev.cancelled:
            ev.cancelled = True
            self._live -= 1
            # Heap hygiene: cancelled events linger until popped (lazy
            # deletion), so a cancel-heavy drive (fault/rewire churn
            # re-arming completion timers) can balloon the heap with
            # corpses.  Compact when they outnumber the live entries.
            heap = self._heap
            if len(heap) > 64 and len(heap) - self._live > self._live:
                self._heap = [e for e in heap if not e.cancelled]
                heapq.heapify(self._heap)

    # ------------------------------------------------------------ lane API
    def load_cursor(self, lane: int, times: Sequence[float], payloads,
                    handler) -> None:
        """Bulk-load a schedule; ``handler(payload, now)`` per entry.

        Equivalent to the in-order ``at()`` loop the call sites used to
        run — one sequence number per entry, same clamping.
        """
        for t, p in zip(times, payloads):
            self.at(t, (lambda now, p=p, h=handler: h(p, now)), lane=lane)

    def arm(self, lane: int, time: float, fn, dedupe: bool = False) -> None:
        slot = self._slots[lane]
        if slot is not None and not slot[1].cancelled:
            if dedupe and time == slot[0]:
                return          # unchanged deadline: draw no sequence number
            self.cancel(slot[1])
        self._slots[lane] = (time, self.at(time, fn, lane=lane))

    def disarm(self, lane: int) -> None:
        slot = self._slots[lane]
        if slot is not None:
            self._slots[lane] = None
            self.cancel(slot[1])

    def arm_slot(self, lane: int, idx: int, time: float, fn) -> None:
        """Per-index one-shot timer; never cancelled (handlers guard)."""
        ev = self.at(time, (lambda now, i=idx, f=fn: f(i, now)), lane=lane)
        ev.slot_idx = idx
        ev.slot_fn = fn

    def drain_due(self, lane: int, fn) -> list[int]:
        """Pop every next-in-order ``arm_slot`` event due right now.

        Collects the contiguous run of heap heads that fire at ``now`` on
        ``lane`` with handler ``fn`` — exactly the events ``run()`` would
        dispatch back-to-back next — and consumes them (processed counts,
        trace entries) so the caller can handle the whole same-timestamp
        cohort in one pass.  Stops at the first non-matching head: an
        interleaved event on another lane keeps its place in global order.
        """
        out: list[int] = []
        heap = self._heap
        while heap:
            ev = heap[0]
            if ev.cancelled:
                heapq.heappop(heap)
                continue
            # Equality, not identity: handlers are bound methods, and each
            # attribute access creates a fresh bound-method object.
            if ev.time != self.now or ev.lane != lane or ev.slot_fn != fn:
                break
            heapq.heappop(heap)
            ev.cancelled = True
            self._live -= 1
            self.processed += 1
            if self.trace_log is not None:
                self.trace_log.append((ev.time, ev.lane))
            out.append(ev.slot_idx)
        return out

    def lane_horizon(self, lane: int) -> float:
        return self.now     # batched is False: callers never batch on this

    def lane_tick(self, lane: int, time: float) -> None:
        self.processed += 1
        self.now = time
        if self.trace_log is not None:
            self.trace_log.append((time, lane))

    def lane_ticks(self, lane: int, count: int, times=None) -> None:
        self.processed += count
        if self.trace_log is not None and times:
            self.trace_log.extend((t, lane) for t in times)

    # ------------------------------------------------------------------ run
    def note_select(self, seconds: float, name: str = "scheduler.select") -> None:
        """Report one scheduler-select's wall time to this loop's session."""
        if self.profile is not None:
            self.profile.note_select(seconds, name)

    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> None:
        log = self.trace_log
        prof = self.profile
        while self._heap and self.processed < max_events:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if ev.time > until:
                heapq.heappush(self._heap, ev)  # put back (still live) for resume
                self.now = until
                return
            self.now = ev.time
            self.processed += 1
            self._live -= 1
            # Mark consumed: a late cancel() on an already-fired event (a
            # caller holding a stale reference) must be a no-op, not a second
            # _live decrement that would make empty() lie.
            ev.cancelled = True
            if log is not None:
                log.append((ev.time, ev.lane))
            if prof is None:
                ev.fn(self.now)
            else:
                t0 = _time.perf_counter()
                s0 = prof.select_s
                ev.fn(self.now)
                # Debit scheduler-select time reported via note_select():
                # it is credited to the dedicated ("select", ...) row, so
                # the owning handler's row shows event plumbing only.
                dt = _time.perf_counter() - t0 - (prof.select_s - s0)
                prof.add(LANE_NAMES[ev.lane], _handler_name(ev.fn), dt)
        if self._heap and self.processed >= max_events:
            raise RuntimeError("event budget exhausted — runaway simulation?")

    def empty(self) -> bool:
        """True when no live (non-cancelled) events are pending.

        Counter-based: the previous implementation linearly scanned the whole
        heap, and ``Simulation._net_tick`` calls this every 0.1 s of sim time.
        """
        return self._live == 0

    def next_time(self) -> float | None:
        """Fire time of the earliest live event (None when idle).

        Lazily pops cancelled heap heads so repeated peeks stay O(1)
        amortised; used by drivers that pace a simulation from outside
        (``benchmarks/decode_throughput.py``).
        """
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].time if self._heap else None


class EventPlane:
    """Typed-lane engine: columnar cursors, O(1) slots, one small scan.

    Instead of one heap entry + closure per event, each lane keeps the
    cheapest structure its traffic allows:

    * **cursors** (arrivals, faults, rewires) — the schedule is known up
      front, so it lives as parallel time/payload arrays with a position
      cursor; enqueue cost is one bulk sort at load, pop cost is an index
      increment.
    * **slots** (net completion, net tick, iteration clock) — at most one
      pending event; re-arm overwrites in place, nothing is ever lazily
      cancelled.
    * **multi-slot** (prefill timers) — a lean tuple heap, no Event
      objects, no per-fire closures.
    * **generic** — a plain Event heap for everything else, with the same
      lazy-cancel + compaction hygiene as the reference loop.

    The run loop scans the eight lane heads for the minimum (time, seq) —
    a bounded Python scan that replaces heappop+heappush bookkeeping — and
    hands ``LANE_CLOCK`` dispatches a *horizon* (``lane_horizon``): the
    cohort handler may absorb all of its own future boundaries up to the
    earliest pending event on any other lane without bouncing through the
    engine (see ``InstancePlane._step``).
    """

    batched = True

    def __init__(self) -> None:
        self._seq = itertools.count()
        self.now = 0.0
        self.processed = 0
        self._live = 0
        self._until = _INF
        self.profile = _CURRENT  # ProfileSession bound for this loop's life
        # generic lane: Event heap + live-in-heap counter for compaction
        self._gen: list[Event] = []
        self._gen_live = 0
        # cursor lanes: parallel arrays + position (None until loaded)
        self._cur_t: list[list[float] | None] = [None] * N_LANES
        self._cur_seq: list[list[int] | None] = [None] * N_LANES
        self._cur_p: list[list | None] = [None] * N_LANES
        self._cur_fn: list[Callable | None] = [None] * N_LANES
        self._cur_pos: list[int] = [0] * N_LANES
        # single-slot lanes: (requested_time, eff_time, seq, fn)
        self._slot: list[tuple | None] = [None] * N_LANES
        # multi-slot lane (prefill): heap of (eff_time, seq, idx, fn)
        self._mslot: list[tuple] = []
        self.trace_log: list[tuple[float, int]] | None = None
        self._batch_buf: list[tuple[float, int]] = []

    # ------------------------------------------------------------- enqueue
    def at(self, time: float, fn: Callable[[float], None],
           lane: int = LANE_GENERIC) -> Event:
        now = self.now
        if time < now - 1e-12:
            time = now
        ev = Event(time if time > now else now, next(self._seq), fn, lane)
        heapq.heappush(self._gen, ev)
        self._live += 1
        self._gen_live += 1
        return ev

    def after(self, delay: float, fn: Callable[[float], None],
              lane: int = LANE_GENERIC) -> Event:
        return self.at(self.now + max(delay, 0.0), fn, lane)

    def cancel(self, ev: Event) -> None:
        if not ev.cancelled:
            ev.cancelled = True
            self._live -= 1
            self._gen_live -= 1
            gen = self._gen
            if len(gen) > 64 and len(gen) - self._gen_live > self._gen_live:
                self._gen = [e for e in gen if not e.cancelled]
                heapq.heapify(self._gen)

    def load_cursor(self, lane: int, times: Sequence[float], payloads,
                    handler) -> None:
        """Load a schedule as a sorted array cursor.

        Sequence numbers are drawn in input order and entries sorted by
        (clamped time, seq) — the dispatch order the reference loop's
        in-order ``at()`` calls produce, without any heap entries.
        """
        now = self.now
        seqs = [next(self._seq) for _ in times]
        eff = [t if t > now else now for t in times]
        order = sorted(range(len(seqs)), key=lambda i: (eff[i], seqs[i]))
        new_t = [eff[i] for i in order]
        new_s = [seqs[i] for i in order]
        new_p = [payloads[i] for i in order]
        pos = self._cur_pos[lane]
        old_t = self._cur_t[lane]
        if old_t is not None and pos < len(old_t):
            # Merge with an unconsumed earlier load (rare; keeps the API
            # total).  Old entries all predate the new seqs.
            new_t = old_t[pos:] + new_t
            new_s = self._cur_seq[lane][pos:] + new_s
            new_p = self._cur_p[lane][pos:] + new_p
            order = sorted(range(len(new_t)), key=lambda i: (new_t[i], new_s[i]))
            new_t = [new_t[i] for i in order]
            new_s = [new_s[i] for i in order]
            new_p = [new_p[i] for i in order]
        self._cur_t[lane] = new_t
        self._cur_seq[lane] = new_s
        self._cur_p[lane] = new_p
        self._cur_fn[lane] = handler
        self._cur_pos[lane] = 0
        self._live += len(seqs)

    def arm(self, lane: int, time: float, fn, dedupe: bool = False) -> None:
        slot = self._slot[lane]
        if slot is not None and dedupe and slot[0] == time:
            return              # unchanged deadline: draw no sequence number
        now = self.now
        eff = time if time > now else now
        self._slot[lane] = (time, eff, next(self._seq), fn)
        if slot is None:
            self._live += 1

    def disarm(self, lane: int) -> None:
        if self._slot[lane] is not None:
            self._slot[lane] = None
            self._live -= 1

    def arm_slot(self, lane: int, idx: int, time: float, fn) -> None:
        now = self.now
        eff = time if time > now else now
        heapq.heappush(self._mslot, (eff, next(self._seq), idx, fn))
        self._live += 1

    def _globally_next(self, t: float, seq: int) -> bool:
        """No event on any other lane precedes (t, seq) in dispatch order."""
        gen = self._gen
        while gen and gen[0].cancelled:
            heapq.heappop(gen)
        if gen and (gen[0].time, gen[0].seq) < (t, seq):
            return False
        for l in _CURSOR_LANES:
            ts = self._cur_t[l]
            if ts is not None:
                pos = self._cur_pos[l]
                if pos < len(ts) and (ts[pos], self._cur_seq[l][pos]) < (t, seq):
                    return False
        for l in _SLOT_LANES:
            slot = self._slot[l]
            if slot is not None and (slot[1], slot[2]) < (t, seq):
                return False
        return True

    def drain_due(self, lane: int, fn) -> list[int]:
        """Pop every next-in-order ``arm_slot`` event due right now.

        Multi-slot counterpart of :meth:`EventLoop.drain_due`: consumes the
        run of ``_mslot`` heads that fire at ``now`` with handler ``fn`` and
        are globally next (no pending event on any other lane ties in ahead
        of them by sequence), so the caller can batch the same-timestamp
        cohort.  Each drained event is counted and traced as if ``run()``
        had dispatched it.
        """
        out: list[int] = []
        ms = self._mslot
        while ms:
            m = ms[0]
            # Equality, not identity: bound-method handlers are fresh
            # objects at every attribute access.
            if m[0] != self.now or m[3] != fn \
                    or not self._globally_next(m[0], m[1]):
                break
            heapq.heappop(ms)
            self._live -= 1
            self.processed += 1
            if self.trace_log is not None:
                self.trace_log.append((m[0], lane))
            out.append(m[2])
        return out

    # ------------------------------------------------------ batching hooks
    def lane_horizon(self, lane: int) -> float:
        """Earliest pending time on any lane but ``lane`` (and ``until``).

        A cohort handler dispatched from ``lane`` may absorb all of its own
        work strictly below this time without changing global event order:
        nothing else can fire inside the window.
        """
        h = self._until
        gen = self._gen
        while gen and gen[0].cancelled:
            heapq.heappop(gen)
        if gen and gen[0].time < h:
            h = gen[0].time
        for l in _CURSOR_LANES:
            if l == lane:
                continue
            ts = self._cur_t[l]
            if ts is not None:
                pos = self._cur_pos[l]
                if pos < len(ts) and ts[pos] < h:
                    h = ts[pos]
        for l in _SLOT_LANES:
            if l == lane:
                continue
            slot = self._slot[l]
            if slot is not None and slot[1] < h:
                h = slot[1]
        if lane != LANE_PREFILL and self._mslot and self._mslot[0][0] < h:
            h = self._mslot[0][0]
        return h

    def lane_tick(self, lane: int, time: float) -> None:
        """One in-batch cohort step absorbed by a horizon-batched handler."""
        self.processed += 1
        self.now = time
        if self.trace_log is not None:
            self._batch_buf.append((time, lane))

    def lane_ticks(self, lane: int, count: int, times=None) -> None:
        """Bulk report of fused per-instance steps (see _fast_forward)."""
        self.processed += count
        if self.trace_log is not None and times:
            buf = self._batch_buf
            for t in times:
                buf.append((t, lane))

    def _flush_batch_log(self) -> None:
        """Order-restore the batch window's entries.

        Fused per-instance runs interleave in time with in-batch cohort
        steps; all of them land strictly inside the horizon window, so a
        sort puts them in global dispatch order and same-time entries merge
        into one — the reference pops one heap event per same-timestamp
        cohort.
        """
        buf = self._batch_buf
        buf.sort()
        log = self.trace_log
        last = None
        for entry in buf:
            if entry[0] != last:
                log.append(entry)
                last = entry[0]
        buf.clear()

    def note_select(self, seconds: float, name: str = "scheduler.select") -> None:
        """Report one scheduler-select's wall time to this loop's session."""
        if self.profile is not None:
            self.profile.note_select(seconds, name)

    # ------------------------------------------------------------------ run
    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> None:
        self._until = until
        gen = self._gen
        cur_t, cur_seq = self._cur_t, self._cur_seq
        cur_pos = self._cur_pos
        slots = self._slot
        ms = self._mslot
        log_on = self.trace_log is not None
        prof = self.profile
        while self.processed < max_events:
            while gen and gen[0].cancelled:
                heapq.heappop(gen)
            lane = -1
            best_t = _INF
            best_seq = 0
            if gen:
                ev = gen[0]
                best_t = ev.time
                best_seq = ev.seq
                lane = LANE_GENERIC
            for l in _CURSOR_LANES:
                ts = cur_t[l]
                if ts is not None:
                    pos = cur_pos[l]
                    if pos < len(ts):
                        t = ts[pos]
                        if t < best_t or (t == best_t and cur_seq[l][pos] < best_seq):
                            best_t = t
                            best_seq = cur_seq[l][pos]
                            lane = l
            for l in _SLOT_LANES:
                slot = slots[l]
                if slot is not None:
                    t = slot[1]
                    if t < best_t or (t == best_t and slot[2] < best_seq):
                        best_t = t
                        best_seq = slot[2]
                        lane = l
            if ms:
                m = ms[0]
                t = m[0]
                if t < best_t or (t == best_t and m[1] < best_seq):
                    best_t = t
                    lane = LANE_PREFILL
            if lane < 0:
                break                       # exhausted (now stays put)
            if best_t > until:
                self.now = until            # events stay pending for resume
                return
            self.now = best_t
            self.processed += 1
            self._live -= 1
            if log_on:
                self.trace_log.append((best_t, lane))
            if prof is not None:
                t0 = _time.perf_counter()
                s0 = prof.select_s
            if lane == LANE_GENERIC:
                ev = heapq.heappop(gen)
                ev.cancelled = True         # consumed: late cancel is a no-op
                self._gen_live -= 1
                fn = ev.fn
                fn(best_t)
            elif lane < LANE_NET:
                pos = cur_pos[lane]
                cur_pos[lane] = pos + 1
                fn = self._cur_fn[lane]
                fn(self._cur_p[lane][pos], best_t)
            elif lane < LANE_PREFILL:
                slot = slots[lane]
                slots[lane] = None
                fn = slot[3]
                fn(best_t)
            else:
                m = heapq.heappop(ms)
                fn = m[3]
                fn(m[2], best_t)
            if prof is not None:
                # Same select-time debit as the reference loop (see above).
                dt = _time.perf_counter() - t0 - (prof.select_s - s0)
                prof.add(LANE_NAMES[lane], _handler_name(fn), dt)
            if self._batch_buf:
                self._flush_batch_log()
        if self.processed >= max_events and self._pending():
            raise RuntimeError("event budget exhausted — runaway simulation?")

    def _pending(self) -> bool:
        if self._gen or self._mslot:
            return True
        for l in _CURSOR_LANES:
            ts = self._cur_t[l]
            if ts is not None and self._cur_pos[l] < len(ts):
                return True
        return any(self._slot[l] is not None for l in _SLOT_LANES)

    def empty(self) -> bool:
        return self._live == 0

    def next_time(self) -> float | None:
        gen = self._gen
        while gen and gen[0].cancelled:
            heapq.heappop(gen)
        t = _INF
        if gen:
            t = gen[0].time
        for l in _CURSOR_LANES:
            ts = self._cur_t[l]
            if ts is not None:
                pos = self._cur_pos[l]
                if pos < len(ts) and ts[pos] < t:
                    t = ts[pos]
        for l in _SLOT_LANES:
            slot = self._slot[l]
            if slot is not None and slot[1] < t:
                t = slot[1]
        if self._mslot and self._mslot[0][0] < t:
            t = self._mslot[0][0]
        return None if t == _INF else t


def make_event_loop(kind: str) -> EventLoop | EventPlane:
    if kind == "reference":
        return EventLoop()
    if kind == "plane":
        return EventPlane()
    raise ValueError(f"unknown event_engine {kind!r}")
