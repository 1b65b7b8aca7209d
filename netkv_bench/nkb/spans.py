"""The benchmark's own spans, stamped around calls into each layer of the
port: ``PrefillEngine.run`` of every prefill instance, the scheduler's
``select``, ``DecodeEngine.step`` of every decode instance (every token it
returns is stamped), and the transfer's ``pack_transfer`` and
``unpack_transfer`` as the cluster calls them.  The wrappers are instance
attributes (module attributes for the transfer and for the engine's
``decode_step``) that ``uninstall`` removes; nothing of the program is
edited.  Beside each served token the logits it was picked from are kept
on the device (prefill's ``last_logits``; the step's row of each active
lane), for the check to judge.

Times are seconds on the host clock from the window's start.  Every span
ends in the program's own host read of device results (prefill's first
token, a step's tokens), except the transfer's, whose device work may end
inside the next step.  The prefill wrapper closes the window: asked to
start a prefill past its end, it raises :class:`WindowClosed` out of
``serve()``.  A request already decoding when the window ends is served to
its end (``serve()`` decodes one request at a time), so that its answer can
be judged: late, not lost.  Its tokens past the end count in no metric.
Only a request still unfinished ``GRACE_S`` past the end is cut off, by the
step wrapper raising the same exception.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from .program import TIERS

GRACE_S = 60.0   # how long past the window's end an answer is waited for


class WindowClosed(Exception):
    """The measured window ended inside a ``serve()`` call."""


@dataclasses.dataclass
class Req:
    rid: int
    prompt_len: int
    max_new: int
    due_s: float
    handed_s: float | None = None
    prefill_start: float | None = None
    prefill_end: float | None = None
    tokens: list = dataclasses.field(default_factory=list)        # served tokens
    logits: list = dataclasses.field(default_factory=list)        # each token's logits
    token_times: list = dataclasses.field(default_factory=list)   # each emission
    token_counts: list = dataclasses.field(default_factory=list)  # tokens delivered then

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new

    def tokens_at(self, t: float) -> int:
        return sum(c for x, c in zip(self.token_times, self.token_counts) if x <= t)


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    engine: int
    lanes: int
    rows: object            # the cache's pos after the step: K4's rows a lane
    positions: list         # each active request's write position
    traced: bool


class Recorder:
    """Spans and counts of one run, kept in memory."""

    def __init__(self, window_s: float, clock=time.perf_counter):
        self.clock = clock
        self.window_s = float(window_s)
        self.t0 = clock()
        self.reqs: dict[int, Req] = {}
        self.steps: list[Step] = []
        self.decisions: list[dict] = []
        self.packs: list[dict] = []
        self.unpacks: list[dict] = []
        self.spans: list[tuple[str, float, float]] = []   # (layer, start, end)
        self.stretch = None          # trace.Stretch of a traced run
        self._step_logits = None     # the engine's last decode_step logits
        self.open = False            # the window has started
        self._undo = []

    def now(self) -> float:
        return self.clock() - self.t0

    def start_window(self) -> None:
        """Time zero of the window; everything recorded before (the warm-up)
        is dropped."""
        self.t0 = self.clock()
        self.open = True
        self.steps.clear()
        self.spans.clear()
        self.packs.clear()
        self.unpacks.clear()

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = self.now()
        try:
            yield
        finally:
            self.spans.append((name, t0, self.now()))

    def _traced(self) -> bool:
        return self.stretch is not None and self.stretch.active

    def _past_end(self, t: float) -> bool:
        return self.open and t >= self.window_s

    # ------------------------------------------------------------- install
    def install(self, c, cluster_module, engine_module) -> None:
        for pe in c.prefill:
            self._wrap(pe, "run", self._prefill(pe.run))
        for de in c.decode:
            self._wrap(de, "step", self._step(de, de.step))
        self._wrap(c.sched, "select", self._select(c.sched.select))
        self._wrap_module(cluster_module, "pack_transfer", self._pack)
        self._wrap_module(cluster_module, "unpack_transfer", self._unpack)
        self._wrap_module(engine_module, "decode_step", self._decode_step)

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _wrap(self, obj, name, fn):
        setattr(obj, name, fn)
        self._undo.append(lambda: delattr(obj, name))

    def _wrap_module(self, mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        self._undo.append(lambda: setattr(mod, name, orig))

    # ------------------------------------------------------------ wrappers
    def _prefill(self, orig):
        def run(request_id, tokens):
            t0 = self.now()
            if self._past_end(t0):
                raise WindowClosed
            with self._span("prefill"):
                res = orig(request_id, tokens)
            t1 = self.now()
            r = self.reqs.get(request_id)
            if r is not None:
                r.prefill_start, r.prefill_end = t0, t1
                r.tokens = [int(res.first_token)]
                r.logits = [res.last_logits.reshape(-1).clone()]
            return res
        return run

    def _decode_step(self, orig):
        def decode_step(model, tokens, cache, *args, **kw):
            logits, out = orig(model, tokens, cache, *args, **kw)
            self._step_logits = logits
            return logits, out
        return decode_step

    def _step(self, de, orig):
        def step():
            lane_of = {s.request_id: i for i, s in enumerate(de.slots) if s.active}
            t0 = self.now()
            traced = self._traced()
            self._step_logits = None
            with self._span("decode_step"):
                emitted = orig()
            t1 = self.now()
            positions = []
            for rid, tok in emitted:
                r = self.reqs.get(rid)
                if r is None:
                    continue
                positions.append(r.prompt_len + len(r.tokens) - 1)
                if self._step_logits is not None:
                    r.logits.append(self._step_logits[lane_of[rid]].reshape(-1).clone())
                r.token_counts.append(1 if r.token_times else 2)
                r.tokens.append(int(tok))
                r.token_times.append(t1)
            pos = de.cache.get("pos")
            rows = [int(x) for x in np.asarray(pos).reshape(-1)] if np.ndim(pos) else int(pos)
            self.steps.append(Step(t0, t1, de.instance_id, de.n_slots, rows, positions, traced))
            if self.stretch is not None and self.open:
                self.stretch.poll(self, t1)
            if self.open and t1 >= self.window_s + GRACE_S:
                raise WindowClosed
            return emitted
        return step

    def _select(self, orig):
        def select(info, prefill_id, cv, view, inflight=None):
            n_fl = [inflight.get(prefill_id, t) if inflight is not None else 0 for t in TIERS]
            t0 = self.now()
            with self._span("decide"):
                d = orig(info, prefill_id, cv, view, inflight)
            t1 = self.now()
            self.decisions.append(dict(
                t0=t0, t1=t1, request_id=int(info.request_id), input_len=int(info.input_len),
                kv_bytes=float(info.kv_bytes), prefill_remaining=float(info.prefill_remaining),
                tail_bytes=info.tail_bytes, prefill_id=int(prefill_id),
                **{k: np.array(cv.column(k), copy=True) for k in
                   ("ids", "free_memory", "queued", "batch", "hit_tokens", "healthy", "role",
                    "iter_scale")},
                tier_row=np.array(cv.tier_row(prefill_id), copy=True),
                bandwidth=[float(view.tier_bandwidth[t]) for t in TIERS],
                latency=[float(view.tier_latency[t]) for t in TIERS],
                congestion=[float(view.congestion.get(t, 0.0)) for t in TIERS],
                n_inflight=n_fl,
                chosen=None if d is None else (int(d.instance_id), int(d.tier))))
            return d
        return select

    def _pack(self, orig):
        def pack_transfer(cache, hit_pages, *args, **kw):
            t0 = self.now()
            traced = self._traced()
            with self._span("pack"):
                buffers, nbytes = orig(cache, hit_pages, *args, **kw)
            self.packs.append(dict(
                t0=t0, t1=self.now(), hit_pages=int(hit_pages), nbytes=int(nbytes),
                pos=int(cache["pos"]), traced=traced,
                tables={k: t for k, (_, t) in buffers.items() if t is not None},
                whole={k: int(b.numel() * b.element_size()) for k, (b, t) in buffers.items()
                       if t is None}))
            return buffers, nbytes
        return pack_transfer

    def _unpack(self, orig):
        def unpack_transfer(buffers, like_cache, *args, **kw):
            t0 = self.now()
            traced = self._traced()
            with self._span("unpack"):
                out = orig(buffers, like_cache, *args, **kw)
            self.unpacks.append(dict(
                t0=t0, t1=self.now(), traced=traced,
                tables={k: t for k, (_, t) in buffers.items() if t is not None}))
            return out
        return unpack_transfer
