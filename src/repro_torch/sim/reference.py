# The port's own copy of repro/sim/reference.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""Retired per-object instance engine — kept as the InstancePlane parity oracle.

This module preserves the seed's prefill / decode / block-cache
implementations verbatim (``PrefillSim``, ``DecodeSim``, ``BlockCache``):
one heap event per decode iteration per instance, a Python dict of
``RequestState`` walked per token, and an ``OrderedDict`` LRU scanned per
hit-length query.  The production engine in ``sim/instances.py``
(``InstancePlane``) is struct-of-arrays with a single cohort-stepped
iteration clock and must stay *bit-identical* to this module — same TTFT,
TBT, finish times/order, per-instance cache-hit tokens and cache counters —
``tests/test_instanceplane_parity.py`` enforces it on seeded 64/256-GPU
runs.  Benchmarks use this engine as the "reference" arm
(``benchmarks/decode_throughput.py``).

Two intentional divergences from the seed, applied to BOTH engines:

* **KV-growth clamp** — the seed let decode-side KV growth push
  ``pinned_bytes`` past ``kv_budget`` with the scheduler then scoring the
  instance with *negative* free memory (phantom negative capacity).  Both
  engines now clamp the scheduler-visible ``free_memory`` at zero; growth
  still evicts the LRU cache each iteration (``evict_to``) exactly as
  before.
* **Two-phase admission** — ``admit_after_transfer`` is split into
  ``admit_enqueue`` (blocks resident, join the queue) + ``admit_kick``
  (start/continue iterating), so the simulator can admit every transfer
  landing in the same net tick as one epoch: enqueue all, then kick each
  touched instance once.  Same-instant landings on an idle instance
  therefore join the *same* first iteration instead of serialising on
  arrival order.  ``admit_after_transfer`` (= enqueue + kick) is retained
  for callers driving a single instance directly.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Hashable, Optional, Sequence

from ..core.cost import B_TOK, IterTimeModel, ModelKVSpec, PrefillTimeModel
from ..core.view import ROLE_DECODE, ROLE_PREFILL, ClusterView
from .engine import LANE_CLOCK, LANE_PREFILL, EventLoop


class BlockCache:
    """LRU over block hashes, budgeted in bytes (retired; see RadixPlane)."""

    def __init__(self, budget_bytes: float, bytes_per_block: float):
        self.budget = budget_bytes
        self.bytes_per_block = bytes_per_block
        self._lru: OrderedDict[Hashable, None] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def bytes_used(self) -> float:
        return len(self._lru) * self.bytes_per_block

    def __contains__(self, h: Hashable) -> bool:
        return h in self._lru

    def lcp_blocks(self, hashes: Sequence[Hashable]) -> int:
        """|LCP_block(h_r, K_d)|: leading blocks all present in the cache."""
        n = 0
        for h in hashes:
            if h in self._lru:
                n += 1
            else:
                break
        return n

    def hit_tokens(self, hashes: Sequence[Hashable], input_len: int) -> int:
        """lambda_r(d) = B_tok * LCP, clamped to the true input length."""
        return min(self.lcp_blocks(hashes) * B_TOK, input_len)

    def touch(self, hashes: Sequence[Hashable]) -> None:
        """Mark blocks as recently used (move to MRU end)."""
        for h in hashes:
            if h in self._lru:
                self._lru.move_to_end(h)
                self.hits += 1
            else:
                self.misses += 1

    def insert(self, hashes: Sequence[Hashable], protected: float = 0.0) -> None:
        """Insert blocks, evicting LRU entries beyond budget.

        ``protected`` bytes are pinned elsewhere (active batches) and shrink
        the evictable budget.
        """
        for h in hashes:
            self._lru[h] = None
            self._lru.move_to_end(h)
        limit = max(self.budget - protected, 0.0)
        while self.bytes_used > limit and self._lru:
            self._lru.popitem(last=False)
            self.evictions += 1

    def evict_to(self, protected: float) -> None:
        limit = max(self.budget - protected, 0.0)
        while self.bytes_used > limit and self._lru:
            self._lru.popitem(last=False)
            self.evictions += 1


class PrefillSim:
    """Serial prefill compute queue, T_prefill(l) = c*l + d (retired)."""

    def __init__(self, instance_id: int, server, prefill_model: PrefillTimeModel,
                 loop: EventLoop):
        self.instance_id = instance_id
        self.server = server
        self.model = prefill_model
        self.loop = loop
        self.busy_until = 0.0
        self.queue: deque = deque()
        self.running = None
        self.on_done: Callable | None = None
        self.healthy = True
        self.busy_s = 0.0        # telemetry: cumulative prefill seconds

    def submit(self, rs, now: float) -> None:
        rs.prefill_instance = self.instance_id
        self.queue.append(rs)
        self._maybe_start(now)

    def eta(self, now: float) -> float:
        """Earliest time a new request would *finish* prefill here."""
        t = max(self.busy_until, now)
        for rs in self.queue:
            t += self.model(rs.req.input_len)
        return t

    def _maybe_start(self, now: float) -> None:
        if self.running is not None or not self.queue or not self.healthy:
            return
        rs = self.queue.popleft()
        self.running = rs
        rs.prefill_start = max(now, self.busy_until)
        dur = self.model(rs.req.input_len)
        self.busy_s += dur
        self.busy_until = rs.prefill_start + dur
        self.loop.at(self.busy_until, self._finish, lane=LANE_PREFILL)

    def _finish(self, now: float) -> None:
        rs = self.running
        if rs is None:
            return
        rs.prefill_end = now
        self.running = None
        if self.on_done is not None:
            self.on_done(rs, now)
        self._maybe_start(now)


class ChunkedPrefillSim:
    """Scalar chunk-interleaved prefill oracle (per-object).

    The per-object mirror of the plane's ``ChunkPlane``: requests split
    into ``chunk_tokens``-token chunks, one prefill iteration serves the
    active requests' head chunks round-robin under ``token_budget`` tokens,
    costing ``c * tokens_served + d * first_chunks`` (the fixed overhead
    rides with the first chunk, so per-request compute telescopes to the
    monolithic ``c*l + d``).  ``on_chunk(rs, tokens_ready, now)`` fires as
    each chunk's KV becomes ready; ``on_done`` when the last one does.
    Must stay bit-exact with ``ChunkPlane``
    (``tests/test_chunkplane.py``), exactly like ``PrefillSim`` is the
    serial oracle.
    """

    def __init__(self, instance_id: int, server, prefill_model: PrefillTimeModel,
                 loop: EventLoop, chunk_tokens: int,
                 token_budget: int | None = None):
        self.instance_id = instance_id
        self.server = server
        self.model = prefill_model
        self.loop = loop
        self.chunk = int(chunk_tokens)
        self.budget = int(token_budget) if token_budget is not None \
            else int(chunk_tokens)
        self.busy_until = 0.0
        self.backlog = 0         # unclaimed tokens over all active requests
        self.pending = 0         # requests whose fixed overhead d is unpaid
        self.streams: list = []  # [rs, done_tokens, cancelled] in RR order
        self.inflight = None     # [(stream, take), ...] of the running iter
        self.on_done: Callable | None = None
        self.on_chunk: Callable | None = None
        self.healthy = True
        self.iterations = 0
        self.busy_s = 0.0        # telemetry: cumulative iteration seconds
        self.trace = None        # TracePlane sink; mirrors ChunkPlane
        self._iter_base = 0.0    # running iteration's start, kept while tracing

    @property
    def queued(self) -> int:
        return len(self.streams)

    def eta(self, now: float) -> float:
        """Drain time of the current backlog (new request's own c*l + d is
        an argmin-invariant constant, like PrefillSim.eta's convention)."""
        return max(self.busy_until, now) + self.model.c * self.backlog \
            + self.model.d * self.pending

    def submit(self, rs, now: float) -> None:
        rs.prefill_instance = self.instance_id
        self.streams.append([rs, 0, False])
        self.backlog += rs.req.input_len
        self.pending += 1
        self._maybe_start(now)

    def cancel(self, rs) -> None:
        for i, st in enumerate(self.streams):
            if st[0] is rs:
                break
        else:
            return
        del self.streams[i]
        st[2] = True
        claimed = st[1]
        if self.inflight is not None:
            for entry, take in self.inflight:
                if entry is st:
                    claimed += take
                    break
        self.backlog -= max(rs.req.input_len - claimed, 0)
        if st[1] == 0 and claimed == 0:
            self.pending -= 1

    def _maybe_start(self, now: float) -> None:
        if self.inflight is not None or not self.healthy or self.backlog == 0:
            return
        base = float(max(self.busy_until, now))
        budget = self.budget
        served = []
        total = 0
        nfirst = 0
        for st in self.streams:
            if budget <= 0:
                break
            take = min(self.chunk, st[0].req.input_len - st[1], budget)
            if st[1] == 0:
                nfirst += 1
                st[0].prefill_start = base
            served.append((st, take))
            budget -= take
            total += take
        self.backlog -= total
        self.pending -= nfirst
        self.busy_until = base + (self.model.c * total + self.model.d * nfirst)
        self.busy_s += self.busy_until - base
        if self.trace is not None:
            self._iter_base = base
        self.inflight = served
        self.loop.at(self.busy_until, self._iteration_done, lane=LANE_PREFILL)

    def _iteration_done(self, now: float) -> None:
        served = self.inflight
        self.inflight = None
        self.iterations += 1
        # Token accounting + stream-list splice BEFORE callbacks (which can
        # synchronously requeue/submit back into this instance) — mirrors
        # ChunkPlane._iteration_done's phase order exactly.
        rotated = []
        live = []
        n_live = 0
        tr = self.trace
        base = self._iter_base
        for st, take in served:
            if st[2]:
                continue
            n_live += 1
            st[1] += take
            if tr is not None:
                tr.chunk(st[0], self.instance_id, base, now, take, st[1])
            live.append(st)
            if st[1] < st[0].req.input_len:
                rotated.append(st)
        self.streams = self.streams[n_live:] + rotated
        for st in live:
            if st[2]:
                continue
            rs = st[0]
            if self.on_chunk is not None:
                self.on_chunk(rs, st[1], now)
            if st[1] >= rs.req.input_len:
                rs.prefill_end = now
                if self.on_done is not None:
                    self.on_done(rs, now)
        self._maybe_start(now)


class DecodeSim:
    """Continuous-batching decode instance with per-instance heap events
    (retired; the production engine is ``InstancePlane``)."""

    def __init__(
        self,
        instance_id: int,
        server,
        iter_model: IterTimeModel,
        beta_max: int,
        kv_budget: float,
        kv_spec: ModelKVSpec,
        loop: EventLoop,
        view: Optional[ClusterView] = None,
    ):
        self.instance_id = instance_id
        self.server = server
        self.iter_model = iter_model
        self.beta_max = beta_max
        self.kv_budget = kv_budget
        self.kv_spec = kv_spec
        self.loop = loop
        self.cache = BlockCache(kv_budget, bytes_per_block=kv_spec.kv_bytes_per_token * B_TOK)
        self.active: dict = {}
        self.queue: deque = deque()
        self.pinned_bytes = 0.0
        self.healthy = True
        self.iter_scale = 1.0          # true slowdown factor (straggler)
        self.iter_scale_est = 1.0      # scheduler-visible EWMA estimate
        self._iterating = False
        self._iter_event = None
        self.iterations = 0
        self.busy_s = 0.0        # telemetry: cumulative iteration seconds
        self.on_first_token: Callable | None = None
        self.on_finish: Callable | None = None
        self.view = view
        self.slot = view.add_instance(
            instance_id, free_memory=kv_budget, healthy=True
        ) if view is not None else -1

    # ---- scheduler-visible state (§III-C) --------------------------------
    @property
    def beta(self) -> int:
        return len(self.active)

    @property
    def queued(self) -> int:
        return len(self.queue)

    @property
    def free_memory(self) -> float:
        # LRU cache is evictable => counts as free.  Clamped at zero: decode
        # KV growth can overcommit the budget, and a negative value would
        # reach the scheduler as phantom negative capacity.
        return max(self.kv_budget - self.pinned_bytes, 0.0)

    def hit_tokens(self, req) -> int:
        return self.cache.hit_tokens(req.block_hashes, req.input_len)

    def _sync(self) -> None:
        """Write scheduler-visible scalars through to the view column slot."""
        v = self.view
        if v is None:
            return
        s = self.slot
        v.free_memory[s] = max(self.kv_budget - self.pinned_bytes, 0.0)
        v.queued[s] = len(self.queue)
        v.batch[s] = len(self.active)
        v.iter_scale[s] = self.iter_scale_est

    def mark_detected(self, now: float = 0.0) -> None:
        """Fault detection fired: health becomes scheduler-visible."""
        if self.view is not None:
            self.view.healthy[self.slot] = self.healthy

    # ---- lifecycle ---------------------------------------------------------
    def reserve(self, rs, now: float) -> None:
        """Pin KV for an inbound transfer (memory committed at dispatch)."""
        self.pinned_bytes += rs.kv_bytes
        self.cache.evict_to(self.pinned_bytes)
        self._sync()

    def admit_enqueue(self, rs, now: float) -> None:
        """Transfer landed: blocks now resident; join the batch queue."""
        self.cache.insert(rs.req.block_hashes, protected=self.pinned_bytes)
        self.queue.append(rs)
        self._sync()

    def admit_kick(self, now: float) -> None:
        """Second admission phase: start/continue iterating."""
        self._maybe_iterate(now)
        self._sync()

    def admit_after_transfer(self, rs, now: float) -> None:
        """Single-instance convenience: enqueue + kick in one call."""
        self.admit_enqueue(rs, now)
        self.admit_kick(now)

    def release(self, rs) -> None:
        self.pinned_bytes = max(0.0, self.pinned_bytes - rs.kv_bytes)
        self._sync()

    def fail(self, now: float) -> list:
        """Hard failure: drop all state, return the victims for re-scheduling.

        Engine-side health flips immediately; the *scheduler-visible*
        ``healthy`` column only flips when ``mark_detected`` fires after the
        configured detection delay, so dispatches in the window bounce.
        """
        self.healthy = False
        victims = list(self.active.values()) + list(self.queue)
        self.active.clear()
        self.queue.clear()
        self.pinned_bytes = 0.0
        self.cache = BlockCache(self.kv_budget, self.cache.bytes_per_block)
        if self._iter_event is not None:
            self.loop.cancel(self._iter_event)
            self._iter_event = None
        self._iterating = False
        self._sync()
        return victims

    # ---- continuous batching ------------------------------------------------
    def _admit(self, now: float) -> None:
        while self.queue and len(self.active) < self.beta_max:
            rs = self.queue.popleft()
            rs.admit_time = now
            rs.tbt = self.iter_model(self.beta + 1) * self.iter_scale  # §VI-A: TBT at entry
            self.active[rs.req.request_id] = rs

    def _maybe_iterate(self, now: float) -> None:
        if self._iterating or not self.healthy:
            return
        if not self.active and not self.queue:
            return
        self._admit(now)
        if not self.active:
            return
        self._iterating = True
        self._sync()
        dur = self.iter_model(self.beta) * self.iter_scale
        self.busy_s += dur
        self._iter_event = self.loop.after(dur, self._iter_done,
                                           lane=LANE_CLOCK)

    def _iter_done(self, now: float) -> None:
        self._iterating = False
        self._iter_event = None
        if not self.healthy:
            return
        self.iterations += 1
        # EWMA straggler estimator the scheduler reads (beyond paper, §DESIGN 8).
        self.iter_scale_est += 0.2 * (self.iter_scale - self.iter_scale_est)
        finished: list = []
        for rs in self.active.values():
            rs.tokens_out += 1
            if rs.tokens_out == 1:
                rs.first_token = now
                if self.on_first_token:
                    self.on_first_token(rs, now)
            # Decode-side KV growth: one token per iteration.
            self.pinned_bytes += self.kv_spec.kv_bytes_per_token
            if rs.tokens_out >= rs.req.output_len:
                finished.append(rs)
        for rs in finished:
            del self.active[rs.req.request_id]
            rs.finish = now
            grown = rs.kv_bytes + rs.req.output_len * self.kv_spec.kv_bytes_per_token
            self.pinned_bytes = max(0.0, self.pinned_bytes - grown)
            if self.on_finish:
                self.on_finish(rs, now)
        self.cache.evict_to(self.pinned_bytes)
        self._maybe_iterate(now)
        self._sync()


class ReferenceInstanceEngine:
    """Engine-protocol adapter over the retired per-object sims.

    ``Simulation`` speaks one instance-engine protocol (pick_prefill /
    fill_hits / reserve / enqueue / kick / fail / ...); this adapter routes
    it to ``PrefillSim``/``DecodeSim`` objects so the parity tests can run
    the full simulator on either engine.
    """

    kind = "reference"

    def __init__(self, pre_meta, dec_meta, *, view: ClusterView, loop: EventLoop,
                 iter_model: IterTimeModel, prefill_model: PrefillTimeModel,
                 beta_max: int, kv_spec: ModelKVSpec, kv_budget: float,
                 chunk_tokens: int | None = None,
                 prefill_token_budget: int | None = None):
        self.view = view
        self.loop = loop
        self.iter_model = iter_model
        self.prefill_model = prefill_model
        self.beta_max = beta_max
        self.kv_spec = kv_spec
        self.kv_budget = kv_budget
        self.chunk_tokens = chunk_tokens
        self.prefill_token_budget = prefill_token_budget
        if chunk_tokens is not None:
            self.prefill = [
                ChunkedPrefillSim(m.instance_id, m.server, prefill_model,
                                  loop, chunk_tokens, prefill_token_budget)
                for m in pre_meta
            ]
        else:
            self.prefill = [
                PrefillSim(m.instance_id, m.server, prefill_model, loop)
                for m in pre_meta
            ]
        self._pre_by_id = {p.instance_id: p for p in self.prefill}
        self.decode = [
            DecodeSim(m.instance_id, m.server, iter_model, beta_max,
                      kv_budget, kv_spec, loop, view=view)
            for m in dec_meta
        ]
        self._by_id = {d.instance_id: d for d in self.decode}
        self._trace = None

    # ------------------------------------------------------------- callbacks
    @property
    def trace(self):
        return self._trace

    @trace.setter
    def trace(self, tr) -> None:
        """TracePlane sink — fanned out to the chunked prefill sims, which
        emit per-chunk spans (mirrors ``InstancePlane.trace`` wiring)."""
        self._trace = tr
        if self.chunk_tokens is not None:
            for p in self.prefill:
                p.trace = tr

    @property
    def on_prefill_done(self):
        return self.prefill[0].on_done if self.prefill else None

    @on_prefill_done.setter
    def on_prefill_done(self, fn) -> None:
        self._on_done_fn = fn     # stored: add_prefill copies it to new sims
        for p in self.prefill:
            p.on_done = fn

    @property
    def on_chunk_done(self):
        return self.prefill[0].on_chunk if self.prefill \
            and self.chunk_tokens is not None else None

    @on_chunk_done.setter
    def on_chunk_done(self, fn) -> None:
        self._on_chunk_fn = fn    # stored: add_prefill copies it to new sims
        for p in self.prefill:
            p.on_chunk = fn

    def set_decode_callbacks(self, on_first_token, on_finish) -> None:
        self._on_first_token = on_first_token
        self._on_finish = on_finish
        for d in self.decode:
            d.on_first_token = on_first_token
            d.on_finish = on_finish

    # --------------------------------------------------------------- prefill
    def pick_prefill(self, now: float):
        healthy = [p for p in self.prefill if p.healthy]
        if not healthy:
            return None
        return min(healthy, key=lambda p: p.eta(now))

    def cancel_prefill(self, rs) -> None:
        """Drop a request still prefilling (chunked fault-requeue path)."""
        if self.chunk_tokens is not None:
            self._pre_by_id[rs.prefill_instance].cancel(rs)

    def prefill_backlog(self, now: float) -> float:
        """RolePlane imbalance signal: min healthy drain ETA minus ``now``
        (mirrors ``InstancePlane.prefill_backlog`` bit-for-bit)."""
        etas = [p.eta(now) for p in self.prefill if p.healthy]
        if not etas:
            return float("inf")
        return min(etas) - now

    def add_prefill(self, iid: int, server):
        """Elastic prefill membership (RolePlane flips, ``add_prefill``
        fault kind).  New sims inherit the current chunk/budget settings
        and the engine-level callbacks, like ``add_decode`` does."""
        if self.chunk_tokens is not None:
            tmpl = self.prefill[0] if self.prefill else None
            p = ChunkedPrefillSim(
                iid, server, self.prefill_model, self.loop,
                tmpl.chunk if tmpl else self.chunk_tokens,
                tmpl.budget if tmpl else self.prefill_token_budget)
            p.on_chunk = getattr(self, "_on_chunk_fn", None)
            p.trace = self._trace
        else:
            p = PrefillSim(iid, server, self.prefill_model, self.loop)
        p.on_done = getattr(self, "_on_done_fn", None)
        self.prefill.append(p)
        self._pre_by_id[iid] = p
        return p

    def fail_prefill(self, iid: int, now: float) -> list:
        """Hard prefill failure (``kill_prefill``): drop queued/in-flight
        work and return the victims — running/stream order, then queue."""
        p = self._pre_by_id[iid]
        p.healthy = False
        victims: list = []
        if self.chunk_tokens is not None:
            for st in list(p.streams):
                victims.append(st[0])
                p.cancel(st[0])
            return victims
        if p.running is not None:
            victims.append(p.running)
            p.running = None
        victims.extend(p.queue)
        p.queue.clear()
        return victims

    def prefill_drained(self, iid: int) -> bool:
        p = self._pre_by_id[iid]
        if self.chunk_tokens is not None:
            return not p.streams and p.inflight is None
        return p.running is None and not p.queue

    def decode_drained(self, iid: int) -> bool:
        d = self._by_id[iid]
        return d.healthy and not d.active and not d.queue

    def flip_role(self, iid: int, role: int, now: float) -> None:
        """Planned role transition — per-object mirror of
        ``InstancePlane.flip_role`` (drain is the caller's job).  A
        decode->prefill flip swaps in a fresh BlockCache: the prefix cache
        hands off (contents and counters), matching RadixPlane's
        ``reset_instance``."""
        d = self._by_id[iid]
        if role == ROLE_PREFILL:
            self.view.role[d.slot] = ROLE_PREFILL
            d.cache = BlockCache(d.kv_budget, d.cache.bytes_per_block)
            d._sync()
            p = self._pre_by_id.get(iid)
            if p is not None:
                p.healthy = True
            else:
                self.add_prefill(iid, d.server)
        elif role == ROLE_DECODE:
            self._pre_by_id[iid].healthy = False
            self.view.role[d.slot] = ROLE_DECODE
            d._sync()
        else:
            raise ValueError(f"unknown role {role!r}")

    def set_chunking(self, chunk_tokens: int, token_budget: int) -> None:
        """Retune chunk size / token budget (auto-tuner; mirrors
        ``InstancePlane.set_chunking``)."""
        if self.chunk_tokens is None:
            raise ValueError("set_chunking requires chunked prefill")
        if int(chunk_tokens) <= 0 or int(token_budget) <= 0:
            raise ValueError("chunk_tokens / token_budget must be positive")
        for p in self.prefill:
            p.chunk = int(chunk_tokens)
            p.budget = int(token_budget)

    # ---------------------------------------------------------------- decode
    def decode_by_id(self, iid: int) -> DecodeSim:
        return self._by_id[iid]

    def is_healthy(self, iid: int) -> bool:
        return self._by_id[iid].healthy

    def fill_hits(self, req) -> None:
        """Refresh the per-request hit_tokens scratch column in-place."""
        hits = self.view.hit_tokens
        for d in self.decode:
            hits[d.slot] = float(d.hit_tokens(req))

    def hit_tokens(self, iid: int, req) -> float:
        return float(self._by_id[iid].hit_tokens(req))

    def hit_rows(self, reqs):
        """(R, D) hit-token matrix for a dispatch cohort (protocol totality
        with InstancePlane.hit_rows; per-object walks, no bitmask)."""
        import numpy as np

        H = np.zeros((len(reqs), len(self.decode)), np.float64)
        for k, req in enumerate(reqs):
            for d in self.decode:
                H[k, d.slot] = float(d.hit_tokens(req))
        return H

    def evictions_of(self, iid: int) -> int:
        return int(self._by_id[iid].cache.evictions)

    def reserve(self, iid: int, rs, now: float) -> None:
        self._by_id[iid].reserve(rs, now)

    def release(self, iid: int, rs) -> None:
        self._by_id[iid].release(rs)

    def enqueue(self, iid: int, rs, now: float) -> None:
        self._by_id[iid].admit_enqueue(rs, now)

    def kick(self, iids, now: float) -> None:
        for iid in iids:
            self._by_id[iid].admit_kick(now)

    def fail(self, iid: int, now: float) -> list:
        return self._by_id[iid].fail(now)

    def mark_detected(self, iid: int, now: float) -> None:
        self._by_id[iid].mark_detected(now)

    def set_iter_scale(self, iid: int, factor: float) -> None:
        self._by_id[iid].iter_scale = factor

    def add_decode(self, iid: int, server, kv_budget: float | None = None) -> DecodeSim:
        d = DecodeSim(iid, server, self.iter_model, self.beta_max,
                      self.kv_budget if kv_budget is None else kv_budget,
                      self.kv_spec, self.loop, view=self.view)
        d.on_first_token = getattr(self, "_on_first_token", None)
        d.on_finish = getattr(self, "_on_finish", None)
        self.decode.append(d)
        self._by_id[iid] = d
        return d

    def finalize(self) -> None:
        """Per-object engine mutates RequestState in place — nothing to flush."""

    # ------------------------------------------------------------ telemetry
    @property
    def total_iterations(self) -> int:
        return sum(d.iterations for d in self.decode)

    @property
    def prefill_busy_s(self) -> float:
        return sum(p.busy_s for p in self.prefill)

    @property
    def decode_busy_s(self) -> float:
        return sum(d.busy_s for d in self.decode)

    @property
    def deflect_busy_s(self) -> float:
        return 0.0   # deflection is plane-engine-only

    def cache_stats(self) -> list[dict]:
        """Per-instance cache counters for the parity tests."""
        return [
            dict(instance_id=d.instance_id, hits=d.cache.hits,
                 misses=d.cache.misses, evictions=d.cache.evictions,
                 bytes_used=d.cache.bytes_used)
            for d in self.decode
        ]
