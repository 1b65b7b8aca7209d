# The port's own copy of repro/sim/instances.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""InstancePlane: columnar prefill/decode lifecycle engine (§III-C, §VI-B).

The retired per-object engine (kept verbatim in ``sim/reference.py``) posts
one heap event per decode instance per continuous-batching iteration and
walks a Python dict of ``RequestState`` per token — at 1000-instance scale
that bookkeeping *is* the simulator hot path.  ``InstancePlane`` replaces it
with struct-of-arrays state and a single **cohort-stepped iteration clock**:

* **Instance columns** (slot-indexed, aligned with ``ClusterView`` slots):
  active count, queue length, pinned KV bytes, per-instance budget, true and
  EWMA-estimated straggler scale, iteration count, and the *next-iteration
  deadline* (``+inf`` when idle).  One event-loop timer fires at the minimum
  deadline and steps the whole cohort of instances due at that instant —
  replacing D per-instance ``_iter_done`` events with one.
* **Request table**: active decoding requests live in parallel columns
  (tokens_out / output_len / instance slot / admission seq / object ref), so
  per-iteration token accounting, first-token detection, finish detection
  and decode-side KV growth are fused array ops over the cohort's rows.
* **Prefill columns**: serial prefill queues keep per-instance
  ``busy_until`` and an *exact left-fold* ETA column, so arrival routing
  (min-ETA healthy instance) is one masked argmin instead of a Python scan
  that re-sums every queue.
* **ChunkPlane** (``chunk_tokens`` set): the serial queues are replaced by
  a chunk-interleaved continuous-batching prefill model — requests split
  into fixed-token chunks, per-instance chunk queues round-robin
  interleaved under a token budget per prefill iteration, per-chunk
  admission callbacks (``on_chunk_done``) as each chunk's KV becomes
  ready.  ``chunk_tokens=None`` (default) keeps the serial columns
  untouched and bit-exact vs ``sim/reference.py``.
* **RadixPlane cache**: per-instance prefix caches share one packed
  presence bitmask, so lambda_r(d) against all D instances is a single
  broadcast LCP (``fill_hits``).
* **Write-through**: scheduler-visible scalars sync to the ``ClusterView``
  columns in one vectorised assignment per event (the one column never
  written here is ``healthy`` — that flips only via ``mark_detected`` after
  the fault-detection delay; see Simulation._on_fault).

Semantics are bit-identical to the reference engine — same TTFT/TBT/finish
times, same cache-hit tokens, same RNG stream consumption downstream —
enforced by ``tests/test_instanceplane_parity.py`` on seeded 64/256-GPU
runs.  Within one clock tick the cohort's instances are processed in slot
order; the reference interleaves per-instance events by heap sequence, but
same-timestamp instance steps are independent (per-instance accumulators,
per-request fields), so outcomes agree exactly.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..core.cost import (
    B_TOK,
    IterTimeModel,
    ModelKVSpec,
    PrefillTimeModel,
    iter_time_vector,
)
from ..core.view import ROLE_DECODE, ROLE_PREFILL, ClusterView
from ..traces.mooncake import Request
from .engine import LANE_CLOCK, LANE_PREFILL, EventLoop
from .kvcache import RadixPlane


@dataclasses.dataclass
class RequestState:
    req: Request
    kv_bytes: float
    prefill_instance: int = -1
    prefill_start: float = -1.0
    prefill_end: float = -1.0
    sched_time: float = -1.0
    decode_instance: int = -1
    tier: int = -1
    s_eff: float = 0.0
    hit_tokens: float = 0.0
    transfer_end: float = -1.0
    admit_time: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0
    tbt: float = -1.0
    tokens_out: int = 0
    rejected: bool = False
    requeues: int = 0  # fault-tolerance: times re-scheduled after a failure
    deflected: bool = False  # RolePlane: prefilled on the decode host itself
    # ---- chunked-prefill / streamed-transfer bookkeeping (ChunkPlane) ----
    tokens_ready: int = 0        # prefilled tokens whose KV exists (chunked)
    streamed_bytes: float = 0.0  # bytes handed to the network so far
    stream_open: int = 0         # in-flight streamed chunk transfers
    stream_scheduled: bool = False  # decode instance chosen at first chunk
    stream_last: bool = False    # final chunk's bytes are in the network

    @property
    def ttft(self) -> float:
        return self.first_token - self.req.arrival if self.first_token >= 0 else float("inf")


class PrefillHandle:
    """Per-instance window into the prefill columns (test/driver surface)."""

    __slots__ = ("_p", "s")

    def __init__(self, plane: "InstancePlane", s: int):
        self._p = plane
        self.s = s

    @property
    def instance_id(self) -> int:
        return int(self._p.p_ids[self.s])

    @property
    def server(self):
        return self._p.p_server[self.s]

    @property
    def healthy(self) -> bool:
        return bool(self._p.p_healthy[self.s])

    @healthy.setter
    def healthy(self, v: bool) -> None:
        self._p.p_healthy[self.s] = bool(v)

    @property
    def busy_until(self) -> float:
        p = self._p
        if p.chunks is not None:
            return float(p.chunks.busy[self.s])
        return float(p.p_busy[self.s])

    @property
    def queued(self) -> int:
        p = self._p
        if p.chunks is not None:
            return len(p.chunks.streams[self.s])
        return int(p.p_qlen[self.s])

    def submit(self, rs: RequestState, now: float) -> None:
        self._p.submit_prefill(self.s, rs, now)

    def eta(self, now: float) -> float:
        p = self._p
        if p.chunks is not None:
            return p.chunks.eta(self.s, now)
        if p.p_qlen[self.s] > 0:
            return float(p.p_eta[self.s])
        return float(max(p.p_busy[self.s], now))


class DecodeHandle:
    """Per-instance window into the decode columns (test/driver surface)."""

    __slots__ = ("_p", "slot")

    def __init__(self, plane: "InstancePlane", slot: int):
        self._p = plane
        self.slot = slot

    @property
    def instance_id(self) -> int:
        return int(self._p.d_ids[self.slot])

    @property
    def server(self):
        return self._p.d_server[self.slot]

    @property
    def healthy(self) -> bool:
        """Engine-side truth (scheduler sees view.healthy, which lags)."""
        return bool(self._p.d_healthy[self.slot])

    @property
    def iterations(self) -> int:
        return int(self._p.d_iterations[self.slot])

    @property
    def iter_scale(self) -> float:
        return float(self._p.d_iter_scale[self.slot])

    @iter_scale.setter
    def iter_scale(self, v: float) -> None:
        self._p.d_iter_scale[self.slot] = float(v)

    @property
    def iter_scale_est(self) -> float:
        return float(self._p.d_iter_scale_est[self.slot])

    @property
    def beta(self) -> int:
        return int(self._p.d_active[self.slot])

    @property
    def queued(self) -> int:
        return int(self._p.d_qlen[self.slot])

    @property
    def free_memory(self) -> float:
        p = self._p
        return float(max(p.d_budget[self.slot] - p.d_pinned[self.slot], 0.0))

    @property
    def pinned_bytes(self) -> float:
        return float(self._p.d_pinned[self.slot])

    def hit_tokens(self, req: Request) -> int:
        return self._p.cache.hit_tokens(self.slot, req.block_hashes, req.input_len)


class _ChunkStream:
    """One request's chunk progress on a prefill instance."""

    __slots__ = ("rs", "done", "cancelled")

    def __init__(self, rs: RequestState):
        self.rs = rs
        self.done = 0            # tokens whose KV is ready
        self.cancelled = False   # requeued mid-prefill (fault path)


class ChunkPlane:
    """Chunk-interleaved continuous-batching prefill engine.

    Replaces the serial per-request prefill queues when
    ``chunk_tokens`` is set: each request is split into fixed-token
    chunks, and every *prefill iteration* serves the head of each
    active request's chunk queue in round-robin order under a token
    budget (Sarathi/DeepSpeed-FastGen-style chunked prefill).  The
    iteration costs ``c * tokens_served + d * first_chunks`` — the
    fixed per-request overhead ``d`` is charged once, with the first
    chunk, so the total compute a request receives telescopes to
    exactly the monolithic ``T_prefill(l) = c*l + d`` (chunk-duration
    conservation, property-tested in ``tests/test_chunkplane.py``).

    As each chunk's KV becomes ready the plane fires
    ``owner.on_chunk_done(rs, tokens_ready, now)`` — the hook the
    simulator uses to *stream* completed chunks into the FlowPlane
    while later chunks are still prefilling (``SimConfig.kv_streaming``).

    Columnar state (slot-indexed like the serial prefill columns):
    ``busy`` (end of the in-flight iteration), ``backlog`` (unclaimed
    tokens over all active requests) and ``pending`` (requests whose
    fixed overhead ``d`` is still unpaid), so arrival routing is one
    masked argmin over ``max(busy, now) + c*backlog + d*pending`` —
    the same value the scalar reference oracle
    (``sim/reference.py::ChunkedPrefillSim``) computes per instance,
    bit-for-bit.
    """

    def __init__(self, owner: "InstancePlane", n_pre: int, *,
                 chunk_tokens: int, token_budget: int | None,
                 ids_attr: str = "p_ids", healthy_attr: str = "p_healthy",
                 deflect: bool = False):
        if int(chunk_tokens) <= 0:
            raise ValueError("chunk_tokens must be positive")
        self.owner = owner
        self.model = owner.prefill_model
        self.chunk = int(chunk_tokens)
        self.budget = int(token_budget) if token_budget is not None \
            else int(chunk_tokens)
        if self.budget <= 0:
            raise ValueError("prefill_token_budget must be positive")
        # The plane is *attachable*: ``ids_attr``/``healthy_attr`` name the
        # owner columns its slots index, so the same token-budget iteration
        # clock can meter prefill hosts (the default) or decode hosts
        # (RolePlane's deflected-prefill twin, ``deflect=True``).  Column
        # arrays are re-read through getattr at use time because the owner
        # reallocates them on growth.  Deflect mode reroutes completion
        # callbacks to ``on_deflect_done`` and emits "deflect" trace spans.
        self._ids_attr = ids_attr
        self._healthy_attr = healthy_attr
        self.deflect_mode = deflect
        self.busy = np.zeros(n_pre, np.float64)
        self.backlog = np.zeros(n_pre, np.int64)
        self.pending = np.zeros(n_pre, np.int64)
        self.streams: list[list[_ChunkStream]] = [[] for _ in range(n_pre)]
        self.inflight: list[Optional[list]] = [None] * n_pre
        self.iterations = 0      # telemetry: chunked prefill iterations
        self.busy_s = 0.0        # telemetry: cumulative iteration seconds
        # Iteration start times, kept only while tracing (chunk spans need
        # the [start, end) interval of the iteration that served them).
        self.iter_base = np.zeros(n_pre, np.float64)

    def add_slot(self) -> int:
        """Grow by one slot (elastic owner columns: add_decode/add_prefill)."""
        s = len(self.busy)
        self.busy = np.append(self.busy, 0.0)
        self.backlog = np.append(self.backlog, np.int64(0))
        self.pending = np.append(self.pending, np.int64(0))
        self.iter_base = np.append(self.iter_base, 0.0)
        self.streams.append([])
        self.inflight.append(None)
        return s

    # ------------------------------------------------------------- routing
    def eta_row(self, now: float, n: int) -> np.ndarray:
        """Earliest-start estimate per instance: drain time of the current
        backlog.  The new request's own ``c*l + d`` is an argmin-invariant
        constant shift, exactly like the serial ETA fold's convention."""
        return (np.maximum(self.busy[:n], now)
                + self.model.c * self.backlog[:n]
                + self.model.d * self.pending[:n])

    def eta(self, s: int, now: float) -> float:
        return float(max(self.busy[s], now)
                     + self.model.c * self.backlog[s]
                     + self.model.d * self.pending[s])

    # ------------------------------------------------------------ lifecycle
    def submit(self, s: int, rs: RequestState, now: float) -> None:
        self.streams[s].append(_ChunkStream(rs))
        self.backlog[s] += rs.req.input_len
        self.pending[s] += 1
        self._maybe_start(s, now)

    def cancel(self, s: int, rs: RequestState) -> None:
        """Drop a request mid-prefill (fault requeue).  Tokens already
        claimed by the in-flight iteration stay charged — that compute is
        physically spent — but the unclaimed remainder leaves the backlog
        and the stream fires no further callbacks."""
        streams = self.streams[s]
        for i, st in enumerate(streams):
            if st.rs is rs:
                break
        else:
            return
        del streams[i]
        st.cancelled = True
        claimed = st.done
        infl = self.inflight[s]
        if infl is not None:
            for entry, take in infl:
                if entry is st:
                    claimed += take
                    break
        self.backlog[s] -= max(rs.req.input_len - claimed, 0)
        if st.done == 0 and claimed == 0:
            # Overhead unpaid and not claimed by the running iteration.
            self.pending[s] -= 1

    # ------------------------------------------------- iteration scheduling
    def _maybe_start(self, s: int, now: float) -> None:
        if self.inflight[s] is not None \
                or not getattr(self.owner, self._healthy_attr)[s] \
                or self.backlog[s] == 0:
            return
        base = float(max(self.busy[s], now))
        budget = self.budget
        served: list[tuple[_ChunkStream, int]] = []
        total = 0
        nfirst = 0
        # Round-robin: the stream list order IS the serve order; every
        # stream has unclaimed tokens (finished ones are removed), so the
        # served set is a prefix of the list, one chunk each, until the
        # token budget runs out.
        for st in self.streams[s]:
            if budget <= 0:
                break
            take = min(self.chunk, st.rs.req.input_len - st.done, budget)
            if st.done == 0:
                nfirst += 1
                st.rs.prefill_start = base
            served.append((st, take))
            budget -= take
            total += take
        self.backlog[s] -= total
        self.pending[s] -= nfirst
        self.busy[s] = base + (self.model.c * total + self.model.d * nfirst)
        self.busy_s += float(self.busy[s]) - base
        if self.owner.trace is not None:
            self.iter_base[s] = base
        self.inflight[s] = served
        self.owner.loop.arm_slot(LANE_PREFILL, s, float(self.busy[s]),
                                 self._iteration_done)

    def _iteration_done(self, s: int, now: float) -> None:
        served = self.inflight[s]
        self.inflight[s] = None
        self.iterations += 1
        streams = self.streams[s]
        owner = self.owner
        # Phase 1+2: account tokens and splice the stream list BEFORE any
        # callback fires — a callback can synchronously re-enter this
        # instance (streamed transfer completes instantly -> detection-
        # window bounce -> requeue -> submit back here), and _maybe_start
        # must then see consistent state, not the stale served prefix.
        rotated: list[_ChunkStream] = []
        live: list[_ChunkStream] = []
        n_live = 0               # served entries still present in `streams`
        tr = owner.trace
        iid = int(getattr(owner, self._ids_attr)[s])
        base = float(self.iter_base[s])
        kind = "deflect" if self.deflect_mode else "chunk"
        for st, take in served:
            if st.cancelled:
                continue
            n_live += 1
            st.done += take
            if tr is not None:
                tr.chunk(st.rs, iid, base, now, take, st.done, kind=kind)
            live.append(st)
            if st.done < st.rs.req.input_len:
                rotated.append(st)
        # Served entries are the first n_live list items; unfinished ones
        # rotate to the back (behind arrivals that landed mid-iteration).
        self.streams[s] = streams[n_live:] + rotated
        # Phase 3: callbacks, in served order; skip entries a previous
        # callback cancelled (requeued mid-phase).  With cohort dispatch
        # enabled, a multi-stream iteration hands the whole served batch
        # over in one call so same-instant selections fuse (the handler
        # replicates this loop's per-stream semantics exactly).  Deflected
        # chunks never stream or cohort-dispatch: the KV is born on the
        # decode host, so only the completion callback matters.
        if self.deflect_mode:
            cohort_cb, chunk_cb, done_cb = None, None, owner.on_deflect_done
        else:
            cohort_cb = owner.on_phase3_cohort
            chunk_cb = owner.on_chunk_done
            done_cb = owner.on_prefill_done
        if cohort_cb is not None and len(live) > 1:
            cohort_cb(live, now)
        else:
            for st in live:
                if st.cancelled:
                    continue
                rs = st.rs
                if chunk_cb is not None:
                    chunk_cb(rs, st.done, now)
                if st.done >= rs.req.input_len:
                    rs.prefill_end = now
                    if done_cb is not None:
                        done_cb(rs, now)
        self._maybe_start(s, now)


class InstancePlane:
    """Struct-of-arrays prefill/decode engine with one cohort iteration clock."""

    kind = "plane"

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
        self.kv_per_token = kv_spec.kv_bytes_per_token
        self.chunk_tokens = chunk_tokens
        self.on_prefill_done: Callable[[RequestState, float], None] | None = None
        self.on_chunk_done: Callable[[RequestState, int, float], None] | None = None
        # RolePlane deflected-prefill completion hook (fires from the
        # deflect ChunkPlane over decode slots; see enable_deflection).
        self.on_deflect_done: Callable[[RequestState, float], None] | None = None
        # TracePlane sink (sim/trace.py), set by the Simulation when
        # tracing; None keeps every emission site a dead branch.
        self.trace = None
        # Cohort dispatch hooks (SimConfig.dispatch_mode="plane"): when set,
        # same-timestamp prefill completions are handed over as one batch so
        # the simulator can run a single fused R x D selection instead of R
        # sequential ones.  None keeps the per-request paths untouched.
        self.on_prefill_cohort: Callable[[list, float], None] | None = None
        self.on_phase3_cohort: Callable[[list, float], None] | None = None
        self._on_first_token: Callable | None = None
        self._on_finish: Callable | None = None

        # ---------- prefill columns (fixed membership) --------------------
        n_pre = len(pre_meta)
        self.n_pre = n_pre
        self.p_ids = np.array([m.instance_id for m in pre_meta], np.int64)
        self.p_server = [m.server for m in pre_meta]
        self.p_busy = np.zeros(n_pre, np.float64)
        # Exact left-fold ETA: when the queue is non-empty this equals the
        # reference's  max(busy, now) + sum(T_prefill)  walk bit-for-bit
        # (queue non-empty implies running implies busy_until >= now).
        self.p_eta = np.zeros(n_pre, np.float64)
        self.p_qlen = np.zeros(n_pre, np.int64)
        self.p_healthy = np.ones(n_pre, bool)
        self.p_queue: list[deque] = [deque() for _ in range(n_pre)]
        self.p_running: list[Optional[RequestState]] = [None] * n_pre
        self.prefill = [PrefillHandle(self, s) for s in range(n_pre)]
        self._pre_slot = {int(i): s for s, i in enumerate(self.p_ids)}
        # ChunkPlane replaces the serial columns when chunk_tokens is set;
        # chunk_tokens=None leaves every serial code path untouched.
        self.chunks = ChunkPlane(
            self, n_pre, chunk_tokens=chunk_tokens,
            token_budget=prefill_token_budget,
        ) if chunk_tokens is not None else None
        # Deflect twin over the decode slots (None until enable_deflection).
        self.deflect: ChunkPlane | None = None
        # Per-role busy-second accumulators (RunMetrics utilization rows).
        self._p_busy_s = 0.0      # serial prefill (chunked lives in .chunks)
        self.decode_busy_s = 0.0

        # ---------- decode columns (elastic membership) -------------------
        cap = max(len(dec_meta), 1)
        self.n_dec = 0
        self.d_ids = np.zeros(cap, np.int64)
        self.d_server: list = []
        self.d_budget = np.zeros(cap, np.float64)
        self.d_pinned = np.zeros(cap, np.float64)
        self.d_active = np.zeros(cap, np.int64)
        self.d_qlen = np.zeros(cap, np.int64)
        self.d_healthy = np.zeros(cap, bool)
        self.d_iter_scale = np.ones(cap, np.float64)
        self.d_iter_scale_est = np.ones(cap, np.float64)
        self.d_iterations = np.zeros(cap, np.int64)
        self.d_deadline = np.full(cap, np.inf, np.float64)
        self.d_queue: list[deque] = []
        self.decode: list[DecodeHandle] = []
        self.cache = RadixPlane(
            kv_spec.kv_bytes_per_token * B_TOK,
            instance_capacity=cap,
        )

        # ---------- request table (active decoding requests) --------------
        rcap = 64
        self.r_live = np.zeros(rcap, bool)
        self.r_tokens = np.zeros(rcap, np.int64)
        self.r_out = np.zeros(rcap, np.int64)
        self.r_inst = np.zeros(rcap, np.int64)
        self.r_seq = np.zeros(rcap, np.int64)
        self.r_obj: list[Optional[RequestState]] = [None] * rcap
        self._r_free: list[int] = list(range(rcap - 1, -1, -1))
        self._r_hi = 0            # rows ever allocated (scan bound)
        self._next_seq = 0        # global admission sequence
        # Admission-ordered row indices per instance: lets small cohorts
        # step through a scalar fast path (identical arithmetic, no
        # full-table scan) while large cohorts take the fused array path.
        self._inst_rows: list[list[int]] = []
        self.scalar_rows_max = 256   # cohort row count below which the
        #                              scalar path runs (tests pin 0 / inf
        #                              to force either path)

        # The cohort iteration clock lives in the loop's LANE_CLOCK slot
        # (arm/disarm with dedupe) — no per-plane event bookkeeping.

        for m in dec_meta:
            self.add_decode(m.instance_id, m.server)

    # ------------------------------------------------------------- callbacks
    def set_decode_callbacks(self, on_first_token, on_finish) -> None:
        self._on_first_token = on_first_token
        self._on_finish = on_finish

    # ----------------------------------------------------------------- sync
    def _sync_slot(self, s: int) -> None:
        """Write-through for one touched slot (reserve/enqueue/release paths
        mutate a single instance; rewriting all D columns would put O(D)
        work on every request event)."""
        v = self.view
        v.free_memory[s] = max(self.d_budget[s] - self.d_pinned[s], 0.0)
        v.queued[s] = self.d_qlen[s]
        v.batch[s] = self.d_active[s]
        v.iter_scale[s] = self.d_iter_scale_est[s]

    def _sync_rows(self, idx: np.ndarray) -> None:
        """Write-through for a cohort of slots."""
        v = self.view
        v.free_memory[idx] = np.maximum(self.d_budget[idx] - self.d_pinned[idx], 0.0)
        v.queued[idx] = self.d_qlen[idx]
        v.batch[idx] = self.d_active[idx]
        v.iter_scale[idx] = self.d_iter_scale_est[idx]

    # --------------------------------------------------------------- prefill
    def pick_prefill(self, now: float) -> Optional[PrefillHandle]:
        n = self.n_pre
        if n == 0 or not self.p_healthy[:n].any():
            return None
        if self.chunks is not None:
            eta = self.chunks.eta_row(now, n)
        else:
            eta = np.where(self.p_qlen[:n] > 0, self.p_eta[:n],
                           np.maximum(self.p_busy[:n], now))
        eta = np.where(self.p_healthy[:n], eta, np.inf)
        return self.prefill[int(np.argmin(eta))]

    def prefill_backlog(self, now: float) -> float:
        """RolePlane imbalance signal: best-case prefill wait in seconds.

        Min-over-healthy-instances drain ETA minus ``now`` — the value the
        deflection gate and the P:D flip controller threshold against.
        ``inf`` when no healthy prefill instance exists.
        """
        n = self.n_pre
        if n == 0 or not self.p_healthy[:n].any():
            return float("inf")
        if self.chunks is not None:
            eta = self.chunks.eta_row(now, n)
        else:
            eta = np.where(self.p_qlen[:n] > 0, self.p_eta[:n],
                           np.maximum(self.p_busy[:n], now))
        eta = np.where(self.p_healthy[:n], eta, np.inf)
        return float(eta.min()) - now

    def submit_prefill(self, s: int, rs: RequestState, now: float) -> None:
        rs.prefill_instance = int(self.p_ids[s])
        if self.chunks is not None:
            self.chunks.submit(s, rs, now)
            return
        q = self.p_queue[s]
        q.append(rs)
        # ETA-fold shortcut, audited at the queue-drain boundary (see
        # tests/test_chunkplane.py::TestSerialEtaBoundary): with the queue
        # previously non-empty, p_eta already holds the exact left fold and
        # a request is necessarily running, so p_busy >= now and appending
        # one term keeps the fold exact.  With the queue previously empty
        # p_busy may be stale (< now, instance idle), but _prefill_start
        # below immediately pops this request and rebuilds the fold from
        # max(now, p_busy) — the transient value is never observable.  The
        # one unreachable gap: an *unhealthy* instance holds a stale fold
        # until it next starts, and pick_prefill masks it to inf anyway.
        base = self.p_eta[s] if len(q) > 1 else self.p_busy[s]
        self.p_eta[s] = base + self.prefill_model(rs.req.input_len)
        self.p_qlen[s] = len(q)
        self._prefill_start(s, now)

    def cancel_prefill(self, rs: RequestState) -> None:
        """Drop a request that is still prefilling (fault-requeue path).

        Only reachable in chunked mode: with serial prefill, transfers —
        and hence fault requeues — only exist after prefill completes.
        Deflected requests cancel on the deflect plane (decode slots).
        """
        if rs.deflected and self.deflect is not None:
            self.deflect.cancel(self.view.slot_of(rs.prefill_instance), rs)
        elif self.chunks is not None:
            self.chunks.cancel(self._pre_slot[rs.prefill_instance], rs)

    def _prefill_start(self, s: int, now: float) -> None:
        if self.p_running[s] is not None or not self.p_queue[s] \
                or not self.p_healthy[s]:
            return
        rs = self.p_queue[s].popleft()
        self.p_running[s] = rs
        rs.prefill_start = float(max(now, self.p_busy[s]))
        dur = self.prefill_model(rs.req.input_len)
        self._p_busy_s += dur
        self.p_busy[s] = rs.prefill_start + dur
        # Rebuild the ETA fold from the new base — the same left-to-right
        # addition order the reference's eta() walk performs.
        eta = self.p_busy[s]
        for queued in self.p_queue[s]:
            eta = eta + self.prefill_model(queued.req.input_len)
        self.p_eta[s] = eta
        self.p_qlen[s] = len(self.p_queue[s])
        self.loop.arm_slot(LANE_PREFILL, s, float(self.p_busy[s]),
                           self._prefill_finish)

    def _prefill_finish(self, s: int, now: float) -> None:
        rs = self.p_running[s]
        if rs is None:
            return
        if self.on_prefill_cohort is not None:
            # Cohort dispatch: absorb every other prefill completion due at
            # this exact instant (they are the engine's next dispatches
            # anyway — drain_due only takes heads that precede all other
            # pending events), mark them all finished, then hand the batch
            # to the simulator for one fused selection.  Successor prefills
            # start after the dispatches, matching the per-event order for
            # everything observable: a prefill start only arms a strictly
            # future timer and touches no decode state.
            drained = self.loop.drain_due(LANE_PREFILL, self._prefill_finish)
            slots = [s] + drained
            batch: list[RequestState] = []
            for s2 in slots:
                rs2 = self.p_running[s2]
                if rs2 is None:
                    continue
                rs2.prefill_end = now
                self.p_running[s2] = None
                batch.append(rs2)
            if len(batch) > 1:
                self.on_prefill_cohort(batch, now)
            elif batch and self.on_prefill_done is not None:
                self.on_prefill_done(batch[0], now)
            for s2 in slots:
                self._prefill_start(s2, now)
            return
        rs.prefill_end = now
        self.p_running[s] = None
        if self.on_prefill_done is not None:
            self.on_prefill_done(rs, now)
        self._prefill_start(s, now)

    def add_prefill(self, iid: int, server) -> PrefillHandle:
        """Elastic prefill membership: append one prefill slot (RolePlane
        flips and the ``add_prefill`` fault kind)."""
        s = self.n_pre
        self.n_pre = s + 1
        self.p_ids = np.append(self.p_ids, np.int64(iid))
        self.p_server.append(server)
        self.p_busy = np.append(self.p_busy, 0.0)
        self.p_eta = np.append(self.p_eta, 0.0)
        self.p_qlen = np.append(self.p_qlen, np.int64(0))
        self.p_healthy = np.append(self.p_healthy, True)
        self.p_queue.append(deque())
        self.p_running.append(None)
        h = PrefillHandle(self, s)
        self.prefill.append(h)
        self._pre_slot[int(iid)] = s
        if self.chunks is not None:
            self.chunks.add_slot()
        return h

    def fail_prefill(self, iid: int, now: float) -> list[RequestState]:
        """Hard prefill failure: drop queued/in-flight work, return victims
        for re-scheduling (``kill_prefill`` fault kind).  Victims come back
        in the reference's order: the running request (chunked: stream list
        order), then the queue."""
        s = self._pre_slot[iid]
        self.p_healthy[s] = False
        victims: list[RequestState] = []
        if self.chunks is not None:
            for st in list(self.chunks.streams[s]):
                victims.append(st.rs)
                self.chunks.cancel(s, st.rs)
            return victims
        if self.p_running[s] is not None:
            victims.append(self.p_running[s])
            self.p_running[s] = None
        victims.extend(self.p_queue[s])
        self.p_queue[s].clear()
        self.p_qlen[s] = 0
        return victims

    def prefill_drained(self, iid: int) -> bool:
        """No running or queued prefill work on ``iid`` (flip precondition)."""
        s = self._pre_slot[iid]
        if self.chunks is not None:
            return not self.chunks.streams[s] and self.chunks.inflight[s] is None
        return self.p_running[s] is None and not self.p_queue[s]

    def decode_drained(self, iid: int) -> bool:
        """No active batch, queue, or deflected stream on ``iid``."""
        s = self.view.slot_of(iid)
        if self.d_active[s] or self.d_qlen[s] or not self.d_healthy[s]:
            return False
        if self.deflect is not None and (
                self.deflect.streams[s] or self.deflect.inflight[s] is not None):
            return False
        return True

    def flip_role(self, iid: int, role: int, now: float) -> None:
        """Planned role transition (RolePlane slow control loop).

        The caller drains first (``decode_drained``/``prefill_drained``);
        the flip itself is then pure bookkeeping: the ``ClusterView`` role
        column resyncs so the scheduler ladder and the cohort selector mask
        the instance out of (or back into) the candidate set, and a
        decode->prefill flip performs the RadixPlane handoff — the prefix
        cache is dropped (contents *and* counters), because a prefill host
        keeps no decode-side radix state.
        """
        s = self.view.slot_of(iid)
        if role == ROLE_PREFILL:
            self.view.role[s] = ROLE_PREFILL
            self.cache.reset_instance(s)
            self._sync_slot(s)
            ps = self._pre_slot.get(int(iid))
            if ps is not None:
                self.p_healthy[ps] = True
            else:
                self.add_prefill(iid, self.d_server[s])
        elif role == ROLE_DECODE:
            self.p_healthy[self._pre_slot[int(iid)]] = False
            self.view.role[s] = ROLE_DECODE
            self._sync_slot(s)
        else:
            raise ValueError(f"unknown role {role!r}")

    # ------------------------------------------------------------ deflection
    def enable_deflection(self) -> ChunkPlane:
        """Attach the deflect ChunkPlane over the decode slots.

        Reuses the prefill plane's chunk/budget settings: a deflected
        request is metered by the same token-budget iteration clock, just
        on a decode host — its KV is born there, so completion feeds
        straight into reserve/enqueue with no transfer.
        """
        if self.chunks is None:
            raise ValueError("deflection requires chunked prefill "
                             "(set chunk_tokens)")
        if self.deflect is None:
            self.deflect = ChunkPlane(
                self, self.n_dec, chunk_tokens=self.chunks.chunk,
                token_budget=self.chunks.budget,
                ids_attr="d_ids", healthy_attr="d_healthy", deflect=True,
            )
        return self.deflect

    def deflect_eta_row(self, now: float) -> np.ndarray:
        """Per-decode-slot deflected-chunk drain ETA (Eq. (5) deflected
        branch's ETA_defl term, aligned with ClusterView slots)."""
        return self.deflect.eta_row(now, self.n_dec)

    def submit_deflected(self, iid: int, rs: RequestState, now: float) -> None:
        rs.prefill_instance = int(iid)
        rs.deflected = True
        self.deflect.submit(self.view.slot_of(iid), rs, now)

    def set_chunking(self, chunk_tokens: int, token_budget: int) -> None:
        """Retune chunk size / per-iteration token budget (auto-tuner).

        Iterations already in flight keep their claimed durations; the next
        ``_maybe_start`` on every instance reads the new values.
        """
        if self.chunks is None:
            raise ValueError("set_chunking requires chunked prefill")
        if int(chunk_tokens) <= 0 or int(token_budget) <= 0:
            raise ValueError("chunk_tokens / token_budget must be positive")
        for plane in (self.chunks, self.deflect):
            if plane is not None:
                plane.chunk = int(chunk_tokens)
                plane.budget = int(token_budget)

    # ---------------------------------------------------------------- decode
    def add_decode(self, iid: int, server, kv_budget: float | None = None
                   ) -> DecodeHandle:
        budget = self.kv_budget if kv_budget is None else kv_budget
        s = self.view.add_instance(iid, free_memory=budget, healthy=True)
        if s != self.n_dec:  # pragma: no cover - plane is the sole registrar
            raise RuntimeError("view slots out of step with InstancePlane")
        if self.n_dec == len(self.d_ids):
            self._grow_decode()
        self.n_dec += 1
        self.d_ids[s] = iid
        self.d_server.append(server)
        self.d_budget[s] = budget
        self.d_pinned[s] = 0.0
        self.d_active[s] = 0
        self.d_qlen[s] = 0
        self.d_healthy[s] = True
        self.d_iter_scale[s] = 1.0
        self.d_iter_scale_est[s] = 1.0
        self.d_iterations[s] = 0
        self.d_deadline[s] = np.inf
        self.d_queue.append(deque())
        self._inst_rows.append([])
        self.cache.add_instance(budget)
        if self.deflect is not None:
            self.deflect.add_slot()
        h = DecodeHandle(self, s)
        self.decode.append(h)
        return h

    def _grow_decode(self) -> None:
        cap = len(self.d_ids) * 2
        for name in ("d_ids", "d_budget", "d_pinned", "d_active", "d_qlen",
                     "d_healthy", "d_iter_scale", "d_iter_scale_est",
                     "d_iterations"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            new[: self.n_dec] = old[: self.n_dec]
            setattr(self, name, new)
        dl = np.full(cap, np.inf, np.float64)
        dl[: self.n_dec] = self.d_deadline[: self.n_dec]
        self.d_deadline = dl

    def decode_by_id(self, iid: int) -> DecodeHandle:
        return self.decode[self.view.slot_of(iid)]

    def is_healthy(self, iid: int) -> bool:
        return bool(self.d_healthy[self.view.slot_of(iid)])

    # --------------------------------------------------------------- scoring
    def fill_hits(self, req: Request) -> None:
        """lambda_r(d) for all instances in one broadcast LCP comparison."""
        self.cache.hit_row(req.block_hashes, req.input_len,
                           out=self.view.hit_tokens)

    def hit_tokens(self, iid: int, req: Request) -> float:
        return float(self.cache.hit_tokens(
            self.view.slot_of(iid), req.block_hashes, req.input_len))

    def hit_rows(self, reqs) -> np.ndarray:
        """lambda_r(d) for a dispatch cohort: (R, D) hit-token matrix in one
        pass over the shared presence bitmask (see RadixPlane.hit_rows)."""
        return self.cache.hit_rows(reqs)

    def evictions_of(self, iid: int) -> int:
        """Cumulative eviction count for one instance (cohort-dispatch
        staleness watch: a changed count invalidates cached hit rows)."""
        return int(self.cache.evictions[self.view.slot_of(iid)])

    # -------------------------------------------------------------- lifecycle
    def reserve(self, iid: int, rs: RequestState, now: float) -> None:
        """Pin KV for an inbound transfer (memory committed at dispatch)."""
        s = self.view.slot_of(iid)
        self.d_pinned[s] += rs.kv_bytes
        self.cache.evict_to(s, float(self.d_pinned[s]))
        self._sync_slot(s)

    def release(self, iid: int, rs: RequestState) -> None:
        s = self.view.slot_of(iid)
        self.d_pinned[s] = max(0.0, float(self.d_pinned[s]) - rs.kv_bytes)
        self._sync_slot(s)

    def enqueue(self, iid: int, rs: RequestState, now: float) -> None:
        """Transfer landed: blocks now resident; join the batch queue."""
        s = self.view.slot_of(iid)
        self.cache.insert(s, rs.req.block_hashes,
                          protected=float(self.d_pinned[s]))
        self.d_queue[s].append(rs)
        self.d_qlen[s] += 1
        self._sync_slot(s)

    def kick(self, iids, now: float) -> None:
        """Epoch admission: start/continue iterating every touched instance."""
        for iid in iids:
            s = self.view.slot_of(iid)
            self._maybe_iterate(s, now)
            self._sync_slot(s)
        self._reschedule_clock()

    def set_iter_scale(self, iid: int, factor: float) -> None:
        self.d_iter_scale[self.view.slot_of(iid)] = float(factor)

    def mark_detected(self, iid: int, now: float) -> None:
        """Fault detection fired: health becomes scheduler-visible."""
        s = self.view.slot_of(iid)
        self.view.healthy[s] = bool(self.d_healthy[s])

    def fail(self, iid: int, now: float) -> list[RequestState]:
        """Hard failure: drop all state, return victims for re-scheduling.

        Victims are returned in the reference's order: active requests in
        admission order, then the queued requests in queue order.
        """
        s = self.view.slot_of(iid)
        self.d_healthy[s] = False
        rows = self._inst_rows[s]
        self._inst_rows[s] = []
        victims = [self.r_obj[r] for r in rows]  # admission order
        victims.extend(self.d_queue[s])
        if self.deflect is not None:
            # Deflected requests still prefilling on the dead host requeue
            # like everything else (post-prefill ones are already queued).
            for st in list(self.deflect.streams[s]):
                victims.append(st.rs)
                self.deflect.cancel(s, st.rs)
        for r in rows:
            self._free_row(r)
        self.d_queue[s].clear()
        self.d_qlen[s] = 0
        self.d_active[s] = 0
        self.d_pinned[s] = 0.0
        self.cache.reset_instance(s)
        self.d_deadline[s] = np.inf
        self._sync_slot(s)
        self._reschedule_clock()
        return victims

    # ---------------------------------------------------- continuous batching
    def _reserve_rows(self, k: int) -> None:
        """Grow the request table until at least ``k`` rows are free."""
        while len(self._r_free) < k:
            rcap = len(self.r_live)
            new_cap = rcap * 2
            for name in ("r_live", "r_tokens", "r_out", "r_inst", "r_seq"):
                old = getattr(self, name)
                new = np.zeros(new_cap, old.dtype)
                new[:rcap] = old
                setattr(self, name, new)
            self.r_obj.extend([None] * rcap)
            self._r_free.extend(range(new_cap - 1, rcap - 1, -1))

    def _alloc_row(self) -> int:
        if not self._r_free:
            self._reserve_rows(1)
        r = self._r_free.pop()
        self._r_hi = max(self._r_hi, r + 1)
        return r

    def _free_row(self, r: int) -> None:
        self.r_live[r] = False
        self.r_obj[r] = None
        self._r_free.append(r)

    def _maybe_iterate(self, s: int, now: float) -> None:
        if self.d_deadline[s] < np.inf or not self.d_healthy[s]:
            return
        active = int(self.d_active[s])
        q = self.d_queue[s]
        if active == 0 and not q:
            return
        if q and active < self.beta_max:
            # Admit from the queue at the iteration boundary (Orca-style),
            # the whole kick-epoch cohort in one vectorised batch: row
            # allocation is a single free-list slice (same pop order as
            # repeated _alloc_row), the table columns are fancy-index
            # writes, and the per-request TBT-at-entry values — t_iter of
            # the batch size each request joins — come out of one
            # iter_time_vector call (element-for-element the IEEE op
            # sequence of the scalar iter_model, so rs.tbt stays
            # bit-identical to the reference's per-request computation).
            k = min(len(q), self.beta_max - active)
            self._reserve_rows(k)
            free = self._r_free
            rows = free[-k:][::-1]           # == k successive .pop()s
            del free[-k:]
            self._r_hi = max(self._r_hi, max(rows) + 1)
            admitted = [q.popleft() for _ in range(k)]
            idx = np.array(rows, np.intp)
            self.r_live[idx] = True
            self.r_tokens[idx] = 0
            self.r_out[idx] = [rs.req.output_len for rs in admitted]
            self.r_inst[idx] = s
            seq = self._next_seq
            self.r_seq[idx] = np.arange(seq, seq + k)
            self._next_seq = seq + k
            scale = float(self.d_iter_scale[s])
            # §VI-A: TBT at entry — batch sizes active+1 .. active+k.
            tbts = (iter_time_vector(self.iter_model,
                                     np.arange(active + 1, active + k + 1))
                    * scale).tolist()
            r_obj = self.r_obj
            for r, rs, tbt in zip(rows, admitted, tbts):
                rs.admit_time = now
                rs.tbt = tbt
                r_obj[r] = rs
            self._inst_rows[s].extend(rows)
            active += k
            self.d_qlen[s] = len(q)
            self.d_active[s] = active
        if active == 0:
            return
        dur = self.iter_model(active) * float(self.d_iter_scale[s])
        self.decode_busy_s += dur
        self.d_deadline[s] = now + dur

    def _reschedule_clock(self) -> None:
        n = self.n_dec
        t = float(self.d_deadline[:n].min()) if n else np.inf
        if np.isfinite(t):
            self.loop.arm(LANE_CLOCK, t, self._step, dedupe=True)
        else:
            self.loop.disarm(LANE_CLOCK)

    def _step(self, now: float) -> None:
        """Clock-lane dispatch: step every instance due at ``now``.

        On a batched engine this is a *horizon loop*: after the due cohort
        steps, the plane keeps absorbing its own future iteration
        boundaries — fused per-instance runs via ``_fast_forward`` where no
        admission/first-token/finish can occur, in-batch cohort steps via
        ``lane_tick`` otherwise — up to the earliest event pending on any
        other lane.  Nothing else can dispatch inside that window, so the
        absorbed boundaries observe exactly the state the reference engine
        would hand them, one heap pop at a time.  On the reference engine
        it is one cohort step + re-arm, as before.
        """
        loop = self.loop
        if not loop.batched:
            self._step_cohort(now)
            self._reschedule_clock()
            return
        while True:
            self._step_cohort(now)
            h = loop.lane_horizon(LANE_CLOCK)
            t = self._fast_forward(h)
            if t < h:
                # Next boundary still precedes every other lane but needs
                # the full cohort step (admission pending, first token or
                # finish due, or a deadline tie across instances).
                loop.lane_tick(LANE_CLOCK, t)   # advances loop.now first
                now = t
                continue
            if t < np.inf:
                loop.arm(LANE_CLOCK, t, self._step, dedupe=True)
            else:
                loop.disarm(LANE_CLOCK)
            return

    def _fast_forward(self, h: float) -> float:
        """Fuse eligible instances' iteration boundaries strictly below ``h``.

        An instance qualifies while nothing observable can happen at its
        boundaries: healthy, empty admit queue, all rows past their first
        token, and stopping one boundary short of the earliest finish.  For
        such a run the per-boundary work collapses to scalar float updates —
        the *same op sequence* the cohort step performs (EWMA estimator,
        one ``+= kv_per_token`` per active row, cache evict-to-limit,
        ``deadline += t_iter``), so state lands bit-identical to stepping
        through the engine.  Returns the new earliest deadline.
        """
        n = self.n_dec
        dl = self.d_deadline
        if not n:
            return float(np.inf)
        cand = (dl[:n] < h).nonzero()[0]
        if cand.size:
            loop = self.loop
            cache = self.cache
            trace = loop.trace_log is not None
            kpt = float(self.kv_per_token)
            bpb = cache.bytes_per_block
            budget = cache.budget
            count = cache.count
            evict = cache._evict_to_limit
            iter_model = self.iter_model
            r_tokens, r_out = self.r_tokens, self.r_out
            est = self.d_iter_scale_est
            for s_ in cand:
                s = int(s_)
                if not self.d_healthy[s] or self.d_qlen[s]:
                    continue
                rows = self._inst_rows[s]
                if not rows:
                    continue
                mintok = 10 ** 9
                max_k = 10 ** 9
                for r in rows:
                    tk = int(r_tokens[r])
                    rem = int(r_out[r]) - tk
                    if tk < mintok:
                        mintok = tk
                    if rem < max_k:
                        max_k = rem
                max_k -= 1      # the boundary reaching a finish runs slow
                if mintok < 1 or max_k <= 0:
                    continue
                active = len(rows)
                scale = float(self.d_iter_scale[s])
                dur = iter_model(active) * scale
                t = float(dl[s])
                e = float(est[s])
                p = float(self.d_pinned[s])
                cb = float(budget[s])
                nb = int(count[s])
                k = 0
                times = [] if trace else None
                while t < h and k < max_k:
                    e = e + 0.2 * (scale - e)
                    for _ in range(active):
                        p = p + kpt
                    limit = cb - p
                    if limit < 0.0:
                        limit = 0.0
                    if nb * bpb > limit:
                        evict(s, limit)
                        nb = int(count[s])
                    if trace:
                        times.append(t)
                    k += 1
                    t = t + dur
                if not k:
                    continue
                self.decode_busy_s += k * dur
                dl[s] = t
                est[s] = e
                self.d_pinned[s] = p
                self.d_iterations[s] += k
                for r in rows:
                    r_tokens[r] += k
                self._sync_slot(s)
                loop.lane_ticks(LANE_CLOCK, k, times=times)
        return float(dl[:n].min())

    def _step_cohort(self, now: float) -> None:
        """Cohort iteration boundary: every instance due at ``now`` steps.

        Token accounting, first-token detection, decode-side KV growth and
        finish detection are fused array ops over the cohort's request rows;
        per-finish bookkeeping runs in admission order per instance, exactly
        reproducing the reference's dict-ordered float accounting.  Small
        cohorts (<= ``scalar_rows_max`` active rows) take a scalar path over
        the per-instance row lists instead of the full-table scan — the
        arithmetic is operation-for-operation the same, so both paths stay
        bit-identical to the reference (the parity tests pin the threshold
        to force each).
        """
        n = self.n_dec
        cohort = (self.d_deadline[:n] <= now).nonzero()[0]
        if cohort.size:
            est = self.d_iter_scale_est
            if cohort.size == 1:
                # Overwhelmingly common with staggered deadlines: one
                # instance due — scalar bookkeeping, same arithmetic.
                s = int(cohort[0])
                self.d_deadline[s] = np.inf
                self.d_iterations[s] += 1
                est[s] += 0.2 * (self.d_iter_scale[s] - est[s])
                nrows = len(self._inst_rows[s])
            else:
                self.d_deadline[cohort] = np.inf
                self.d_iterations[cohort] += 1
                est[cohort] += 0.2 * (self.d_iter_scale[cohort] - est[cohort])
                nrows = int(self.d_active[cohort].sum())
            if nrows <= self.scalar_rows_max:
                self._step_rows_scalar(cohort, now)
            else:
                self._step_rows_vector(cohort, now)
            # Growth may overcommit: evict the LRU cache down to the pin
            # level on every iterating instance (reference does this each
            # _iter_done), then start the next iteration / admit waiters.
            self.cache.evict_cohort(cohort, self.d_pinned[cohort])
            if cohort.size > 4:
                # Vector restart for instances with nothing to admit (the
                # steady-state bulk of a synchronized cohort): deadline =
                # now + t_iter(beta) * scale, elementwise — the same op
                # sequence as _maybe_iterate's scalar arithmetic.
                easy = (self.d_qlen[cohort] == 0) & (self.d_active[cohort] > 0) \
                    & self.d_healthy[cohort]
                ez = cohort[easy]
                if ez.size:
                    dur = iter_time_vector(self.iter_model, self.d_active[ez]) \
                        * self.d_iter_scale[ez]
                    self.decode_busy_s += float(dur.sum())
                    self.d_deadline[ez] = now + dur
                rest = cohort[~easy]
            else:
                rest = cohort
            for s in rest:
                self._maybe_iterate(int(s), now)
            if cohort.size == 1:
                self._sync_slot(int(cohort[0]))
            else:
                self._sync_rows(cohort)

    def _step_rows_scalar(self, cohort, now: float) -> None:
        """Small-cohort token accounting: per-row scalar ops, no table scan."""
        r_tokens, r_out, r_obj = self.r_tokens, self.r_out, self.r_obj
        pinned = self.d_pinned
        kpt = float(self.kv_per_token)
        for s_ in cohort:
            s = int(s_)
            rows = self._inst_rows[s]
            if not rows:
                continue
            finished: list[int] = []
            for r in rows:
                t = int(r_tokens[r]) + 1
                r_tokens[r] = t
                if t == 1:
                    rs = r_obj[r]
                    rs.first_token = now
                    if self._on_first_token:
                        self._on_first_token(rs, now)
                # Decode-side KV growth: one token per active request —
                # one scalar add per request, as the reference does.
                pinned[s] += kpt
                if t >= r_out[r]:
                    finished.append(r)
            if finished:
                for r in finished:
                    rs = r_obj[r]
                    rs.finish = now
                    rs.tokens_out = int(r_tokens[r])
                    grown = rs.kv_bytes + rs.req.output_len * self.kv_per_token
                    pinned[s] = max(0.0, float(pinned[s]) - grown)
                    self._free_row(r)
                    self.d_active[s] -= 1
                    if self._on_finish:
                        self._on_finish(rs, now)
                gone = set(finished)
                self._inst_rows[s] = [r for r in rows if r not in gone]

    def _step_rows_vector(self, cohort, now: float) -> None:
        """Large-cohort token accounting: fused array ops over the table."""
        n = self.n_dec
        hi = self._r_hi
        in_cohort = np.zeros(n, bool)
        in_cohort[cohort] = True
        rows = (self.r_live[:hi] & in_cohort[self.r_inst[:hi]]).nonzero()[0]
        if not rows.size:
            return
        self.r_tokens[rows] += 1
        toks = self.r_tokens[rows]
        for r in rows[toks == 1]:
            rs = self.r_obj[r]
            rs.first_token = now
            if self._on_first_token:
                self._on_first_token(rs, now)
        # Decode-side KV growth: one token per active request.  np.add.at
        # applies the equal-sized additions sequentially per instance
        # accumulator — bit-identical to the reference's one-request-at-a-
        # time += loop.
        np.add.at(self.d_pinned, self.r_inst[rows], float(self.kv_per_token))
        fin = rows[toks >= self.r_out[rows]]
        if fin.size:
            # Finish bookkeeping in admission order per instance — the
            # reference's dict order, and the order the per-instance
            # max(0, pinned - grown) clamp sequence depends on.
            order = np.lexsort((self.r_seq[fin], self.r_inst[fin]))
            fin = fin[order]
            fin_rows = fin.tolist()                     # one bulk convert
            fin_insts = self.r_inst[fin].tolist()
            fin_toks = self.r_tokens[fin].tolist()
            r_live, r_obj = self.r_live, self.r_obj
            free = self._r_free
            pinned = self.d_pinned
            active = self.d_active
            kpt = self.kv_per_token
            on_finish = self._on_finish
            touched: dict[int, set] = {}
            for r, s, t in zip(fin_rows, fin_insts, fin_toks):
                rs = r_obj[r]
                rs.finish = now
                rs.tokens_out = t
                grown = rs.kv_bytes + rs.req.output_len * kpt
                pinned[s] = max(0.0, float(pinned[s]) - grown)
                r_live[r] = False
                r_obj[r] = None
                free.append(r)
                touched.setdefault(s, set()).add(r)
                active[s] -= 1
                if on_finish:
                    on_finish(rs, now)
            # One admission-order rebuild per touched instance (a per-finish
            # list.remove would be O(beta) per finished request).
            for s, gone in touched.items():
                self._inst_rows[s] = [
                    r for r in self._inst_rows[s] if r not in gone
                ]

    def finalize(self) -> None:
        """Write per-request token counts back to the RequestState objects.

        The reference engine mutates ``rs.tokens_out`` per token; the plane
        keeps the count columnar and flushes it once at end of run (finished
        requests are flushed at finish time), so records of requests still
        decoding at the horizon report the same partial progress.
        """
        for r in np.flatnonzero(self.r_live[: self._r_hi]):
            self.r_obj[r].tokens_out = int(self.r_tokens[r])

    # ------------------------------------------------------------ telemetry
    @property
    def total_iterations(self) -> int:
        return int(self.d_iterations[: self.n_dec].sum())

    @property
    def prefill_busy_s(self) -> float:
        """Cumulative prefill compute seconds (serial or chunked)."""
        if self.chunks is not None:
            return self.chunks.busy_s
        return self._p_busy_s

    @property
    def deflect_busy_s(self) -> float:
        """Cumulative deflected-prefill compute seconds on decode hosts."""
        return self.deflect.busy_s if self.deflect is not None else 0.0

    def cache_stats(self) -> list[dict]:
        """Per-instance cache counters for the parity tests."""
        c = self.cache
        return [
            dict(instance_id=int(self.d_ids[s]), hits=int(c.hits[s]),
                 misses=int(c.misses[s]), evictions=int(c.evictions[s]),
                 bytes_used=c.bytes_used(s))
            for s in range(self.n_dec)
        ]
