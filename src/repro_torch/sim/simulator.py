# The port's own copy of repro/sim/simulator.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""End-to-end disaggregated-serving simulation (§VI-A/B).

Wires trace -> prefill pool -> scheduler (decode-instance selection) ->
flow-level network transfer -> continuous-batching decode -> metrics.

Scheduler decisions use only scheduler-visible state: per-instance compute
metrics refreshed at each scheduling event and oracle-provided network
metrics refreshed every Delta_oracle seconds; the scheduler cannot observe
per-flow network state or future arrivals.

The instance layer is pluggable (``SimConfig.instance_engine``):

* ``"plane"`` (default) — the columnar ``InstancePlane`` with one
  cohort-stepped iteration clock and the array-backed RadixPlane cache.
* ``"reference"`` — the retired per-object ``PrefillSim``/``DecodeSim``
  engine (``sim/reference.py``), kept as the bit-exact parity oracle and
  benchmark baseline.

Admission is **epoch-batched**: every transfer completion the FlowPlane
pops at one net instant is enqueued first, then each touched decode
instance is kicked exactly once — so same-instant landings on an idle
instance join the same first iteration, and the network sees one
``_reschedule_net`` per epoch.  Window-batched scheduling (netkv-batch)
similarly opens a FlowPlane *arrival epoch* around its dispatch burst: all
transfers start, then one union dirty-component rate recompute runs
(bit-identical rates; see ``FlowPlane.begin_epoch``).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Sequence

import numpy as np

from ..core.cost import (
    H100_TP4_ITER,
    H100_TP4_PREFILL,
    IterTimeModel,
    LLAMA3_70B_KV,
    ModelKVSpec,
    PrefillTimeModel,
)
from ..core.dispatch import CohortItem, supports_cohort
from ..core.oracle import NetworkCostOracle, SelfContentionTracker
from ..core.schedulers import RequestInfo, make_scheduler
from ..core.batch_assign import NetKVBatch
from ..core.multihop import NetKVMultiHop, StagingStore
from ..core.view import ClusterView, ROLE_DECODE, ROLE_PREFILL
from ..cluster.network import BackgroundTraffic, FlowPlane, Transfer
from ..cluster.topology import FatTree, make_instances
from ..traces.mooncake import Request
from .engine import (
    LANE_ARRIVAL,
    LANE_FAULT,
    LANE_NET,
    LANE_REWIRE,
    LANE_ROLE,
    LANE_TICK,
    make_event_loop,
)
from .instances import InstancePlane, RequestState
from .metrics import RunMetrics, summarize
from .reference import ReferenceInstanceEngine
from .trace import TracePlane, trace_session


@dataclasses.dataclass
class FaultEvent:
    time: float
    # "kill_decode" | "add_decode" | "slowdown" | "kill_prefill" | "add_prefill"
    kind: str
    instance_id: int = -1
    factor: float = 2.0  # slowdown factor
    detection_delay: float = 0.25


@dataclasses.dataclass
class RewireEvent:
    """Scheduled OCS reconfiguration: swap tier capacities at ``time``.

    ``tier_bandwidth`` sets absolute per-tier bytes/s; ``scale`` multiplies
    the current values (both partial maps; ``scale`` applies after).  The
    swap is atomic at ``time``: the FlowPlane re-water-fills every in-flight
    flow immediately, while the scheduler keeps routing on the oracle's
    pre-rewire snapshot until the next oracle refresh.
    """

    time: float
    tier_bandwidth: dict | None = None
    scale: dict | None = None


@dataclasses.dataclass
class SimConfig:
    scheduler: str = "netkv-full"
    scheduler_kwargs: dict = dataclasses.field(default_factory=dict)
    # topology
    n_pods: int = 2
    racks_per_pod: int = 2
    servers_per_rack: int = 2
    gpus_per_server: int = 8
    tier_bandwidth: dict | None = None
    tier_latency: dict | None = None
    n_tor_uplinks: int = 8
    n_agg_uplinks: int = 8
    nics_per_server: int = 1
    nic_policy: str = "hash"                # "hash" | "least-loaded" | "rail-affine"
    # instances
    tp: int = 4
    n_prefill: int = 4
    beta_max: int = 64
    hbm_free_per_gpu: float = 45e9          # §VI-A: 45 GB free HBM per GPU
    kv_spec: ModelKVSpec = LLAMA3_70B_KV
    iter_model: IterTimeModel = H100_TP4_ITER
    prefill_model: PrefillTimeModel = H100_TP4_PREFILL
    m_min: float = 2e9
    instance_engine: str = "plane"          # "plane" | "reference"
    # chunked prefill (ChunkPlane): None = serial whole-request prefill
    # (bit-exact legacy model); an int enables chunk-interleaved prefill
    # with that chunk size.
    chunk_tokens: int | None = None
    prefill_token_budget: int | None = None  # tokens per prefill iteration
    # Stream completed chunks into the network while later chunks still
    # prefill: the decode instance is selected at *first* chunk readiness
    # and each chunk's KV bytes enter the FlowPlane as it completes; decode
    # admission still waits for the last byte.  Requires chunk_tokens.
    kv_streaming: bool = False
    # oracle / network
    oracle_refresh: float = 1.0
    telemetry_source: str = "model"         # "model" | "measured"
    background: float | dict = 0.0
    bg_wander: float = 0.25
    inflight_cap: int = 16
    # run windows
    warmup: float = 5.0
    measure: float = 15.0
    seed: int = 0
    # faults / elasticity / topology dynamics
    faults: Sequence[FaultEvent] = ()
    rewires: Sequence[RewireEvent] = ()     # OCS capacity timeline
    # Rewire notifications: when True every RewireEvent also forces an
    # out-of-band oracle refresh at the reconfiguration instant, so the
    # scheduler prices the new capacities immediately instead of riding
    # the stale snapshot until the periodic refresh (exp9's
    # notified-vs-stale arms).
    notify_rewires: bool = False
    net_tick: float = 0.1                   # rate refresh for wandering bg
    # "auto" elides the fixed-interval net tick while background traffic is
    # piecewise-constant AND no flow is in the air — ticks that are provably
    # no-ops — re-arming on the preserved tick grid when a transfer starts.
    # "always" keeps every tick (the pre-EventPlane behaviour; outcomes are
    # identical either way).
    net_tick_mode: str = "auto"             # "auto" | "always"
    event_engine: str = "plane"             # "plane" | "reference"
    # DispatchPlane: "plane" batches every same-timestamp cohort of
    # dispatch-ready requests through one fused R x D selection
    # (core/dispatch.py — bit-exact vs the per-request path, including the
    # RNG tie-break stream); "reference" keeps one Scheduler.select call
    # per request.  "plane" silently degrades to per-request selection for
    # schedulers without a cohort path (netkv-batch, netkv-multihop), the
    # reference instance engine, or a zero oracle refresh interval (where
    # each sequential select would legitimately observe fresher telemetry).
    dispatch_mode: str = "plane"            # "plane" | "reference"
    staging_capacity: float = 512e9         # per-pod DRAM KV store (multihop)
    # TracePlane (sim/trace.py): lifecycle spans + decision forensics.
    # Off by default — no span allocation, no hook calls on the hot path.
    # Also auto-enabled for the run when a process-wide TraceSession is
    # active (benchmarks/run.py --trace).
    trace: bool = False
    trace_decisions: int = 1                # record every Nth decision
    # RolePlane: prefill deflection.  When the healthy prefill pool's
    # backlog (earliest drain ETA minus now) exceeds deflect_threshold
    # seconds, an arriving request is offered to the decode instances as a
    # *prefill* target first: Eq. (4) collapses to a zero-transfer KV term
    # (the KV is born on the decode host: s_eff = 0, tier 0) plus the
    # host's deflected-chunk-queue drain ETA.  Requires the plane instance
    # engine and chunk_tokens (deflected prefill is metered by an
    # attachable ChunkPlane over the decode slots).
    deflection: str = "off"                 # "off" | "on"
    deflect_threshold: float = 0.5          # seconds of prefill backlog
    # RolePlane: dynamic P:D flipping — a slow control loop on LANE_ROLE
    # samples prefill backlog every role_flip_interval seconds (0 = off)
    # and, after role_flip_sustain consecutive samples beyond a bound,
    # converts ONE drained instance: decode -> prefill above role_flip_hi,
    # the most recent convert back below role_flip_lo.  Pool floors
    # (min_prefill / min_decode healthy instances) are never crossed.
    role_flip_interval: float = 0.0
    role_flip_sustain: int = 3
    role_flip_hi: float = 0.75
    role_flip_lo: float = 0.15
    min_prefill: int = 1
    min_decode: int = 1
    # ChunkPlane auto-tuning: adapt chunk_tokens (and a 4x token budget) to
    # the observed arrival input-length EWMA.  Requires chunk_tokens; driven
    # by the arrival stream alone, so both instance engines see identical
    # retune sequences (parity-safe).
    chunk_autotune: bool = False


class Simulation:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.loop = make_event_loop(cfg.event_engine)
        self.tree = FatTree(
            cfg.n_pods, cfg.racks_per_pod, cfg.servers_per_rack, cfg.gpus_per_server,
            tier_bandwidth=cfg.tier_bandwidth, tier_latency=cfg.tier_latency,
            n_tor_uplinks=cfg.n_tor_uplinks, n_agg_uplinks=cfg.n_agg_uplinks,
            nics_per_server=cfg.nics_per_server,
        )
        bg = cfg.background
        self.bg = bg if isinstance(bg, BackgroundTraffic) else BackgroundTraffic(
            bg, wander=cfg.bg_wander, seed=cfg.seed
        )
        self.net = FlowPlane(self.tree, self.bg, seed=cfg.seed,
                             nic_policy=cfg.nic_policy)
        pre_meta, dec_meta = make_instances(self.tree, tp=cfg.tp, n_prefill=cfg.n_prefill)
        kv_budget = cfg.hbm_free_per_gpu * cfg.tp
        self._server_of = {
            i.instance_id: i.server for i in (*pre_meta, *dec_meta)
        }
        # Columnar scheduler-visible state plane, maintained incrementally by
        # the instance engine (write-through), never rebuilt per request.
        self.view = ClusterView(
            tier_fn=lambda a, b: self.tree.tier(self._server_of[a], self._server_of[b]),
            capacity=max(len(dec_meta), 1),
        )
        if cfg.kv_streaming:
            if cfg.chunk_tokens is None:
                raise ValueError("kv_streaming requires chunk_tokens")
            if cfg.scheduler == "netkv-multihop":
                raise ValueError("kv_streaming does not compose with the "
                                 "staged multihop scheduler")
            if cfg.scheduler == "netkv-batch":
                # Streamed requests are committed per-request at first-chunk
                # readiness; silently running the windowed joint assigner in
                # that mode would degrade it to greedy select() under its
                # own name.  Refuse until a first-chunk-keyed window exists
                # (ROADMAP: streaming-aware batch window).
                raise ValueError("kv_streaming does not compose with the "
                                 "windowed netkv-batch scheduler yet")
        eng_kw = dict(view=self.view, loop=self.loop, iter_model=cfg.iter_model,
                      prefill_model=cfg.prefill_model, beta_max=cfg.beta_max,
                      kv_spec=cfg.kv_spec, kv_budget=kv_budget,
                      chunk_tokens=cfg.chunk_tokens,
                      prefill_token_budget=cfg.prefill_token_budget)
        if cfg.instance_engine == "reference":
            self.engine = ReferenceInstanceEngine(pre_meta, dec_meta, **eng_kw)
        elif cfg.instance_engine == "plane":
            self.engine = InstancePlane(pre_meta, dec_meta, **eng_kw)
        else:
            raise ValueError(f"unknown instance_engine {cfg.instance_engine!r}")
        self.prefill = self.engine.prefill
        self.decode = self.engine.decode
        # topology= wires the static B_tau/L_tau maps to the live tree, so
        # rewires surface at the next oracle refresh (not before).
        self.oracle = NetworkCostOracle(
            tier_of=lambda a, b: self.tree.tier(self._server_of[a], self._server_of[b]),
            topology=self.tree,
            telemetry_fn=lambda now: self.net.tier_congestion(now),
            measured_fn=lambda now: self.net.measured_tier_congestion(now),
            source=cfg.telemetry_source,
            refresh_interval=cfg.oracle_refresh,
        )
        self.inflight = SelfContentionTracker(cap=cfg.inflight_cap)
        if cfg.scheduler == "netkv-multihop":
            # Beyond paper (§VII-D): one CPU-DRAM staging store per pod,
            # hosted on the last rack's first server.
            stores = []
            for pod in range(cfg.n_pods):
                node_id = 1000 + pod
                self._extra_servers = getattr(self, "_extra_servers", {})
                srv = (pod, cfg.racks_per_pod - 1, 0)
                stores.append(StagingStore(
                    node_id,
                    capacity_bytes=cfg.staging_capacity,
                    bytes_per_block=16 * cfg.kv_spec.kv_bytes_per_token or 1.0,
                ))
                self._server_of[node_id] = srv
            self.sched = NetKVMultiHop(
                cfg.iter_model, cfg.beta_max, m_min=cfg.m_min, stores=stores,
                **cfg.scheduler_kwargs,
            )
        else:
            self.sched = make_scheduler(
                cfg.scheduler, cfg.iter_model, cfg.beta_max, m_min=cfg.m_min,
                **cfg.scheduler_kwargs,
            )
        self.records: list[RequestState] = []
        self.rejected = 0
        self.decision_latencies: list[float] = []
        # Net-tick elision state: _tick_next replays the exact float grid
        # the old after()-chain produced (sequential now + net_tick adds);
        # _tick_idle means the chain is dormant and must be woken by the
        # next network activity.
        self._tick_next = 0.0
        self._tick_idle = False
        self._net_tick_elidable = (cfg.net_tick_mode == "auto"
                                   and self.bg.is_static)
        self._batch_window: list[tuple[RequestState, int]] = []
        self._batch_timer = None
        self._inbound: dict[int, list] = {}   # decode id -> [(rs, transfer)]
        self._epoch: list | None = None       # landing buffer during net fire
        # Effective chunk granularity: the largest take a single iteration
        # can give one request (sizes the streamed-tail estimate).
        self._chunk_eff = None
        if cfg.chunk_tokens is not None:
            budget = cfg.prefill_token_budget or cfg.chunk_tokens
            self._chunk_eff = min(cfg.chunk_tokens, budget)
        self.engine.on_prefill_done = self._on_prefill_done
        if cfg.kv_streaming:
            self.engine.on_chunk_done = self._on_chunk_done
        if cfg.dispatch_mode not in ("plane", "reference"):
            raise ValueError(f"unknown dispatch_mode {cfg.dispatch_mode!r}")
        self._cohort_ok = (
            cfg.dispatch_mode == "plane"
            and isinstance(self.engine, InstancePlane)
            and supports_cohort(self.sched)
            and cfg.oracle_refresh > 0
        )
        if self._cohort_ok:
            self.engine.on_prefill_cohort = self._prefill_cohort
            if cfg.chunk_tokens is not None:
                self.engine.on_phase3_cohort = self._phase3_cohort
        self.engine.set_decode_callbacks(lambda rs, now: None,
                                         lambda rs, now: None)
        # TracePlane: created only when asked for — every emission site
        # below is behind an ``is not None`` guard, so the untraced hot
        # path costs one attribute load per site and allocates nothing.
        self.trace: TracePlane | None = None
        if cfg.trace or trace_session() is not None:
            self.trace = TracePlane(decision_stride=cfg.trace_decisions)
            self.engine.trace = self.trace
            self.sched.trace_hook = self.trace
            self.net.record_bottlenecks = True
        # RolePlane: deflection + P:D flip state.
        if cfg.deflection not in ("off", "on"):
            raise ValueError(f"unknown deflection {cfg.deflection!r}")
        self._deflect_on = cfg.deflection == "on"
        if self._deflect_on:
            if not isinstance(self.engine, InstancePlane):
                raise ValueError("deflection requires the plane instance engine")
            if cfg.chunk_tokens is None:
                raise ValueError("deflection requires chunk_tokens")
            if cfg.kv_streaming:
                # Deflected KV never crosses the wire, so there is nothing
                # to stream; refuse rather than silently mix the modes.
                raise ValueError("deflection does not compose with kv_streaming")
            self.engine.enable_deflection()
            self.engine.on_deflect_done = self._on_deflect_done
        self.deflected = 0
        self.role_flips = 0
        self._flipped: list[int] = []   # decode->prefill converts, flip-back LIFO
        self._hi_run = 0
        self._lo_run = 0
        if cfg.chunk_autotune and cfg.chunk_tokens is None:
            raise ValueError("chunk_autotune requires chunk_tokens")
        self._chunk_cur = cfg.chunk_tokens
        self._len_ewma = -1.0

    # ---------------------------------------------------------------- trace
    def load_trace(self, trace: Sequence[Request]) -> None:
        kv_bytes = self.cfg.kv_spec.kv_bytes
        arrivals: list[float] = []
        states: list[RequestState] = []
        for req in trace:
            rs = RequestState(req=req, kv_bytes=float(kv_bytes(req.input_len)))
            self.records.append(rs)
            arrivals.append(req.arrival)
            states.append(rs)
        # Whole schedules are known up front: bulk-load them as lane
        # cursors (presorted array + position on the plane engine; the
        # equivalent in-order at() sequence on the reference engine).
        self.loop.load_cursor(LANE_ARRIVAL, arrivals, states, self._on_arrival)
        faults = list(self.cfg.faults)
        if faults:
            self.loop.load_cursor(LANE_FAULT, [f.time for f in faults],
                                  faults, self._on_fault)
        rewires = list(self.cfg.rewires)
        if rewires:
            self.loop.load_cursor(LANE_REWIRE, [rw.time for rw in rewires],
                                  rewires, self._on_rewire)
        if self.cfg.net_tick > 0:
            self._tick_next = self.loop.now + self.cfg.net_tick
            self.loop.arm(LANE_TICK, self._tick_next, self._net_tick)
        if self.cfg.role_flip_interval > 0:
            self.loop.arm(LANE_ROLE, self.loop.now + self.cfg.role_flip_interval,
                          self._role_tick)

    # ------------------------------------------------------------ prefill side
    def _on_arrival(self, rs: RequestState, now: float) -> None:
        if self.cfg.chunk_autotune:
            self._autotune(rs.req.input_len)
        if self._deflect_on and \
                self.engine.prefill_backlog(now) > self.cfg.deflect_threshold:
            if self._deflect_one(rs, now):
                return
        target = self.engine.pick_prefill(now)
        if target is None:
            rs.rejected = True
            self.rejected += 1
            return
        target.submit(rs, now)

    # -------------------------------------------------- RolePlane: deflection
    def _deflect_one(self, rs: RequestState, now: float) -> bool:
        """Offer ``rs`` to the decode instances as a prefill target.

        The deflected ladder (``Scheduler.select_deflected``) scores
        ROLE_DECODE rows with Eq. (4) collapsed to a zero-transfer KV term;
        on acceptance the request is committed exactly like a dispatch —
        sched_time, reserve() pin — except its KV is born in place (tier 0,
        s_eff = 0).  Returns False (fall back to the prefill pool) when no
        decode row is feasible.
        """
        info = self._make_info(rs, False)
        if self.trace is not None:
            self.trace.now = now
        t0 = _time.perf_counter()
        decision = self.sched.select_deflected(
            info, self.view, self.engine.deflect_eta_row(now))
        dt = _time.perf_counter() - t0
        self.decision_latencies.append(dt)
        self.loop.note_select(dt)
        if decision is None:
            return False
        iid = decision.instance_id
        rs.sched_time = now
        rs.decode_instance = iid
        rs.tier = 0
        rs.s_eff = 0.0
        rs.hit_tokens = 0.0
        self.engine.reserve(iid, rs, now)
        self.engine.submit_deflected(iid, rs, now)
        self.deflected += 1
        return True

    def _on_deflect_done(self, rs: RequestState, now: float) -> None:
        """Deflected prefill finished *on the decode host itself*: the KV
        is already resident, so admission is immediate — no transfer and no
        base-latency hop (the network term collapsed at selection time)."""
        if rs.rejected:
            return
        rs.transfer_end = now
        iid = rs.decode_instance
        if not self.engine.is_healthy(iid):
            # Host died while the deflected chunks were still metering:
            # release the reserve() pin and re-run from scratch.
            self.engine.release(iid, rs)
            self._requeue(rs, now)
            return
        self.engine.enqueue(iid, rs, now)
        self.engine.kick((iid,), now)

    # ---------------------------------------------- RolePlane: P:D flipping
    def _role_tick(self, now: float) -> None:
        """Slow control loop: sample prefill backlog on the role lane,
        convert one drained instance per sustained-imbalance episode."""
        sig = self.engine.prefill_backlog(now)
        if sig > self.cfg.role_flip_hi:
            self._hi_run += 1
            self._lo_run = 0
        elif sig < self.cfg.role_flip_lo:
            self._lo_run += 1
            self._hi_run = 0
        else:
            self._hi_run = self._lo_run = 0
        if self._hi_run >= self.cfg.role_flip_sustain:
            if self._flip_to_prefill(now):
                self._hi_run = 0
        elif self._lo_run >= self.cfg.role_flip_sustain and self._flipped:
            if self._flip_back(now):
                self._lo_run = 0
        if not self.loop.empty():
            self.loop.arm(LANE_ROLE, now + self.cfg.role_flip_interval,
                          self._role_tick)

    def _n_prefill_role(self) -> int:
        eng = self.engine
        if isinstance(eng, InstancePlane):
            return int(eng.p_healthy[: eng.n_pre].sum())
        return sum(1 for p in eng.prefill if p.healthy)

    def _flip_to_prefill(self, now: float) -> bool:
        """Sustained prefill starvation: convert the lowest-id drained
        decode instance (no active batch, queue, deflected stream, or
        in-flight inbound transfer) to a prefill worker."""
        v = self.view
        cands = [int(v.ids[s]) for s in range(v.n)
                 if v.role[s] == ROLE_DECODE
                 and self.engine.is_healthy(int(v.ids[s]))]
        if len(cands) - 1 < self.cfg.min_decode:
            return False
        for iid in sorted(cands):
            if self._inbound.get(iid):
                continue
            if not self.engine.decode_drained(iid):
                continue
            self.engine.flip_role(iid, ROLE_PREFILL, now)
            self._flipped.append(iid)
            self.role_flips += 1
            if self.trace is not None:
                self.trace.role_flip(iid, now, ROLE_PREFILL)
            return True
        return False

    def _flip_back(self, now: float) -> bool:
        """Sustained prefill idleness: return the most recent convert to
        decode duty once its prefill work has drained."""
        iid = self._flipped[-1]
        if not self.engine.prefill_drained(iid):
            return False
        if self._n_prefill_role() - 1 < self.cfg.min_prefill:
            return False
        self.engine.flip_role(iid, ROLE_DECODE, now)
        self._flipped.pop()
        self.role_flips += 1
        if self.trace is not None:
            self.trace.role_flip(iid, now, ROLE_DECODE)
        return True

    # ------------------------------------------------ ChunkPlane auto-tuning
    def _autotune(self, input_len: int) -> None:
        """EWMA-driven chunk-size controller.

        Tracks arrival input lengths (EWMA, alpha 0.3) and retunes
        ``chunk_tokens`` to the largest power of two at most 1/8 of the
        typical length, clamped to [128, 2048], with a 4x iteration token
        budget — so a typical request prefills in a handful of
        interleavable chunks instead of one monolithic slice (short inputs)
        or hundreds of tiny ones (long inputs).
        """
        l = float(input_len)
        if self._len_ewma < 0:
            self._len_ewma = l
        else:
            self._len_ewma += 0.3 * (l - self._len_ewma)
        target = self._len_ewma / 8.0
        chunk = 128
        while chunk * 2 <= target and chunk < 2048:
            chunk *= 2
        if chunk != self._chunk_cur:
            self._chunk_cur = chunk
            self.engine.set_chunking(chunk, 4 * chunk)
            self._chunk_eff = chunk

    def _on_prefill_done(self, rs: RequestState, now: float) -> None:
        if rs.rejected:
            # Already rejected at first-chunk scheduling (kv_streaming):
            # the remaining chunks prefilled in vain; don't schedule (or
            # count the rejection) a second time.
            return
        if rs.stream_scheduled:
            # Streaming path: the decode instance was chosen at first-chunk
            # readiness and every chunk's bytes are already in (or through)
            # the network — the final chunk's transfer was started by
            # _on_chunk_done at this same instant.  A 100 % prefix hit
            # never streams anything: admission is latency-only from here.
            if rs.s_eff <= 0.0 and rs.stream_open == 0 and not rs.stream_last:
                lat = self.tree.tier_latency[rs.tier]
                if self.trace is not None:
                    self.trace.lat_segment(rs, now, now + lat)
                self.loop.after(lat,
                                lambda t, rs=rs: self._on_transfer_done(rs, None, t))
            return
        if isinstance(self.sched, NetKVBatch) and self.sched.window > 0:
            self._batch_window.append((rs, rs.prefill_instance))
            if self._batch_timer is None:
                self._batch_timer = self.loop.after(self.sched.window, self._flush_batch)
            return
        self._schedule_one(rs, now)

    # ------------------------------------------------------- streamed chunks
    def _on_chunk_done(self, rs: RequestState, tokens_ready: int, now: float) -> None:
        """One prefill chunk's KV is ready (kv_streaming only): select the
        decode instance on the first chunk, then stream each chunk's bytes
        into the FlowPlane while later chunks are still prefilling."""
        rs.tokens_ready = tokens_ready
        if rs.rejected:
            return
        if not rs.stream_scheduled:
            self._schedule_one(rs, now, streaming=True)
            if not rs.stream_scheduled:
                return          # rejected: remaining chunks prefill in vain
        self._stream_chunks(rs, now)

    def _stream_chunks(self, rs: RequestState, now: float) -> None:
        """Hand every newly-ready, non-prefix-hit byte to the network.

        Cumulative-fraction accounting: after k of the shippable tokens are
        ready the total streamed bytes equal ``s_eff * k / ship_total``, so
        per-chunk deltas telescope to *exactly* ``s_eff`` at the last chunk
        (byte conservation, property-tested across mid-stream rewires).
        """
        if rs.s_eff <= 0.0:
            return              # full prefix hit: nothing ever streams
        req = rs.req
        l = req.input_len
        last = rs.tokens_ready >= l
        hit = min(rs.hit_tokens, float(l))
        ship_total = float(l) - hit
        shipped = min(max(float(rs.tokens_ready) - hit, 0.0), ship_total)
        cum = rs.s_eff if last else rs.s_eff * (shipped / ship_total)
        delta = cum - rs.streamed_bytes
        rs.streamed_bytes = cum
        if last:
            rs.stream_last = True
        if delta > 0.0:
            src = self._server_of[rs.prefill_instance]
            dst = self._server_of[rs.decode_instance]
            rs.stream_open += 1
            tr = self.net.start_transfer(
                src, dst, delta, now,
                on_complete=lambda t, tt, rs=rs: self._on_chunk_transfer_done(rs, t, tt),
                n_flows=self.cfg.tp,
            )
            self._inbound.setdefault(rs.decode_instance, []).append((rs, tr))
            if not self.net.in_epoch:
                self._reschedule_net(now)
        elif last and rs.stream_open == 0:
            # Degenerate: the tail rounded to zero bytes with nothing in
            # flight — admission is latency-only, like a full hit.
            lat = self.tree.tier_latency[rs.tier]
            if self.trace is not None:
                self.trace.lat_segment(rs, now, now + lat)
            self.loop.after(lat, lambda t, rs=rs: self._on_transfer_done(rs, None, t))

    def _on_chunk_transfer_done(self, rs: RequestState, transfer, now: float) -> None:
        if self.trace is not None:
            self.trace.segment(rs, transfer)
        rs.stream_open -= 1
        if rs.stream_last and rs.stream_open == 0:
            # Last byte of the last chunk: admit through the usual
            # epoch-batched completion path (which clears every _inbound
            # entry of this request).
            self._on_transfer_done(rs, transfer, now)
            return
        # Intermediate chunk landed: the entry deliberately STAYS in
        # _inbound.  It is the fault path's only handle on a streamed
        # request caught *between* chunk transfers (stream_open == 0, next
        # chunk still prefilling) — kill_decode must cancel its stream and
        # requeue it at fault time, not after the remaining chunks finish
        # streaming to a dead instance.  Aborting an already-completed
        # transfer is a no-op in both network engines.

    # ------------------------------------------------------------- scheduling
    def _fill_hits(self, req: Request) -> None:
        """Refresh the per-request hit_tokens scratch column in-place."""
        self.engine.fill_hits(req)

    def _make_info(self, rs: RequestState, streaming: bool,
                   tokens_ready: int = 0) -> RequestInfo:
        req = rs.req
        info = RequestInfo(req.request_id, req.input_len, rs.kv_bytes)
        if streaming:
            # Streamed-transfer information set (Eq. 3 extension): bytes
            # keep becoming ready for prefill_remaining more seconds, and
            # the final-chunk tail can only enter the network at the end —
            # the ladder's T_xfer column credits the overlap accordingly.
            info.prefill_remaining = self.cfg.prefill_model.c * max(
                req.input_len - tokens_ready, 0)
            info.tail_bytes = rs.kv_bytes * (
                min(self._chunk_eff, req.input_len) / req.input_len)
        return info

    def _schedule_one(self, rs: RequestState, now: float,
                      streaming: bool = False) -> None:
        req = rs.req
        info = self._make_info(rs, streaming, rs.tokens_ready)
        self._fill_hits(req)
        view = self.oracle.view(now)
        if isinstance(self.sched, NetKVMultiHop):
            self.sched.observe_request(req.block_hashes)
        if self.trace is not None:
            self.trace.now = now
        t0 = _time.perf_counter()
        decision = self.sched.select(info, rs.prefill_instance, self.view, view,
                                     self.inflight)
        dt = _time.perf_counter() - t0
        self.decision_latencies.append(dt)
        self.loop.note_select(dt)
        if decision is None:
            rs.rejected = True
            self.rejected += 1
            return
        if streaming:
            self._dispatch_stream(rs, decision, now)
        else:
            self._dispatch(rs, decision, now)

    # --------------------------------------------------- cohort dispatch
    def _cohort_selector(self, items, reqs, now: float):
        """One fused R x D selection for a same-timestamp dispatch cohort.

        The stacked hit matrix and the oracle snapshot play the role of the
        per-request ``_fill_hits`` + ``oracle.view`` calls (untimed on the
        sequential path too); ``hit_fn``/``evictions_fn`` wire the selector's
        reserve-time eviction watch to the live caches.
        """
        H = self.engine.hit_rows(reqs)
        view = self.oracle.view(now)
        return self.sched.select_cohort(
            items, self.view, view, self.inflight,
            hit_matrix=H,
            hit_fn=lambda r, iid: self.engine.hit_tokens(iid, reqs[r]),
            evictions_fn=self.engine.evictions_of,
        )

    def _schedule_row(self, sel, k: int, rs: RequestState, now: float,
                      streaming: bool = False) -> None:
        """Cohort-path twin of ``_schedule_one``: row k's batched decision,
        with the cohort's one-time setup cost folded into the first row's
        latency so the per-decision metric stays comparable."""
        if self.trace is not None:
            self.trace.now = now
        t0 = _time.perf_counter()
        decision = sel.select_row(k)
        dt = (_time.perf_counter() - t0) + sel.take_setup_time()
        self.decision_latencies.append(dt)
        self.loop.note_select(dt)
        if decision is None:
            rs.rejected = True
            self.rejected += 1
            return
        if streaming:
            self._dispatch_stream(rs, decision, now)
        else:
            self._dispatch(rs, decision, now)

    def _prefill_cohort(self, batch, now: float) -> None:
        """Serial-prefill cohort hook: every prefill completing at this
        instant dispatches through one fused selection, each row's Decision
        (and its reserve / self-contention side effects) applied before the
        next row — bit-exact vs per-request ``_on_prefill_done`` calls."""
        items = [CohortItem(self._make_info(rs, False), rs.prefill_instance)
                 for rs in batch]
        sel = self._cohort_selector(items, [rs.req for rs in batch], now)
        for k, rs in enumerate(batch):
            if rs.rejected:
                continue        # skipped row: draws no tie-break, like the
                #                 sequential guard in _on_prefill_done
            self._schedule_row(sel, k, rs, now)

    def _phase3_cohort(self, live, now: float) -> None:
        """Chunked-prefill cohort hook: ChunkPlane's phase-3 callback loop
        with the same-instant selections fused.

        Replicates ``ChunkPlane._iteration_done`` phase 3 per stream —
        tokens_ready update, first-chunk scheduling (kv_streaming), chunk
        streaming, prefill-done handling — with rows that need a decode
        selection routed through one CohortSelector.  Rows whose sequential
        predicate flips mid-walk (a callback cancelled or rejected the
        stream) fall back exactly as the per-stream path would.
        """
        streaming = self.cfg.kv_streaming
        jobs = []
        for st in live:
            if st.cancelled or st.rs.rejected:
                continue
            if streaming:
                if not st.rs.stream_scheduled:
                    jobs.append(st)
            elif st.done >= st.rs.req.input_len:
                jobs.append(st)
        sel = None
        row: dict[int, int] = {}
        if len(jobs) > 1:
            items = [
                CohortItem(self._make_info(st.rs, streaming, st.done),
                           st.rs.prefill_instance)
                for st in jobs
            ]
            sel = self._cohort_selector(items, [st.rs.req for st in jobs], now)
            row = {id(st): k for k, st in enumerate(jobs)}
        for st in live:
            if st.cancelled:
                continue
            rs = st.rs
            if streaming:
                # _on_chunk_done with the fused selection spliced in.
                rs.tokens_ready = st.done
                if not rs.rejected:
                    if not rs.stream_scheduled:
                        k = row.get(id(st))
                        if sel is not None and k is not None:
                            self._schedule_row(sel, k, rs, now, streaming=True)
                        else:
                            self._schedule_one(rs, now, streaming=True)
                    if rs.stream_scheduled:
                        self._stream_chunks(rs, now)
            if st.done >= rs.req.input_len:
                rs.prefill_end = now
                k = row.get(id(st)) if not streaming else None
                if sel is not None and k is not None and not rs.rejected \
                        and not rs.stream_scheduled:
                    self._schedule_row(sel, k, rs, now)
                else:
                    self._on_prefill_done(rs, now)

    def _flush_batch(self, now: float) -> None:
        window, self._batch_window = self._batch_window, []
        self._batch_timer = None
        if not window:
            return
        reqs = [
            (RequestInfo(rs.req.request_id, rs.req.input_len, rs.kv_bytes), pid)
            for rs, pid in window
        ]
        hit_matrix = np.empty((len(window), self.view.n))
        for i, (rs, _) in enumerate(window):
            self._fill_hits(rs.req)
            hit_matrix[i] = self.view.column("hit_tokens")
        view = self.oracle.view(now)
        if self.trace is not None:
            self.trace.now = now
        t0 = _time.perf_counter()
        decisions = self.sched.select_batch(reqs, (self.view, hit_matrix), view,
                                            self.inflight)
        dt = _time.perf_counter() - t0
        self.decision_latencies.append(dt / len(window))
        self.loop.note_select(dt)
        # Arrival epoch: the whole dispatch burst lands at one timestamp, so
        # the FlowPlane admits it with a single union rate recompute.
        self.net.begin_epoch()
        try:
            for (rs, pid), dec in zip(window, decisions):
                if dec is None:
                    rs.rejected = True
                    self.rejected += 1
                else:
                    self._dispatch(rs, dec, now)
        finally:
            self.net.end_epoch()
        self._reschedule_net(now)

    def _dispatch_stream(self, rs: RequestState, decision, now: float) -> None:
        """Streaming dispatch: commit the decode target and its memory at
        first-chunk time; _stream_chunks moves the actual bytes."""
        rs.sched_time = now
        rs.decode_instance = decision.instance_id
        rs.tier = decision.tier
        rs.s_eff = decision.s_eff
        rs.hit_tokens = self.engine.hit_tokens(decision.instance_id, rs.req)
        self.engine.reserve(decision.instance_id, rs, now)
        rs.stream_scheduled = True

    def _dispatch(self, rs: RequestState, decision, now: float) -> None:
        rs.sched_time = now
        rs.decode_instance = decision.instance_id
        rs.tier = decision.tier
        rs.s_eff = decision.s_eff
        rs.hit_tokens = self.engine.hit_tokens(decision.instance_id, rs.req)
        self.engine.reserve(decision.instance_id, rs, now)
        src = self._server_of[rs.prefill_instance]
        dst = self._server_of[decision.instance_id]
        if decision.s_eff <= 0.0:
            # 100% prefix hit: only base latency applies.
            lat = self.tree.tier_latency[decision.tier]
            if self.trace is not None:
                self.trace.lat_segment(rs, now, now + lat)
            self.loop.after(lat, lambda t, rs=rs: self._on_transfer_done(rs, None, t))
            return
        plan = None
        if isinstance(self.sched, NetKVMultiHop):
            plan = self.sched.plans.get(rs.req.request_id)
        if plan is not None and plan.kind == "staged":
            # Two parallel legs: store->d (staged) and p->d (remainder).
            pending = {"n": 0}

            def leg_done(tr, t, rs=rs, pending=pending, plan=plan):
                if self.trace is not None:
                    self.trace.segment(rs, tr)
                pending["n"] -= 1
                if pending["n"] == 0:
                    self.sched.staged_leg_done(plan.store_id)
                    self._on_transfer_done(rs, tr, t)

            store_src = self._server_of[plan.store_id]
            for leg_src, nbytes in ((store_src, plan.staged_bytes),
                                    (src, plan.direct_bytes)):
                if nbytes <= 0:
                    continue
                pending["n"] += 1
                tr = self.net.start_transfer(
                    leg_src, dst, nbytes, now, on_complete=leg_done,
                    n_flows=self.cfg.tp)
                self._inbound.setdefault(decision.instance_id, []).append((rs, tr))
            if pending["n"] == 0:  # fully resident: latency only
                lat = self.tree.tier_latency[decision.tier]
                if self.trace is not None:
                    self.trace.lat_segment(rs, now, now + lat)
                self.loop.after(lat, lambda t, rs=rs: self._on_transfer_done(rs, None, t))
            if not self.net.in_epoch:
                self._reschedule_net(now)
            return
        transfer = self.net.start_transfer(
            src, dst, decision.s_eff, now,
            on_complete=lambda tr, t, rs=rs: self._on_transfer_done(rs, tr, t),
            n_flows=self.cfg.tp,
        )
        self._inbound.setdefault(decision.instance_id, []).append((rs, transfer))
        if not self.net.in_epoch:
            self._reschedule_net(now)

    # -------------------------------------------------------------- transfers
    def _complete_transfer(self, rs: RequestState, transfer, now: float):
        """Bookkeeping for one landed transfer.

        Returns the decode instance id to kick, or None when the request
        bounced (dispatched inside a fault-detection window) and requeued.
        """
        rs.transfer_end = now
        if transfer is not None:
            if self.trace is not None:
                # Deduped by transfer id, so the streamed last chunk and the
                # staged final leg (already emitted above) don't double-count.
                self.trace.segment(rs, transfer)
            lst = self._inbound.get(rs.decode_instance, [])
            self._inbound[rs.decode_instance] = [
                (r, t) for (r, t) in lst if r is not rs
            ]
        if self.sched.uses_self_contention:
            self.inflight.decr(rs.prefill_instance, rs.tier)
        if isinstance(self.sched, NetKVMultiHop):
            # write-through: the landed prefix populates the dst pod's store.
            pod = self._server_of[rs.decode_instance][0]
            self.sched.on_transfer_complete(rs.req.block_hashes, 1000 + pod)
        iid = rs.decode_instance
        if not self.engine.is_healthy(iid):
            # Dispatched inside the detection window: the landed transfer
            # bounces — release the pin taken at reserve() and requeue.
            self.engine.release(iid, rs)
            self._requeue(rs, now)
            return None
        self.engine.enqueue(iid, rs, now)
        return iid

    def _on_transfer_done(self, rs: RequestState, transfer, now: float) -> None:
        if self._epoch is not None:
            # Same-net-instant landing: buffered, admitted as one epoch in
            # _net_fire (enqueue all, then one kick per touched instance).
            self._epoch.append((rs, transfer))
            return
        iid = self._complete_transfer(rs, transfer, now)
        if iid is not None:
            self.engine.kick((iid,), now)
        self._reschedule_net(now)

    def _decode_by_id(self, iid: int):
        return self.engine.decode_by_id(iid)  # O(1): ClusterView.slot_of

    def _reschedule_net(self, now: float) -> None:
        if self._tick_idle:
            self._wake_tick(now)
        nct = self.net.next_completion_time(now)
        if nct is None:
            return
        self.loop.arm(LANE_NET, nct, self._net_fire)

    def _net_fire(self, now: float) -> None:
        # Buffer every completion this advance pops (the FlowPlane already
        # batch-pops all flows finishing at one instant), then admit them as
        # a single InstancePlane epoch.
        self._epoch = []
        try:
            self.net.advance(now)
        finally:
            epoch, self._epoch = self._epoch, None
        touched: list[int] = []
        for rs, transfer in epoch:
            iid = self._complete_transfer(rs, transfer, now)
            if iid is not None and iid not in touched:
                touched.append(iid)
        if touched:
            self.engine.kick(touched, now)
        self._reschedule_net(now)

    def _net_tick(self, now: float) -> None:
        self.net.refresh_rates(now)
        self._reschedule_net(now)
        if self.loop.empty():
            return
        self._tick_next = now + self.cfg.net_tick
        if self._net_tick_elidable and self.net.n_flows_active == 0:
            # Static background + empty network: every tick until the next
            # transfer starts would refresh rates to the values they already
            # hold.  Go dormant; _reschedule_net wakes the chain on the
            # preserved grid as soon as a flow enters the plane.
            self._tick_idle = True
            return
        self.loop.arm(LANE_TICK, self._tick_next, self._net_tick)

    def _wake_tick(self, now: float) -> None:
        self._tick_idle = False
        t = self._tick_next
        tick = self.cfg.net_tick
        while t <= now:
            t = t + tick     # replay the skipped grid points exactly
        self._tick_next = t
        self.loop.arm(LANE_TICK, t, self._net_tick)

    # ------------------------------------------------------ topology dynamics
    def _on_rewire(self, rw: RewireEvent, now: float) -> None:
        """OCS reconfiguration fires: swap capacities, re-water-fill, and
        re-arm the completion timer (every in-flight ETA just moved).  The
        oracle is *not* poked unless ``notify_rewires`` is set — by default
        the scheduler keeps its stale pre-rewire snapshot until the next
        refresh interval elapses; with notifications it refreshes at the
        reconfiguration instant."""
        self.tree.rewire(tier_bandwidth=rw.tier_bandwidth, scale=rw.scale)
        self.net.on_rewire(now)
        if self.cfg.notify_rewires:
            self.oracle.force_refresh(now)
        self._reschedule_net(now)

    # ------------------------------------------------------ faults/elasticity
    def _on_fault(self, f: FaultEvent, now: float) -> None:
        if f.kind == "kill_decode":
            victims = self.engine.fail(f.instance_id, now)
            seen: set[int] = set()
            for rs, transfer in self._inbound.pop(f.instance_id, []):
                self.net.abort_transfer(transfer, now)
                if id(rs) in seen:
                    continue  # one request, many flows (streamed chunks /
                    #           staged legs): requeue + decrement once
                seen.add(id(rs))
                if self.sched.uses_self_contention:
                    self.inflight.decr(rs.prefill_instance, rs.tier)
                victims.append(rs)
            # Health flips scheduler-visible after the detection delay; until
            # then new dispatches to this instance bounce and requeue.
            self.loop.after(
                f.detection_delay,
                lambda t, i=f.instance_id: self.engine.mark_detected(i, t))
            for rs in victims:
                self._requeue(rs, now)
            self._reschedule_net(now)
        elif f.kind == "slowdown":
            self.engine.set_iter_scale(f.instance_id, f.factor)
        elif f.kind == "add_decode":
            new_id = max(self._server_of) + 1
            # Elastic join: place on the decode-hosting server with the
            # fewest healthy resident decode instances (ties -> lowest
            # server coordinate), so capacity lands where the pool is thin.
            pop: dict[tuple[int, int, int], int] = {}
            for d in self.decode:
                pop.setdefault(d.server, 0)
                if d.healthy:
                    pop[d.server] += 1
            srv = min(sorted(pop), key=pop.get)
            self._server_of[new_id] = srv
            self.engine.add_decode(new_id, srv)
        elif f.kind == "kill_prefill":
            victims = self.engine.fail_prefill(f.instance_id, now)
            for rs in victims:
                if rs.decode_instance >= 0:
                    # Streamed dispatch caught mid-prefill: abort its
                    # in-flight inbound flows and release the reserve()
                    # pin before re-running from scratch.
                    lst = self._inbound.get(rs.decode_instance, [])
                    mine = [(r, t) for (r, t) in lst if r is rs]
                    self._inbound[rs.decode_instance] = [
                        (r, t) for (r, t) in lst if r is not rs
                    ]
                    for _, tr in mine:
                        self.net.abort_transfer(tr, now)
                    if self.sched.uses_self_contention:
                        self.inflight.decr(rs.prefill_instance, rs.tier)
                    self.engine.release(rs.decode_instance, rs)
                self._requeue(rs, now)
            self._reschedule_net(now)
        elif f.kind == "add_prefill":
            new_id = max(self._server_of) + 1
            # Elastic prefill join: add_decode's placement policy over the
            # prefill-hosting servers.
            pop = {}
            for p in self.prefill:
                pop.setdefault(p.server, 0)
                if p.healthy:
                    pop[p.server] += 1
            srv = min(sorted(pop), key=pop.get)
            self._server_of[new_id] = srv
            self.engine.add_prefill(new_id, srv)
        else:
            raise ValueError(f.kind)

    def _requeue(self, rs: RequestState, now: float) -> None:
        """Fault path: re-run the request through prefill + scheduling.

        The prefill-side KV buffer was released when the transfer completed,
        so a decode-side loss after admit requires a fresh prefill; a loss
        during transfer could reuse the buffer, but we conservatively re-run
        prefill in both cases (counts in ``requeues``).
        """
        rs.requeues += 1
        if rs.prefill_instance >= 0:
            # Streamed dispatch may die while chunks are still prefilling:
            # drop any live chunk stream before re-running from scratch.
            # Unconditional on purpose — ``prefill_end`` may hold a *stale*
            # earlier attempt's finish time while the current attempt is
            # mid-prefill; cancel is a no-op when no stream is live.
            self.engine.cancel_prefill(rs)
        rs.decode_instance = -1
        rs.tokens_out = 0
        rs.transfer_end = -1.0
        rs.prefill_end = -1.0  # the fresh attempt re-runs prefill in full
        # Streaming bookkeeping restarts with the fresh prefill attempt.
        rs.tokens_ready = 0
        rs.streamed_bytes = 0.0
        rs.stream_open = 0
        rs.stream_scheduled = False
        rs.stream_last = False
        # A deflected attempt that died re-runs through the ordinary
        # arrival gate (it may deflect again, or prefill normally).
        rs.deflected = False
        # Clear every per-attempt field from the failed attempt: a stale
        # first_token/admit_time would report a phantom TTFT for a request
        # that never decoded, and stale tier/s_eff/hit_tokens would skew the
        # tier-fraction and hit-rate metrics toward the dead instance.
        rs.sched_time = -1.0
        rs.first_token = -1.0
        rs.admit_time = -1.0
        rs.tier = -1
        rs.s_eff = 0.0
        rs.hit_tokens = 0.0
        if rs.requeues > 3:
            rs.rejected = True
            self.rejected += 1
            return
        self._on_arrival(rs, now)

    # ------------------------------------------------------------------- run
    def run(self, trace: Sequence[Request], drain: float = 60.0) -> RunMetrics:
        self.load_trace(trace)
        horizon = self.cfg.warmup + self.cfg.measure + drain
        self.loop.run(until=horizon)
        self.engine.finalize()
        if self.trace is not None:
            # Whole-phase lifecycle spans derive from RequestState
            # timestamps at the end — zero hot-path cost for them.
            self.trace.finalize(self.records)
            sess = trace_session()
            if sess is not None:
                sess.register(self.cfg.scheduler, self.trace, self.records)
        # Per-role utilization: busy seconds over instance-seconds.  The
        # denominators use the final pool sizes (handle lists grow under
        # add_* faults and role flips) — a telemetry approximation, not a
        # parity-checked outcome.
        elapsed = max(self.loop.now, 1e-9)
        n_pre = len(self.prefill)
        n_dec = len(self.decode)
        prefill_util = (self.engine.prefill_busy_s / (n_pre * elapsed)
                        if n_pre else float("nan"))
        decode_util = ((self.engine.decode_busy_s + self.engine.deflect_busy_s)
                       / (n_dec * elapsed) if n_dec else float("nan"))
        return summarize(
            self.records,
            window=(self.cfg.warmup, self.cfg.warmup + self.cfg.measure),
            scheduler=self.cfg.scheduler,
            decision_latencies=self.decision_latencies,
            rejected=self.rejected,
            decode_iterations=self.engine.total_iterations,
            prefill_util=prefill_util,
            decode_util=decode_util,
        )


def run_sim(cfg: SimConfig, trace: Sequence[Request], drain: float = 60.0) -> RunMetrics:
    return Simulation(cfg).run(trace, drain=drain)
