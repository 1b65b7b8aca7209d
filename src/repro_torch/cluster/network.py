# The port's own copy of repro/cluster/network.py, verbatim in its code, so that repro_torch imports
# nothing of the JAX package; tests/test_torch_serving.py holds the two equal.
"""FlowPlane: columnar flow-level network model (max-min fair sharing + ECMP).

Each KV transfer is realised as ``n_flows`` parallel flows (one per TP shard)
sharing the source NIC and one ECMP uplink choice.  On every flow
arrival/completion the coexisting flows on shared links are re-evaluated
(progressive water-filling), the model RDMA congestion control (DCQCN)
converges to.  Background traffic is a steady-state per-link utilisation
fraction that scales down residual capacity — the mean-field approximation
of §VI-B — optionally time-varying for the staleness experiments.

The engine mirrors the ``ClusterView`` pattern: flows live in
struct-of-arrays NumPy columns (``bytes_remaining``, ``rate``, ``tier``,
``transfer``, fixed-width ``path`` rows built from ``FatTree.path_row``),
so water-filling is a vectorised bincount/argmin fixed-point, ``advance``
drains every flow in fused array ops, ``next_completion_time`` is one
argmin, and abort/completion are O(flows-of-transfer) via a transfer->slot
map.  Two scale levers beyond vectorisation:

* **Incremental recomputation** — an arriving/departing flow only dirties
  the connected component of flows it shares links with (transitively);
  rates outside that component are provably unchanged by max-min
  decomposition, so they are not recomputed.
* **Piecewise-constant background sampling** — residual link capacities are
  sampled from ``BackgroundTraffic`` at construction and at every
  ``refresh_rates`` tick (0.1 s of sim time) instead of at every event, so
  incremental recomputes stay exact between ticks.  With static background
  this is identical to per-event sampling.

The retired per-object implementation lives in ``cluster/reference.py``
(``ReferenceFlowNetwork``) as the parity oracle: rates, transfer completion
order, finish times and per-tier byte counters must match it bit-for-bit
(``tests/test_flowplane_parity.py``) — which is why the byte accumulators
below use ordered ``np.add.at`` reductions (sequential, reference-order
float addition) rather than pairwise ``sum``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from .topology import FatTree, MAX_PATH_LEN, NicPolicy, make_nic_policy


class BackgroundTraffic:
    """Per-tier offered-load fraction, optionally time-varying.

    ``base[tier]`` is the mean utilisation; with ``wander > 0`` the
    instantaneous value follows a slow sinusoid + per-refresh jitter
    (seeded), giving the oracle something real to track in Exp. 4.
    """

    def __init__(
        self,
        base: dict[int, float] | float = 0.0,
        wander: float = 0.0,
        period: float = 7.0,
        seed: int = 0,
    ) -> None:
        if isinstance(base, (int, float)):
            base = {0: 0.0, 1: float(base), 2: float(base), 3: float(base)}
        self.base = {t: float(base.get(t, 0.0)) for t in range(4)}
        self.wander = wander
        self.period = period
        self._phase = {t: np.random.default_rng(seed + t).uniform(0, 2 * math.pi) for t in range(4)}

    def util(self, tier: int, now: float) -> float:
        u = self.base[tier]
        if self.wander > 0.0 and u > 0.0:
            u = u * (1.0 + self.wander * math.sin(2 * math.pi * now / self.period + self._phase[tier]))
        return float(min(max(u, 0.0), 0.95))

    def tier_map(self, now: float) -> dict[int, float]:
        return {t: self.util(t, now) for t in range(4)}

    @property
    def is_static(self) -> bool:
        """True when ``util`` is time-invariant (the wander sinusoid is off
        or never applied) — the condition under which idle net ticks are
        provably no-ops and may be elided."""
        return self.wander <= 0.0 or not any(self.base.values())


@dataclasses.dataclass
class Transfer:
    transfer_id: int
    src: tuple[int, int, int]
    dst: tuple[int, int, int]
    tier: int
    total_bytes: float
    start_time: float
    on_complete: Callable[["Transfer", float], None]
    flows_open: int = 0
    done: bool = False
    aborted: bool = False
    finish_time: float | None = None
    # Link id the water-fill fixed this transfer's flows at (every flow of
    # one transfer shares a path, so they fix in the same round at the same
    # link).  Only populated when ``FlowPlane.record_bottlenecks`` is on;
    # -1 for latency-only / aborted / untraced transfers.
    bottleneck_link: int = -1


@dataclasses.dataclass
class FlowView:
    """Read-only per-flow view materialised from the columns (debug/tests)."""

    flow_id: int
    transfer: Transfer
    path: tuple[int, ...]
    bytes_remaining: float
    rate: float


class FlowPlane:
    """Columnar fluid flow simulator over the fat-tree's directed links."""

    def __init__(self, tree: FatTree, background: BackgroundTraffic, seed: int = 0,
                 capacity: int = 64, nic_policy: "str | NicPolicy" = "hash"):
        self.tree = tree
        self.bg = background
        self.rng = np.random.default_rng(seed)
        # NIC choice is resolved here, at flow start: the policy sees the
        # engine's live per-link open-flow counters (least-loaded) or its
        # own counters (rail-affine), so it must be engine-local — parity
        # drives resolve one instance per engine from the name.
        self.nic_policy = make_nic_policy(nic_policy)
        self.nic_policy.bind(lambda lids: self._link_nflows[lids])
        self._next_flow = 0
        self._next_transfer = 0
        self._last_advance = 0.0
        self.completed_transfers = 0
        self.bytes_delivered = 0.0
        self._tier_bytes = np.zeros(4, np.float64)
        # ---- flow columns (slot-indexed; slots recycled via a free list) --
        cap = max(int(capacity), 1)
        self.f_id = np.full(cap, -1, np.int64)
        self.f_bytes = np.zeros(cap, np.float64)          # bytes_remaining
        self.f_rate = np.zeros(cap, np.float64)
        self.f_tier = np.zeros(cap, np.int64)
        self.f_transfer = np.full(cap, -1, np.int64)      # transfer id
        self.f_bneck = np.full(cap, -1, np.int64)         # last bottleneck link
        # Path rows are padded with the virtual link id ``n_links`` (capacity
        # +inf, never a bottleneck), so every array op can ignore ragged
        # path lengths without masking.  int16 link ids (topologies under
        # ~32k links, i.e. any fat tree this repo builds) keep the stable
        # argsort in the water-filling CSR build on NumPy's radix path.
        self._pad = tree.n_links
        self._path_dtype = np.int16 if tree.n_links < 2**15 - 1 else np.int32
        self.f_path = np.full((cap, MAX_PATH_LEN), self._pad, self._path_dtype)
        self._free: list[int] = list(range(cap - 1, -1, -1))
        # Creation-order registry of live slots (dict => preserves insertion
        # order under deletion, mirroring the reference's flow dict).
        self._slot_order: dict[int, None] = {}
        self._transfers: dict[int, Transfer] = {}         # open transfers
        self._tslots: dict[int, list[int]] = {}           # transfer -> slots
        # Arrival epoch: while open, start_transfer defers its rate
        # recomputation and accumulates dirty links; end_epoch runs one
        # union recompute (see begin_epoch).
        self._epoch_dirty: list[np.ndarray] | None = None
        # Per-link open-flow count, maintained incrementally on flow
        # add/remove (slot [pad] accumulates padding hops; never read).
        # Feeds the least-loaded NIC policy's argmin.
        self._link_nflows = np.zeros(tree.n_links + 1, np.int64)
        # ---- residual capacity plane (piecewise-constant bg sampling) ----
        self._resid_caps = np.empty(tree.n_links + 1, np.float64)
        self._bg_time = 0.0
        self._sample_background(0.0)
        # Optional water-filling instrumentation: when a list, every
        # recompute appends its per-round (bottleneck link id, share)
        # sequence — the oracle trace the jitted solver
        # (``kernels.waterfill``) must reproduce exactly.
        self._wf_trace: list[tuple[int, float]] | None = None
        # TracePlane instrumentation: when on, each water-fill round also
        # stamps the fixing link id into ``f_bneck`` so a completing
        # Transfer can report the bottleneck that set its final rate.
        self.record_bottlenecks = False

    # ------------------------------------------------------------- internals
    def _sample_background(self, now: float) -> None:
        """(Re)sample bg utilisation into the residual-capacity vector."""
        u = np.array([self.bg.util(t, now) for t in range(4)], np.float64)
        self._resid_caps[:-1] = self.tree.link_capacity * (1.0 - u[self.tree.link_tier])
        self._resid_caps[-1] = np.inf
        self._bg_time = now

    def _ordered_slots(self) -> np.ndarray:
        return np.fromiter(self._slot_order, np.intp, len(self._slot_order))

    def _grow(self) -> None:
        cap = len(self.f_id)
        new_cap = cap * 2
        for name in ("f_id", "f_bytes", "f_rate", "f_tier", "f_transfer",
                     "f_bneck"):
            old = getattr(self, name)
            new = np.zeros(new_cap, old.dtype)
            new[:cap] = old
            setattr(self, name, new)
        path = np.full((new_cap, MAX_PATH_LEN), self._pad, self._path_dtype)
        path[:cap] = self.f_path
        self.f_path = path
        self._free.extend(range(new_cap - 1, cap - 1, -1))

    def _alloc_slot(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _remove_slot(self, s: int) -> None:
        del self._slot_order[s]
        self.f_id[s] = -1
        self.f_rate[s] = 0.0
        # Real links appear at most once per row, so fancy subtraction is
        # exact for them (the pad slot collects garbage; never read).
        self._link_nflows[self.f_path[s]] -= 1
        self.f_path[s] = self._pad
        self._free.append(s)

    # ------------------------------------------------------------------ API
    def start_transfer(
        self,
        src: tuple[int, int, int],
        dst: tuple[int, int, int],
        total_bytes: float,
        now: float,
        on_complete: Callable[[Transfer, float], None],
        n_flows: int = 4,
    ) -> Transfer:
        """Begin a KV transfer of ``total_bytes`` as n parallel shard flows."""
        self.advance(now)
        tier = self.tree.tier(src, dst)
        t = Transfer(
            self._next_transfer, src, dst, tier, total_bytes, now, on_complete
        )
        self._next_transfer += 1
        if total_bytes <= 0:
            # Pure-latency transfer (100 % prefix hit): complete immediately
            # after base latency; caller handles via zero-byte fast path.
            t.done = True
            t.finish_time = now + self.tree.tier_latency[tier]
            return t
        per_flow = total_bytes / n_flows
        # One ECMP hash per transfer: TP shard flows share the host pair and
        # take the same uplinks, so the per-transfer uncontested ceiling is
        # exactly B_tau while distinct transfers can still collide.  Same
        # RNG draw sequence as the reference's flow_path.  The NIC pair is
        # resolved here, at flow start, by the engine's NIC policy (tier 0
        # never crosses a NIC and must not consume policy draws or size
        # observations).
        if tier == 0:
            nics = (0, 0)
        else:
            self.nic_policy.observe(total_bytes)
            nics = self.nic_policy.pick(
                self.tree, self.tree.server_index(src),
                self.tree.server_index(dst), self.rng)
        row, plen = self.tree.path_row(src, dst, self.rng, nics=nics)
        row = np.where(row < 0, self._pad, row).astype(self._path_dtype)
        slots = []
        for _ in range(n_flows):
            s = self._alloc_slot()
            self.f_id[s] = self._next_flow
            self._next_flow += 1
            self.f_bytes[s] = per_flow
            self.f_rate[s] = 0.0
            self.f_tier[s] = tier
            self.f_transfer[s] = t.transfer_id
            self.f_bneck[s] = -1
            self.f_path[s] = row
            self._slot_order[s] = None
            slots.append(s)
            t.flows_open += 1
        self._transfers[t.transfer_id] = t
        self._tslots[t.transfer_id] = slots
        self._link_nflows[row] += n_flows
        if self._epoch_dirty is not None:
            self._epoch_dirty.append(row[:plen])
        else:
            self._recompute_rates(dirty_links=row[:plen])
        return t

    # -------------------------------------------------------- arrival epochs
    @property
    def in_epoch(self) -> bool:
        return self._epoch_dirty is not None

    def begin_epoch(self) -> None:
        """Batch same-instant transfer arrivals into one rate recompute.

        Water-filling rates depend only on the *current* flow set, so
        admitting a burst of same-timestamp transfers and recomputing once
        over the union of their dirty links yields bit-identical final
        rates to the per-arrival recompute sequence (no time passes between
        the arrivals, so no bytes drain at the intermediate rates) — one
        dirty-component pass instead of one per transfer.
        """
        if self._epoch_dirty is not None:
            raise RuntimeError("FlowPlane epoch already open")
        self._epoch_dirty = []

    def end_epoch(self) -> None:
        dirty, self._epoch_dirty = self._epoch_dirty, None
        if dirty:
            self._recompute_rates(dirty_links=np.concatenate(dirty))

    def abort_transfer(self, transfer: Transfer, now: float) -> None:
        """Tear down every flow of ``transfer`` immediately.

        The per-link open-flow counters (``_link_nflows``, the signal the
        ``least-loaded`` NIC policy argmins over) are reconciled *here*, at
        abort time, by ``_remove_slot`` — not when the flow would later
        have been popped — and ``flows_open`` drops to zero with them, so
        the Transfer record and the counters stay in lockstep with the
        reference engine's recount (``tests/test_chunkplane.py`` proves
        counter parity after fault-driven aborts).
        """
        self.advance(now)
        dead = [s for s in self._tslots.pop(transfer.transfer_id, ())
                if s in self._slot_order]
        touched = self.f_path[dead, :].ravel() if dead else None
        for s in dead:
            self._remove_slot(s)
        self._transfers.pop(transfer.transfer_id, None)
        transfer.aborted = True
        transfer.done = True
        transfer.flows_open = 0
        if dead:
            self._recompute_rates(dirty_links=touched)

    def advance(self, now: float) -> None:
        """Drain bytes at current rates from the last advance point to now."""
        dt = now - self._last_advance
        if dt < 0:
            raise ValueError(f"time went backwards: {self._last_advance} -> {now}")
        if dt == 0.0 or not self._slot_order:
            self._last_advance = now
            return
        slots = self._ordered_slots()
        rem = self.f_bytes[slots]
        moved = np.minimum(rem, self.f_rate[slots] * dt)
        self.f_bytes[slots] = rem - moved
        # Ordered (sequential) accumulation: np.add.at applies the additions
        # in index order, reproducing the reference's per-flow running sums
        # bit-for-bit where a pairwise .sum() would not.
        acc = np.array([self.bytes_delivered])
        np.add.at(acc, np.zeros(len(slots), np.intp), moved)
        self.bytes_delivered = float(acc[0])
        np.add.at(self._tier_bytes, self.f_tier[slots], moved)
        self._last_advance = now
        # 1-byte completion threshold: float residue from rate*dt would
        # otherwise strand sub-byte remainders and storm the event loop.
        finished = slots[self.f_bytes[slots] <= 1.0]
        if len(finished) == 0:
            return
        touched = self.f_path[finished, :].ravel()
        done_transfers: list[Transfer] = []
        for s in finished:           # creation order, matching the reference
            tid = int(self.f_transfer[s])
            if self.record_bottlenecks:
                self._transfers[tid].bottleneck_link = int(self.f_bneck[s])
            self._remove_slot(s)
            t = self._transfers[tid]
            t.flows_open -= 1
            self._tslots[tid].remove(s)
            if t.flows_open == 0:
                del self._transfers[tid]
                del self._tslots[tid]
                if not t.aborted:
                    t.done = True
                    t.finish_time = now
                    done_transfers.append(t)
        self._recompute_rates(dirty_links=touched)
        for t in done_transfers:
            self.completed_transfers += 1
            t.on_complete(t, now)

    def next_completion_time(self, now: float) -> Optional[float]:
        """Earliest moment any flow drains at current rates (None if idle)."""
        if not self._slot_order:
            return None
        slots = self._ordered_slots()
        rates = self.f_rate[slots]
        live = rates > 0
        if not live.any():
            return None
        etas = self.f_bytes[slots][live] / rates[live]
        return float(now + etas.min() + 1e-9)

    def refresh_rates(self, now: float) -> None:
        """Periodic tick: resample background, full water-filling pass."""
        self.advance(now)
        self._sample_background(now)
        if self._slot_order:
            self._recompute_rates(dirty_links=None)

    def on_rewire(self, now: float) -> None:
        """Topology capacities changed (``FatTree.rewire``): re-water-fill.

        Bytes drain at the old rates up to ``now`` (the reconfiguration
        instant), then the residual-capacity plane is rebuilt from the new
        ``link_capacity`` table and every in-flight flow is re-water-filled
        in one full pass — the swap moves capacity under *all* components at
        once, so no flow may keep a rate assigned against the old
        capacities (it could silently sit over the new ones).
        """
        if self._epoch_dirty is not None:
            raise RuntimeError("cannot rewire inside an open arrival epoch")
        self.refresh_rates(now)

    def on_rewire_links(self, link_ids, now: float) -> None:
        """Per-link capacity retarget (``FatTree.rewire_links``): refresh
        only the touched links' residuals and re-water-fill their dirty
        component.

        Unlike the tier-level :meth:`on_rewire`, a per-link edit provably
        cannot move any rate outside the connected component of flows
        crossing the edited links (max-min decomposes over link-disjoint
        components), so the full refresh pass is skipped.  The residual is
        rebuilt with the background utilisation as of the *last sample
        tick* (``_bg_time``), keeping the piecewise-constant sampling
        contract: all other links' residuals stay untouched between ticks.
        """
        if self._epoch_dirty is not None:
            raise RuntimeError("cannot rewire inside an open arrival epoch")
        self.advance(now)
        lids = np.unique(np.asarray(link_ids, np.int64).ravel())
        if lids.size == 0:
            return
        u = np.array([self.bg.util(t, self._bg_time) for t in range(4)],
                     np.float64)
        tiers = self.tree.link_tier[lids]
        self._resid_caps[lids] = self.tree.link_capacity[lids] * (1.0 - u[tiers])
        if self._slot_order:
            self._recompute_rates(dirty_links=lids)

    # -------------------------------------------------------- water-filling
    def _recompute_rates(self, dirty_links: np.ndarray | None = None) -> None:
        """Vectorised progressive water-filling (max-min fair sharing).

        ``dirty_links=None`` recomputes every flow.  Otherwise only the
        connected component of flows reachable from ``dirty_links`` through
        shared links is recomputed: max-min allocations decompose exactly
        over link-disjoint components, so untouched flows keep their rates
        (bit-for-bit what a full recompute would assign them).
        """
        if not self._slot_order:
            return
        slots = self._ordered_slots()
        P = self.f_path[slots]                       # (k, MAX_PATH_LEN)
        pad = self._pad
        if dirty_links is not None:
            link_dirty = np.zeros(pad + 1, bool)
            link_dirty[dirty_links] = True
            link_dirty[pad] = False
            flow_dirty = np.zeros(len(slots), bool)
            while True:
                hit = link_dirty[P].any(axis=1) & ~flow_dirty
                if not hit.any():
                    break
                flow_dirty |= hit
                link_dirty[self.f_path[slots[hit]].ravel()] = True
                link_dirty[pad] = False
            if not flow_dirty.any():
                return
            slots = slots[flow_dirty]
            P = P[flow_dirty]
        k = len(slots)
        flat = P.ravel()                             # row-major: flow x hop
        # First-encounter order per link (flow-creation x hop order) — the
        # tie-break the reference's insertion-ordered dict scan applies.
        # The whole fixed point runs in *encounter-permuted* link space so
        # the per-round bottleneck pick is a single argmin (first minimum in
        # scan order == first-encountered link with the minimal share).
        enc = np.full(pad + 1, flat.size + 1, np.int64)
        np.minimum.at(enc, flat, np.arange(flat.size))
        perm = np.argsort(enc, kind="stable")        # unseen links sort last
        inv = np.empty_like(perm)
        inv[perm] = np.arange(pad + 1)
        P = inv[P].astype(self._path_dtype)          # permuted path matrix
        flat = P.ravel()
        counts = np.bincount(flat, minlength=pad + 1)
        ppad = int(inv[pad])
        counts[ppad] = 0
        # CSR link -> flow-row index, built once per recompute.  The stable
        # sort keeps rows in flow-creation order within each link, which is
        # both the reference's per-link flow order (for the residual
        # subtraction sequence) and what makes each round O(flows-on-link).
        csr_order = np.argsort(flat, kind="stable")
        csr_rows = csr_order // MAX_PATH_LEN
        csr_start = np.searchsorted(flat[csr_order], np.arange(pad + 2))
        caps = self._resid_caps[perm]
        shares = np.empty(pad + 1, np.float64)
        unfixed = np.ones(k, bool)
        rates = np.zeros(k, np.float64)
        n_unfixed = k
        while n_unfixed:
            shares.fill(np.inf)
            np.divide(caps, counts, out=shares, where=counts > 0)
            lid = int(np.argmin(shares))             # enc-order tie-break
            share = shares[lid]
            if share == np.inf:  # pragma: no cover - every flow has links
                rates[unfixed] = np.inf
                break
            if self._wf_trace is not None:
                self._wf_trace.append((int(perm[lid]), float(share)))
            rows = csr_rows[csr_start[lid]:csr_start[lid + 1]]
            fixed_rows = rows[unfixed[rows]]         # flow-creation order
            rates[fixed_rows] = share
            if self.record_bottlenecks:
                self.f_bneck[slots[fixed_rows]] = perm[lid]
            idx = P[fixed_rows].ravel()              # reference subtraction order
            np.subtract.at(caps, idx, share)
            np.maximum(caps, 0.0, out=caps)
            np.subtract.at(counts, idx, 1)           # padded hops go negative:
            n_unfixed -= len(fixed_rows)             # counts<=0 is never active
            unfixed[fixed_rows] = False
        self.f_rate[slots] = rates

    # ------------------------------------------------------------ telemetry
    def open_flow_counts(self) -> np.ndarray:
        """Per-link open-flow counters (real links only) — the incremental
        state the least-loaded NIC policy reads; must equal a from-scratch
        recount of live flows at all times, including right after aborts."""
        return self._link_nflows[:-1].copy()

    def tier_congestion(self, now: float) -> dict[int, float]:
        """Operator-side per-tier congestion, *excluding* marked KV flows.

        The scheduler's own transfers ride a dedicated DSCP class (§III-D),
        so the operator's aggregation reports only external (background)
        utilisation — this is exactly what keeps c_tau and n_inflight from
        double counting.
        """
        return self.bg.tier_map(now)

    def tier_utilization_observed(self, now: float) -> dict[int, float]:
        """Diagnostic: cumulative KV bytes moved per tier (for Table VI)."""
        return {t: float(self._tier_bytes[t]) for t in range(4)}

    def link_utilization(self) -> tuple[np.ndarray, np.ndarray]:
        """(per-link aggregate flow rate, residual capacity) diagnostics.

        Real (non-padding) links only; feeds the max-min invariant tests and
        the measured-telemetry oracle aggregation.
        """
        load = np.zeros(self._pad + 1, np.float64)
        if self._slot_order:
            slots = self._ordered_slots()
            np.add.at(load, self.f_path[slots].ravel(),
                      np.repeat(self.f_rate[slots], self.f_path.shape[1]))
        load[self._pad] = 0.0
        return load[:-1], self._resid_caps[:-1].copy()

    def measured_tier_congestion(self, now: float, include_kv: bool = True
                                 ) -> dict[int, float]:
        """Per-tier congestion aggregated from *measured* link counters.

        Instead of the background model's ground truth
        (``tier_congestion``), this sums what switch byte counters would
        report on every link of a tier — background occupancy
        (capacity - residual) plus, with ``include_kv``, the scheduler's own
        in-flight KV flow rates (an operator whose aggregation cannot
        subtract the KV DSCP class) — divided by the tier's aggregate raw
        capacity.  This is the realistic telemetry regime for the staleness
        experiments: the signal now contains self-traffic feedback and
        ECMP-imbalance noise the mean-field model hides.
        """
        load, resid = self.link_utilization()
        cap = self.tree.link_capacity
        used = cap - resid
        if include_kv:
            used = used + np.minimum(load, resid)
        tiers = self.tree.link_tier
        cap_t = np.bincount(tiers, weights=cap, minlength=4)[:4]
        used_t = np.bincount(tiers, weights=used, minlength=4)[:4]
        with np.errstate(invalid="ignore", divide="ignore"):
            u = np.where(cap_t > 0, used_t / np.maximum(cap_t, 1e-12), 0.0)
        return {t: float(np.clip(u[t], 0.0, 0.999)) for t in range(4)}

    # ---------------------------------------------------------------- debug
    @property
    def flows(self) -> dict[int, FlowView]:
        """Per-flow object view materialised on demand (tests/debug only)."""
        out = {}
        for s in self._slot_order:
            path = tuple(int(l) for l in self.f_path[s] if l != self._pad)
            out[int(self.f_id[s])] = FlowView(
                flow_id=int(self.f_id[s]),
                transfer=self._transfers[int(self.f_transfer[s])],
                path=path,
                bytes_remaining=float(self.f_bytes[s]),
                rate=float(self.f_rate[s]),
            )
        return out

    @property
    def n_flows_active(self) -> int:
        return len(self._slot_order)


# The production engine; the per-object original is
# ``cluster.reference.ReferenceFlowNetwork``.
FlowNetwork = FlowPlane
