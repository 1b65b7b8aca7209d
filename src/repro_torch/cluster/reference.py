# The port's own copy of repro/cluster/reference.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_oracles.py holds the two equal.
"""Retired per-object fluid network simulator — kept as the parity oracle.

This is the seed's ``FlowNetwork`` verbatim: a Python dict of ``Flow``
dataclasses, an O(rounds x links x flows) progressive water-filling loop
re-run on every flow arrival/completion, and per-flow Python scans in
``advance`` / ``next_completion_time`` / ``abort_transfer``.  The
production engine in ``network.py`` (``FlowPlane``) is a columnar
struct-of-arrays rewrite and must stay *bit-exact* to this module — same
per-flow rates, same transfer completion order and finish times, same
per-tier byte counters, same ECMP RNG stream consumption —
``tests/test_flowplane_parity.py`` enforces it, exactly like
``core/reference.py`` does for the scheduler ladder.  Benchmarks use this
loop as the "python" baseline arm (``benchmarks/net_throughput.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .topology import FatTree, NicPolicy, make_nic_policy


@dataclasses.dataclass
class Flow:
    flow_id: int
    transfer: "Transfer"
    path: tuple[int, ...]
    bytes_remaining: float
    rate: float = 0.0


class ReferenceFlowNetwork:
    """Fluid flow simulator over the fat-tree's directed links (per-object).

    Multi-NIC topologies and capacity rewires are supported the per-object
    way: the NIC policy is resolved per transfer through the same
    ``NicPolicy`` protocol (engine-local instance, identical call order =
    identical RNG stream), and ``_recompute_rates`` reads link capacities
    live from ``tree.links``, so a ``FatTree.rewire`` takes effect at the
    next ``refresh_rates`` call — the rewire-time hook mirroring
    ``FlowPlane.on_rewire``.
    """

    def __init__(self, tree: FatTree, background, seed: int = 0,
                 nic_policy: "str | NicPolicy" = "hash"):
        self.tree = tree
        self.bg = background
        self.rng = np.random.default_rng(seed)
        self.nic_policy = make_nic_policy(nic_policy)
        self.nic_policy.bind(self._nic_load)
        self.flows: dict[int, Flow] = {}
        self._next_flow = 0
        self._next_transfer = 0
        self._last_advance = 0.0
        self.completed_transfers = 0
        self.bytes_delivered = 0.0
        self._tier_bytes = {0: 0.0, 1: 0.0, 2: 0.0, 3: 0.0}

    def _nic_load(self, lids) -> np.ndarray:
        """Open-flow count per candidate NIC link (least-loaded policy)."""
        cnt: dict[int, int] = {}
        for f in self.flows.values():
            for l in f.path:
                cnt[l] = cnt.get(l, 0) + 1
        return np.array([cnt.get(int(l), 0) for l in lids], np.int64)

    # ------------------------------------------------------------------ API
    def start_transfer(
        self,
        src: tuple[int, int, int],
        dst: tuple[int, int, int],
        total_bytes: float,
        now: float,
        on_complete: Callable[["Transfer", float], None],
        n_flows: int = 4,
    ) -> "Transfer":
        """Begin a KV transfer of ``total_bytes`` as n parallel shard flows."""
        from .network import Transfer

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
        # exactly B_tau while distinct transfers can still collide.  NIC
        # pair resolved at flow start, same policy call order (observe then
        # pick, tier-0 exempt) as the plane.
        if tier == 0:
            nics = (0, 0)
        else:
            self.nic_policy.observe(total_bytes)
            nics = self.nic_policy.pick(
                self.tree, self.tree.server_index(src),
                self.tree.server_index(dst), self.rng)
        path = tuple(self.tree.flow_path(src, dst, self.rng, nics=nics))
        for _ in range(n_flows):
            f = Flow(self._next_flow, t, path, per_flow)
            self._next_flow += 1
            self.flows[f.flow_id] = f
            t.flows_open += 1
        self._recompute_rates(now)
        return t

    def abort_transfer(self, transfer, now: float) -> None:
        """Tear down every flow of ``transfer`` immediately (flow removal
        reconciles the open-flow counts ``_nic_load`` recounts from, and
        ``flows_open`` drops to zero with them — lockstep with FlowPlane)."""
        self.advance(now)
        dead = [fid for fid, f in self.flows.items() if f.transfer is transfer]
        for fid in dead:
            del self.flows[fid]
        transfer.aborted = True
        transfer.done = True
        transfer.flows_open = 0
        if dead:
            self._recompute_rates(now)

    def open_flow_counts(self) -> np.ndarray:
        """Per-link open-flow counts recounted from live flows (the parity
        oracle for FlowPlane's incremental ``_link_nflows``)."""
        cnt = np.zeros(self.tree.n_links, np.int64)
        for f in self.flows.values():
            for l in f.path:
                cnt[l] += 1
        return cnt

    def advance(self, now: float) -> None:
        """Drain bytes at current rates from the last advance point to now."""
        dt = now - self._last_advance
        if dt < 0:
            raise ValueError(f"time went backwards: {self._last_advance} -> {now}")
        if dt == 0.0 or not self.flows:
            self._last_advance = now
            return
        finished: list[Flow] = []
        for f in self.flows.values():
            moved = min(f.bytes_remaining, f.rate * dt)
            f.bytes_remaining -= moved
            self.bytes_delivered += moved
            self._tier_bytes[f.transfer.tier] += moved
            # 1-byte completion threshold: float residue from rate*dt would
            # otherwise strand sub-byte remainders and storm the event loop.
            if f.bytes_remaining <= 1.0:
                finished.append(f)
        self._last_advance = now
        if finished:
            done_transfers = []
            for f in finished:
                del self.flows[f.flow_id]
                f.transfer.flows_open -= 1
                if f.transfer.flows_open == 0 and not f.transfer.aborted:
                    f.transfer.done = True
                    f.transfer.finish_time = now
                    done_transfers.append(f.transfer)
            self._recompute_rates(now)
            for t in done_transfers:
                self.completed_transfers += 1
                t.on_complete(t, now)

    def next_completion_time(self, now: float) -> Optional[float]:
        """Earliest moment any flow drains at current rates (None if idle)."""
        best = None
        for f in self.flows.values():
            if f.rate <= 0:
                continue
            eta = now + f.bytes_remaining / f.rate + 1e-9
            if best is None or eta < best:
                best = eta
        return best

    def refresh_rates(self, now: float) -> None:
        """Periodic tick so time-varying background traffic takes effect."""
        self.advance(now)
        if self.flows:
            self._recompute_rates(now)

    # -------------------------------------------------------- water-filling
    def _recompute_rates(self, now: float) -> None:
        if not self.flows:
            return
        flows_on_link: dict[int, list[int]] = {}
        for fid, f in self.flows.items():
            for lid in f.path:
                flows_on_link.setdefault(lid, []).append(fid)
        caps = {
            lid: self.tree.links[lid].capacity
            * (1.0 - self.bg.util(self.tree.links[lid].tier, now))
            for lid in flows_on_link
        }
        unfixed = set(self.flows.keys())
        while unfixed:
            bottleneck = None
            for lid, fl in flows_on_link.items():
                active = [fid for fid in fl if fid in unfixed]
                if not active:
                    continue
                share = caps[lid] / len(active)
                if bottleneck is None or share < bottleneck[0]:
                    bottleneck = (share, lid, active)
            if bottleneck is None:  # pragma: no cover - every flow has links
                for fid in unfixed:
                    self.flows[fid].rate = float("inf")
                break
            share, lid, active = bottleneck
            for fid in active:
                self.flows[fid].rate = share
                unfixed.discard(fid)
                for l2 in self.flows[fid].path:
                    caps[l2] = max(0.0, caps.get(l2, 0.0) - share)
            flows_on_link.pop(lid, None)

    # ------------------------------------------------------------ telemetry
    def tier_congestion(self, now: float) -> dict[int, float]:
        """Operator-side per-tier congestion, *excluding* marked KV flows."""
        return self.bg.tier_map(now)

    def tier_utilization_observed(self, now: float):
        """Diagnostic: cumulative KV bytes moved per tier (for Table VI)."""
        return dict(self._tier_bytes)
