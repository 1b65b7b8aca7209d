# The port's own copy of repro/cluster/topology.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_serving.py holds the two equal.
"""Multi-tier fat-tree cluster topology (§III-A, §VI-A) — the TopoPlane.

The evaluation cluster: 2 pods x 2 racks x 2 servers x 8 GPUs = 64 GPUs.
Locality tiers:

  tier 0  same server   (NVLink / intra-host ICI)
  tier 1  same rack     (NIC -> ToR -> NIC)
  tier 2  same pod      (+ ToR uplink -> agg -> ToR downlink)
  tier 3  cross pod     (+ agg uplink -> core -> agg downlink)

Directed links are materialised for the flow-level simulator; ECMP gives
each ToR/agg ``n_uplinks`` parallel uplinks chosen uniformly at random per
flow (so correlated flows can collide below capacity, §VI-B).

The link structure itself is a first-class, time-varying simulation object:

* **Multi-NIC hosts** — ``nics_per_server`` materialises N nic_up/nic_down
  pairs per server (rail-optimised H100-class hosts carry 4-8), each at the
  full tier-1 bandwidth class, so host egress scales with the NIC count
  while the per-transfer uncontested ceiling stays B_1.  Which NIC a
  transfer rides is a pluggable :class:`NicPolicy` (``hash`` /
  ``least-loaded`` / ``rail-affine``) resolved at flow start by the network
  engine.  ``nics_per_server=1`` reproduces the single-NIC link table (same
  link ids, same ECMP RNG stream) bit-for-bit.
* **Capacity timeline** — :meth:`FatTree.rewire` atomically swaps tier
  capacities mid-run (an OCS reconfiguration event).  Both the columnar
  link table (``link_capacity``) and the per-object ``Link`` records are
  rebuilt so the FlowPlane and the reference engine observe the same swap;
  callers holding in-flight flows must follow with a full rate recompute
  (``FlowPlane.on_rewire`` / ``ReferenceFlowNetwork.refresh_rates``) so no
  flow is silently left over the new capacity.  ``topo_epoch`` counts
  rewires for staleness bookkeeping.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

import numpy as np

from ..core.oracle import PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY

# Longest possible path: nic_up, tor_up, agg_up, agg_down, tor_down, nic_down.
MAX_PATH_LEN = 6


# -- NIC-choice policies -----------------------------------------------------
class NicPolicy:
    """Picks the (src_nic, dst_nic) pair for one transfer at flow start.

    The policy is owned by a network engine instance (FlowPlane or the
    reference); engines drive it in identical call order, so two engines
    with their *own* policy instances stay bit-exact under a shared seed.
    With one NIC per server every policy returns ``(0, 0)`` without
    consuming RNG draws — the single-NIC stream is untouched.
    """

    name = "base"

    def bind(self, load_fn) -> None:
        """Attach an engine-side ``load_fn(link_ids) -> open-flow counts``."""
        self._load_fn = load_fn

    def observe(self, nbytes: float) -> None:
        """Engines report each transfer's size before asking for a pick —
        stateless policies ignore it; the adaptive policy tracks the
        distribution."""

    def pick(self, tree: "FatTree", si: int, di: int, rng) -> tuple[int, int]:
        raise NotImplementedError


class HashNicPolicy(NicPolicy):
    """Per-transfer uniform hash, the multi-rail analogue of ECMP (§VI-B):
    one independent draw per endpoint, so correlated transfers can collide
    on a NIC below aggregate host capacity."""

    name = "hash"

    def pick(self, tree, si, di, rng):
        n = tree.nics_per_server
        if n == 1:
            return 0, 0
        return int(rng.integers(n)), int(rng.integers(n))


class LeastLoadedNicPolicy(NicPolicy):
    """argmin open-flow count over each endpoint's NICs (ties -> lowest
    NIC index), the QP-count rail selection real multi-rail RDMA stacks
    apply.  Needs the engine's ``bind``-ed load counters."""

    name = "least-loaded"
    _load_fn = None

    def pick(self, tree, si, di, rng):
        n = tree.nics_per_server
        if n == 1 or self._load_fn is None:
            return 0, 0
        up = self._load_fn(tree._srv_nic_up[si])
        down = self._load_fn(tree._srv_nic_down[di])
        return int(np.argmin(up)), int(np.argmin(down))


class RailAffineNicPolicy(NicPolicy):
    """Rail-optimised placement: src and dst use the *same* rail index
    (NIC i talks to NIC i through the rail's dedicated fabric), rails
    assigned round-robin across transfer starts."""

    name = "rail-affine"

    def __init__(self) -> None:
        self._turn = 0

    def pick(self, tree, si, di, rng):
        n = tree.nics_per_server
        if n == 1:
            return 0, 0
        rail = self._turn % n
        self._turn += 1
        return rail, rail


class AdaptiveNicPolicy(NicPolicy):
    """Trace-adaptive rail choice: switch hash <-> rail-affine on the
    observed transfer-size distribution.

    Rail-affine wins for large/persistent transfers (a dedicated rail end
    to end, no hash collisions below host capacity); hash wins for
    small/many (round-robin rails would synchronise bursts onto one rail
    pair).  The policy tracks an EWMA of observed transfer sizes and
    delegates each pick to whichever specialist the current mean selects —
    above ``threshold_bytes`` rail-affine, below it hash.  The first
    ``warm`` observations always use hash (the paper's default), so a
    cold start matches the hash baseline bit-for-bit.
    """

    name = "adaptive"

    def __init__(self, threshold_bytes: float = 256e6, alpha: float = 0.1,
                 warm: int = 8) -> None:
        self._hash = HashNicPolicy()
        self._rail = RailAffineNicPolicy()
        self.threshold_bytes = float(threshold_bytes)
        self.alpha = float(alpha)
        self.warm = int(warm)
        self.ewma = 0.0
        self.seen = 0

    def observe(self, nbytes: float) -> None:
        self.seen += 1
        if self.seen == 1:
            self.ewma = float(nbytes)
        else:
            self.ewma += self.alpha * (float(nbytes) - self.ewma)

    def pick(self, tree, si, di, rng):
        if self.seen > self.warm and self.ewma >= self.threshold_bytes:
            return self._rail.pick(tree, si, di, rng)
        return self._hash.pick(tree, si, di, rng)


NIC_POLICIES = {
    "hash": HashNicPolicy,
    "least-loaded": LeastLoadedNicPolicy,
    "rail-affine": RailAffineNicPolicy,
    "adaptive": AdaptiveNicPolicy,
}


def make_nic_policy(policy: "str | NicPolicy") -> NicPolicy:
    """Resolve a policy name (or pass through an instance).

    Engines that must stay mutually bit-exact (plane vs reference) should
    each resolve their own instance from the name — rail-affine carries a
    round-robin counter, least-loaded binds engine-local load counters.
    """
    if isinstance(policy, NicPolicy):
        return policy
    try:
        return NIC_POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown NIC policy {policy!r}; known: {sorted(NIC_POLICIES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class GpuCoord:
    pod: int
    rack: int
    server: int
    slot: int


@dataclasses.dataclass(frozen=True)
class Link:
    link_id: int
    kind: str          # "nvlink" | "nic_up" | "nic_down" | "tor_up" | "tor_down" | "agg_up" | "agg_down"
    tier: int          # the tier whose bandwidth class this link belongs to
    capacity: float    # bytes/s


@dataclasses.dataclass(frozen=True)
class Instance:
    """A TP group: ``tp`` GPUs on one server, acting as one schedulable unit."""

    instance_id: int
    role: str           # "prefill" | "decode"
    server: tuple[int, int, int]  # (pod, rack, server)
    gpu_ids: tuple[int, ...]


class FatTree:
    def __init__(
        self,
        n_pods: int = 2,
        racks_per_pod: int = 2,
        servers_per_rack: int = 2,
        gpus_per_server: int = 8,
        tier_bandwidth: dict[int, float] | None = None,
        tier_latency: dict[int, float] | None = None,
        n_tor_uplinks: int = 8,
        n_agg_uplinks: int = 8,
        nics_per_server: int = 1,
    ) -> None:
        self.n_pods = n_pods
        self.racks_per_pod = racks_per_pod
        self.servers_per_rack = servers_per_rack
        self.gpus_per_server = gpus_per_server
        self.tier_bandwidth = dict(tier_bandwidth or PAPER_TIER_BANDWIDTH)
        self.tier_latency = dict(tier_latency or PAPER_TIER_LATENCY)
        self.n_tor_uplinks = n_tor_uplinks
        self.n_agg_uplinks = n_agg_uplinks
        if nics_per_server < 1:
            raise ValueError("nics_per_server must be >= 1")
        self.nics_per_server = int(nics_per_server)
        self.topo_epoch = 0   # rewire generation counter

        self.n_gpus = n_pods * racks_per_pod * servers_per_rack * gpus_per_server
        self._coords = [self._coord_of(g) for g in range(self.n_gpus)]

        # --- materialise directed links -----------------------------------
        self.links: list[Link] = []
        self._nic_up: dict[tuple[int, int, int], list[int]] = {}
        self._nic_down: dict[tuple[int, int, int], list[int]] = {}
        self._nvlink: dict[tuple[int, int, int], int] = {}
        self._tor_up: dict[tuple[int, int], list[int]] = {}
        self._tor_down: dict[tuple[int, int], list[int]] = {}
        self._agg_up: dict[int, list[int]] = {}
        self._agg_down: dict[int, list[int]] = {}

        # Per-uplink capacity is B_tau: one transfer's shard flows share one
        # ECMP uplink choice (they hash on the same host pair), so the
        # per-transfer uncontested ceiling equals the cost model's B_tau,
        # while the segment aggregate is n_uplinks * B_tau and two transfers
        # collide on an uplink with probability 1/n_uplinks (§VI-B).
        def add(kind: str, tier: int) -> int:
            lid = len(self.links)
            self.links.append(Link(lid, kind, tier, self.tier_bandwidth[tier]))
            return lid

        # NIC link ids are contiguous per direction (all ups, then all downs)
        # so that nics_per_server=1 reproduces the historical per-server
        # nvlink, nic_up, nic_down id sequence exactly.
        for p in range(n_pods):
            for r in range(racks_per_pod):
                for s in range(servers_per_rack):
                    key = (p, r, s)
                    self._nvlink[key] = add("nvlink", 0)
                    self._nic_up[key] = [
                        add("nic_up", 1) for _ in range(self.nics_per_server)]
                    self._nic_down[key] = [
                        add("nic_down", 1) for _ in range(self.nics_per_server)]
                rack = (p, r)
                self._tor_up[rack] = [add("tor_up", 2) for _ in range(n_tor_uplinks)]
                self._tor_down[rack] = [add("tor_down", 2) for _ in range(n_tor_uplinks)]
            self._agg_up[p] = [add("agg_up", 3) for _ in range(n_agg_uplinks)]
            self._agg_down[p] = [add("agg_down", 3) for _ in range(n_agg_uplinks)]

        # --- columnar link/path plane (FlowPlane substrate) ----------------
        # Flat arrays mirroring the dicts above so the flow simulator can
        # build per-flow path rows and residual-capacity vectors without
        # touching Python objects.  Server index: (pod * racks + rack) *
        # servers_per_rack + server.
        self.n_links = len(self.links)
        self.link_capacity = np.array([l.capacity for l in self.links], np.float64)
        self.link_tier = np.array([l.tier for l in self.links], np.int64)
        self.n_servers = n_pods * racks_per_pod * servers_per_rack
        n_racks = n_pods * racks_per_pod
        self._srv_nvlink = np.zeros(self.n_servers, np.int32)
        # NIC tables carry a per-server NIC axis; column 0 is the historical
        # single-NIC link for every server.
        self._srv_nic_up = np.zeros((self.n_servers, self.nics_per_server), np.int32)
        self._srv_nic_down = np.zeros((self.n_servers, self.nics_per_server), np.int32)
        self._rack_tor_up = np.zeros((n_racks, n_tor_uplinks), np.int32)
        self._rack_tor_down = np.zeros((n_racks, n_tor_uplinks), np.int32)
        self._pod_agg_up = np.zeros((n_pods, n_agg_uplinks), np.int32)
        self._pod_agg_down = np.zeros((n_pods, n_agg_uplinks), np.int32)
        for (p, r, s), lid in self._nvlink.items():
            si = self.server_index((p, r, s))
            self._srv_nvlink[si] = lid
            self._srv_nic_up[si] = self._nic_up[(p, r, s)]
            self._srv_nic_down[si] = self._nic_down[(p, r, s)]
        for (p, r), lids in self._tor_up.items():
            self._rack_tor_up[p * racks_per_pod + r] = lids
            self._rack_tor_down[p * racks_per_pod + r] = self._tor_down[(p, r)]
        for p, lids in self._agg_up.items():
            self._pod_agg_up[p] = lids
            self._pod_agg_down[p] = self._agg_down[p]

    # -- coordinates --------------------------------------------------------
    def _coord_of(self, gpu: int) -> GpuCoord:
        per_server = self.gpus_per_server
        per_rack = per_server * self.servers_per_rack
        per_pod = per_rack * self.racks_per_pod
        return GpuCoord(
            pod=gpu // per_pod,
            rack=(gpu % per_pod) // per_rack,
            server=(gpu % per_rack) // per_server,
            slot=gpu % per_server,
        )

    def coord(self, gpu: int) -> GpuCoord:
        return self._coords[gpu]

    def server_of(self, gpu: int) -> tuple[int, int, int]:
        c = self._coords[gpu]
        return (c.pod, c.rack, c.server)

    def server_index(self, srv: tuple[int, int, int]) -> int:
        """Flat index of a (pod, rack, server) triple into the link tables."""
        p, r, s = srv
        return (p * self.racks_per_pod + r) * self.servers_per_rack + s

    # -- tiers ---------------------------------------------------------------
    def tier(self, a: GpuCoord | tuple[int, int, int], b: GpuCoord | tuple[int, int, int]) -> int:
        """tau(p, d) for two servers (or GPU coords)."""
        pa = a if isinstance(a, tuple) else (a.pod, a.rack, a.server)
        pb = b if isinstance(b, tuple) else (b.pod, b.rack, b.server)
        if pa == pb:
            return 0
        if pa[:2] == pb[:2]:
            return 1
        if pa[0] == pb[0]:
            return 2
        return 3

    def tier_vec(self, src_idx: np.ndarray, dst_idx: np.ndarray) -> np.ndarray:
        """Vectorised tau over flat server indices (broadcasting)."""
        spr, rpp = self.servers_per_rack, self.racks_per_pod
        src_rack, dst_rack = src_idx // spr, dst_idx // spr
        src_pod, dst_pod = src_rack // rpp, dst_rack // rpp
        t = np.full(np.broadcast(src_idx, dst_idx).shape, 3, np.int64)
        t[src_pod == dst_pod] = 2
        t[src_rack == dst_rack] = 1
        t[src_idx == dst_idx] = 0
        return t

    # -- capacity timeline (OCS rewiring) ------------------------------------
    def rewire(
        self,
        tier_bandwidth: Mapping[int, float] | None = None,
        scale: Mapping[int, float] | None = None,
    ) -> int:
        """Atomically swap tier capacities mid-run (OCS reconfiguration).

        ``tier_bandwidth`` sets absolute per-tier bytes/s; ``scale``
        multiplies the current values (both may be partial maps).  Every
        link of a touched tier gets the new capacity in the same call —
        both the columnar ``link_capacity`` table (FlowPlane substrate) and
        the per-object ``Link`` records (reference engine substrate), so
        the two network engines observe one consistent swap.  The caller
        owning in-flight flows must follow with a full rate recompute
        (``FlowPlane.on_rewire`` / ``ReferenceFlowNetwork.refresh_rates``):
        rates assigned under the old capacities are not feasible under the
        new ones.  Returns the new ``topo_epoch``.
        """
        if tier_bandwidth:
            for t, b in tier_bandwidth.items():
                if int(t) not in self.tier_bandwidth:
                    raise KeyError(f"unknown tier {t}")
                self.tier_bandwidth[int(t)] = float(b)
        if scale:
            for t, f in scale.items():
                self.tier_bandwidth[int(t)] = self.tier_bandwidth[int(t)] * float(f)
        touched = set()
        for m in (tier_bandwidth, scale):
            if m:
                touched |= {int(t) for t in m}
        if not touched:
            touched = set(range(4))
        # Only links of touched tiers are rewritten: a tier-level swap must
        # not clobber per-link ``rewire_links`` edits elsewhere.  (For
        # untouched tiers the old full rebuild recomputed the same values,
        # so this is bit-identical absent per-link edits.)
        caps = np.array([self.tier_bandwidth[t] for t in range(4)], np.float64)
        mask = np.isin(self.link_tier, sorted(touched))
        self.link_capacity[mask] = caps[self.link_tier[mask]]
        for lid in np.flatnonzero(mask).tolist():
            self.links[lid] = dataclasses.replace(
                self.links[lid], capacity=float(self.link_capacity[lid]))
        self.topo_epoch += 1
        return self.topo_epoch

    def rewire_links(self, link_ids, capacity) -> int:
        """Retarget *individual* links' capacities (per-link OCS edit).

        ``capacity`` is a scalar or per-link array of bytes/s applied to
        ``link_ids``.  The columnar ``link_capacity`` table and the
        per-object ``Link`` records are both updated, and
        ``tier_bandwidth`` is refreshed as a **derived p50-per-tier
        summary** of the per-link table — mutated in place, because the
        ``NetworkCostOracle`` holds a live reference to this dict — so
        tier-granular consumers (cost model Eq. (3), staleness snapshots)
        keep a representative figure while the flow simulator sees exact
        per-link values.  Callers owning in-flight flows must follow with
        ``FlowPlane.on_rewire_links(link_ids, now)``, which re-water-fills
        only the dirty component of the edited links.  Note a subsequent
        tier-level :meth:`rewire` of the same tier resets its per-link
        edits (it reasserts one capacity per tier).  Returns the new
        ``topo_epoch``.
        """
        lids = np.asarray(link_ids, np.int64).ravel()
        if lids.size == 0:
            return self.topo_epoch
        if np.any((lids < 0) | (lids >= self.n_links)):
            raise IndexError("link id out of range")
        caps = np.broadcast_to(np.asarray(capacity, np.float64), lids.shape)
        if np.any(~np.isfinite(caps)) or np.any(caps <= 0):
            raise ValueError("link capacity must be finite and > 0")
        self.link_capacity[lids] = caps
        for lid, c in zip(lids.tolist(), caps.tolist()):
            self.links[lid] = dataclasses.replace(self.links[lid],
                                                  capacity=float(c))
        for t in np.unique(self.link_tier[lids]).tolist():
            sel = self.link_tier == t
            self.tier_bandwidth[int(t)] = float(
                np.median(self.link_capacity[sel]))
        self.topo_epoch += 1
        return self.topo_epoch

    # -- paths (ECMP) ---------------------------------------------------------
    def path_row(
        self, src: tuple[int, int, int], dst: tuple[int, int, int], rng,
        out: np.ndarray | None = None, nics: tuple[int, int] = (0, 0),
    ) -> tuple[np.ndarray, int]:
        """Fixed-width link-id row (padded with -1) + path length.

        Same ECMP model and — critically — the *same RNG draw sequence* as
        ``flow_path``, so the columnar FlowPlane and the per-object reference
        pick identical uplinks under a shared seed.  ``nics`` selects the
        (src, dst) NIC pair; the engines resolve it through their
        :class:`NicPolicy` before building the path.
        """
        if out is None:
            out = np.full(MAX_PATH_LEN, -1, np.int32)
        t = self.tier(src, dst)
        si, di = self.server_index(src), self.server_index(dst)
        if t == 0:
            out[0] = self._srv_nvlink[si]
            return out, 1
        out[0] = self._srv_nic_up[si, nics[0]]
        k = 1
        if t >= 2:
            out[k] = self._rack_tor_up[si // self.servers_per_rack][
                rng.integers(self.n_tor_uplinks)]
            k += 1
        if t == 3:
            out[k] = self._pod_agg_up[src[0]][rng.integers(self.n_agg_uplinks)]
            out[k + 1] = self._pod_agg_down[dst[0]][rng.integers(self.n_agg_uplinks)]
            k += 2
        if t >= 2:
            out[k] = self._rack_tor_down[di // self.servers_per_rack][
                rng.integers(self.n_tor_uplinks)]
            k += 1
        out[k] = self._srv_nic_down[di, nics[1]]
        return out, k + 1

    def flow_path(
        self, src: tuple[int, int, int], dst: tuple[int, int, int], rng,
        nics: tuple[int, int] = (0, 0),
    ) -> list[int]:
        """Directed link ids traversed by one flow src-server -> dst-server.

        ECMP is modelled as a uniform random uplink pick at flow start
        (tor_up/agg_up on the source side, agg_down/tor_down on the
        destination side), per §VI-B.
        """
        row, k = self.path_row(src, dst, rng, nics=nics)
        return [int(l) for l in row[:k]]

    def base_latency(self, src, dst) -> float:
        return self.tier_latency[self.tier(src, dst)]

    def links_of_tier(self, tier: int) -> Iterator[Link]:
        return (l for l in self.links if l.tier == tier)


def make_instances(
    tree: FatTree, tp: int = 4, n_prefill: int = 4, placement: str = "pack"
) -> tuple[list[Instance], list[Instance]]:
    """Partition the cluster into TP groups and split prefill/decode pools.

    Paper setup: 64 GPUs at TP=4 -> 16 instances: 4 prefill + 12 decode.
    TP groups never span servers (gpus_per_server % tp == 0).

    placement="pack" (paper-faithful): the prefill pool fills whole racks in
    order, so prefill never shares a server or rack with decode — Table VI's
    footnote that tier 0 and tier 1 are unreached.  placement="spread"
    stride-places prefill across racks (exercises tiers 0-3; used by tests).
    """
    assert tree.gpus_per_server % tp == 0, "TP group must fit in a server"
    groups: list[tuple[tuple[int, int, int], tuple[int, ...]]] = []
    for g0 in range(0, tree.n_gpus, tp):
        gpus = tuple(range(g0, g0 + tp))
        groups.append((tree.server_of(g0), gpus))
    n_total = len(groups)
    assert 0 < n_prefill < n_total
    if placement == "pack":
        prefill_idx = set(range(n_prefill))
    elif placement == "spread":
        stride = max(1, n_total // n_prefill)
        prefill_idx = set(range(0, stride * n_prefill, stride))
    else:
        raise ValueError(placement)
    prefill, decode = [], []
    for i, (srv, gpus) in enumerate(groups):
        role = "prefill" if i in prefill_idx else "decode"
        inst = Instance(instance_id=i, role=role, server=srv, gpu_ids=gpus)
        (prefill if role == "prefill" else decode).append(inst)
    return prefill, decode
