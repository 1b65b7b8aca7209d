"""Max-min fair water-filling: the CUDA kernels (``csrc/waterfill.cu``) and
the public entries over them.

  waterfill_progressive  K5: FlowPlane's progressive fixed point, one
                         bottleneck link a round, with its (link, share)
                         trace; one block a flow table, which also builds
                         the first-encounter link order, so a call is one
                         launch and no other op.
  waterfill_fast         K6: the parallel-bottleneck fixed point of the
                         ScenarioPlane sweep, one block a scenario, one
                         launch a sweep step; each block stages its hop slab
                         and walks bitmasks of it.

Both run the whole round loop on the device in f32, as the Pallas route of
``repro/kernels/waterfill.py`` computes in f32.  :func:`waterfill_progressive_plan`
and :func:`waterfill_fast_plan` place each kernel's arrays in shared memory
while they fit, and in device memory past that.  ``ops`` routes CUDA tensors
to the kernels and CPU tensors to their plain versions in ``ref``.
:func:`waterfill_rates` is the counterpart of the JAX entry:
``backend="torch"`` is the f64 plain loop (the port of the jitted f64
route), ``backend="kernel"`` K5 through ``ops``.  :func:`random_flow_table`
and :func:`random_incidence` make the seeded tables that the card tests and
``chip_smoke.py`` hold the kernels to their plain versions on.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build, ops, ref

# Shared memory on the H100: a block can use 227 KB; an SM holds 228 KB, of
# which each resident block reserves 1 KB.
SMEM_MAX = 227 * 1024
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
MIN_THREADS, MAX_THREADS = 256, 1024
MAX_GRID_X = 2 ** 31 - 1
RED_BYTES = 272  # K5's reduction scratch: 33 floats and 33 ints, 16-byte rounded

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _threads(n: int) -> int:
    """Threads a block: one for every ~8 flows or links, 256 to 1024."""
    return min(MAX_THREADS, max(MIN_THREADS, (1 << max(0, n - 1).bit_length()) // 8))


class ProgressivePlan(NamedTuple):
    threads: int
    layout: str        # "shared": link state and permuted paths in shared
                       # memory; "paths": the paths re-read from device
                       # memory; "global": the link state in scratch too
    smem_bytes: int
    scratch_bytes: int  # device memory for the link state ("global" only)


def waterfill_progressive_plan(n_flows: int, n_hops: int, n_links1: int) -> ProgressivePlan:
    """K5's block for a table of ``n_flows`` paths of ``n_hops`` over
    ``n_links1`` links (the pad included): the link state (caps, counts,
    inv, perm: 16 bytes a link) and the flows' flags, then the permuted
    paths (4 bytes a hop), in shared memory while they fit."""
    if n_flows < 0 or n_hops < 0 or n_links1 < 1:
        raise ValueError(f"no water-filling plan for {n_flows} flows x {n_hops} hops, "
                         f"{n_links1} links")
    if n_flows * n_hops >= 2 ** 31 - 1:
        raise ValueError(f"{n_flows} x {n_hops} hop positions exceed 32-bit indices")
    threads = _threads(max(n_flows, n_links1))
    links = 4 * _a16(4 * n_links1) + _a16(n_flows)
    paths = _a16(4 * n_flows * n_hops)
    if RED_BYTES + links + paths <= SMEM_MAX:
        return ProgressivePlan(threads, "shared", RED_BYTES + links + paths, 0)
    if RED_BYTES + links <= SMEM_MAX:
        return ProgressivePlan(threads, "paths", RED_BYTES + links, 0)
    return ProgressivePlan(threads, "global", RED_BYTES, links)


class FastSizes(NamedTuple):
    state: int  # caps0, shares, counts, used, fixable; s_f, rates, fix; 2 flow words
    masks: int  # links of each flow, flows of each link (two of each): one bit each
    slab: int   # the (F, L+1) hops, 16 bytes longer for the staged copy


def fast_sizes(n_flows: int, n_links1: int) -> FastSizes:
    """Bytes of K6's regions for one scenario (``csrc/waterfill.cu``
    ``FastSizes``)."""
    wf, wl = -(-n_flows // 32), -(-n_links1 // 32)
    l4, f4 = _a16(4 * n_links1), _a16(4 * n_flows)
    state = 4 * l4 + _a16(n_links1) + 2 * f4 + _a16(n_flows) + 2 * _a16(4 * wf)
    masks = 2 * _a16(4 * n_flows * wl) + 2 * _a16(4 * n_links1 * wf)
    return FastSizes(state, masks, _a16(4 * n_flows * n_links1) + 16)


class FastPlan(NamedTuple):
    threads: int
    lanes: int          # adjacent lanes that share a link in the link passes
    layout: str         # "shared": state, masks and slab in shared memory;
                        # "masks": the slab read from device memory;
                        # "global": the state and masks in scratch too
    smem_bytes: int
    scratch_bytes: int  # device scratch a scenario ("global" only)


def waterfill_fast_plan(n_scen: int, n_flows: int, n_links1: int, n_sm: int) -> FastPlan:
    """K6's block for ``n_scen`` tables of ``n_flows`` flows over
    ``n_links1`` links on a card of ``n_sm`` SMs.  The state and masks, and
    then the slab, go to shared memory while the blocks an SM must hold for
    one wave (``ceil(n_scen / n_sm)``) still fit it together.  A link gets
    the most lanes (a power of two, at most 32) that let every link have its
    group at once."""
    if n_scen < 0 or n_flows < 0 or n_links1 < 1 or n_sm < 1:
        raise ValueError(f"no water-filling plan for {n_scen} scenarios x {n_flows} flows, "
                         f"{n_links1} links, {n_sm} SMs")
    if n_scen > MAX_GRID_X:
        raise ValueError(f"{n_scen} scenarios exceed the grid")
    threads = _threads(max(n_flows, n_links1))
    lanes = 1
    while lanes < 32 and n_links1 * lanes * 2 <= threads:
        lanes *= 2
    per_sm = max(1, -(-n_scen // n_sm))
    budget = min(SMEM_MAX, SM_SMEM // per_sm - BLOCK_RESERVED)
    z = fast_sizes(n_flows, n_links1)
    if z.state + z.masks > budget:
        return FastPlan(threads, lanes, "global", 0, z.state + z.masks)
    if z.state + z.masks + z.slab > budget:
        return FastPlan(threads, lanes, "masks", z.state + z.masks, 0)
    return FastPlan(threads, lanes, "shared", z.state + z.masks + z.slab, 0)


def _lib():
    lib = build.library("waterfill")
    fn = lib.waterfill_progressive_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 3 + [_I] * 6 + [_LL] + [_VP] * 6
        fn.restype = _I
        fast = lib.waterfill_fast_launch
        fast.argtypes = [_VP] * 3 + [_I] * 7 + [_LL, _VP, _LL, _VP, _VP]
        fast.restype = _I
    return lib


def waterfill_progressive(paths: torch.Tensor, caps: torch.Tensor,
                          active: torch.Tensor):
    """K5 on the card.  paths (F, H) int link ids (pad link L on short
    paths), int32 or cast to it; caps (L + 1,) f32 with ``caps[L] = inf``;
    active (F,) bool.

    Returns ``(rates (F,) f32, trace_links (max(F, 1),) int32, trace_shares
    (max(F, 1),) f32, n_rounds (1,) int32)`` on the card, as
    ``ref.waterfill_fixed_point_ref`` in f32 (the round count stays on the
    card; -1 would mean the loop overran its bound)."""
    build.require(caps, "caps", dtype=torch.float32, ndim=1, align=4)
    dev = caps.device
    if paths.dtype != torch.int32:
        if paths.dtype.is_floating_point or paths.dtype.is_complex or paths.dtype == torch.bool:
            raise TypeError(f"paths must hold integer link ids, got {paths.dtype}")
        build.require(paths, "paths", ndim=2, device=dev, align=1)
        paths = paths.to(torch.int32)
    build.require(paths, "paths", dtype=torch.int32, ndim=2, device=dev, align=4)
    build.require(active, "active", dtype=torch.bool, ndim=1, device=dev, align=1)
    n_flows, n_hops = paths.shape
    if active.shape[0] != n_flows:
        raise ValueError(f"active has {active.shape[0]} rows, paths {n_flows}")
    plan = waterfill_progressive_plan(n_flows, n_hops, caps.shape[0])
    n = max(n_flows, 1)
    rates = torch.empty(n_flows, dtype=torch.float32, device=dev)
    tl = torch.empty(n, dtype=torch.int32, device=dev)
    ts = torch.empty(n, dtype=torch.float32, device=dev)
    rounds = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
               if plan.scratch_bytes else None)
    lib = _lib()
    rc = lib.waterfill_progressive_launch(
        paths.data_ptr(), caps.data_ptr(), active.data_ptr(), n_flows, n_hops, caps.shape[0],
        plan.threads, int(plan.layout != "global"), int(plan.layout == "shared"),
        plan.smem_bytes, None if scratch is None else scratch.data_ptr(), rates.data_ptr(),
        tl.data_ptr(), ts.data_ptr(), rounds.data_ptr(), build.stream_ptr(caps))
    build.check(lib, rc, "waterfill_progressive")
    build.LAUNCHES["waterfill_progressive"] += 1
    return rates, tl, ts, rounds


def fast_plan_for(caps: torch.Tensor, active: torch.Tensor) -> FastPlan:
    """The plan :func:`waterfill_fast` launches for these tensors."""
    s, lp1 = caps.shape
    return waterfill_fast_plan(s, active.shape[1], lp1, build.sm_count(caps.device))


def waterfill_fast(caps: torch.Tensor, active: torch.Tensor,
                   nhops: torch.Tensor) -> torch.Tensor:
    """K6 on the card, one block a scenario.  caps (S, L + 1) f32; active
    (S, F) bool; nhops (S, F, L + 1) f32 hops of flow f on link l.  The
    kernel leaves out inactive rows and the pad column, as the JAX entry
    zeroes them.  Returns rates (S, F) f32."""
    build.require(caps, "caps", dtype=torch.float32, ndim=2, align=4)
    dev = caps.device
    build.require(active, "active", dtype=torch.bool, ndim=2, device=dev, align=1)
    build.require(nhops, "nhops", dtype=torch.float32, ndim=3, device=dev, align=4)
    s, lp1 = caps.shape
    f = active.shape[1]
    if active.shape[0] != s or nhops.shape != (s, f, lp1):
        raise ValueError(f"shapes disagree: caps {tuple(caps.shape)}, active "
                         f"{tuple(active.shape)}, nhops {tuple(nhops.shape)}")
    plan = fast_plan_for(caps, active)
    rates = torch.empty((s, f), dtype=torch.float32, device=dev)
    scratch = (torch.empty(s * plan.scratch_bytes, dtype=torch.uint8, device=dev)
               if plan.scratch_bytes and s else None)
    lib = _lib()
    rc = lib.waterfill_fast_launch(
        caps.data_ptr(), active.data_ptr(), nhops.data_ptr(), s, f, lp1, plan.threads,
        plan.lanes, int(plan.layout != "global"), int(plan.layout == "shared"), plan.smem_bytes,
        None if scratch is None else scratch.data_ptr(), plan.scratch_bytes, rates.data_ptr(),
        build.stream_ptr(caps))
    build.check(lib, rc, "waterfill_fast")
    build.LAUNCHES["waterfill_fast"] += 1
    return rates


def waterfill_rates(paths, caps, active=None, *, backend: str = "torch",
                    device=None):
    """Water-filling over one flow table (``repro.kernels.waterfill_rates``).

    ``backend="torch"``: the f64 plain loop, bit-exact against
    ``FlowPlane._recompute_rates``; ``backend="kernel"``: f32, K5 on a CUDA
    ``device`` (the default), its plain f32 version on ``"cpu"``.
    Returns ``(rates, trace_links, trace_shares, n_rounds)``: tensors on the
    device and an int."""
    if backend not in ("torch", "kernel"):
        raise ValueError(f"unknown waterfill backend {backend!r}")
    dev = build.resolve_device(device)
    dtype = torch.float64 if backend == "torch" else torch.float32
    paths = torch.as_tensor(paths).to(dev, torch.int32).contiguous()
    caps = torch.as_tensor(caps).to(dev, dtype).contiguous()
    active = (torch.ones(paths.shape[0], dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active).to(dev, torch.bool).contiguous())
    if backend == "torch":
        return ref.waterfill_fixed_point_ref(paths, caps, active)
    return ops.waterfill_progressive(paths, caps, active)


def random_flow_table(seed: int, n_flows: int = 40, n_links: int = 28, h: int = 6,
                      stall: bool = False):
    """A seeded K5 table to hold the kernel to its plain version: paths
    (n_flows, h) int32 of 1..h distinct links, padded with the pad link
    ``n_links``; caps (n_links + 1,) f64 with ``caps[n_links] = inf``; active
    (n_flows,) bool, ~85% set.  ``stall`` puts every seventh flow on the pad
    link only (no finite share: the loop strands it at inf)."""
    rng = np.random.default_rng(seed)
    caps = np.append(rng.uniform(1e7, 1e9, n_links), np.inf)
    paths = np.full((n_flows, h), n_links, np.int32)
    for f in range(n_flows):
        plen = int(rng.integers(1, h + 1))
        paths[f, :plen] = rng.choice(n_links, plen, replace=False)
    if stall:
        paths[::7] = n_links
    active = rng.random(n_flows) < 0.85
    return paths, caps, active


def random_incidence(s: int, f: int, lp1: int, seed: int, max_links: int = 5):
    """S seeded K6 tables: caps (s, lp1) f64, the pad column inf; active
    (s, f) bool, ~80% set, with none in scenario ``s // 2`` where s > 1;
    nhops (s, f, lp1) f32, each flow on 1..max_links links, flow 1 twice on
    link 0, every ninth flow on none (stranded at inf)."""
    rng = np.random.default_rng(seed)
    caps = np.concatenate([rng.uniform(1e7, 1e9, (s, lp1 - 1)), np.full((s, 1), np.inf)], 1)
    nh = np.zeros((s, f, lp1), np.float32)
    for i in range(s):
        for j in range(f):
            nh[i, j, rng.choice(lp1, int(rng.integers(1, min(max_links, lp1) + 1)),
                                replace=False)] = 1.0
    if f > 1:
        nh[:, 1, 0] = 2.0
    nh[:, ::9] = 0.0
    active = rng.random((s, f)) < 0.8
    if s > 1:
        active[s // 2] = False
    return caps, active, nh
