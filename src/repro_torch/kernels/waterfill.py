"""Max-min fair water-filling: the CUDA kernels (``csrc/waterfill.cu``) and
the public entries over them.

  waterfill_progressive  K5: FlowPlane's progressive fixed point, one
                         bottleneck link a round, with its (link, share)
                         trace; one block per flow table.
  waterfill_fast         K6: the parallel-bottleneck fixed point of the
                         ScenarioPlane sweep, one block per scenario, one
                         launch per sweep step.

Both run the whole round loop on the device in f32, as the Pallas route of
``repro/kernels/waterfill.py`` computes in f32.  ``ops`` routes CUDA
tensors to them and CPU tensors to their plain versions in ``ref``.
:func:`waterfill_rates` is the counterpart of the JAX entry:
``backend="torch"`` is the f64 plain loop (the port of the jitted f64
route), ``backend="kernel"`` K5 through ``ops``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops, ref

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.library("waterfill")
    fn = lib.waterfill_progressive_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_I] * 3 + [_VP] * 5
        fn.restype = _I
        fast = lib.waterfill_fast_launch
        fast.argtypes = [_VP] * 3 + [_I] * 3 + [_VP] * 2
        fast.restype = _I
    return lib


def waterfill_progressive(paths: torch.Tensor, caps: torch.Tensor,
                          active: torch.Tensor):
    """K5 on the card.  paths (F, H) int link ids (pad link L on short
    paths); caps (L + 1,) f32 with ``caps[L] = inf``; active (F,) bool.

    Returns ``(rates (F,) f32, trace_links (max(F, 1),) int32, trace_shares
    (max(F, 1),) f32, n_rounds (1,) int32)`` on the card, as
    ``ref.waterfill_fixed_point_ref`` in f32 (the round count stays on the
    card; -1 would mean the loop overran its bound)."""
    build.require(caps, "caps", dtype=torch.float32, ndim=1, align=4)
    dev = caps.device
    build.require(paths, "paths", ndim=2, device=dev, align=4)
    build.require(active, "active", dtype=torch.bool, ndim=1, device=dev, align=1)
    n_flows, n_hops = paths.shape
    if active.shape[0] != n_flows:
        raise ValueError(f"active has {active.shape[0]} rows, paths {n_flows}")
    p, perm, counts0, caps_p0 = ref.waterfill_prep(paths, caps, active)
    p32 = p.to(torch.int32).contiguous()
    counts32 = counts0.to(torch.int32)
    n = max(n_flows, 1)
    rates = torch.empty(n_flows, dtype=torch.float32, device=dev)
    tl = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ts = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    rounds = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.waterfill_progressive_launch(
        p32.data_ptr(), caps_p0.contiguous().data_ptr(), counts32.data_ptr(),
        active.data_ptr(), perm.data_ptr(), n_flows, n_hops, caps.shape[0],
        rates.data_ptr(), tl.data_ptr(), ts.data_ptr(), rounds.data_ptr(),
        build.stream_ptr(caps))
    build.check(lib, rc, "waterfill_progressive")
    build.LAUNCHES["waterfill_progressive"] += 1
    return rates, tl, ts, rounds


def waterfill_fast(caps: torch.Tensor, active: torch.Tensor,
                   nhops: torch.Tensor) -> torch.Tensor:
    """K6 on the card, one block per scenario.  caps (S, L + 1) f32; active
    (S, F) bool; nhops (S, F, L + 1) f32 hops of flow f on link l.
    Inactive rows and the pad column are zeroed here, as the JAX entry does.
    Returns rates (S, F) f32."""
    build.require(caps, "caps", dtype=torch.float32, ndim=2, align=4)
    dev = caps.device
    build.require(active, "active", dtype=torch.bool, ndim=2, device=dev, align=1)
    build.require(nhops, "nhops", dtype=torch.float32, ndim=3, device=dev, align=4)
    s, lp1 = caps.shape
    f = active.shape[1]
    if active.shape[0] != s or nhops.shape != (s, f, lp1):
        raise ValueError(f"shapes disagree: caps {tuple(caps.shape)}, active "
                         f"{tuple(active.shape)}, nhops {tuple(nhops.shape)}")
    nh = nhops * active[..., None]
    nh[..., lp1 - 1] = 0.0
    rates = torch.empty((s, f), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.waterfill_fast_launch(caps.data_ptr(), active.data_ptr(), nh.data_ptr(),
                                   s, f, lp1, rates.data_ptr(), build.stream_ptr(caps))
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
