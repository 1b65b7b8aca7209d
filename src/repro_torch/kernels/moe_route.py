"""CUDA wrapper of K9, the routing of a decode step's MoE layer and its
capacity rule (``csrc/moe_route.cu``).

``x`` (T, d) and the ``router`` (d, E) as the model stores it, in one dtype,
give ``experts`` (T, k) int64, ``gates_kept`` (T, k) f32 (each slot past its
expert's ``cap`` slots given gate 0) and the aux loss () f32: what
``models.moe``'s ``route``, ``slot_positions`` and aux compute, in one
launch of one 8-block cluster: the blocks split the router's rows and their
partial logits meet in block 0's distributed shared memory.  The grid and
shared memory depend on (T, d, E) alone, so a CUDA graph captures it.  K8
(``kernels.moe_decode``) takes ``experts`` and ``gates_kept``.  CUDA tensors
only: the plain version is ``ref.moe_route_ref`` and ``ops`` picks per
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .moe_decode import DTYPE_CODE, MAX_ROWS

MAX_EXPERTS = 64

_VP, _I = ctypes.c_void_p, ctypes.c_int


def routes(n_experts: int, top_k: int) -> bool:
    """Whether K9 takes E experts, top k: E a power of two at most
    MAX_EXPERTS (a thread's router vectors then always hold the same
    columns), 1 <= k <= E."""
    return 1 <= n_experts <= MAX_EXPERTS and n_experts & (n_experts - 1) == 0 \
        and 1 <= top_k <= n_experts


def _lib():
    lib = build.library("moe_route")
    fn = lib.moe_route_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_I] * 8 + [_VP]
        fn.restype = _I
    return lib


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
              renormalize: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(experts (T, k) int64, gates_kept (T, k) f32, aux () f32) of T <=
    MAX_ROWS tokens: the top k of softmax(x router) in f32, the lower index
    first on a tie; their gates renormalised or not; a slot's gate 0 where
    ``cap`` earlier tokens already route to its expert."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"moe_route takes {tuple(DTYPE_CODE)}, got {x.dtype}")
    build.require(x, "x", ndim=2)
    build.require(router, "router", dtype=x.dtype, ndim=2, device=x.device)
    t, d = x.shape
    e = router.shape[1]
    if router.shape[0] != d:
        raise ValueError(f"router must be ({d}, E), got {tuple(router.shape)}")
    if not 1 <= t <= MAX_ROWS:
        raise ValueError(f"moe_route takes 1..{MAX_ROWS} tokens, got {t}")
    if not routes(e, top_k):
        raise ValueError(f"moe_route takes a power of two <= {MAX_EXPERTS} experts and "
                         f"1 <= k <= E, got E {e}, k {top_k}")
    if d % (16 // x.element_size()):
        raise ValueError(f"moe_route needs d a multiple of {16 // x.element_size()}, got {d}")
    experts = torch.empty((t, top_k), dtype=torch.int64, device=x.device)
    gates = torch.empty((t, top_k), dtype=torch.float32, device=x.device)
    aux = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.moe_route_launch(x.data_ptr(), router.data_ptr(), experts.data_ptr(),
                              gates.data_ptr(), aux.data_ptr(), t, d, e, top_k, cap,
                              int(renormalize), 1 << (t - 1).bit_length(), DTYPE_CODE[x.dtype],
                              build.stream_ptr(x))
    build.check(lib, rc, "moe_route")
    build.LAUNCHES["moe_route"] += 1
    return experts, gates, aux
