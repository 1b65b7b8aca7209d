"""CUDA wrapper of K8, the MoE FFN of a decode step over its routed experts
(``csrc/moe_decode.cu``).

``x`` (T, d), the routing of ``models.moe.route`` (``experts`` (T, k) int64
and ``gates`` (T, k) f32, each row's elements contiguous) and the stacked
expert weights as the model stores them (``w_gate``, ``w_up`` (E, d, f),
``w_down`` (E, f, d)) give the combined (T, d) output in x's dtype, reading
only the experts the T tokens route to.  Three kernels: gate and up over
(column tile, expert), down over (column tile, split of f, expert), and the
combine; a block of an expert no token routes to exits before it reads a
weight.  :func:`plan` chooses the rows a block holds and the split of f
from (T, d, f, dtype) alone, so the grids never depend on the routing and a
CUDA graph captures the launches.  CUDA tensors only: the plain version is
``ref.moe_decode_ref`` and ``ops`` picks per tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 8            # tokens a launch takes (rows of x a block holds)
ROW_BYTES = 64 * 1024   # shared memory a block gives its rows of x (or of h over its split)
MAX_RANGE = 4096        # rows of f a block of the down projection reads at most
ALIGN = 8               # d, f and the split's ranges: 16-byte vectors of bf16

_VP, _I = ctypes.c_void_p, ctypes.c_int


class Plan(NamedTuple):
    rows: int       # rows a block holds: the least power of two >= T
    n_split: int    # ranges of f in the down projection: grid (d tiles, n_split, E)
    range_len: int  # rows of f a range, a multiple of ALIGN; the last range holds the rest


def held_rows(d: int, dtype: torch.dtype) -> int:
    """The most tokens a launch at width ``d`` takes: a power of two at most
    MAX_ROWS whose rows of x fit ROW_BYTES (0 where one row does not)."""
    rows = MAX_ROWS
    while rows and rows * d * dtype.itemsize > ROW_BYTES:
        rows //= 2
    return rows


def plan(t: int, d: int, f: int, dtype: torch.dtype) -> Plan:
    """Rows and split of a launch for T tokens at widths (d, f): ranges of f
    of at most MAX_RANGE rows whose staged rows of h fit ROW_BYTES, cut
    evenly, each a multiple of ALIGN."""
    if not 1 <= t <= held_rows(d, dtype):
        raise ValueError(f"moe_decode takes 1..{held_rows(d, dtype)} tokens at d {d} in "
                         f"{dtype}, got {t}")
    if d % ALIGN or f % ALIGN:
        raise ValueError(f"moe_decode needs d and f multiples of {ALIGN}, got {d}, {f}")
    rows = 1 << (t - 1).bit_length()
    cap = min(MAX_RANGE, ROW_BYTES // (rows * dtype.itemsize)) // ALIGN * ALIGN
    n_split = -(-f // cap)
    range_len = -(-(-(-f // n_split)) // ALIGN) * ALIGN
    return Plan(rows, -(-f // range_len), range_len)


def _lib():
    lib = build.library("moe_decode")
    fn = lib.moe_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP] + [_I] * 9 + [_VP]
        fn.restype = _I
    return lib


def _rows(t: torch.Tensor, what: str, dtype, shape) -> int:
    """Checks a (T, k) routing tensor whose rows may be a slice of longer
    rows (``route``'s top-k of its sort); returns its row stride."""
    build.require(t, what, dtype=dtype, ndim=2, align=t.element_size(), contiguous=False)
    if tuple(t.shape) != shape or t.stride(1) != 1:
        raise ValueError(f"{what} must be {shape} with contiguous rows, got "
                         f"{tuple(t.shape)}, strides {t.stride()}")
    return t.stride(0)


def moe_decode(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The MoE FFN's combined output (T, d) in x's dtype: each token's k
    slots through their experts' SwiGLU, weighed by their gates and added in
    k order, rounded as ``models.moe``'s ``bmm`` path rounds.  A slot the
    capacity rule drops comes with gate 0 (K9's ``gates_kept``), so its term
    is 0 as on the ``bmm`` path.  ``experts`` must lie in
    [0, E), a token's k distinct (``route`` gives them so): nothing is read
    back to check."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"moe_decode takes {tuple(DTYPE_CODE)}, got {x.dtype}")
    build.require(x, "x", ndim=2)
    t, d = x.shape
    e, _, f = w_gate.shape
    k = experts.shape[-1]
    for w, what, shape in ((w_gate, "w_gate", (e, d, f)), (w_up, "w_up", (e, d, f)),
                           (w_down, "w_down", (e, f, d))):
        build.require(w, what, dtype=x.dtype, ndim=3, device=x.device)
        if tuple(w.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(w.shape)}")
    ld_e = _rows(experts, "experts", torch.int64, (t, k))
    ld_g = _rows(gates, "gates", torch.float32, (t, k))
    if experts.device != x.device or gates.device != x.device:
        raise ValueError("experts and gates must lie on x's device")
    if not 1 <= k <= e:
        raise ValueError(f"top-k {k} of {e} experts")
    p = plan(t, d, f, x.dtype)
    h = torch.empty((t * k, f), dtype=x.dtype, device=x.device)
    part = torch.empty((p.n_split, t * k, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.moe_decode_launch(x.data_ptr(), experts.data_ptr(), ld_e, gates.data_ptr(), ld_g,
                               w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                               h.data_ptr(), part.data_ptr(), out.data_ptr(), t, k, e, d, f,
                               p.rows, p.n_split, p.range_len, DTYPE_CODE[x.dtype],
                               build.stream_ptr(x))
    build.check(lib, rc, "moe_decode")
    build.LAUNCHES["moe_decode"] += 1
    return out
