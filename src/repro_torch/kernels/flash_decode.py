"""CUDA flash-decode wrapper (``csrc/flash_decode.cu``).

GQA one-token attention of q (B, H, dh) over k/v caches (B, S, KV, dh) for
the first ``pos`` positions, or row b over its first ``lengths[b]`` (the
per-slot decode), with an f32 online softmax; the output is in q's dtype.
The kernel splits ``[0, pos)`` into contiguous ranges, one block a (batch,
KV head, range), and a second kernel merges the ranges in order;
:func:`split_plan` chooses the ranges (over the longest row).  CUDA tensors
only: the plain version is ``ref.flash_decode_ref`` and ``ops`` picks per
tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8   # query heads per KV head that one block holds
CHUNKS = (2, 4, 8, 16, 32, 64)  # 16-byte chunks per head row the kernel takes

# The split: a block stages its range's key rows, and then its value rows,
# whole in shared memory, at most TILE_BYTES of each; ranges hold MIN_RANGE
# keys or more where pos has them, and enough ranges are cut that
# BLOCKS_PER_SM blocks (~70 KB of shared memory each) fill every SM once.
TILE_BYTES = 32 * 1024
MAX_RANGE = 256   # keys a block scores at most (its score rows in shared memory)
MIN_RANGE = 16
BLOCKS_PER_SM = 3
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SplitPlan(NamedTuple):
    n_split: int    # ranges of [0, pos): grid (batch * n_kv, n_split)
    range_len: int  # keys of each range; the last holds pos - (n_split - 1) * range_len
    # With per-row lengths pos is the longest row's; range i of a row of
    # length L holds min(range_len, L - i * range_len) keys, none where that
    # is <= 0 (its block writes an empty partial).


def split_plan(batch: int, n_kv: int, pos: int, n_sm: int, row_bytes: int) -> SplitPlan:
    """Cut the first ``pos`` keys of each of the ``batch * n_kv`` (batch, KV
    head) pairs into contiguous ranges, one block each, so that the blocks
    fill ``n_sm`` SMs ``BLOCKS_PER_SM`` deep.  A range stages at most
    ``TILE_BYTES`` of key rows of ``row_bytes`` each; the ranges are then
    balanced, so all but the last hold ``range_len`` keys."""
    if pos < 1 or batch < 1 or n_kv < 1 or n_sm < 1 or row_bytes < 1:
        raise ValueError(f"no split for batch {batch}, n_kv {n_kv}, pos {pos}, "
                         f"{n_sm} SMs, rows of {row_bytes} bytes")
    pairs = batch * n_kv
    if pairs > MAX_GRID_X:
        raise ValueError(f"{pairs} (batch, KV head) pairs exceed the grid")
    cap = max(1, min(MAX_RANGE, TILE_BYTES // row_bytes))
    want = -(-BLOCKS_PER_SM * n_sm // pairs)       # ranges a pair to fill the card
    range_len = min(cap, max(MIN_RANGE, -(-pos // want)))
    n_split = -(-pos // range_len)
    if n_split > MAX_GRID_Y:
        raise ValueError(f"pos {pos} needs {n_split} ranges, over the grid's {MAX_GRID_Y}")
    return SplitPlan(n_split, -(-pos // n_split))


def _lib():
    lib = build.library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 6 + [_I] * 8 + [_F, _I, _VP]
        fn.restype = _I
    return lib


def plan_for(q: torch.Tensor, k_cache: torch.Tensor, pos: int) -> SplitPlan:
    """The split :func:`flash_decode` launches for these tensors."""
    b, _, dh = q.shape
    return split_plan(b, k_cache.shape[2], int(pos), build.sm_count(q.device),
                      dh * q.element_size())


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, H, dh); k/v (B, S, KV, dh); ``pos`` valid keys (1 <= pos <= S).

    ``lengths``, a (B,) int32 tensor on q's device, gives each row its own
    number of valid keys, each in [1, pos], with ``pos`` their maximum (the
    caller knows it on the host: nothing is read back here).  A length past
    ``pos`` is cut to ``pos``; a length below 1 gives that row zeros.
    ``pos = 0`` is left undefined by the reference and never reached by
    serving, so it raises here."""
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_decode takes {tuple(DTYPE_CODE)}, got {q.dtype}")
    build.require(q, "q", ndim=3)
    build.require(k_cache, "k_cache", dtype=q.dtype, ndim=4, device=q.device)
    build.require(v_cache, "v_cache", dtype=q.dtype, ndim=4, device=q.device)
    b, h, dh = q.shape
    _, s, kv, _ = k_cache.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != dh:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} heads over {kv} KV heads: need H % KV == 0 and "
                         f"H / KV <= {MAX_GROUP}")
    chunks = dh * q.element_size() // 16
    if dh * q.element_size() % 16 or chunks not in CHUNKS:
        raise ValueError(f"d_head {dh} in {q.dtype} is not 2..64 16-byte chunks (a power of two)")
    pos = int(pos)
    if not 1 <= pos <= s:
        raise ValueError(f"pos must lie in [1, {s}], got {pos}")
    if lengths is not None:
        build.require(lengths, "lengths", dtype=torch.int32, ndim=1, device=q.device, align=4)
        if lengths.shape[0] != b:
            raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    plan = plan_for(q, k_cache, pos)
    out = torch.empty_like(q)
    # The ranges' partial (acc, m, l) in f32, merged by the second kernel.
    part = None
    if plan.n_split > 1:
        part = torch.empty(plan.n_split * b * h * (dh + 2), dtype=torch.float32,
                           device=q.device)
    lib = _lib()
    rc = lib.flash_decode_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                 out.data_ptr(), None if part is None else part.data_ptr(),
                                 None if lengths is None else lengths.data_ptr(),
                                 b, h, kv, s, dh, pos, plan.n_split, plan.range_len,
                                 dh ** -0.5, DTYPE_CODE[q.dtype], build.stream_ptr(q))
    build.check(lib, rc, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    return out
