"""CUDA flash-decode wrapper (``csrc/flash_decode.cu``).

GQA one-token attention of q (B, H, dh) over k/v caches (B, S, KV, dh) for
the first ``pos`` positions, or row b over its first ``lengths[b]`` (the
per-slot decode), with an f32 online softmax; the output is in q's dtype.
With ``k_new``/``v_new`` (B, KV, dh) the current token's key and value join
the softmax as one more key (the read-only decode's self term);
:func:`flash_decode_partials` returns the unnormalised (acc, m, l) of a
sequence shard instead, for ``models.attention.merge_partials``.
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

from .. import hosttrace
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
        fn.argtypes = [_VP] * 8 + [_I] * 10 + [_F, _I, _VP]
        fn.restype = _I
    return lib


def plan_for(q: torch.Tensor, k_cache: torch.Tensor, pos: int) -> SplitPlan:
    """The split :func:`flash_decode` launches for these tensors; ``pos = 0``
    (an empty cache: the self term alone, or an empty partial) is one range."""
    if int(pos) == 0:
        return SplitPlan(1, 1)
    b, _, dh = q.shape
    return split_plan(b, k_cache.shape[2], int(pos), build.sm_count(q.device),
                      dh * q.element_size())


def _launch(q, k_cache, v_cache, pos, lengths, k_new, v_new, start: int,
            partial: bool) -> torch.Tensor:
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"flash_decode takes {tuple(DTYPE_CODE)}, got {q.dtype}")
    build.require(q, "q", ndim=3)
    b, h, dh = q.shape
    _, s, kv, _ = k_cache.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != dh:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    # A cache may be a slice of rows of a larger one (a sequence shard,
    # k[:, lo:hi]): its rows contiguous, a batch stride of whole rows.
    row = kv * dh
    for t, what in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        build.require(t, what, dtype=q.dtype, ndim=4, device=q.device, contiguous=False)
        if (t.stride()[1:] != (row, dh, 1) or t.stride(0) % row or t.stride(0) < s * row
                or (b > 1 and t.stride(0) != k_cache.stride(0))):
            raise ValueError(f"{what} must have contiguous rows, got strides {t.stride()}")
    seq_stride = k_cache.stride(0) // row if b > 1 else s
    if h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} heads over {kv} KV heads: need H % KV == 0 and "
                         f"H / KV <= {MAX_GROUP}")
    chunks = dh * q.element_size() // 16
    if dh * q.element_size() % 16 or chunks not in CHUNKS:
        raise ValueError(f"d_head {dh} in {q.dtype} is not 2..64 16-byte chunks (a power of two)")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    if k_new is not None:
        for t, what in ((k_new, "k_new"), (v_new, "v_new")):
            build.require(t, what, dtype=q.dtype, ndim=3, device=q.device)
            if tuple(t.shape) != (b, kv, dh):
                raise ValueError(f"{what} must be {(b, kv, dh)}, got {tuple(t.shape)}")
    pos = int(pos)
    low = 0 if k_new is not None or partial else 1
    if not low <= pos <= s:
        raise ValueError(f"pos must lie in [{low}, {s}], got {pos}")
    if lengths is not None:
        build.require(lengths, "lengths", dtype=torch.int32, ndim=1, device=q.device, align=4)
        if lengths.shape[0] != b:
            raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    plan = plan_for(q, k_cache, pos)
    if partial:   # acc (B, H, dh), then the (m, l) pairs, all f32
        out = torch.empty(b * h * (dh + 2), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
    # The ranges' partial (acc, m, l) in f32, merged by the second kernel.
    part = None
    if plan.n_split > 1:
        part = torch.empty(plan.n_split * b * h * (dh + 2), dtype=torch.float32,
                           device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    tr = hosttrace.RECORDER
    if tr is not None:
        tr.stamp(hosttrace.K4_LAUNCH)
    rc = lib.flash_decode_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                 out.data_ptr(), ptr(part), ptr(lengths), ptr(k_new), ptr(v_new),
                                 b, h, kv, seq_stride, dh, pos, int(start), plan.n_split,
                                 plan.range_len,
                                 int(partial), dh ** -0.5, DTYPE_CODE[q.dtype],
                                 build.stream_ptr(q))
    build.check(lib, rc, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int, lengths: torch.Tensor | None = None,
                 k_new: torch.Tensor | None = None,
                 v_new: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, H, dh); k/v (B, S, KV, dh); ``pos`` valid keys of the cache:
    in [1, S] without a self term, in [0, S] with one (below).

    ``lengths``, a (B,) int32 tensor on q's device, gives each row its own
    number of valid keys, each at most ``pos``, with ``pos`` their maximum
    (the caller knows it on the host: nothing is read back here).  A length
    past ``pos`` is cut to ``pos``.  Without a self term a length below 1
    gives that row zeros (the reference leaves it undefined), and ``pos =
    0`` raises.

    ``k_new``/``v_new`` (B, KV, dh), contiguous: the current token's key
    and value, one more key of every row (the cache is read, not written).
    A row with no cache key then attends to its own token alone: its output
    is its ``v_new``.  A null ``k_new`` is the launch without a self term."""
    return _launch(q, k_cache, v_cache, pos, lengths, k_new, v_new, 0, False)


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: int, lengths: torch.Tensor | None = None, *, start: int = 0,
                          k_new: torch.Tensor | None = None,
                          v_new: torch.Tensor | None = None):
    """A sequence shard's softmax partial: (acc (B, H, dh), m (B, H), l
    (B, H)), all f32, with acc = sum_j exp(s_j - m) v_j and l = sum_j
    exp(s_j - m) over the shard's valid keys (and the self term, where
    ``k_new`` is given: on shard 0 only).  k/v (B, S_loc, KV, dh) are the
    shard's rows ``[start, start + S_loc)``; ``pos`` (0 <= pos <= S_loc)
    the longest row's valid local keys, ``lengths`` the rows' global
    lengths, from which ``start`` is taken.  A row with no key gives m =
    -1e30, l = 0 and acc = 0, which the merge weighs 0."""
    b, h, dh = q.shape
    flat = _launch(q, k_cache, v_cache, pos, lengths, k_new, v_new, start, True)
    acc = flat[:b * h * dh].view(b, h, dh)
    ml = flat[b * h * dh:].view(b, h, 2)
    return acc, ml[..., 0], ml[..., 1]
