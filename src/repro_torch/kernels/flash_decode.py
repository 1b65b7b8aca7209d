"""CUDA flash-decode wrapper (``csrc/flash_decode.cu``).

GQA one-token attention of q (B, H, dh) over k/v caches (B, S, KV, dh) for
the first ``pos`` positions, with an f32 online softmax; the output is in
q's dtype.  CUDA tensors only: the plain version is ``ref.flash_decode_ref``
and ``ops`` picks per tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8   # query heads per KV head that one block holds
CHUNKS = (2, 4, 8, 16, 32, 64)  # 16-byte chunks per head row the kernel takes

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.library("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _F, _I, _VP]
        fn.restype = _I
    return lib


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """q (B, H, dh); k/v (B, S, KV, dh); ``pos`` valid keys (1 <= pos <= S).

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
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.flash_decode_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                 out.data_ptr(), b, h, kv, s, dh, pos, dh ** -0.5,
                                 DTYPE_CODE[q.dtype], build.stream_ptr(q))
    build.check(lib, rc, "flash_decode")
    build.LAUNCHES["flash_decode"] += 1
    return out
