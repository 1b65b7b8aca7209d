"""CUDA WKV-6 scan wrapper (``csrc/rwkv_scan.cu``).

The recurrence of the RWKV-6 time mix over T steps from a zero state, one
block per (batch, head) walking the whole of T.  The JAX kernel's ``chunk``
argument is dropped: it sized the blocks that carried the state across a
sequential grid axis on the TPU, and here no state crosses blocks, so any T
is taken, a ragged one included.  CUDA tensors only: the plain version is
``ref.rwkv_scan_ref`` and ``ops`` picks per tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128   # the widest state column block the kernel holds

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.library("rwkv_scan")
    fn = lib.rwkv_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 5 + [_VP]
        fn.restype = _I
    return lib


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor):
    """r/k/v/w (B, T, H, dh) of one dtype, f32 or bf16, w the per-step decay;
    u (H, dh) of any float dtype (used in f32).

    Returns (y (B, T, H, dh) in r's dtype, final state (B, H, dh, dh) f32
    indexed [k_idx, v_idx]), as ``ref.rwkv_scan_ref``."""
    if r.dtype not in DTYPE_CODE:
        raise TypeError(f"rwkv_scan takes {tuple(DTYPE_CODE)}, got {r.dtype}")
    es = r.element_size()   # the kernel reads one element at a time
    build.require(r, "r", ndim=4, align=es)
    for name, t in (("k", k), ("v", v), ("w", w)):
        build.require(t, name, dtype=r.dtype, ndim=4, device=r.device, align=es)
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
    b, t_len, h, dh = r.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if not u.is_floating_point() or tuple(u.shape) != (h, dh):
        raise ValueError(f"u must be a float tensor of shape {(h, dh)}, got "
                         f"{u.dtype} {tuple(u.shape)}")
    if u.device != r.device:
        raise ValueError(f"u is on {u.device}, expected {r.device}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    lib = _lib()
    rc = lib.rwkv_scan_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                              u32.data_ptr(), y.data_ptr(), state.data_ptr(),
                              b, t_len, h, dh, DTYPE_CODE[r.dtype], build.stream_ptr(r))
    build.check(lib, rc, "rwkv_scan")
    build.LAUNCHES["rwkv_scan"] += 1
    return y, state
