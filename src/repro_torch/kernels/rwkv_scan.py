"""CUDA WKV-6 scan wrapper (``csrc/rwkv_scan.cu``).

The recurrence of the RWKV-6 time mix over T steps from a zero state, one
block per (batch, head, group of state columns) walking the whole of T;
:func:`column_plan` sizes the groups.  The JAX kernel's ``chunk`` argument
is dropped: it sized the blocks that carried the state across a sequential
grid axis on the TPU, and here no state crosses blocks, so any T is taken,
a ragged one included.  The kernel copies rows in 16-byte pieces: where a
row of dh elements is not a whole number of them, or a tensor is not
16-byte aligned, the wrapper runs it on zero-padded copies and cuts the
outputs back to dh.  CUDA tensors only: the plain version is
``ref.rwkv_scan_ref`` and ``ops`` picks per tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128   # the widest state the kernel holds
COLUMN_WIDTHS = (16, 24, 32)   # state columns a block can own
MAX_GRID_X = 2 ** 31 - 1

_VP, _I = ctypes.c_void_p, ctypes.c_int


def padded_width(dh: int, element_size: int) -> int:
    """The head width the kernel runs: dh rounded up to whole 16-byte rows.
    Padded rows carry r = k = w = 0 and padded columns v = 0, so the first
    dh rows and columns of y and the state are those of the unpadded scan."""
    per = 16 // element_size
    return -(-dh // per) * per


def column_plan(batch: int, n_heads: int, dh: int, n_sm: int) -> int:
    """The state columns one block owns, 16, 24 or 32.  Its column threads
    each walk their own 4 x 4 tile, so a block takes about as long whatever
    its width while its warps do not share a scheduler: take the width that
    puts the fewest blocks on the busiest of ``n_sm`` SMs, and the narrowest
    (fewer warps a block) on a tie."""
    if min(batch, n_heads, dh, n_sm) < 1:
        raise ValueError(f"no column plan for batch {batch}, {n_heads} heads, dh {dh}, "
                         f"{n_sm} SMs")

    def busiest(width: int) -> int:
        return -(-batch * n_heads * -(-dh // width) // n_sm)

    width = min(COLUMN_WIDTHS, key=lambda w_: (busiest(w_), w_))
    if batch * n_heads * -(-dh // width) > MAX_GRID_X:
        raise ValueError(f"{batch * n_heads} (batch, head) pairs exceed the grid")
    return width


def _lib():
    lib = build.library("rwkv_scan")
    fn = lib.rwkv_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 6 + [_VP]
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
    es = r.element_size()
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
    width = padded_width(dh, es)
    x = (r, k, v, w)
    if width != dh or any(t.data_ptr() % 16 for t in x):
        x = tuple(F.pad(t, (0, width - dh)) if width != dh else t.clone() for t in x)
        u32 = F.pad(u32, (0, width - dh))
    y = torch.empty_like(x[0])
    state = torch.empty((b, h, width, width), dtype=torch.float32, device=r.device)
    lib = _lib()
    cols = column_plan(b, h, width, build.sm_count(r.device))
    rc = lib.rwkv_scan_launch(*(t.data_ptr() for t in x), u32.data_ptr(), y.data_ptr(),
                              state.data_ptr(), b, t_len, h, width, cols,
                              DTYPE_CODE[r.dtype], build.stream_ptr(r))
    build.check(lib, rc, "rwkv_scan")
    build.LAUNCHES["rwkv_scan"] += 1
    if width != dh:
        y = y[..., :dh].contiguous()
        state = state[:, :, :dh, :dh].contiguous()
    return y, state
