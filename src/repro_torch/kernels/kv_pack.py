"""CUDA kv_pack / kv_unpack wrappers (``csrc/kv_pack.cu``).

``kv_pack`` gathers the pages a block table selects from a paged KV pool
into one contiguous transfer buffer; ``kv_unpack`` scatters such a buffer
back into the caller's pool, in place.  They take CUDA tensors only: the
plain versions for the CPU are in ``ref.py`` and ``ops`` picks per tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

DTYPES = (torch.bfloat16, torch.float32)

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = build.library("kv_pack")
    for fn in (lib.kv_pack_launch, lib.kv_unpack_launch):
        if fn.argtypes is None:
            fn.argtypes = [_VP, _VP, _VP, _I, _LL, _VP]
            fn.restype = _I
    return lib


def _table_on(table, n_pages: int, device: torch.device) -> torch.Tensor:
    """The block table as a contiguous int32 tensor on ``device``.  A host
    table (the transfer path builds its tables on the host) is checked
    against the pool's page count before it is copied over."""
    table = torch.as_tensor(table)
    if table.dtype != torch.int32:
        raise TypeError(f"block table must be int32, got {table.dtype}")
    if table.dim() != 1:
        raise ValueError("block table must be 1-D")
    if table.device.type == "cpu":
        if table.numel() and (int(table.min()) < 0 or int(table.max()) >= n_pages):
            raise IndexError(f"block table outside the pool's {n_pages} pages")
        table = table.to(device)
    elif table.device != device:
        raise ValueError(f"block table is on {table.device}, pool on {device}")
    return table.contiguous()


def _page_bytes(pages: torch.Tensor) -> int:
    nbytes = pages[0].numel() * pages.element_size() if pages.shape[0] else 0
    if nbytes % 16:
        raise ValueError(f"page of {nbytes} bytes is not a multiple of 16")
    return nbytes


def kv_pack(pool: torch.Tensor, block_table) -> torch.Tensor:
    """pool (n_pages, page_tokens, KV, dh); table (n_sel,) int32 ->
    (n_sel, page_tokens, KV, dh), the selected pages, contiguous."""
    build.require(pool, "pool", dtype=DTYPES, ndim=4)
    table = _table_on(block_table, pool.shape[0], pool.device)
    out = torch.empty((table.shape[0], *pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if not table.numel():
        return out  # nothing to launch
    lib = _lib()
    rc = lib.kv_pack_launch(pool.data_ptr(), out.data_ptr(), table.data_ptr(),
                            table.shape[0], _page_bytes(pool),
                            build.stream_ptr(pool))
    build.check(lib, rc, "kv_pack")
    build.LAUNCHES["kv_pack"] += 1
    return out


def kv_unpack(pool: torch.Tensor, buf: torch.Tensor, block_table) -> torch.Tensor:
    """Scatter ``buf``'s pages into ``pool`` at the table's page ids, in
    place; returns ``pool``."""
    build.require(pool, "pool", dtype=DTYPES, ndim=4)
    build.require(buf, "buf", dtype=pool.dtype, ndim=4, device=pool.device)
    if buf.shape[1:] != pool.shape[1:]:
        raise ValueError(f"page shapes differ: buf {tuple(buf.shape)}, pool {tuple(pool.shape)}")
    table = _table_on(block_table, pool.shape[0], pool.device)
    if table.shape[0] != buf.shape[0]:
        raise ValueError(f"table has {table.shape[0]} pages, buf {buf.shape[0]}")
    if not table.numel():
        return pool  # nothing to launch
    lib = _lib()
    rc = lib.kv_unpack_launch(pool.data_ptr(), buf.data_ptr(), table.data_ptr(),
                              table.shape[0], _page_bytes(pool),
                              build.stream_ptr(pool))
    build.check(lib, rc, "kv_unpack")
    build.LAUNCHES["kv_unpack"] += 1
    return pool
