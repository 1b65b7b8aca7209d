"""Peaks of one H100 and the operations and bytes of the measured calls.

``HBM_BYTES_S``, ``PEAK_FLOPS``, :func:`bound` and :func:`kernel_class` are
copied from ``chip_smoke.py`` at commit 8a74bdd2 (``HBM_BYTES_S``,
``PEAK_FLOPS``, ``bound``, ``kernel_class``), keyed by dtype name here.
The byte counts of K2/K3/K4 follow that script's bounds (each input byte
read once, each output byte written once); a decode step's useful work is
its layer stack's (``nkb.stacks``).  Dimensions come from the benchmark's
configuration file, never from the program.
"""

from __future__ import annotations

from . import stacks

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and FLOP/s
# by operand type.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PAGE_TOKENS = 16          # the transfer's page (block) size in tokens
BF16 = 2


def bound(nbytes: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """Least seconds at the peaks, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_class(name: str, moe: bool = False) -> str:
    """A kernel's class by its name (``chip_smoke.kernel_class`` without
    its training split)."""
    low = name.lower()
    if "rwkv" in low:
        return "rwkv"
    if "flash_decode" in low:
        return "flash_decode"
    if "kv_pack" in low or "kv_unpack" in low:
        return "kv_pack"
    if "waterfill" in low:
        return "waterfill"
    if "netkv" in low:
        return "netkv"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if not moe:
        return "other"
    if any(k in low for k in ("sort", "scan", "scatter_gather", "index")):
        return "moe_dispatch"
    if "softmax" in low:
        return "softmax"
    return "other"


class Dims:
    """The widths a count of K4's or K2/K3's bytes needs, the attention
    layers a step calls K4 in, and the MoE flag of ``trace.summarize``: from
    the configuration's layer stack (``nkb.stacks``), whatever its layers."""

    def __init__(self, cfg: dict):
        f = stacks.of(cfg).model_fields(cfg)
        self.heads, self.kv, self.dh = int(f["n_heads"]), int(f["n_kv_heads"]), int(f["d_head"])
        self.vocab = int(f["vocab_size"])
        blocks = f.get("block_pattern", ("attn",))
        self.attn_layers = int(f["n_layers"]) // len(blocks) * blocks.count("attn")
        self.experts = int((f.get("moe") or {}).get("n_experts", 0))

    @property
    def kv_row_bytes(self) -> int:
        """One position's K (or V) row of one layer."""
        return self.kv * self.dh * BF16

    @property
    def page_bytes(self) -> int:
        return PAGE_TOKENS * self.kv_row_bytes


def k4_call_bytes(dims: Dims, lanes: int, rows: int) -> int:
    """One K4 call: q and the output (lanes x H x dh) and K and V of
    ``rows`` positions for every lane, the call's inputs as given
    (inactive lanes included)."""
    return 2 * lanes * dims.heads * dims.dh * BF16 + 2 * lanes * rows * dims.kv_row_bytes


def pack_call_bytes(dims: Dims, pages: int) -> int:
    """One K2 or K3 call over ``pages`` pages: each read once and written
    once."""
    return 2 * pages * dims.page_bytes
