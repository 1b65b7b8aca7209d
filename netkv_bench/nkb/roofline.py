"""Peaks of one H100 and the operations and bytes of the measured calls.

``HBM_BYTES_S``, ``PEAK_FLOPS``, :func:`bound` and :func:`kernel_class` are
copied from ``chip_smoke.py`` at commit 8a74bdd2 (``HBM_BYTES_S``,
``PEAK_FLOPS``, ``bound``, ``kernel_class``), keyed by dtype name here.
The byte counts of K2/K3/K4 follow that script's bounds (each input byte
read once, each output byte written once); the decode step's useful work
follows its ``model_bounds``, narrowed to the weights and KV that the
active requests use.  Dimensions come from the benchmark's configuration
file, never from the program.
"""

from __future__ import annotations

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
    """The widths a count needs, from a configuration file."""

    def __init__(self, cfg: dict):
        self.d = int(cfg["hidden_size"])
        self.layers = int(cfg["num_hidden_layers"])
        self.heads = int(cfg["num_attention_heads"])
        self.kv = int(cfg["num_key_value_heads"])
        self.dh = int(cfg.get("head_dim") or self.d // self.heads)
        self.vocab = int(cfg["vocab_size"])
        self.ff = int(cfg["intermediate_size"])
        self.experts = int(cfg.get("num_local_experts") or 0)
        self.top_k = int(cfg.get("num_experts_per_tok") or 0)

    @property
    def kv_row_bytes(self) -> int:
        """One position's K (or V) row of one layer."""
        return self.kv * self.dh * BF16

    @property
    def page_bytes(self) -> int:
        return PAGE_TOKENS * self.kv_row_bytes

    def attn_params(self) -> int:
        """Per layer: the q, k, v and o projections."""
        d, h, kv, dh = self.d, self.heads, self.kv, self.dh
        return d * h * dh + 2 * d * kv * dh + h * dh * d

    def expert_params(self) -> int:
        return 3 * self.d * self.ff

    def ffn_params_per_token(self) -> int:
        """Per layer, the FFN weights one token runs through."""
        if self.experts:
            return self.d * self.experts + self.top_k * self.expert_params()
        return 3 * self.d * self.ff


def k4_call_bytes(dims: Dims, lanes: int, rows: int) -> int:
    """One K4 call: q and the output (lanes x H x dh) and K and V of
    ``rows`` positions for every lane, the call's inputs as given
    (inactive lanes included)."""
    return 2 * lanes * dims.heads * dims.dh * BF16 + 2 * lanes * rows * dims.kv_row_bytes


def pack_call_bytes(dims: Dims, pages: int) -> int:
    """One K2 or K3 call over ``pages`` pages: each read once and written
    once."""
    return 2 * pages * dims.page_bytes


def decode_step_work(dims: Dims, positions: list[int]) -> tuple[float, float]:
    """(bytes, operations) of one decode step's useful work for the active
    requests at ``positions`` (each the position its token is written at):
    every weight they use read once (for a MoE, the router and the routed
    experts, at most all of them), their own K/V rows read and the new row
    written, the embedding rows gathered; 2 operations a weight a token and
    4·H·dh a (query, key) pair."""
    n = len(positions)
    if n == 0:
        return 0.0, 0.0
    if dims.experts:
        used = min(dims.experts, dims.top_k * n)
        ffn_bytes = (dims.d * dims.experts + used * dims.expert_params()) * BF16
    else:
        ffn_bytes = 3 * dims.d * dims.ff * BF16
    norms = 2 * dims.d * BF16                     # a layer's two norm scales
    weights = dims.layers * (dims.attn_params() * BF16 + ffn_bytes + norms) \
        + dims.d * dims.vocab * BF16 + dims.d * 4     # lm_head, the final norm in f32
    keys = sum(p + 1 for p in positions)
    kv = dims.layers * 2 * dims.kv_row_bytes * (keys + n)
    embed = n * dims.d * BF16
    per_token = dims.layers * (dims.attn_params() + dims.ffn_params_per_token()) \
        + dims.d * dims.vocab
    flops = 2.0 * n * per_token + 4.0 * dims.layers * dims.heads * dims.dh * keys
    return float(weights + kv + embed), flops
