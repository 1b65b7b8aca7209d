"""Per-architecture configs of the port (``--arch <id>``).

Every architecture of ``repro.configs`` is ported: the dense models
(llama3-70b, qwen3-14b, phi3-medium-14b, internlm2-20b, smollm-135m), the MoE
models (granite-moe-1b-a400m, arctic-480b), rwkv6-3b (RWKV-6),
jamba-v0.1-52b (Mamba, attention and MoE), seamless-m4t-medium (an
encoder-decoder with an audio stub) and internvl2-76b (a vision prefix).
``SHAPES`` are the dry run's four input shapes; ``ASSIGNED`` the ten
architectures besides the paper's own llama3-70b, as in ``repro.configs``.
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ArchSpec

_MODULES = {"llama3-70b": "llama3_70b", "qwen3-14b": "qwen3_14b",
            "phi3-medium-14b": "phi3_medium_14b", "internlm2-20b": "internlm2_20b",
            "smollm-135m": "smollm_135m", "granite-moe-1b-a400m": "granite_moe_1b",
            "arctic-480b": "arctic_480b", "rwkv6-3b": "rwkv6_3b",
            "jamba-v0.1-52b": "jamba_v01_52b",
            "seamless-m4t-medium": "seamless_m4t_medium", "internvl2-76b": "internvl2_76b"}
ASSIGNED = [k for k in _MODULES if k != "llama3-70b"]   # llama3-70b: the paper's own model
ALL = list(_MODULES)


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}").SPEC


__all__ = ["ALL", "ASSIGNED", "ArchSpec", "SHAPES", "get_spec"]
