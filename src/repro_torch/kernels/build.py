"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, and loaded with ``ctypes``.  No PyTorch header is
compiled, so a build takes seconds.  :func:`build_all` starts one ``nvcc``
per source, all at once.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]

# source name -> extra nvcc flags.  netkv_score must agree bitwise with the
# f32 NumPy twin on the host, and waterfill keeps its plain versions' order
# of operations: no contraction of a*b+c into one FMA.
SOURCES = {
    "netkv_score": ["--fmad=false"],
    "kv_pack": [],
    "flash_decode": [],
    "waterfill": ["--fmad=false"],
}

LAUNCHES = {"netkv_score_cohort": 0, "kv_pack": 0, "kv_unpack": 0,
            "flash_decode": 0, "waterfill_progressive": 0, "waterfill_fast": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    there is none: an entry point never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + COMMON_FLAGS + SOURCES[name]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns ``{name: {"seconds", "ptxas", "cached"}}``; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            logs[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = {"seconds": secs, "ptxas": log, "cached": False}
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, what: str, *, dtype=None, ndim=None,
            device: torch.device | None = None, align: int = 16) -> None:
    """Wrapper-side argument checks: a CUDA tensor, contiguous, of the
    expected dtype/rank/device, aligned to ``align`` bytes."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what} must be {align}-byte aligned")
