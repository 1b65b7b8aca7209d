"""Checkpoint/restart in the JAX package's files (``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N>/arrays.npz`` and ``meta.json``, written to a
temporary directory and renamed into place, so that a preemption during a
write never leaves a partial checkpoint; the 3 newest are kept.  The npz
keys are JAX's ``keystr`` paths (``['p']['layers']['b0']['wq']``,
``['o']['m']['embed']``, ``['o']['step']``), so either package restores
what the other wrote.

A tree is a nested dict whose leaves are tensors, NumPy arrays or
numbers; a key with dots (a parameter's name in the port, ``layers.b0.wq``)
stands for the nested path, and a :class:`~repro_torch.models.Model` for the
dict of its parameters by name.  Dict keys are taken in sorted order, as
JAX flattens a dict.  A bf16 leaf is stored as JAX stores it: NumPy has no
bf16, and JAX's ``ml_dtypes`` array is written with the 2-byte void
descriptor ``'<V2'`` and the raw bf16 bits.  The port writes that header and
those bytes itself and reads them back bit for bit, without ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any

import numpy as np
import torch
from numpy.lib import format as npy_format

from ..models.convert import nested
from ..models.model import Model

BF16_DESCR = "<V2"   # how an ml_dtypes bfloat16 array's header names its dtype


def _walk(node, path: str = ""):
    """(keystr, leaf) pairs in JAX's flattening order."""
    kids = nested(node)
    if kids is None:
        yield path, node
        return
    for key, value in kids.items():
        yield from _walk(value, f"{path}[{key!r}]")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _write_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive, with bf16 (2-byte void) members headed as
    JAX's are."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype == np.dtype("V2"):
                    header = npy_format.header_data_from_array_1_0(arr)
                    header["descr"] = BF16_DESCR
                    npy_format.write_array_header_1_0(f, header)
                    f.write(arr.tobytes())
                else:
                    npy_format.write_array(f, arr, allow_pickle=False)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays = {k: _to_numpy(leaf) for k, leaf in _walk(tree)}
        _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
        meta = {"step": step, "n_arrays": len(arrays), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # Retention: keep the 3 newest.
    for s in list_checkpoints(ckpt_dir)[:-3]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    return final


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, name, "meta.json")
        ):
            out.append(int(name[5:]))
    return sorted(out)


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """``arr`` in ``like``'s dtype and on its device; a 2-byte void array
    holds bf16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.copy(order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy(order="C"))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


@torch.no_grad()
def _restore(node, data, path: str = ""):
    kids = nested(node)
    if kids is None:
        return _to_tensor(data[path], node)
    if isinstance(node, Model):
        params = dict(node.named_parameters())
        for name, t in params.items():
            key = path + "".join(f"[{p!r}]" for p in name.split("."))
            t.copy_(_to_tensor(data[key], t))
        return node
    out = {}
    for key, value in node.items():
        sub = path + "".join(f"[{p!r}]" for p in str(key).split("."))
        out[key] = _restore(value, data, sub)
    return out


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``like``: its dicts
    come back as dicts with the same keys, its tensors as new tensors, and
    a :class:`Model` is overwritten in place and returned."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        return _restore(like, data)


def restore_latest(ckpt_dir: str, like: Any) -> tuple[int, Any] | None:
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None
    step = steps[-1]
    return step, restore_checkpoint(ckpt_dir, step, like)
