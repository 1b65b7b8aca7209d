"""The layer stack of a configuration: the one module that knows how a model
of its architecture is built, drawn, referenced, counted and transferred.

A configuration file names its stack by ``"layer_stack"`` (``decoder`` where
the key is absent); the module is ``netkv_bench/stacks/<name>.py``, loaded by
its path as the metric readers are, so a configuration with another stack is
added as files, with no list of stacks in code.  Each hook takes the
configuration file's dict:

* ``model_fields(cfg) -> dict``: the keyword arguments of the program's
  ``ModelConfig`` (``block_pattern`` and ``ffn_pattern`` among them), the
  MoE's as a nested ``"moe"`` dict of ``MoEConfig``'s and
  ``compute_dtype`` by its name; ``nkb.program`` builds the config from them;
* ``weight_specs(cfg) -> list[(name, shape, dtype, mean, std)]``: every
  tensor ``nkb.weights.draw`` draws, in draw order, named as the program's
  parameter tree;
* ``reference``: the module under ``netkv_bench/reference/`` whose
  ``served_logits(weights, cfg, seqs, *, fp8, margins)`` ``nkb.correct``
  calls, in plain float32 torch, importing nothing of the program;
* ``decode_step_work(cfg, positions) -> (bytes, flops)``: one decode step's
  useful work for the active requests at ``positions``
  (``decode_mfu_pct.batch`` divides by it);
* ``transfer_layout(cfg, pos, pages_per_layer) -> (tables, whole)``: for a
  request of ``pos`` prompt tokens, the page table expected of each paged
  K/V leaf (name -> tuple) and the bytes of each leaf shipped whole (name ->
  bytes).
"""

from __future__ import annotations

import importlib.util

from . import spec

DEFAULT = "decoder"
HOOKS = ("model_fields", "weight_specs", "reference", "decode_step_work", "transfer_layout")


def name_of(cfg: dict) -> str:
    return cfg.get("layer_stack", DEFAULT)


def load(name: str):
    """The stack module ``stacks/<name>.py``."""
    path = spec.BENCH / "stacks" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no layer stack named {name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(f"nkb_stack_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    missing = [h for h in HOOKS if not hasattr(mod, h)]
    if missing:
        raise AttributeError(f"layer stack {name!r} ({path}) lacks {missing}")
    return mod


def of(cfg: dict):
    """The stack the configuration file names."""
    return load(name_of(cfg))
