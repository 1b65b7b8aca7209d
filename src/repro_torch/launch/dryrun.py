"""Multi-pod dry run on the meta device (``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k --mesh both
    python -m repro_torch.launch.dryrun --all --mesh both      # every cell, a process each

A cell is an (arch, shape, mesh): the production mesh of 256 or 512 ranks
(``launch/mesh.py``, a fake process group), the arch's full-width model and
the shape's inputs as meta tensors (``ArchSpec.input_specs``), distributed
with the placement plan (``models/sharding.py``: the logical-axis rules, the
parameter and optimizer-state specs, sanitised against the mesh, the batch
over the batch axes, the decode cache by ``_cache_specs_for``).  The cell's
step runs eagerly on DTensors, as rank 0 sees it:
  train    the train step (forward and backward over every microbatch, the
           update) with the spec's master and accumulator dtypes;
  prefill  prefill into a cache distributed as JAX's out shardings;
  decode   the read-only decode (``update_cache=False``) under the rules
           JAX's ``build_cell`` picks, the attention on the sequence-sharded
           partials and their merge.
It writes one JSON a cell, under JAX's file names (in ``artifacts/dryrun_torch``
by default, beside JAX's ``artifacts/dryrun``): ``status`` (ok, skipped
or error), ``n_devices``, ``reason`` for a skipped cell, the per-device
``argument_bytes`` and ``output_bytes`` (local shards' nbytes), ``flops``
(rank 0's local ops, counted with ``torch.utils.flop_counter``'s formulas)
and the collectives (count and operand bytes by kind, from a dispatch mode
over the functional collectives DTensor emits).  The trace runs every
layer, microbatch and chunk, so its counts are loop-aware as they stand.
The model names the ops DTensor has no sharding rule for and places them
itself (``models/sharding.py``): the head views that split a dimension
unevenly (``split_dim``, ``merge_dims``), the RWKV and Mamba scans and
seamless's cross K/V projection (``local_region``), the decode attention
(``local_map`` over the sequence shards); any other op that DTensor
refuses ends the cell in ``error``.
JAX's compiled temp and peak memory and its lower/compile times have no
meta-device counterpart and are not recorded; the port has no twin of
``launch/hlo_analysis.py``, which parses XLA's HLO.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ALL, SHAPES, get_spec
from ..models.model import Model, decode_step, dtype_of, encode, make_decode_cache, prefill
from ..models.sharding import (
    LONG_RULES,
    SERVE_RULES,
    SERVE_RULES_MULTIPOD,
    TRAIN_RULES,
    TRAIN_RULES_MULTIPOD,
    axis_rules,
    param_partition_specs,
    placements,
    recompute_under,
    sanitize_specs,
)
from ..train import make_optimizer, make_train_step, opt_state_specs
from .mesh import batch_axes, batch_shards, make_production_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
# functional collective -> JAX's HLO name for its kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def local_bytes(tree) -> int:
    """Bytes of rank 0's shards of every tensor in ``tree``."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


class StepCounter(TorchDispatchMode):
    """Rank 0's local work under DTensor: DTensor ops are left to DTensor
    (``NotImplemented``), so this mode sees the local ops they lower to,
    the functional collectives among them.  Counts operations with
    ``torch.utils.flop_counter``'s formulas and each collective's count and
    operand bytes by kind."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.counts = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        kind = COLLECTIVES.get(packet.__name__) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(list(args)))
            self.counts[kind] += 1
            self.bytes[kind] += nbytes
            self.largest = max(self.largest, nbytes)
        return out

    def record(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values()), "largest_bytes": self.largest}


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def _distribute(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))


def _set_param(model: nn.Module, name: str, value: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    node = model
    for part in path:
        node = node[part] if isinstance(node, (nn.ModuleDict, nn.ParameterDict)) else \
            getattr(node, part)
    if isinstance(node, nn.ParameterDict):
        node[leaf] = value
    else:
        setattr(node, leaf, value)


def _distributed_model(cfg, dtype, mode: str, multi_pod: bool, mesh, sizes):
    """(the full-width model on the meta device, every parameter in
    ``dtype`` (as JAX's abstract parameters), distributed by the sanitised
    specs of ``mode``; those specs)."""
    model = Model(cfg, device="meta", train_dtype=dtype)
    params = dict(model.named_parameters())
    specs = sanitize_specs(params, param_partition_specs(params, mode, multi_pod), sizes)
    for name, p in params.items():
        _set_param(model, name, nn.Parameter(_distribute(p.detach(), specs[name], mesh),
                                             requires_grad=p.requires_grad))
    return model, specs


def _cache_specs_for(spec, shape_name: str, multi_pod: bool, cache: dict) -> dict:
    """Spec per decode-cache leaf, by leaf name (JAX's ``_cache_specs_for``)."""
    ba = batch_axes(multi_pod)
    bt = ba if len(ba) > 1 else ba[0]
    long = shape_name == "long_500k"
    seq_mode = spec.decode_cache_shard == "seq"

    def leaf_spec(name, leaf):
        nd = len(leaf.shape) if isinstance(leaf, torch.Tensor) else 0
        if name == "pos":
            return ()
        if name.startswith(("k", "v", "ck", "cv")) and nd == 5:
            if long:
                return (None, None, "data", "model", None)
            if seq_mode:
                return (None, bt, "model", None, None)
            return (None, bt, None, "model", None)
        if name.startswith("ssm"):
            return (None, None if long else bt, "model", None)
        if name.startswith("conv"):
            return (None, None if long else bt, None, "model")
        if name.startswith("wkv"):
            return (None, None if long else bt, "model", None, None)
        if name.startswith(("sa", "sc")):
            return (None, None if long else bt, "model")
        return (None,) * nd

    return {name: leaf_spec(name, leaf) for name, leaf in cache.items()}


def _rows(t: torch.Tensor, bt) -> tuple:
    return (bt,) + (None,) * (t.dim() - 1)


def build_cell(arch: str, shape_name: str, multi_pod: bool):
    """(mesh, rules, step, args): ``step(*args)`` runs the cell's step on
    the distributed inputs and returns its outputs."""
    spec = get_spec(arch)
    cfg = spec.model
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    kind = SHAPES[shape_name]["kind"]
    ba = batch_axes(multi_pod)
    bt = ba if len(ba) > 1 else ba[0]
    ins = spec.input_specs(shape_name)

    if kind == "train":
        rules = dict(TRAIN_RULES_MULTIPOD if multi_pod else TRAIN_RULES)
        model, pspecs = _distributed_model(cfg, dtype_of(spec.train_param_dtype), "train",
                                           multi_pod, mesh, sizes)
        params = dict(model.named_parameters())
        opt = make_optimizer(spec.optimizer)
        state = opt.init({n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                          for n, p in params.items()})
        sspecs = sanitize_specs(state, opt_state_specs(opt, params, state, pspecs), sizes)
        state = _map2(lambda t, s: _distribute(t, s, mesh), state, sspecs)
        batch = {k: _distribute(t, _rows(t, bt), mesh) for k, t in ins["batch"].items()}
        step = make_train_step(opt, microbatches=spec.train_microbatches,
                               batch_shards=batch_shards(multi_pod),
                               accum_dtype=dtype_of(spec.grad_accum_dtype))

        def train(model, state, batch):
            model, state, metrics = step(model, state, batch)
            return dict(model.named_parameters()), state

        return mesh, rules, train, (model, state, batch)

    if shape_name == "long_500k":
        rules = dict(LONG_RULES)
    else:
        rules = dict(SERVE_RULES_MULTIPOD if multi_pod else SERVE_RULES)
    if spec.serve_fsdp:
        rules["fsdp"] = ("pod", "data") if multi_pod else ("data",)
        rules["experts"] = rules["fsdp"]
    mode = "train" if spec.serve_fsdp else "serve"
    model, _ = _distributed_model(cfg, torch.bfloat16, mode, multi_pod, mesh, sizes)

    if kind == "prefill":
        sh = SHAPES[shape_name]
        cache = make_decode_cache(cfg, sh["global_batch"], sh["seq_len"], "meta",
                                  enc_len=sh["seq_len"] if cfg.is_enc_dec else 0)
        leaves = {k: v for k, v in cache.items() if k != "pos"}
        cspecs = sanitize_specs(leaves, _cache_specs_for(spec, shape_name, multi_pod, leaves),
                                sizes)
        if cfg.is_enc_dec:
            cspecs["cross_memory"] = (bt, None, None)
        inputs = {k: _distribute(t, _rows(t, bt), mesh) for k, t in ins.items()}
        fill = {k: _distribute(t, cspecs[k], mesh) for k, t in leaves.items()
                if not k.startswith(("ck", "cv"))}

        def run_prefill(model, inputs):   # the cache to fill is an output, as in JAX
            memory = encode(model, inputs["frames"]) if cfg.is_enc_dec else None
            logits, out = prefill(model, inputs["tokens"],
                                  prefix_embeds=inputs.get("prefix_embeds"), memory=memory,
                                  cache_len=sh["seq_len"], cache=fill)
            out = {k: _redistribute(v, cspecs[k], mesh) if k in cspecs else v
                   for k, v in out.items()}
            return logits, out

        return mesh, rules, run_prefill, (model, inputs)

    # decode: the READ-ONLY cache (paged semantics); the new token's K/V
    # returns as a fragment, the cache is never written.
    leaves = {k: v for k, v in ins["cache"].items() if k != "pos"}
    cspecs = sanitize_specs(leaves, _cache_specs_for(spec, shape_name, multi_pod, leaves), sizes)
    cache = {k: _distribute(t, cspecs[k], mesh) for k, t in leaves.items()}
    cache["pos"] = SHAPES[shape_name]["seq_len"] - 1
    tok_spec = (None, None) if shape_name == "long_500k" else (bt, None)
    token = _distribute(ins["token"], tok_spec, mesh)

    def run_decode(model, token, cache):
        return decode_step(model, token, cache, update_cache=False)

    return mesh, rules, run_decode, (model, token, cache)


def _redistribute(t, spec, mesh):
    return t.redistribute(mesh, placements(spec, mesh)) if hasattr(t, "redistribute") else t


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def _write(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    spec = get_spec(arch)
    mesh_name = "multipod" if multi_pod else "pod"
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "n_devices": 512 if multi_pod else 256}
    if shape_name not in spec.runnable_shapes():
        rec["status"] = "skipped"
        rec["reason"] = spec.skip_notes.get(shape_name, "not applicable")
        _write(rec, out_dir)
        return rec
    try:
        mesh, rules, fn, args = build_cell(arch, shape_name, multi_pod)
        rec["argument_bytes"] = local_bytes([dict(a.named_parameters()) if isinstance(
            a, nn.Module) else a for a in args])
        counter = StepCounter()
        with axis_rules(rules, mesh=mesh), recompute_under(implicit_replication), \
                implicit_replication(), counter:
            outputs = fn(*args)
        rec["status"] = "ok"
        rec["output_bytes"] = local_bytes(outputs)
        rec["flops"] = counter.flops
        rec["collectives"] = counter.record()
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-pod dry run on the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true", help="every (arch x shape) via subprocesses")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs = ALL if args.arch is None else [args.arch]
        shapes = list(SHAPES) if args.shape is None else [args.shape]
        failures = 0
        for arch in archs:
            for shape in shapes:
                for mesh in meshes:
                    path = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            prev = json.load(f)
                        if prev.get("status") in ("ok", "skipped"):
                            print(f"[skip] {arch} {shape} {mesh}: cached {prev['status']}")
                            continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--out", args.out]
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       env={**os.environ})
                    tail = (r.stdout + r.stderr).strip().splitlines()
                    print(f"[{arch} {shape} {mesh}] rc={r.returncode} "
                          + (tail[-1] if tail else ""), flush=True)
                    if r.returncode != 0:
                        failures += 1
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    ok = True
    for mesh in meshes:
        rec = run_cell(args.arch, args.shape, mesh == "multipod", args.out)
        status = rec["status"]
        if status == "ok":
            coll = rec["collectives"]
            print(f"{args.arch} {args.shape} {mesh}: OK {rec['wall_s']}s "
                  f"args/dev={rec['argument_bytes'] / 1e9:.2f}GB "
                  f"out/dev={rec['output_bytes'] / 1e9:.2f}GB flops={rec['flops']:.3g} "
                  f"coll={coll['total_bytes'] / 1e9:.3f}GB in "
                  f"{sum(coll['counts'].values())} (largest {coll['largest_bytes'] / 1e6:.2f} MB)")
        elif status == "skipped":
            print(f"{args.arch} {args.shape} {mesh}: SKIPPED ({rec['reason']})")
        else:
            print(f"{args.arch} {args.shape} {mesh}: ERROR {rec['error']}")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
