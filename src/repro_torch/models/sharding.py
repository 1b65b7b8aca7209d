"""Logical-axis sharding: rules resolved against the active mesh
(``repro/models/sharding.py``).

Model code names the logical axes of an activation ("batch", "seq",
"model_dim", "heads", "ff", "vocab", "experts"); the launcher installs a rule
set mapping logical axes onto mesh axes.  Outside a rules context every
:func:`constrain` is a no-op, so the model runs unsharded on one device.

A spec is plain Python: a tuple with one entry per tensor dimension, each
None (replicated), a mesh-axis name, or a tuple of names (sharded over their
product, the first major), JAX's ``PartitionSpec`` entries.
:func:`placements` maps one onto a ``DeviceMesh`` as DTensor ``Shard`` /
``Replicate`` placements.

Parameter specs are derived from leaf paths (the port's dotted parameter
names are JAX's paths):
  train mode -> FSDP + TP (weights sharded over data AND model axes)
  serve mode -> TP only (weights replicated over data, batch sharded)
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Mapping, Sequence

import torch

_RULES: contextvars.ContextVar = contextvars.ContextVar("logical_axis_rules", default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar("axis_rules_mesh", default=None)


@contextlib.contextmanager
def axis_rules(rules: Mapping[str, tuple[str, ...] | str | None], mesh=None):
    norm = {}
    for k, v in rules.items():
        if v is None:
            norm[k] = ()
        elif isinstance(v, str):
            norm[k] = (v,)
        else:
            norm[k] = tuple(v)
    token = _RULES.set(norm)
    mtoken = _MESH.set(mesh)
    try:
        yield
    finally:
        _RULES.reset(token)
        _MESH.reset(mtoken)


_RECOMPUTE: contextvars.ContextVar = contextvars.ContextVar("recompute_contexts", default=())


@contextlib.contextmanager
def recompute_under(*factories):
    """Within the block, remat's recomputation of a period (which runs inside
    ``torch.autograd.grad``, where function modes are off) enters a context
    from each factory again: the dry run's sharding fallback."""
    token = _RECOMPUTE.set(tuple(factories))
    try:
        yield
    finally:
        _RECOMPUTE.reset(token)


@contextlib.contextmanager
def recompute_contexts():
    with contextlib.ExitStack() as stack:
        for make in _RECOMPUTE.get():
            stack.enter_context(make())
        yield


def current_rules():
    return _RULES.get()


def current_mesh():
    return _MESH.get()


def _entry(mesh_axes: tuple[str, ...]):
    """A spec entry for these mesh axes: None, a name, or a tuple."""
    return mesh_axes if len(mesh_axes) > 1 else (mesh_axes[0] if mesh_axes else None)


def logical_to_spec(axes: Sequence[str | None]) -> tuple | None:
    rules = _RULES.get()
    if rules is None:
        return None
    return tuple(None if a is None else _entry(rules.get(a, ())) for a in axes)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on each mesh
    dimension named in entry d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            owner[a] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in mesh.mesh_dim_names)


def constrain(x, *axes: str | None):
    """JAX's ``with_sharding_constraint`` by logical axes: under a rules
    context with a mesh, a DTensor is redistributed (a plain tensor
    distributed) to the axes' placements, each dim sharded only where its
    axes divide it (where GSPMD would pad); a no-op otherwise."""
    spec = logical_to_spec(axes)
    mesh = _MESH.get()
    if spec is None or mesh is None:
        return x
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    want = placements(sanitize_specs(x, spec, sizes), mesh)
    if hasattr(x, "redistribute"):
        return x if tuple(x.placements) == want else x.redistribute(mesh, want)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, want)


def fsdp_gather():
    """Under a mesh whose rules shard weights over ``fsdp`` axes, a function
    that gathers a weight over those axes before its use (what FSDP does,
    and what GSPMD does with JAX's FSDP specs; the backward pass
    reduce-scatters the gradient); None otherwise."""
    rules, mesh = _RULES.get(), _MESH.get()
    if rules is None or mesh is None:
        return None
    axes = set(rules.get("fsdp", ())) | set(rules.get("fsdp_moe", ()))
    if not axes:
        return None
    from torch.distributed.tensor import Replicate

    def gather(t):
        if not hasattr(t, "placements"):
            return t
        want = tuple(Replicate() if n in axes else p
                     for n, p in zip(mesh.mesh_dim_names, t.placements))
        return t if want == tuple(t.placements) else t.redistribute(mesh, want)

    return gather


def local_region(fn, in_axes, out_axes, shapes=None):
    """``fn`` on each rank's local shards, as JAX wraps an op in
    ``shard_map``: under a rules context with a mesh, a ``local_map`` whose
    tensor inputs are redistributed to their logical axes' placements (a
    dim sharded only where its axes divide it; ``None`` for an input that
    is not a tensor) and whose outputs take the placements of
    ``out_axes``; ``fn`` itself otherwise.  For the sequential loops that
    DTensor has no rules for (the RWKV and Mamba scans).  ``shapes`` stands
    in for ``fn`` on local shards on the meta device (the dry run's, which
    hold shapes and no values): outputs of ``fn``'s shapes and dtypes."""
    rules, mesh = _RULES.get(), _MESH.get()
    if rules is None or mesh is None:
        return fn

    def local(*args):
        meta = shapes is not None and any(getattr(a, "device", None) == torch.device("meta")
                                          for a in args)
        return (shapes if meta else fn)(*args)

    def wrapped(*args):
        from torch.distributed.tensor.experimental import local_map

        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        ins = tuple(None if ax is None or not hasattr(a, "shape") else
                    list(placements(sanitize_specs(a, logical_to_spec(ax), sizes), mesh))
                    for a, ax in zip(args, in_axes))
        outs = tuple(list(placements(logical_to_spec(ax), mesh)) for ax in out_axes)
        return local_map(local, out_placements=outs if len(outs) > 1 else outs[0],
                         in_placements=ins, device_mesh=mesh, redistribute_inputs=True)(*args)

    return wrapped


def split_dim(x, dim: int, sizes: tuple[int, ...]):
    """``x`` with dimension ``dim`` viewed as ``sizes``: the heads out of
    H * dh, or the KV groups out of H.  Under a mesh, a DTensor sharded on
    ``dim`` over mesh axes whose product does not divide ``sizes[0]`` (8 KV
    heads, or 9, 10, 40 heads, over a 16-way axis), which DTensor refuses to
    view, has that dimension gathered first, where GSPMD would pad it.  The
    gradient is held to the view's placements (:func:`_hold`)."""
    dim %= x.dim()
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    mesh = _MESH.get()
    if mesh is None or not hasattr(x, "placements"):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate

    over = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    ways = 1
    for i in over:
        ways *= mesh.mesh.shape[i]
    if sizes[0] % ways:
        x = x.redistribute(mesh, tuple(Replicate() if i in over else p
                                       for i, p in enumerate(x.placements)))
    return _hold(x.reshape(shape))


def merge_dims(x, start: int, end: int = -1):
    """``x`` with dimensions ``start`` to ``end`` flattened into one (the
    heads back into H * dh, the KV groups into H, the experts' capacity
    rows into one); under a mesh the gradient is held to the merged
    placements (:func:`_hold`)."""
    out = x.flatten(start, end)
    return _hold(out) if _MESH.get() is not None and hasattr(out, "placements") else out


def _hold(t):
    """``t``, whose gradient is redistributed to ``t``'s own placements in
    the backward pass (a redistribution to themselves): the gradient that
    meets a view's backward (the inverse view) is then placed as the
    forward was, where the product's backward would leave it sharded on a
    dimension the inverse view cannot split (heads) or replicated where
    the forward was sharded (the experts' rows, which would then run each
    expert's backward on every rank)."""
    return t.redistribute(t.device_mesh, t.placements) if t.requires_grad else t


# ---------------------------------------------------------------------------
# Parameter partition specs by leaf path.
# Patterns map path-regex -> logical axes per dim (excluding the leading
# period-stack dim, which is always unsharded).
# ---------------------------------------------------------------------------
_PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed$", ("vocab", "fsdp")),
    (r"lm_head$", ("fsdp", "vocab")),
    (r"pos_embed$", (None, "fsdp")),
    # attention
    (r"(wq|wk|wv)$", ("fsdp", "heads")),
    (r"wo$", ("heads", "fsdp")),
    # dense mlp
    (r"(w_gate|w_up|gate|up)$", ("fsdp", "ff")),
    (r"(w_down|down)$", ("ff", "fsdp")),
    # moe (leading expert dim)
    (r"router$", ("fsdp", None)),
    (r"moe/(w_gate|w_up)$", ("experts", "fsdp_moe", "ff")),
    (r"moe/w_down$", ("experts", "ff", "fsdp_moe")),
    (r"res_(gate|up)$", ("fsdp", "ff")),
    (r"res_down$", ("ff", "fsdp")),
    # mamba
    (r"in_proj$", ("fsdp", "ff")),
    (r"out_proj$", ("ff", "fsdp")),
    (r"x_proj$", ("ff", None)),
    (r"dt_proj$", (None, "ff")),
    (r"(a_log|d_skip|dt_bias)$", ("ff",)),
    (r"conv_w$", (None, "ff")),
    # rwkv
    (r"(w_r|w_k|w_v|w_g)$", ("fsdp", "heads")),
    (r"w_o$", ("heads", "fsdp")),
    (r"cm_k$", ("fsdp", "ff")),
    (r"cm_v$", ("ff", "fsdp")),
    (r"cm_r$", ("fsdp", "heads")),
    (r"(mu_lora_a|decay_lora_a)$", ("fsdp", None)),
    (r"(mu_lora_b|decay_lora_b)$", (None, "fsdp")),
]

TRAIN_RULES = {
    "batch": ("data",), "seq": (), "model_dim": (),
    "heads": ("model",), "ff": ("model",), "vocab": ("model",),
    "experts": ("data",), "fsdp": ("data",), "fsdp_moe": (),
    "kv_seq": (),
}
TRAIN_RULES_MULTIPOD = {
    # FSDP over BOTH pod and data axes: a 480B model's optimizer state only
    # fits when sharded across all 512 chips.
    **TRAIN_RULES, "batch": ("pod", "data"), "fsdp": ("pod", "data"),
    "experts": ("pod", "data"),
}
SERVE_RULES = {
    "batch": ("data",), "seq": (), "model_dim": (),
    "heads": ("model",), "ff": ("model",), "vocab": ("model",),
    "experts": ("data",), "fsdp": (), "fsdp_moe": (),
    "kv_seq": ("model",),   # prefill-produced KV caches shard S over model
}
SERVE_RULES_MULTIPOD = {**SERVE_RULES, "batch": ("pod", "data")}
# Long-context (batch=1): shard the KV/sequence dim over data instead.
LONG_RULES = {**SERVE_RULES, "batch": (), "kv_seq": ("data",), "seq": ()}
LONG_RULES_MULTIPOD = {**LONG_RULES}


def _spec_for_path(path: str, ndim: int, rules: Mapping[str, tuple[str, ...]],
                   stacked: bool) -> tuple:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            dims: list = [None] if stacked else []
            dims += [None if a is None else _entry(rules.get(a, ())) for a in axes]
            dims += [None] * (ndim - len(dims))
            return tuple(dims[:ndim])
    return (None,) * ndim


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def sanitize_specs(shapes, specs, mesh_axis_sizes: Mapping[str, int]):
    """Drop sharding on dims not divisible by their assigned mesh axes.

    ``shapes`` and ``specs`` are trees of the same dicts: leaves are tensors
    (or shapes) and specs.  A dim whose size the product of its axes does not
    divide falls back to suffixes of its axis tuple (16 experts over
    ("pod", "data") = 32 -> "data" = 16), then to replication (kv=8 heads
    over a 16-way model axis, vocab 49155, 40 RWKV heads)."""
    if isinstance(shapes, dict):
        return {k: sanitize_specs(shapes[k], specs[k], mesh_axis_sizes) for k in shapes}
    out = []
    dims = list(specs) + [None] * (len(_shape(shapes)) - len(specs))
    for size, d in zip(_shape(shapes), dims):
        axes = [] if d is None else [d] if isinstance(d, str) else list(d)
        chosen = None
        while axes:
            total = 1
            for a in axes:
                total *= mesh_axis_sizes[a]
            if size % total == 0:
                chosen = _entry(tuple(axes))
                break
            axes = axes[1:]
        out.append(chosen)
    return tuple(out)


def param_partition_specs(params, mode: str = "train", multi_pod: bool = False) -> dict:
    """Spec of every parameter by its dotted name (``params``: name ->
    tensor or shape, e.g. ``dict(model.named_parameters())``)."""
    if mode == "train":
        rules = TRAIN_RULES_MULTIPOD if multi_pod else TRAIN_RULES
    else:
        rules = SERVE_RULES_MULTIPOD if multi_pod else SERVE_RULES
    return {name: _spec_for_path(name.replace(".", "/"), len(_shape(leaf)), rules,
                                 name.startswith(("layers.", "enc_layers.", "cross_layers.")))
            for name, leaf in params.items()}
