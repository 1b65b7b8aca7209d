"""The specs the dry run reads, against the JAX package: the benchmark
shapes and ``ArchSpec``'s dry-run fields, ``input_specs`` (meta tensors
against JAX's ShapeDtypeStructs), and the placement plan: the sanitised
parameter and optimizer-state specs leaf by leaf against JAX's
``PartitionSpec``s, for every arch, train and serve mode, on a pod and on a
multipod, and the decode cache's.  JAX's side needs no devices: it works on
``abstract_params`` and ``jax.eval_shape``.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ALL as JAX_ALL
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_spec as jax_spec
from repro.models import abstract_params
from repro.models import sharding as jshard
from repro.train import make_optimizer as jax_make_optimizer
from repro.train import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import ALL, ASSIGNED, SHAPES, get_spec
from repro_torch.models import Model
from repro_torch.models import sharding as tshard
from repro_torch.models.model import dtype_of
from repro_torch.train import make_optimizer, opt_state_specs

POD = {"data": 16, "model": 16}
MULTIPOD = {"pod": 2, "data": 16, "model": 16}
SPEC_FIELDS = ("train_microbatches", "optimizer", "train_param_dtype", "grad_accum_dtype",
               "serve_fsdp", "decode_cache_shard", "shapes", "skip_notes", "source")


def test_registry_and_shapes_are_jax_s():
    assert SHAPES == JAX_SHAPES
    assert sorted(ALL) == sorted(JAX_ALL) and sorted(ASSIGNED) == sorted(JAX_ASSIGNED)
    for arch in ALL:
        mine, theirs = get_spec(arch), jax_spec(arch)
        for field in SPEC_FIELDS:
            assert getattr(mine, field) == getattr(theirs, field), (arch, field)
        assert mine.runnable_shapes() == theirs.runnable_shapes()


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


_TORCH_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32,
                torch.float32: jnp.float32}


@pytest.mark.parametrize("arch", JAX_ALL)
def test_input_specs_match_jax(arch):
    """Every input of every shape: the same leaves, shapes and dtypes, as
    meta tensors; a shape the arch skips raises ValueError in both, an
    unknown one KeyError."""
    mine, theirs = get_spec(arch), jax_spec(arch)
    for shape in SHAPES:
        if shape not in theirs.shapes:
            with pytest.raises(ValueError, match="skips"):
                mine.input_specs(shape)
            with pytest.raises(ValueError, match="skips"):
                theirs.input_specs(shape)
            continue
        got, want = _flat(mine.input_specs(shape)), _flat(theirs.input_specs(shape))
        assert set(got) == set(want), (shape, sorted(set(got) ^ set(want)))
        for name, leaf in got.items():
            assert leaf.device.type == "meta", name
            assert tuple(leaf.shape) == tuple(want[name].shape), (shape, name)
            assert _TORCH_DTYPE[leaf.dtype] == want[name].dtype, (shape, name)
    with pytest.raises(KeyError):
        mine.input_specs("train_8k")


def _jax_specs(tree):
    """{dotted path: spec as a tuple} from a JAX PartitionSpec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _torch_specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", JAX_ALL)
def test_sanitised_specs_match_jax(arch, multi_pod):
    """Parameter specs in train and serve mode, and the optimizer state's
    (AdamW's m/v, Adafactor's vr/vc/v and the step), sanitised against the
    mesh, leaf by leaf equal to JAX's."""
    mine, theirs = get_spec(arch), jax_spec(arch)
    sizes = MULTIPOD if multi_pod else POD
    dtype = dtype_of(mine.train_param_dtype)
    model = Model(mine.model, device="meta", train_dtype=dtype)
    params = dict(model.named_parameters())
    aparams = abstract_params(theirs.model, dtype=jnp.dtype(theirs.train_param_dtype))
    for mode in ("train", "serve"):
        got = tshard.sanitize_specs(params, tshard.param_partition_specs(params, mode, multi_pod),
                                    sizes)
        want = jshard.sanitize_specs(
            aparams, jshard.param_partition_specs(aparams, mode, multi_pod), sizes)
        assert _torch_specs(got) == _jax_specs(want), mode
    pspecs = tshard.sanitize_specs(params, tshard.param_partition_specs(params, "train",
                                                                        multi_pod), sizes)
    jspecs = jshard.sanitize_specs(aparams, jshard.param_partition_specs(aparams, "train",
                                                                         multi_pod), sizes)
    opt, jopt = make_optimizer(mine.optimizer), jax_make_optimizer(theirs.optimizer)
    state = opt.init({n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                      for n, p in params.items()})
    astate = jax.eval_shape(jopt.init, aparams)
    got = _torch_specs(tshard.sanitize_specs(state, opt_state_specs(opt, params, state, pspecs),
                                             sizes))
    want = _jax_specs(jshard.sanitize_specs(
        astate, jax_opt_state_specs(jopt, aparams, astate, jspecs), sizes))
    if mine.optimizer == "adamw":
        assert got == want
    else:
        # JAX's opt_state_specs looks each factored leaf's parameter up by a
        # path one key short (path[1:-1] of a path under "acc"), so every
        # Adafactor leaf comes out replicated (ROADMAP §3 item 10).  The port
        # applies the rule it documents to JAX's parameter specs: vr drops
        # the last dim, vc the one before it, v keeps them.
        assert all(all(d is None for d in v) for k, v in want.items() if k != "step")
        jp = _jax_specs(jspecs)
        rule = {}
        for name, acc in state["acc"].items():
            dims = list(jp[name])
            for kind in acc:
                sel = dims[:-1] if kind == "vr" else dims[:-2] + dims[-1:] if kind == "vc" \
                    else dims
                rule[f"acc.{name}.{kind}"] = tuple(sel)
        rule = _torch_specs(tshard.sanitize_specs(
            _flat(state["acc"], "acc."), rule, sizes))
        assert got == {**rule, "step": ()}
    shapes = {k: tuple(v.shape) for k, v in _flat(state).items()}
    jshapes = {".".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
               for p, v in jax.tree_util.tree_flatten_with_path(astate)[0]}
    assert shapes == jshapes


@pytest.mark.parametrize("arch", ["qwen3-14b", "jamba-v0.1-52b", "rwkv6-3b",
                                  "seamless-m4t-medium", "llama3-70b"])
def test_cache_specs_match_jax(arch):
    """The decode cache's specs (JAX's ``_cache_specs_for``) on both meshes
    for every decode shape the arch runs, sanitised."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry   # sets XLA_FLAGS at import: restored at once
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    from repro_torch.launch import dryrun as tdry

    mine, theirs = get_spec(arch), jax_spec(arch)
    for shape in ("decode_32k", "long_500k"):
        if shape not in mine.shapes:
            continue
        for multi_pod, sizes in ((False, POD), (True, MULTIPOD)):
            cache = {k: v for k, v in mine.input_specs(shape)["cache"].items() if k != "pos"}
            acache = dict(theirs.input_specs(shape)["cache"])
            want = jshard.sanitize_specs(acache, jdry._cache_specs(theirs, shape, multi_pod),
                                         sizes)
            got = tshard.sanitize_specs(
                cache, tdry._cache_specs_for(mine, shape, multi_pod, cache), sizes)
            want = _jax_specs(want)
            assert want.pop("pos") == ()
            assert _torch_specs(got) == want, (shape, multi_pod)


def test_constrain_and_placements():
    """``constrain`` is a no-op outside a rules context (and without a
    mesh); logical axes resolve as JAX's ``logical_to_spec``; a spec maps to
    one placement a mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    x = torch.zeros(4, 6)
    assert tshard.constrain(x, "batch", None) is x
    with tshard.axis_rules(tshard.TRAIN_RULES_MULTIPOD):
        assert tshard.current_mesh() is None
        assert tshard.constrain(x, "batch", None) is x
        assert tshard.logical_to_spec(("batch", "heads", None)) == (("pod", "data"), "model",
                                                                     None)
        with jshard.axis_rules(jshard.TRAIN_RULES_MULTIPOD):
            assert tshard.logical_to_spec(("batch", "heads", None)) == tuple(
                jshard.logical_to_spec(("batch", "heads", None)))
    assert tshard.current_rules() is None

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert tshard.placements((("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert tshard.placements((None, "data"), Mesh()) == (Replicate(), Shard(1), Replicate())
