"""The port's multi-pod dry run (``repro_torch.launch.dryrun``), mirroring
``tests/test_dryrun_integration.py``: one real cell per step kind, each in a
subprocess (the dry run initialises a fake process group of 512 ranks; the
test process stays without one).

The per-device argument bytes are held to what JAX's sanitised specs give
(``jax.eval_shape`` of its abstract parameters and optimizer state, no
devices), and the read-only decode's collectives to the point of that path:
none moves as many bytes as one layer's local KV shard.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_spec as jax_spec
from repro.models import abstract_params
from repro.models import sharding as jshard
from repro.train import make_optimizer, opt_state_specs

REPO = os.path.join(os.path.dirname(__file__), "..")
SIZES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


def _run_cell(arch, shape, mesh, tmpdir):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmpdir)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=540,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    with open(os.path.join(str(tmpdir), f"{arch}__{shape}__{mesh}.json")) as f:
        return json.load(f)


def _per_device(tree, specs, sizes) -> int:
    """Bytes a device holds of ``tree`` under the PartitionSpec tree."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for size, d in zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape)):
            axes = () if d is None else (d,) if isinstance(d, str) else d
            n *= size // math.prod(sizes[a] for a in axes)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _jax_argument_bytes(arch, shape, mesh) -> int:
    """JAX's ``build_cell`` arguments per device, from its sanitised specs
    (the decode cache's ``pos`` scalar left out: the port's is a host int)."""
    spec = jax_spec(arch)
    sizes = SIZES[mesh]
    multi = mesh == "multipod"
    bt = ("pod", "data") if multi else "data"
    ins = spec.input_specs(shape)
    if shape == "train_4k":
        ap = abstract_params(spec.model, dtype=jnp.dtype(spec.train_param_dtype))
        ps = jshard.sanitize_specs(ap, jshard.param_partition_specs(ap, "train", multi), sizes)
        opt = make_optimizer(spec.optimizer)
        st = jax.eval_shape(opt.init, ap)
        ss = jshard.sanitize_specs(st, opt_state_specs(opt, ap, st, ps), sizes)
        bs = jax.tree.map(lambda l: jax.sharding.PartitionSpec(bt, *([None] * (l.ndim - 1))),
                          ins["batch"])
        return _per_device(ap, ps, sizes) + _per_device(st, ss, sizes) + \
            _per_device(ins["batch"], bs, sizes)
    ap = abstract_params(spec.model, dtype=jnp.bfloat16)
    mode = "train" if spec.serve_fsdp else "serve"
    ps = jshard.sanitize_specs(ap, jshard.param_partition_specs(ap, mode, multi), sizes)
    total = _per_device(ap, ps, sizes)
    if shape == "prefill_32k":
        toks = ins["tokens"]
        return total + _per_device(toks, jax.sharding.PartitionSpec(bt, None), sizes)
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry   # sets XLA_FLAGS at import: restored at once
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    cache = dict(ins["cache"])
    cs = jshard.sanitize_specs(cache, jdry._cache_specs(spec, shape, multi), sizes)
    cache.pop("pos")
    cs.pop("pos")
    tok = jax.sharding.PartitionSpec(None, None) if shape == "long_500k" else \
        jax.sharding.PartitionSpec(bt, None)
    return total + _per_device(ins["token"], tok, sizes) + _per_device(cache, cs, sizes)


@pytest.mark.parametrize("shape,mesh", [
    ("train_4k", "pod"),        # train step, 256 ranks
    ("prefill_32k", "pod"),     # prefill, 256 ranks
    ("decode_32k", "multipod"),  # the read-only decode, 512 ranks (the pod axis)
])
def test_smollm_cells_run(shape, mesh, tmp_path):
    rec = _run_cell("smollm-135m", shape, mesh, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == (512 if mesh == "multipod" else 256)
    assert rec["argument_bytes"] == _jax_argument_bytes("smollm-135m", shape, mesh)
    assert rec["output_bytes"] > 0 and rec["flops"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert sum(coll["counts"].values()) > 0
    if shape == "decode_32k":
        cfg = jax_spec("smollm-135m").model
        # one layer's K (or V) shard on a device: batch over pod x data,
        # the sequence over model
        kv_shard = (128 // 32) * (32768 // 16) * cfg.n_kv_heads * cfg.d_head * 2
        assert coll["largest_bytes"] < kv_shard, (coll["largest_bytes"], kv_shard)


def test_skip_cell_recorded(tmp_path):
    rec = _run_cell("smollm-135m", "long_500k", "pod", tmp_path)
    assert rec["status"] == "skipped"
    assert "full attention" in rec["reason"]


def test_long_500k_runs_for_ssm(tmp_path):
    rec = _run_cell("rwkv6-3b", "long_500k", "pod", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["argument_bytes"] == _jax_argument_bytes("rwkv6-3b", "long_500k", "pod")
    assert rec["argument_bytes"] + rec["output_bytes"] < 16e9  # O(1)-state decode fits


HEAD_VIEWS = """
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding

mesh = make_production_mesh()
x = distribute_tensor(torch.empty(32, 1, 40 * 128, device="meta", requires_grad=True),
                      mesh, (Shard(0), Shard(2)))
try:                        # 40 heads over the 16-way model axis: refused
    x.reshape(32, 1, 40, 128)
    raise SystemExit("DTensor took an uneven head view")
except RuntimeError:
    pass
with sharding.axis_rules(sharding.SERVE_RULES, mesh=mesh):
    q = sharding.split_dim(x, -1, (40, 128))          # gathered over model first
    assert q.shape == (32, 1, 40, 128) and q.placements == (Shard(0), Replicate()), q
    y = distribute_tensor(torch.empty(32, 1, 32 * 128, device="meta"), mesh,
                          (Shard(0), Shard(2)))
    k = sharding.split_dim(y, -1, (32, 128))           # 32 heads divide 16: kept
    assert k.shape == (32, 1, 32, 128) and k.placements == (Shard(0), Shard(2)), k
    m = sharding.merge_dims(q, 2)
    assert m.shape == (32, 1, 40 * 128) and m.placements == q.placements
    m.sum().backward()       # the held gradient meets the inverse views as placed
    assert x.grad is not None and x.grad.shape == x.shape
print("OK")
"""


def test_uneven_head_views_are_named():
    """The dry run has no fallback for an op DTensor refuses: the model's
    head views go through ``sharding.split_dim`` / ``merge_dims``, which
    gather a head dimension the mesh axes do not divide (40 heads over 16)
    and keep one they divide, on the production pod mesh; outside a mesh
    they are the plain reshape and flatten, bitwise."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", HEAD_VIEWS], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stdout + r.stderr[-2000:]
    import torch

    from repro_torch.models import sharding

    x = torch.randn(2, 3, 40 * 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sharding.split_dim(x, -1, (40, 8)), x.reshape(2, 3, 40, 8))
    y = x.reshape(2, 3, 40, 8)
    assert torch.equal(sharding.merge_dims(y, 2), y.reshape(2, 3, -1))
    assert torch.equal(sharding.merge_dims(y, 1, 2), y.reshape(2, 120, 8))
