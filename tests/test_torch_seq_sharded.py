"""The sequence-sharded read-only decode on the CPU: each shard's partial
(K4's partials mode, its plain version here) and their merge, over a list
of shards against JAX's ``seq_sharded_decode_attention`` under
``shard_map`` (run in a subprocess with 4 forced host devices), and over a
``DeviceMesh`` in four gloo processes against the list merge.  Inputs come
from numpy seeds; f32, held at F32_RTOL x max|ref|.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

REPO = os.path.join(os.path.dirname(__file__), "..")
F32_RTOL = 1e-5  # attention in f32: x max|ref|


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _lengths(pos, b):
    """The rows' lengths, an int32 (B,) tensor, from an int (every row) or
    an array of each row's."""
    return torch.from_numpy(np.broadcast_to(np.asarray(pos, np.int32), (b,)).copy())


def _attn_inputs(rng, b, h, kv, dh, s, dtype=np.float32):
    q = rng.standard_normal((b, h, dh)).astype(dtype)
    k, v = (rng.standard_normal((b, s, kv, dh)).astype(dtype) for _ in range(2))
    kn, vn = (rng.standard_normal((b, kv, dh)).astype(dtype) for _ in range(2))
    return q, k, v, kn, vn


SHARD_CASES = [  # (n_shards, pos): one shard past pos (empty) in each
    (2, 30), (4, 45), (4, 5), (4, np.array([64, 45, 0], np.int32)),
]

_JAX_SHARDED = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.models.attention import seq_sharded_decode_attention
from jax.sharding import Mesh
d = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
out = {}
for i, (n, pos) in enumerate(cases):
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    q, k, v, kn, vn = (jnp.asarray(d[x]) for x in ("q", "k", "v", "kn", "vn"))
    pos = jnp.asarray(np.asarray(pos, np.int32))
    out[str(i)] = np.asarray(seq_sharded_decode_attention(
        q[:, None], k, v, pos, kn[:, None], vn[:, None], mesh=mesh,
        batch_axes=("data",), seq_axes=("model",)))[:, 0]
np.savez(sys.argv[3], **out)
"""


def test_seq_sharded_merge_matches_jax_shard_map(tmp_path):
    """The port's per-shard partials (K4's partials mode, plain here) and
    their merge at 2 and 4 shards, one shard holding no valid row, against
    JAX's ``seq_sharded_decode_attention`` under ``shard_map`` on a mesh of
    forced host devices; the self term joins on shard 0 only.  Also the
    merge of one shard equals K4's plain version with the self term."""
    rng = np.random.default_rng(21)
    q, k, v, kn, vn = _attn_inputs(rng, 3, 8, 2, 32, 64)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, kn=kn, vn=vn)
    cases = [(n, p.tolist() if isinstance(p, np.ndarray) else p) for n, p in SHARD_CASES]
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", _JAX_SHARDED, str(tmp_path / "in.npz"),
                        json.dumps(cases), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    tq, tk, tv, tkn, tvn = (torch.from_numpy(x) for x in (q, k, v, kn, vn))
    for i, (n, pos) in enumerate(SHARD_CASES):
        lengths, last = _lengths(pos, 3), int(np.max(pos))
        got = tattn.seq_sharded_decode_attention(tq[:, None], tk, tv, lengths, last,
                                                 tkn[:, None], tvn[:, None], n_shards=n)[:, 0]
        _close(got, want[str(i)], F32_RTOL)
        parts = [tattn.decode_partial(tq, tk[:, lo:lo + 64 // n], tv[:, lo:lo + 64 // n],
                                      lengths, last, lo,
                                      *((tkn, tvn) if lo == 0 else (None, None)))
                 for lo in range(0, 64, 64 // n)]
        for j, (acc, m, l) in enumerate(parts):
            if j * (64 // n) >= last:   # a shard past every row's end: empty
                assert bool((m == tattn.EMPTY_M).all()) and not l.any() and not acc.any()
    one = tattn.seq_sharded_decode_attention(tq[:, None], tk, tv, _lengths(45, 3), 45,
                                             tkn[:, None], tvn[:, None], n_shards=1)[:, 0]
    _close(one, ref.flash_decode_ref(tq, tk, tv, 45, tkn, tvn), F32_RTOL)


def _gloo_worker(rank, port, inputs, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
        q, k, v, kn, vn = (torch.from_numpy(x) for x in inputs)
        cache = [Shard(0), Shard(1)]
        dk, dv = (distribute_tensor(t, mesh, cache) for t in (k, v))
        dq, dkn, dvn = (distribute_tensor(t[:, None], mesh, [Shard(0), Replicate()])
                        for t in (q, kn, vn))
        out = tattn.seq_sharded_decode_attention(dq, dk, dv, _lengths(45, 2), 45, dkn, dvn,
                                                 mesh=mesh, batch_axes=("data",),
                                                 seq_axes=("model",))
        np.save(os.path.join(out_dir, f"{rank}.npy"), out.full_tensor()[:, 0].numpy())
    finally:
        dist.destroy_process_group()


def test_mesh_merge_in_four_gloo_processes(tmp_path):
    """The mesh form of the merge (``local_map`` over the cache's sequence
    shards, all-reduces over the ``model`` axis) in four CPU processes
    under gloo: every rank's output equals the list merge's."""
    import socket

    import torch.multiprocessing as mp

    rng = np.random.default_rng(22)
    inputs = _attn_inputs(rng, 2, 8, 2, 32, 64)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_gloo_worker, args=(port, inputs, str(tmp_path)), nprocs=4, join=True)
    q, k, v, kn, vn = (torch.from_numpy(x) for x in inputs)
    want = tattn.seq_sharded_decode_attention(q[:, None], k, v, _lengths(45, 2), 45,
                                              kn[:, None], vn[:, None], n_shards=4)[:, 0]
    for rank in range(4):
        _close(np.load(tmp_path / f"{rank}.npy"), want, F32_RTOL)
