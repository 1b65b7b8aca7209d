"""The port's training launcher against JAX's: the master parameters and
the gradient accumulator are f32 for every arch, as
``repro/launch/train.py`` has them (``init_params``' f32 ``InitSpec``s and
``make_train_step``'s default ``accum_dtype``); the spec's
``train_param_dtype`` and ``grad_accum_dtype`` are read only by the dry run.
arctic-480b's smoke run goes through both launchers, and JAX's ``--resume``
reads the port's checkpoint.
"""

import inspect
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jax_spec
from repro.models.model import init_params
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import ALL
from repro_torch.launch import train as launcher

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_jax_launcher_trains_in_f32():
    """What the port's launcher is held to: JAX's launcher passes no
    dtype to ``init_params`` or ``make_train_step``, whose defaults are
    f32."""
    with open(os.path.join(REPO, "src", "repro", "launch", "train.py")) as f:
        src = f.read()
    assert "init_params(cfg, jax.random.PRNGKey(args.seed))" in src
    assert "accum_dtype" not in src and "train_param_dtype" not in src
    assert inspect.signature(jax_make_train_step).parameters["accum_dtype"].default \
        is jnp.float32


@pytest.mark.parametrize("arch", ALL)
def test_master_and_accumulator_dtypes_match_jax(arch, tmp_path, monkeypatch):
    """Every master parameter of the port's launcher (``--smoke``) and its
    accumulator are f32, the dtypes of JAX's launcher's parameters leaf by
    leaf (``jax.eval_shape`` of its ``init_params``)."""
    seen = {}
    real_step, real_init = launcher.make_train_step, launcher.init_random_

    def step(opt, **kw):
        seen["accum"] = kw.get("accum_dtype", torch.float32)
        return real_step(opt, **kw)

    def init(model, seed):
        seen["model"] = model
        return real_init(model, seed)

    monkeypatch.setattr(launcher, "make_train_step", step)
    monkeypatch.setattr(launcher, "init_random_", init)
    assert launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "0",
                          "--ckpt-dir", str(tmp_path)]) == 0
    assert seen["accum"] == torch.float32
    ours = {n: p.dtype for n, p in seen["model"].named_parameters()}
    theirs = jax.eval_shape(lambda: init_params(jax_spec(arch).smoke, jax.random.PRNGKey(0)))
    flat = {".".join(str(k.key) for k in path): leaf.dtype
            for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert set(ours) == set(flat)
    assert all(ours[n] == torch.float32 and flat[n] == jnp.float32 for n in ours)


def _leaf_dtypes(ckpt_dir: str) -> dict:
    (step,) = [d for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    with zipfile.ZipFile(os.path.join(ckpt_dir, step, "arrays.npz")) as z:
        out = {}
        for name in z.namelist():
            with z.open(name) as f:
                version = np.lib.format.read_magic(f)
                header = np.lib.format._read_array_header(f, version)
            out[name] = np.dtype(header[2]).str
    return out


def test_arctic_smoke_through_both_launchers(tmp_path):
    """``--arch arctic-480b --smoke --steps 1 --batch 4 --seq 16`` through
    JAX's launcher and the port's: the same checkpoint leaves, every one
    f32 but the int32 step; then JAX's launcher resumes from the port's
    directory and trains a second step."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    args = ["--arch", "arctic-480b", "--smoke", "--steps", "1", "--batch", "4", "--seq", "16"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    r = subprocess.run([sys.executable, "-m", "repro.launch.train", *args, "--ckpt-dir", jax_dir],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert launcher.main(args + ["--device", "cpu", "--ckpt-dir", port_dir]) == 0
    jd, pd = _leaf_dtypes(jax_dir), _leaf_dtypes(port_dir)
    assert jd == pd
    assert sorted(set(pd.values())) == ["<f4", "<i4"]
    assert sum(v == "<i4" for v in pd.values()) == 1
    args[args.index("1")] = "2"
    r = subprocess.run([sys.executable, "-m", "repro.launch.train", *args, "--ckpt-dir",
                        port_dir, "--resume"], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from step 1" in r.stdout
    assert "step     1 loss=" in r.stdout
