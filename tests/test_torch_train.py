"""The port's training slice against the JAX package, on the CPU:
``train/data.py::synth_batch``, the optimizers, the microbatch layout,
``models/model.py::forward_train`` (loss, MoE aux loss and gradients, with
remat on and off), ``train/train_step.py::make_train_step`` against JAX's
jitted step, checkpoints that cross between the two packages, the restart
drill and the launcher.

Inputs come from numpy seeds and cross into each framework as numpy;
weights come from ``repro.models.init_params`` through ``params_from_jax``
(f32 master parameters, f32 compute).  Tolerances: the loss rtol 1e-5;
gradients |d| <= 1e-4 |g| + 1e-6 element by element, but rwkv6's, whose
24 steps of the WKV recurrence the two packages sum in other orders, within
1e-4 of the leaf's largest |g| (measured: 6e-6 of it); optimizer updates
rtol 1e-6, with atol 1e-6 lr on the parameters (a reduction's last bit,
as in Adafactor's RMS, moves an element by a millionth of a step, which
shows relative to an element a weight-decayed step brings near zero:
measured 1.5e-8 at lr 3e-2).  After 3 AdamW or Adafactor steps an element whose gradient sits
below the packages' rounding differences may step the other way (each
element's step is normalised), so parameters are held leaf by leaf: at
most 1% of a leaf's elements outside rtol 1e-5 + atol 1e-6 (measured: up
to 3 of 1920, rwkv6's ``mu_base``), and the
difference's norm within 1e-2 of the 3 steps' update's norm.
"""

import dataclasses
import functools
import os
import re
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jax_spec
from repro.models.model import forward_logits as jax_forward_logits
from repro.models.model import forward_train as jax_forward_train
from repro.models.model import init_params
from repro.train import make_optimizer as jax_make_optimizer
from repro.train import make_train_step as jax_make_train_step
from repro.train import microbatch_split as jax_microbatch_split
from repro.train import restore_latest as jax_restore_latest
from repro.train import save_checkpoint as jax_save_checkpoint
from repro.train import synth_batch as jax_synth_batch
from repro.train.train_step import effective_microbatches as jax_effective_microbatches
from repro_torch.configs import ALL, get_spec
from repro_torch.launch import train as launcher
from repro_torch.models import (
    Model,
    forward_logits_aux,
    forward_train,
    init_random_,
    opt_state_from_jax,
    params_from_jax,
    to_numpy_tree,
)
from repro_torch.models.model import dtype_of
from repro_torch.train import (
    effective_microbatches,
    list_checkpoints,
    make_optimizer,
    make_train_step,
    microbatch_split,
    restore_latest,
    save_checkpoint,
    synth_batch,
)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
OPT_RTOL = 1e-6
TRAINED = ["smollm-135m", "qwen3-14b", "granite-moe-1b-a400m", "arctic-480b", "jamba-v0.1-52b",
           "seamless-m4t-medium", "internvl2-76b"]
BATCH, SEQ = 4, 24


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_pair(arch):
    jcfg = dataclasses.replace(jax_spec(arch).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32)
    return jcfg, tcfg, init_params(jcfg, jax.random.PRNGKey(0))


def _model(arch):
    _, tcfg, jp = _jax_pair(arch)
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           train_dtype=torch.float32)


def _batches(arch, step, b=BATCH, s=SEQ):
    jcfg, tcfg, _ = _jax_pair(arch)
    return (jax_synth_batch(jcfg, global_batch=b, seq_len=s, seed=1, step=step),
            synth_batch(tcfg, global_batch=b, seq_len=s, seed=1, step=step, device="cpu"))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and x.dtype.kind == "V" else x


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ALL)
def test_training_fields_equal_jax(arch):
    """ArchSpec's training knobs and every config's ``remat`` are JAX's."""
    j, t = jax_spec(arch), get_spec(arch)
    for field in ("train_microbatches", "optimizer", "train_param_dtype", "grad_accum_dtype"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.model.remat, t.smoke.remat) == (j.model.remat, j.smoke.remat) == (True, False)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ALL)
def test_synth_batch_bitwise_jax(arch):
    jcfg, tcfg, _ = _jax_pair(arch)
    for step in (0, 7):
        jb = jax_synth_batch(jcfg, global_batch=3, seq_len=40, seed=5, step=step)
        tb = synth_batch(tcfg, global_batch=3, seq_len=40, seed=5, step=step, device="cpu")
        assert set(jb) == set(tb)
        for key, want in jb.items():
            want = np.asarray(want)
            got = tb[key]
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name, key
            np.testing.assert_array_equal(_bits(got), _bits(want.view(np.int16)
                                                           if want.dtype.itemsize == 2
                                                           else want), err_msg=key)


# -------------------------------------------------------------- optimizers
def _random_tree(rng):
    shapes = {"embed": (24, 8), "out_norm": (8,), "layers.b0.wq": (2, 8, 12),
              "layers.b0.ln": (2, 8), "layers.f0.moe.w_up": (2, 4, 8, 6)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _nest(flat):
    out = {}
    for name, x in flat.items():
        d = out
        parts = name.split(".")
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = x
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("kw", [{}, {"lr": 3e-2, "weight_decay": 0.05}], ids=["default", "wd"])
def test_optimizer_updates_match_jax(name, kw):
    """Three updates of a random tree (1-D to 4-D leaves, so Adafactor's
    factored and unfactored moments both run) from random gradients."""
    rng = np.random.default_rng(11)
    params = _random_tree(rng)
    jopt, topt = jax_make_optimizer(name, **kw), make_optimizer(name, **kw)
    jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                 for k, v in params.items()}
        jp, jstate = jopt.update(_nest({k: jnp.asarray(g) for k, g in grads.items()}),
                                 jstate, jp)
        tp, tstate = topt.update({k: torch.from_numpy(g) for k, g in grads.items()}, tstate, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), _leaf(jp, k), rtol=OPT_RTOL,
                                   atol=OPT_RTOL * topt.lr, err_msg=k)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    jstate_np = jax.tree.map(np.asarray, jstate)
    tstate_np = to_numpy_tree(tstate)
    assert jax.tree.structure(jstate_np) == jax.tree.structure(tstate_np)
    for a, b in zip(jax.tree.leaves(tstate_np), jax.tree.leaves(jstate_np)):
        np.testing.assert_allclose(a, b, rtol=OPT_RTOL, atol=0)


def test_optimizer_keeps_a_bf16_master_in_bf16():
    """A bf16 parameter (arctic's master copy) is updated in f32 and
    rounded back, as JAX's ``astype(p.dtype)``: bitwise JAX's."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((6, 10)).astype(np.float32)
    g = rng.standard_normal((6, 10)).astype(np.float32)
    for name in ("adamw", "adafactor"):
        jopt, topt = jax_make_optimizer(name), make_optimizer(name)
        jp = {"w": jnp.asarray(p, jnp.bfloat16)}
        tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
        jnew, _ = jopt.update({"w": jnp.asarray(g, jnp.bfloat16)}, jopt.init(jp), jp)
        tnew, _ = topt.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, topt.init(tp), tp)
        assert tnew["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tnew["w"]), np.asarray(jnew["w"]).view(np.int16))


# ------------------------------------------------------------- microbatches
@pytest.mark.parametrize("gb,mb,shards", [(8, 2, 1), (8, 4, 2), (12, 3, 2), (6, 4, 1),
                                          (16, 16, 4), (5, 2, 1)])
def test_microbatch_layout_is_jax(gb, mb, shards):
    assert effective_microbatches(gb, mb, shards) == jax_effective_microbatches(gb, mb, shards)
    mb = effective_microbatches(gb, mb, shards)
    if gb % shards:
        return
    x = np.arange(gb * 3, dtype=np.int32).reshape(gb, 3)
    want = jax_microbatch_split({"t": jnp.asarray(x)}, mb, shards)["t"]
    got = microbatch_split({"t": torch.from_numpy(x)}, mb, shards)["t"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- forward_train
def _grads_close(arch, got, want, name):
    err = np.abs(got - want)
    if arch == "rwkv6-3b":
        assert err.max() <= GRAD_RTOL * np.abs(want).max(), (name, err.max())
    else:
        excess = err - GRAD_RTOL * np.abs(want) - GRAD_ATOL
        assert excess.max() <= 0, (name, err.max())


@pytest.mark.parametrize("arch", ALL)
def test_forward_train_loss_and_grads_match_jax(arch):
    jcfg, _, jp = _jax_pair(arch)
    jb, tb = _batches(arch, 0, b=2)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_forward_train(jcfg, p, jb), has_aux=True)(jp)
    model = _model(arch)
    loss, parts = forward_train(model, tb)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=LOSS_RTOL)
    assert (float(jparts["aux"]) > 0) == (get_spec(arch).smoke.moe is not None)
    for name, g in zip(params, grads):
        _grads_close(arch, g.numpy(), _leaf(jgrads, name), name)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b", "internvl2-76b"])
def test_forward_logits_aux_matches_jax(arch):
    """The grad-enabled logits and the MoE aux loss summed over periods
    (JAX's ``forward_logits``), behind a prefix for the vision model."""
    jcfg, _, jp = _jax_pair(arch)
    jb, tb = _batches(arch, 0, b=2)
    prefix = jb.get("embeds")
    jl, jaux = jax_forward_logits(jcfg, jp, jb["tokens"], prefix_embeds=prefix)
    tl, taux = forward_logits_aux(_model(arch), tb["tokens"], prefix_embeds=tb.get("embeds"))
    assert tl.requires_grad
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m", "rwkv6-3b",
                                  "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b"])
def test_remat_gives_bitwise_the_same_loss_and_grads(arch):
    """Each period recomputed in the backward pass (``torch.utils.checkpoint``
    per period, JAX's ``jax.checkpoint`` per period) changes no bit."""
    _, tcfg, _ = _jax_pair(arch)
    _, tb = _batches(arch, 0, b=2)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = init_random_(Model(cfg, device="cpu", train_dtype="float32"), 0)
        loss, _ = forward_train(model, tb)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------- train step
def _held_params(model, jp, jp0):
    for name, p in model.named_parameters():
        got, want, start = p.detach().float().numpy(), _leaf(jp, name), _leaf(jp0, name)
        off = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6
        assert off.mean() <= 1e-2, (name, int(off.sum()), off.size)
        update = np.linalg.norm(want - start)
        assert np.linalg.norm(got - want) <= 1e-2 * max(update, 1e-12), name


@pytest.mark.parametrize("arch,mb", [(a, 2) for a in TRAINED] + [("smollm-135m", 1)])
def test_train_step_matches_jax_over_3_steps(arch, mb):
    """``make_train_step`` with ``mb`` microbatches and the architecture's
    optimizer against JAX's jitted step: loss and grad_norm at every step,
    the parameters after 3 steps."""
    jcfg, _, jp = _jax_pair(arch)
    name = get_spec(arch).optimizer
    jopt, topt = jax_make_optimizer(name, lr=1e-3), make_optimizer(name, lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=mb, batch_shards=1))
    tstep = make_train_step(topt, microbatches=mb)
    model = _model(arch)
    jstate, tstate = jopt.init(jp), topt.init(dict(model.named_parameters()))
    jp0 = jp
    for i in range(3):
        jb, tb = _batches(arch, i)
        jp, jstate, jm = jstep(jp, jstate, jb)
        model, tstate, tm = tstep(model, tstate, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    _held_params(model, jp, jp0)
    assert int(tstate["step"]) == 3


def test_rwkv_train_step_matches_jax_step_by_step():
    """rwkv6: each of 3 steps from JAX's parameters and optimizer state.
    Its WKV gradients (norm ~25) make the two packages' runs part after a
    step, as any rounding change would; from the same state each step's
    loss and grad_norm agree (measured: 1e-7 and 2e-5)."""
    arch = "rwkv6-3b"
    jcfg, tcfg, jp = _jax_pair(arch)
    jopt, topt = jax_make_optimizer("adamw", lr=1e-3), make_optimizer("adamw", lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=2, batch_shards=1))
    tstep = make_train_step(topt, microbatches=2)
    jstate = jopt.init(jp)
    for i in range(3):
        model = _model(arch) if i == 0 else params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu", train_dtype=torch.float32)
        names = [n for n, _ in model.named_parameters()]
        tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate), names, device="cpu")
        jb, tb = _batches(arch, i)
        jp1, jstate, jm = jstep(jp, jstate, jb)
        model, tstate, tm = tstep(model, tstate, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        _held_params(model, jp1, jp)
        jp = jp1


# -------------------------------------------------------------- checkpoints
def _adafactor_pair():
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg, jp = _jax_pair(arch)
    jopt = jax_make_optimizer("adafactor")
    model = Model(tcfg, device="cpu", train_dtype="float32")
    return jp, jopt.init(jp), model, make_optimizer("adafactor").init(
        dict(model.named_parameters()))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jp, jstate, model, tstate = _adafactor_pair()
    jax_save_checkpoint(str(tmp_path), 5, {"p": jp, "o": jstate})
    step, tree = restore_latest(str(tmp_path), {"p": model, "o": tstate})
    assert step == 5 and tree["p"] is model
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _leaf(jp, name))
    assert tree["o"]["step"].dtype == torch.int32 and tree["o"]["step"].shape == ()
    assert set(tree["o"]["acc"]) == set(tstate["acc"])


def test_port_checkpoint_restores_in_jax_with_the_same_keys(tmp_path):
    """The port writes JAX's keys (``['p']['layers']['b0']['wq']``,
    ``['o']['acc'][...]['vr']``, ``['o']['step']``) and the same npy
    members byte for byte; JAX's ``restore_latest`` reads it back."""
    jp, jstate, model, tstate = _adafactor_pair()
    jax_save_checkpoint(str(tmp_path / "jax"), 5, {"p": jp, "o": jstate})
    restore_latest(str(tmp_path / "jax"), {"p": model, "o": tstate})
    tstate = restore_latest(str(tmp_path / "jax"), {"p": model, "o": tstate})[1]["o"]
    save_checkpoint(str(tmp_path / "port"), 5, {"p": model, "o": tstate})
    a = zipfile.ZipFile(tmp_path / "jax" / "step_00000005" / "arrays.npz")
    b = zipfile.ZipFile(tmp_path / "port" / "step_00000005" / "arrays.npz")
    assert sorted(a.namelist()) == sorted(b.namelist())
    assert "['o']['step'].npy" in b.namelist()
    assert "['p']['layers']['f0']['moe']['router'].npy" in b.namelist()
    for member in a.namelist():
        assert a.read(member) == b.read(member), member
    step, tree = jax_restore_latest(str(tmp_path / "port"), {"p": jp, "o": jstate})
    assert step == 5
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves({"p": jp, "o": jstate})):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bf16_leaves_are_jax_bytes(tmp_path):
    """A bf16 master (arctic's) is written as JAX writes an ml_dtypes leaf
    (the ``'<V2'`` header and the raw bits) and read back bit for bit."""
    arch = "arctic-480b"
    _, tcfg, jp = _jax_pair(arch)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jax_save_checkpoint(str(tmp_path / "jax"), 1, {"p": jb})
    model = Model(tcfg, device="cpu", train_dtype="bfloat16")
    restore_latest(str(tmp_path / "jax"), {"p": model})
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(p), _leaf(jb, name).view(np.int16))
    save_checkpoint(str(tmp_path / "port"), 1, {"p": model})
    a = zipfile.ZipFile(tmp_path / "jax" / "step_00000001" / "arrays.npz")
    b = zipfile.ZipFile(tmp_path / "port" / "step_00000001" / "arrays.npz")
    assert all(a.read(m) == b.read(m) for m in a.namelist())
    assert sorted(a.namelist()) == sorted(b.namelist())


def test_retention_keeps_3_and_leaves_no_partial_directory(tmp_path):
    model = init_random_(Model(get_spec("smollm-135m").smoke, device="cpu",
                               train_dtype="float32"), 0)
    for step in range(1, 6):
        save_checkpoint(str(tmp_path), step, {"p": model}, extra={"n": step})
    assert list_checkpoints(str(tmp_path)) == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    os.makedirs(tmp_path / ".tmp_dead")
    assert list_checkpoints(str(tmp_path)) == [3, 4, 5]


def test_restart_drill_is_bitwise(tmp_path):
    """The preemption drill of the JAX package's tests: 6 steps
    uninterrupted against 3 steps, a checkpoint, a restore into a fresh
    model and 3 more steps: every parameter bitwise equal."""
    cfg = get_spec("smollm-135m").smoke
    opt = make_optimizer("adamw", lr=1e-3)
    step_fn = make_train_step(opt, microbatches=2)

    def fresh():
        model = init_random_(Model(cfg, device="cpu", train_dtype="float32"), 0)
        return model, opt.init(dict(model.named_parameters()))

    def run(model, state, start, end, ckpt_at=None):
        for i in range(start, end):
            batch = synth_batch(cfg, global_batch=4, seq_len=32, seed=11, step=i, device="cpu")
            model, state, _ = step_fn(model, state, batch)
            if i == ckpt_at:
                save_checkpoint(str(tmp_path), i + 1, {"p": model, "o": state})
        return model, state

    full, _ = run(*fresh(), 0, 6)
    run(*fresh(), 0, 3, ckpt_at=2)
    model, state = fresh()
    step0, tree = restore_latest(str(tmp_path), {"p": model, "o": state})
    assert step0 == 3
    resumed, _ = run(tree["p"], tree["o"], step0, 6)
    for (name, a), b in zip(full.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------- launcher
LINE = re.compile(r"step +\d+ loss=\d+\.\d{4} gnorm=\d+\.\d{3} \(\d+\.\d{2}s/step\)")


def test_launcher_prints_the_jax_line_format(tmp_path, capsys):
    """``--smoke --device cpu`` trains, prints JAX's lines (step 0, every
    10th and the last), checkpoints, and resumes from its last step."""
    args = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "12",
            "--ckpt-dir", str(tmp_path)]
    assert launcher.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "10", "11"]
    assert all(LINE.fullmatch(ln) for ln in lines[:-1]), lines
    assert lines[-1] == f"done: 12 steps, checkpoints in {tmp_path}"
    assert list_checkpoints(str(tmp_path)) == [12]
    args[args.index("12")] = "14"
    assert launcher.main(args + ["--resume"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "resumed from step 12" and LINE.fullmatch(lines[1])
    assert lines[1].split()[1] == "13"
    first = float(re.search(r"loss=(\S+)", lines[1]).group(1))
    assert np.isfinite(first)


def test_train_dtype_names_and_bf16_accumulation():
    """``train_dtype`` takes a dtype or its name; arctic's bf16 master and
    bf16 accumulator train a step with finite metrics, every parameter
    staying bf16 and requiring grad."""
    spec = get_spec("arctic-480b")
    assert dtype_of(spec.train_param_dtype) == torch.bfloat16
    model = init_random_(Model(spec.smoke, device="cpu", train_dtype=spec.train_param_dtype), 0)
    assert all(p.dtype == torch.bfloat16 and p.requires_grad for p in model.parameters())
    opt = make_optimizer(spec.optimizer)
    step = make_train_step(opt, microbatches=2, accum_dtype=dtype_of(spec.grad_accum_dtype))
    batch = synth_batch(spec.smoke, global_batch=4, seq_len=16, seed=0, step=0, device="cpu")
    model, state, m = step(model, opt.init(dict(model.named_parameters())), batch)
    assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
