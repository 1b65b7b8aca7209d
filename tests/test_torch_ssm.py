"""The port's Mamba slice against the JAX package, on the CPU: the Mamba
mixer (``mamba_forward``, ``mamba_decode_step``), periods of more than one
layer, and jamba-v0.1-52b: its configs and transfer-size model, the smoke
model's prefill and decode, its serving cluster field by field, and the
launcher.

Inputs come from numpy seeds and cross into each framework as numpy.  The
JAX package has no Pallas kernel for the Mamba scan (a ``lax.scan``), and
the port runs it as plain PyTorch; jamba's attention layer decodes through
``ops.flash_decode``, whose plain version runs here.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
import repro.models.ssm as jssm
from repro.configs import get_spec as jax_spec
from repro.models.common import materialise
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params, param_specs as jax_param_specs
from repro.models.model import prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.launch import serve
from repro_torch.models import (
    Model,
    decode_step,
    make_decode_cache,
    mamba_decode_step,
    mamba_forward,
    mamba_param_specs,
    params_from_jax,
    prefill,
    state_bytes,
)
from repro_torch.models.ssm import TIME_BLOCK
from repro_torch.serving import DisaggregatedCluster, ServeRequest

ARCH = "jamba-v0.1-52b"
ATOL = 1e-4            # logits and cache leaves: tests/test_torch_model.py's
F32_RTOL = 1e-5        # the mixer in f32: x max(1, max|ref|)
BF16_RTOL = 2.0 ** -6  # the mixer in bf16: x max|ref|, a few rounding steps
# One request's fixed state at full width: 14 Mamba layers at 16 layers, each
# (8192, 16) f32 of SSM state and (3, 8192) bf16 of conv tail.
FULL16_STATE_BYTES = 8_028_160
PAGE_BYTES_PER_TOKEN = 8_192   # k4 + v4 over 2 periods, 8 KV heads of 128, bf16


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfg16(spec):
    return dataclasses.replace(spec.model, n_layers=16)


# ----------------------------------------------------------------- the mixer
def _mixer_case(d, b, s, seed, dtype):
    """JAX's init of one Mamba layer, a seeded x (B, S, d) and a seeded
    decode input (B, 1, d), in ``dtype`` on both sides."""
    jp = materialise(jssm.mamba_param_specs(d), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    xd = rng.standard_normal((b, 1, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: v.astype(jdt) for k, v in jp.items()}
    tp = {k: torch.tensor(_np(v)).to(dtype) for k, v in jp.items()}
    return jp, tp, (jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)), \
        (jnp.asarray(xd, jdt), torch.from_numpy(xd).to(dtype))


def _held(got, want, dtype, what):
    want = _np(want)
    scale = np.abs(want).max()
    tol = F32_RTOL * max(1.0, scale) if dtype == torch.float32 else BF16_RTOL * scale
    err = np.abs(_np(got) - want).max()
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:.3g}"


class TestMamba:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("s", [40, 512])
    def test_forward_and_decode_equal_jax(self, s, dtype):
        """S 40 (JAX's flat scan) and S 512 (its two-level TIME_CHUNK scan,
        and two of the port's time blocks): the output, the final SSM state
        and the conv tail; then one decode step from JAX's state."""
        assert s <= TIME_BLOCK or s == 2 * TIME_BLOCK
        jp, tp, (jx, tx), (jxd, txd) = _mixer_case(128, 2, s, s, dtype)
        jout, jst = jssm.mamba_forward(jp, jx)
        tout, tst = mamba_forward(tp, tx)
        assert tout.shape == (2, s, 128) and tout.dtype == dtype
        assert tst["ssm"].shape == (2, 256, 16) and tst["ssm"].dtype == torch.float32
        assert tst["conv"].shape == (2, 3, 256) and tst["conv"].dtype == dtype
        _held(tout, jout, dtype, "out")
        _held(tst["ssm"], jst["ssm"], dtype, "ssm")
        _held(tst["conv"], jst["conv"], dtype, "conv")
        state = {"ssm": torch.tensor(_np(jst["ssm"])),
                 "conv": torch.tensor(_np(jst["conv"])).to(dtype)}
        jd, jdst = jssm.mamba_decode_step(jp, jxd, jst)
        td, tdst = mamba_decode_step(tp, txd, state)
        assert td.shape == (2, 1, 128) and td.dtype == dtype
        _held(td, jd, dtype, "decode out")
        _held(tdst["ssm"], jdst["ssm"], dtype, "decode ssm")
        _held(tdst["conv"], jdst["conv"], dtype, "decode conv")

    @pytest.mark.parametrize("s", [1, 2, 5, 40])
    def test_prefill_then_decode_equals_longer_prefill(self, s):
        """Prefill of S tokens and one decode step give the output and state
        of a prefill of S + 1 (f32); S 1 and 2 keep pad rows in the conv
        tail."""
        _, tp, (_, tx), (_, txd) = _mixer_case(64, 2, s, 7, torch.float32)
        _, st = mamba_forward(tp, tx)
        if s < 3:
            assert torch.all(st["conv"][:, :3 - s] == 0)
        step, st1 = mamba_decode_step(tp, txd, st)
        whole, stw = mamba_forward(tp, torch.cat([tx, txd], dim=1))
        _held(step[:, 0], whole[:, -1], torch.float32, "last output")
        _held(st1["ssm"], stw["ssm"], torch.float32, "ssm")
        assert torch.equal(st1["conv"], stw["conv"])

    def test_param_specs_equal_jax(self):
        jspecs = jssm.mamba_param_specs(4096)
        tspecs = mamba_param_specs(4096)
        assert list(tspecs) == list(jspecs)
        for k, t in tspecs.items():
            j = jspecs[k]
            assert (t.shape, t.scale, t.kind) == (j.shape, j.scale, j.kind), k
        assert tspecs["x_proj"].shape == (8192, 256 + 32)


# ----------------------------------------------------------------- periods
def _pair(cfg_j, cfg_t, seed=0):
    jp = init_params(cfg_j, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg_t, device="cpu")


def _prefill_and_two_steps(jcfg, jp, model, toks, cache_len=64):
    """Prefill and two greedy steps on both sides: logits within ATOL and
    greedy tokens equal; returns both caches."""
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=cache_len)
    tl, tc = prefill(model, torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for _ in range(2):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        jl, jc = jax_decode_step(jcfg, jp, jt, jc)
        tl, tc = decode_step(model, tt, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == toks.shape[1] + 2
    assert set(tc) == set(jc)
    for k in tc:
        if k != "pos":
            assert tc[k].dtype == (torch.float32 if k.startswith(("ssm", "wkv"))
                                   else model.cfg.compute_dtype), k
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=ATOL, err_msg=k)
    return jc, tc


# Periods of more than one position that JAX builds, at jamba's smoke widths
# (f32): attention and Mamba with a dense FFN and none; RWKV beside
# attention; Mamba before a MoE.
MIXED = {"attn-mamba": (("attn", "mamba"), ("dense", "none")),
         "mamba-attn-moe": (("mamba", "attn"), ("moe", "dense")),
         "rwkv-attn": (("rwkv", "attn"), ("dense", "dense"))}


@pytest.mark.parametrize("period", list(MIXED))
def test_mixed_period_equals_jax(period):
    """A mixed period's parameter names, prefill, two decode steps and
    every cache leaf equal JAX's (the RWKV position's FFN is dropped in
    both, as JAX drops it)."""
    from repro.models.model import ModelConfig as JaxConfig
    from repro.models.moe import MoEConfig as JaxMoE
    from repro_torch.models import ModelConfig, MoEConfig

    blocks, ffns = MIXED[period]
    common = dict(name=period, d_model=128, n_layers=2 * len(blocks), n_heads=4,
                  n_kv_heads=2, d_head=32, d_ff=256, vocab_size=512,
                  block_pattern=blocks, ffn_pattern=ffns)
    moe = dict(n_experts=4, top_k=2, d_expert=128)
    jcfg = JaxConfig(**common, moe=JaxMoE(**moe), compute_dtype=jnp.float32)
    tcfg = ModelConfig(**common, moe=MoEConfig(**moe), compute_dtype=torch.float32)
    jp, model = _pair(jcfg, tcfg, seed=3)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert set(dict(model.named_parameters())) == {
        ".".join(k.key for k in path) for path, _ in leaves}
    toks = np.random.default_rng(5).integers(0, 512, (2, 12))
    _prefill_and_two_steps(jcfg, jp, model, toks, cache_len=32)
    for seq in (0, 12, 2048):
        assert state_bytes(tcfg, seq) == jax_state_bytes(jcfg, seq)


# ----------------------------------------------------------------- jamba
@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_spec(ARCH).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(ARCH).smoke, compute_dtype=torch.float32)
    jp, model = _pair(jcfg, tcfg)
    return jcfg, tcfg, jp, model


@pytest.mark.parametrize("which", ["model", "smoke", "16 layers"])
def test_config_equals_jax(which):
    """Every field of the port's ModelConfig equals the JAX one (``moe``
    field by field, dtypes by name); the encoder and front-end fields are at
    their defaults; ``remat`` (a training option) is compared too."""
    if which == "16 layers":
        j, t = _cfg16(jax_spec(ARCH)), _cfg16(get_spec(ARCH))
    else:
        j, t = getattr(jax_spec(ARCH), which), getattr(get_spec(ARCH), which)
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    for name, value in tf.items():
        if name == "compute_dtype":
            assert str(value).removeprefix("torch.") == jnp.dtype(jf[name]).name
        else:
            assert value == jf[name], name
    assert set(jf) == set(tf)
    assert (t.n_enc_layers, t.frontend, t.n_prefix_embeds) == (0, None, 0)
    assert t.n_periods == j.n_periods and t.n_attn_layers == j.n_attn_layers
    assert get_spec(ARCH).source == jax_spec(ARCH).source


@pytest.mark.parametrize("which", ["model", "smoke", "16 layers"])
def test_kv_spec_and_state_bytes(which):
    jspec, tspec = jax_spec(ARCH), get_spec(ARCH)
    if which == "16 layers":
        jspec = dataclasses.replace(jspec, model=_cfg16(jspec))
        tspec = dataclasses.replace(tspec, model=_cfg16(tspec))
    elif which == "smoke":
        jspec = dataclasses.replace(jspec, model=jspec.smoke)
        tspec = dataclasses.replace(tspec, model=tspec.smoke)
    assert dataclasses.asdict(tspec.kv_spec()) == dataclasses.asdict(jspec.kv_spec())
    for seq in (0, 1, 24, 2048, 32768):
        assert state_bytes(tspec.model, seq) == jax_state_bytes(jspec.model, seq)
    if which == "16 layers":
        m = tspec.model
        assert state_bytes(m, 0) == FULL16_STATE_BYTES
        assert state_bytes(m, 2048) == FULL16_STATE_BYTES + 2048 * PAGE_BYTES_PER_TOKEN
        assert state_bytes(m, 2048) - state_bytes(m, 1024) == 1024 * PAGE_BYTES_PER_TOKEN


def test_params_keep_jax_names(setup):
    """Every leaf of the JAX tree is a parameter of the port under its
    dotted path: eight positions, FFNs at every position, MoE at the odd
    ones; the stacked leaves stored in the compute dtype."""
    _, _, jp, model = setup
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path) for path, _ in leaves}
    params = dict(model.named_parameters())
    assert set(params) == want
    assert {"layers.b0.in_proj", "layers.b4.wq", "layers.f1.moe.router",
            "layers.f4.gate", "layers.b7.a_log"} <= want
    assert params["layers.b0.a_log"].shape == (1, 256, 16)
    full = jax_param_specs(_cfg16(jax_spec(ARCH)))["layers"]
    assert full["b0"]["a_log"].shape == (2, 8192, 16)
    bf16 = Model(get_spec(ARCH).smoke, device="cpu")
    assert all(p.dtype == (torch.float32 if p.dim() == 1 else torch.bfloat16)
               for p in bf16.parameters())


def test_smoke_prefill_and_decode(setup):
    """Prefill, then two greedy decode steps: logits within ATOL, greedy
    tokens equal, and every cache leaf (k4, v4, ssm{i}, conv{i}) within
    ATOL."""
    jcfg, _, jp, model = setup
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 20))
    _, tc = _prefill_and_two_steps(jcfg, jp, model, toks)
    assert set(tc) == {"k4", "v4", "pos", *(f"{n}{i}" for n in ("ssm", "conv")
                                          for i in (0, 1, 2, 3, 5, 6, 7))}
    assert tuple(tc["ssm0"].shape) == (1, 2, 256, 16)
    assert tuple(tc["conv0"].shape) == (1, 2, 3, 256)
    assert tuple(tc["k4"].shape) == (1, 2, 64, 2, 32)


def test_decode_cache_layout():
    cfg = _cfg16(get_spec(ARCH))
    cache = make_decode_cache(cfg, 1, 16, "cpu")
    assert tuple(cache["k4"].shape) == (2, 1, 16, 8, 128)
    assert tuple(cache["ssm0"].shape) == (2, 1, 8192, 16) and cache["ssm0"].dtype == torch.float32
    assert tuple(cache["conv7"].shape) == (2, 1, 3, 8192) and cache["conv7"].dtype == torch.bfloat16
    fixed = sum(v.numel() * v.element_size() for k, v in cache.items()
                if k.startswith(("ssm", "conv")))
    assert fixed == FULL16_STATE_BYTES


def test_smoke_cluster_equals_jax(setup):
    """examples/serve_netkv.py's workload, the even requests sharing a
    prefix: every ServeResult field equal; a prefix hit ships fewer pages
    and the whole fixed state."""
    jcfg, tcfg, _, model = setup
    rng = np.random.default_rng(0)
    shared = rng.integers(0, jcfg.vocab_size, size=16)
    work = [(i, np.concatenate([shared, rng.integers(0, jcfg.vocab_size, 8)]) if i % 2 == 0
             else rng.integers(0, jcfg.vocab_size, size=24), 8, i * 0.05) for i in range(8)]
    jres = JaxCluster(jcfg, scheduler="netkv-full", cache_len=64).serve(
        [JaxRequest(*a) for a in work])
    tres = DisaggregatedCluster(tcfg, scheduler="netkv-full", cache_len=64, params=model,
                                device="cpu").serve([ServeRequest(*a) for a in work])
    assert len(tres) == len(jres) == 8
    for j, t in zip(jres, tres):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # f32 smoke: 7 Mamba layers of (256, 16) f32 SSM and (3, 256) f32 conv;
    # a 16-token page of k4 + v4 is 16 x 2 x 2 x 32 x 4 bytes.
    fixed = 7 * (256 * 16 * 4 + 3 * 256 * 4)
    page = 16 * 2 * 2 * 32 * 4
    sent = sorted({r.transfer_bytes for r in tres})
    assert sent == [fixed + page, fixed + 2 * page] == [144_384, 152_576]


def test_launcher_serves_jamba_smoke(capsys):
    assert serve.model_config(ARCH, "smoke") == dataclasses.replace(
        get_spec(ARCH).smoke, compute_dtype=torch.float32)
    assert serve.main(["--real", "--arch", ARCH, "--requests", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests on cpu" in out and "xfer=153KB" in out


def test_full_width_is_refused_before_allocating(monkeypatch):
    """jamba's 32 layers, ~103.1 GB of bf16 weights, do not fit one 80 GB
    card: the launcher names both byte counts and builds nothing.  16
    layers, ~52.1 GB, fit."""
    def no_cluster(*a, **k):
        raise AssertionError("a cluster was built")

    need = serve.weight_bytes(get_spec(ARCH).model)
    assert 103.0e9 < need < 103.3e9
    monkeypatch.setattr(serve, "build_cluster", no_cluster)
    with pytest.raises(ValueError, match=f"{need:,} bytes .* 80,000,000,000 bytes"):
        serve.main(["--real", "--arch", ARCH, "--width", "full", "--device", "cpu"])
    assert 52.0e9 < serve.weight_bytes(_cfg16(get_spec(ARCH))) < 52.2e9


def test_launcher_prints_the_jax_launchers_lines(capsys, monkeypatch):
    """The simulator with jamba's KV-size model: with the NumPy scorer the
    two launchers print the same lines."""
    argv = ["--arch", ARCH, "--profile", "rag", "--rate", "0.5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jax_serve.main() == 0
    want = capsys.readouterr().out
    assert serve.main(argv + ["--backend", "numpy", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith(f"netkv-full on rag ({ARCH} KV) @ 50%:")
