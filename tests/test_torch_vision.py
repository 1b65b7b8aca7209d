"""The port's vision slice against the JAX package, on the CPU:
internvl2-76b's configs and transfer-size model, the smoke model's prefill
behind stub patch embeddings and its decode (also with H % KV != 0, the
head-expanded path, which no registered config has), its serving cluster
field by field (text only, as the JAX cluster serves it), and the launcher.

Inputs come from numpy seeds and cross into each framework as numpy;
weights come from ``repro.models.init_params`` through ``params_from_jax``.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.configs import get_spec as jax_spec
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward_logits as jax_forward_logits
from repro.models.model import init_params
from repro.models.model import prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.launch import serve
from repro_torch.models import (
    decode_step,
    forward_logits,
    params_from_jax,
    prefill,
    state_bytes,
)
from repro_torch.serving import DisaggregatedCluster, ServeRequest

ARCH = "internvl2-76b"
ATOL = 1e-4            # logits and cache leaves: tests/test_torch_model.py's
BF16_RTOL = 2.0 ** -6  # the model in bf16: x max|ref|, a few rounding steps
# 80 layers' bf16 weights (1-D norms in f32), and the 24 chip_smoke.py serves.
FULL_WEIGHT_BYTES = 141_107_429_376
WEIGHT_BYTES_24 = 45_274_136_576


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(h=None, kv=None, dtype=torch.float32, seed=0):
    """(JAX config, params; the port's model) of the smoke config, with
    ``h`` query heads over ``kv`` KV heads if given."""
    heads = {} if h is None else dict(n_heads=h, n_kv_heads=kv)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jax_spec(ARCH).smoke, compute_dtype=jdt, **heads)
    tcfg = dataclasses.replace(get_spec(ARCH).smoke, compute_dtype=dtype, **heads)
    jp = init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def setup():
    return _models()


def _inputs(jcfg, seed, b=2, s=20):
    rng = np.random.default_rng(seed)
    pe = rng.standard_normal((b, jcfg.n_prefix_embeds, jcfg.d_model)).astype(np.float32)
    return rng.integers(0, jcfg.vocab_size, (b, s)), pe


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_config_equals_jax(which):
    """Every field of the port's ModelConfig equals the JAX one (dtypes by
    name), ``remat`` (a training option) among them."""
    j = getattr(jax_spec(ARCH), which)
    t = getattr(get_spec(ARCH), which)
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    for name, value in tf.items():
        if name == "compute_dtype":
            assert str(value).removeprefix("torch.") == jnp.dtype(jf[name]).name
        else:
            assert value == jf[name], name
    assert set(jf) == set(tf)
    assert t.frontend == "vision" and t.n_prefix_embeds > 0 and not t.is_enc_dec
    assert get_spec(ARCH).source == jax_spec(ARCH).source == "[arXiv:2404.16821; unverified]"


def test_kv_spec_and_state_bytes():
    assert dataclasses.asdict(get_spec(ARCH).kv_spec()) == dataclasses.asdict(
        jax_spec(ARCH).kv_spec())
    for which in ("model", "smoke"):
        jc, tc = getattr(jax_spec(ARCH), which), getattr(get_spec(ARCH), which)
        for seq in (0, 1, 2048, 2304, 32768):
            assert state_bytes(tc, seq) == jax_state_bytes(jc, seq)
    # A 2048-token request at 24 layers: 8 KV heads of 128 in bf16, k and v.
    cut = dataclasses.replace(get_spec(ARCH).model, n_layers=24)
    assert state_bytes(cut, 2048) == 201_326_592


@pytest.mark.parametrize("h,kv", [(None, None), (6, 4)], ids=["smoke", "h6kv4"])
def test_prefill_with_prefix_and_decode(h, kv):
    """Prefill behind the stub patch embeddings (``pos`` = n + S), every
    cache leaf, then two greedy decode steps: logits within ATOL of JAX,
    tokens equal, and the port's forward_logits at each position."""
    jcfg, jp, model = _models(h, kv, seed=1)
    toks, pe = _inputs(jcfg, 2)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32),
                         prefix_embeds=jnp.asarray(pe), cache_len=48)
    tl, tc = prefill(model, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pe),
                     cache_len=48)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert set(tc) == set(jc) == {"k0", "v0", "pos"}
    assert tc["pos"] == int(jc["pos"]) == jcfg.n_prefix_embeds + 20
    for leaf in ("k0", "v0"):
        np.testing.assert_allclose(_np(tc[leaf]), _np(jc[leaf]), atol=ATOL, err_msg=leaf)
    want, _ = jax_forward_logits(jcfg, jp, jnp.asarray(toks, jnp.int32),
                                 prefix_embeds=jnp.asarray(pe))
    seq = torch.from_numpy(toks)
    full = forward_logits(model, seq, prefix_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(_np(full), _np(want), atol=ATOL)
    for _ in range(2):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        seq = torch.cat([seq, tt], dim=1)
        jl, jc = jax_decode_step(jcfg, jp, jt, jc)
        tl, tc = decode_step(model, tt, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        full = forward_logits(model, seq, prefix_embeds=torch.from_numpy(pe))
        np.testing.assert_allclose(_np(tl[:, 0]), _np(full[:, -1]), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == jcfg.n_prefix_embeds + 22
    np.testing.assert_allclose(_np(tc["k0"]), _np(jc["k0"]), atol=ATOL)


@pytest.mark.parametrize("h,kv", [(None, None), (6, 4)], ids=["smoke", "h6kv4"])
def test_bf16_within_a_few_rounding_steps(h, kv):
    """In bf16 (JAX keeps f32 parameters and casts; the port stores the
    cast): prefill logits and two decode steps' within 2^-6 of the largest."""
    jcfg, jp, model = _models(h, kv, dtype=torch.bfloat16, seed=3)
    toks, pe = _inputs(jcfg, 4)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32),
                         prefix_embeds=jnp.asarray(pe), cache_len=48)
    tl, tc = prefill(model, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pe),
                     cache_len=48)
    tok = toks[:, -1:]
    for step in range(3):
        if step:
            jl, jc = jax_decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32), jc)
            tl, tc = decode_step(model, torch.from_numpy(tok), tc)
        scale = float(np.abs(_np(jl)).max())
        assert float(np.abs(_np(tl) - _np(jl)).max()) <= BF16_RTOL * scale


def test_smoke_cluster_equals_jax(setup):
    """examples/serve_netkv.py's workload, the even requests sharing a
    prefix, text only: every ServeResult field equal."""
    jcfg, _, model = setup
    rng = np.random.default_rng(0)
    shared = rng.integers(0, jcfg.vocab_size, size=16)
    work = [(i, np.concatenate([shared, rng.integers(0, jcfg.vocab_size, 8)]) if i % 2 == 0
             else rng.integers(0, jcfg.vocab_size, size=24), 8, i * 0.05) for i in range(8)]
    jres = JaxCluster(jcfg, scheduler="netkv-full", cache_len=64).serve(
        [JaxRequest(*a) for a in work])
    tres = DisaggregatedCluster(model.cfg, scheduler="netkv-full", cache_len=64, params=model,
                                device="cpu").serve([ServeRequest(*a) for a in work])
    assert len(tres) == len(jres) == 8
    for j, t in zip(jres, tres):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # A 16-token page of k + v over 4 layers, 2 KV heads of 16, f32.
    page = 4 * 2 * 16 * 2 * 16 * 4
    assert sorted({r.transfer_bytes for r in tres}) == [page, 2 * page]


def test_launcher_serves_the_smoke_config(capsys):
    assert serve.model_config(ARCH, "smoke") == dataclasses.replace(
        get_spec(ARCH).smoke, compute_dtype=torch.float32)
    assert serve.main(["--real", "--arch", ARCH, "--requests", "2", "--device", "cpu"]) == 0
    assert "served 2 requests on cpu" in capsys.readouterr().out


def test_full_width_is_refused_before_allocating(monkeypatch):
    """80 layers of bf16 weights do not fit one 80 GB card: the launcher
    names both byte counts and builds nothing; 24 layers fit."""
    def no_cluster(*a, **k):
        raise AssertionError("a cluster was built")

    assert serve.weight_bytes(get_spec(ARCH).model) == FULL_WEIGHT_BYTES
    monkeypatch.setattr(serve, "build_cluster", no_cluster)
    with pytest.raises(ValueError, match=f"{FULL_WEIGHT_BYTES:,} bytes .* 80,000,000,000 bytes"):
        serve.main(["--real", "--arch", ARCH, "--width", "full", "--device", "cpu"])
    cut = dataclasses.replace(get_spec(ARCH).model, n_layers=24)
    assert serve.weight_bytes(cut) == WEIGHT_BYTES_24


def test_launcher_prints_the_jax_launchers_lines(capsys, monkeypatch):
    """The simulator with internvl2's KV-size model: with the NumPy scorer
    the two launchers print the same lines."""
    argv = ["--arch", ARCH, "--profile", "rag", "--rate", "0.5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jax_serve.main() == 0
    want = capsys.readouterr().out
    assert serve.main(argv + ["--backend", "numpy"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith(f"netkv-full on rag ({ARCH} KV) @ 50%:")
