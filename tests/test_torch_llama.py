"""llama3-70b, the paper's model, in the port against the JAX package: its
config field by field, its KV-size model, the smoke model's prefill and
decode, the smoke cluster field by field, and the launcher, whose default
it is in both packages."""

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
from repro.models.model import init_params, prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.core.cost import LLAMA3_70B_KV
from repro_torch.launch import serve
from repro_torch.models import decode_step, params_from_jax, prefill, state_bytes
from repro_torch.serving import DisaggregatedCluster, ServeRequest

ATOL = 1e-4   # tests/test_torch_model.py's, for qwen3-14b
ARCH = "llama3-70b"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_spec(ARCH).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(ARCH).smoke, compute_dtype=torch.float32)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_config_equals_jax(which):
    """Every field of the port's ModelConfig equals the JAX one (dtypes by
    name; ``moe`` None on both sides); the encoder and front-end fields are
    at their defaults; ``remat`` (a training option) is compared too."""
    j = getattr(jax_spec(ARCH), which)
    t = getattr(get_spec(ARCH), which)
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    for name, value in tf.items():
        if name == "compute_dtype":
            assert str(value).removeprefix("torch.") == jnp.dtype(jf[name]).name
        else:
            assert value == jf[name], name
    assert set(jf) == set(tf)
    assert t.moe is None and j.moe is None
    assert (t.n_enc_layers, t.frontend, t.n_prefix_embeds) == (0, None, 0)
    assert get_spec(ARCH).source == jax_spec(ARCH).source == "[arXiv:2407.21783; hf]"


def test_kv_spec_and_state_bytes():
    kv = get_spec(ARCH).kv_spec()
    assert dataclasses.asdict(kv) == dataclasses.asdict(jax_spec(ARCH).kv_spec())
    assert kv.kv_bytes_per_token == LLAMA3_70B_KV.kv_bytes_per_token == 327_680
    assert kv.tp == LLAMA3_70B_KV.tp and kv.kv_bytes(8192) == LLAMA3_70B_KV.kv_bytes(8192)
    for which in ("model", "smoke"):
        jc, tc = getattr(jax_spec(ARCH), which), getattr(get_spec(ARCH), which)
        for seq in (0, 1, 2048, 32768):
            assert state_bytes(tc, seq) == jax_state_bytes(jc, seq)


def test_smoke_prefill_and_decode(setup):
    """Prefill, then two greedy decode steps: logits within ATOL, greedy
    tokens and the KV cache as JAX's."""
    jcfg, _, jp, model = setup
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 20))
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=64)
    tl, tc = prefill(model, torch.from_numpy(toks), cache_len=64)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for _ in range(2):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        jl, jc = jax_decode_step(jcfg, jp, jt, jc)
        tl, tc = decode_step(model, tt, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == 22
    np.testing.assert_allclose(_np(tc["k0"]), _np(jc["k0"]), atol=ATOL)


def test_smoke_cluster_equals_jax(setup):
    """examples/serve_netkv.py's workload, the even requests sharing a
    prefix: every ServeResult field equal."""
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


@pytest.mark.parametrize("argv", [["--profile", "chatbot", "--rate", "0.3"],
                                  ["--profile", "rag", "--rate", "0.5", "--faults"]])
def test_launcher_prints_the_jax_launchers_lines(argv, capsys, monkeypatch):
    """With the NumPy scorer the two launchers run the same simulation of
    the same default model and print the same lines."""
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jax_serve.main() == 0
    want = capsys.readouterr().out
    assert serve.main(argv + ["--backend", "numpy", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith(f"netkv-full on {argv[1]} ({ARCH} KV) @ ")


def test_launcher_numpy_backend_needs_no_card(capsys):
    """``--backend numpy`` scores on the host: no device is resolved, so it
    runs where there is no card (and on one)."""
    assert serve.main(["--profile", "chatbot", "--rate", "0.3", "--backend", "numpy"]) == 0
    assert f"({ARCH} KV) @ 30%:" in capsys.readouterr().out


def test_full_width_is_refused_before_allocating(monkeypatch):
    """~141 GB of bf16 weights do not fit one 80 GB card: the launcher
    names both byte counts and builds nothing."""
    def no_cluster(*a, **k):
        raise AssertionError("a cluster was built")

    monkeypatch.setattr(serve, "build_cluster", no_cluster)
    with pytest.raises(ValueError, match=r"141,107,429,376 bytes .* 80,000,000,000 bytes"):
        serve.main(["--real", "--width", "full", "--device", "cpu"])
    assert serve.weight_bytes(get_spec(ARCH).model) == 141_107_429_376
    assert serve.weight_bytes(get_spec("qwen3-14b").model) < serve.CPU_CARD_BYTES


def test_real_smoke_serves_the_llama_smoke_config(capsys):
    assert serve.model_config(ARCH, "smoke") == dataclasses.replace(
        get_spec(ARCH).smoke, compute_dtype=torch.float32)
    assert serve.main(["--real", "--requests", "2", "--device", "cpu"]) == 0
    assert "served 2 requests on cpu" in capsys.readouterr().out
