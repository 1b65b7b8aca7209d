"""The port's encoder-decoder slice against the JAX package, on the CPU:
cross-attention, the bidirectional and head-expanded attention paths, and
seamless-m4t-medium: its configs and transfer-size model, the smoke model's
``encode``, ``forward_logits``, ``prefill(memory=...)`` and decode, and the
cluster and launcher, which refuse to serve it as the JAX cluster fails to.

Inputs come from numpy seeds and cross into each framework as numpy;
weights come from ``repro.models.init_params`` through ``params_from_jax``.
The JAX package computes cross-attention, the encoder and the head
expansion in XLA; the port's decode runs them through ``ops.flash_decode``,
whose plain version runs here.
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
from repro.models import attention as jattn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import encode as jax_encode
from repro.models.model import forward_logits as jax_forward_logits
from repro.models.model import init_params
from repro.models.model import prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.launch import serve
from repro_torch.models import (
    Model,
    decode_step,
    encode,
    forward_logits,
    make_decode_cache,
    params_from_jax,
    prefill,
    state_bytes,
)
from repro_torch.models import attention
from repro_torch.serving import DisaggregatedCluster, ServeRequest

ARCH = "seamless-m4t-medium"
ATOL = 1e-4            # logits and cache leaves: tests/test_torch_model.py's
F32_RTOL = 1e-5        # attention in f32: x max|ref|
BF16_RTOL = 2.0 ** -6  # the model in bf16: x max|ref|, a few rounding steps
RAGGED = [(6, 4), (3, 2), (5, 3)]   # (H, KV) with H % KV != 0


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_spec(ARCH).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(ARCH).smoke, compute_dtype=torch.float32)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _inputs(jcfg, seed, b=2, s=20, t=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jcfg.vocab_size, (b, s)), _rand(rng, b, t, jcfg.d_model)


class TestAttention:
    @pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), *RAGGED])
    def test_cross_attention(self, h, kv):
        rng = np.random.default_rng(h * 10 + kv)
        q, k, v = _rand(rng, 2, 7, h, 16), _rand(rng, 2, 11, kv, 16), _rand(rng, 2, 11, kv, 16)
        got = attention.cross_attention(*map(torch.from_numpy, (q, k, v)))
        _close(got, jattn.cross_attention(*map(jnp.asarray, (q, k, v))), F32_RTOL)

    @pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), *RAGGED])
    @pytest.mark.parametrize("chunk", [16, 64])
    def test_bidirectional_attention(self, h, kv, chunk):
        """The encoder's attention (causal=False), through the chunk loop
        and in one block."""
        rng = np.random.default_rng(h + kv + chunk)
        q, k, v = _rand(rng, 2, 40, h, 16), _rand(rng, 2, 40, kv, 16), _rand(rng, 2, 40, kv, 16)
        got = attention.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                                 chunk=chunk, causal=False)
        want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                                              causal=False)
        _close(got, want, F32_RTOL)

    @pytest.mark.parametrize("h,kv", RAGGED)
    @pytest.mark.parametrize("chunk", [16, 64])
    def test_head_expanded_causal_attention(self, h, kv, chunk):
        rng = np.random.default_rng(3 * h + kv + chunk)
        q, k, v = _rand(rng, 2, 40, h, 16), _rand(rng, 2, 40, kv, 16), _rand(rng, 2, 40, kv, 16)
        got = attention.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk)
        want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk)
        _close(got, want, F32_RTOL)

    @pytest.mark.parametrize("h,kv", RAGGED)
    def test_head_expanded_decode_attention(self, h, kv):
        """JAX's decode attention against the port's reference and its
        kernel path, which pads the query heads to KV * ceil(H/KV) for K4
        (its plain version here)."""
        rng = np.random.default_rng(h * kv)
        q, k, v = _rand(rng, 2, 1, h, 16), _rand(rng, 2, 48, kv, 16), _rand(rng, 2, 48, kv, 16)
        want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(30))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        _close(attention.decode_attention(tq, tk, tv, 30), want, F32_RTOL)
        got = attention.kernel_decode_attention(tq[:, 0], tk, tv, 30)
        _close(got[:, None], want, F32_RTOL)

    @pytest.mark.parametrize("h,kv", RAGGED)
    def test_gqa_expand_is_tile_and_slice(self, h, kv):
        k = np.arange(2 * 3 * kv * 4, dtype=np.float32).reshape(2, 3, kv, 4)
        np.testing.assert_array_equal(_np(attention._gqa_expand(torch.from_numpy(k), h)),
                                      np.asarray(jattn._gqa_expand(jnp.asarray(k), h)))


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
    assert t.is_enc_dec and j.is_enc_dec and t.frontend == "audio"
    assert get_spec(ARCH).source == jax_spec(ARCH).source == "[arXiv:2308.11596; hf]"


def test_kv_spec_and_state_bytes():
    """Cross K/V do not ship: the transfer-size model counts the decoder's
    self-attention pages only, as JAX's."""
    assert dataclasses.asdict(get_spec(ARCH).kv_spec()) == dataclasses.asdict(
        jax_spec(ARCH).kv_spec())
    for which in ("model", "smoke"):
        jc, tc = getattr(jax_spec(ARCH), which), getattr(get_spec(ARCH), which)
        assert tc.n_attn_layers == jc.n_attn_layers
        for seq in (0, 1, 2048, 32768):
            assert state_bytes(tc, seq) == jax_state_bytes(jc, seq)
    assert get_spec(ARCH).kv_spec().kv_bytes_per_token == 2 * 12 * 16 * 64 * 2


def test_params_round_trip_the_encoder_and_cross_trees(setup):
    """Every leaf of the JAX tree, ``enc_layers``, ``enc_norm`` and
    ``cross_layers`` included, is a parameter of the port under its dotted
    path, with the JAX values."""
    _, _, jp, model = setup
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path): np.asarray(x) for path, x in leaves}
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert {"enc_norm", "enc_layers.b0.wq", "enc_layers.f0.down",
            "cross_layers.c0.wk"} <= set(got)
    for name, t in got.items():
        np.testing.assert_array_equal(_np(t), want[name])


def test_full_width_param_count():
    """977,758,208 parameters (~1.96 GB in bf16): decoder, encoder, cross
    blocks, embedding and head."""
    from repro.models.model import param_specs as jax_param_specs
    from repro_torch.models import param_specs

    specs = param_specs(get_spec(ARCH).model)
    assert sum(int(np.prod(s.shape)) for s in specs.values()) == 977_758_208
    jspecs = jax.tree_util.tree_flatten_with_path(
        jax_param_specs(jax_spec(ARCH).model), is_leaf=lambda x: hasattr(x, "kind"))[0]
    assert {".".join(k.key for k in path): s.shape for path, s in jspecs} == {
        name: s.shape for name, s in specs.items()}
    assert serve.weight_bytes(get_spec(ARCH).model) == 1_955_520_512


def test_encode(setup):
    jcfg, _, jp, model = setup
    _, frames = _inputs(jcfg, 1)
    _close(encode(model, torch.from_numpy(frames)), jax_encode(jcfg, jp, jnp.asarray(frames)),
           ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_logits(setup, causal):
    jcfg, _, jp, model = setup
    toks, frames = _inputs(jcfg, 2)
    jmem = jax_encode(jcfg, jp, jnp.asarray(frames))
    want, _ = jax_forward_logits(jcfg, jp, jnp.asarray(toks, jnp.int32), memory=jmem,
                                 causal=causal)
    got = forward_logits(model, torch.from_numpy(toks),
                         memory=encode(model, torch.from_numpy(frames)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


def test_prefill_logits_and_every_cache_leaf(setup):
    jcfg, _, jp, model = setup
    toks, frames = _inputs(jcfg, 3)
    jmem = jax_encode(jcfg, jp, jnp.asarray(frames))
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), memory=jmem, cache_len=32)
    tl, tc = prefill(model, torch.from_numpy(toks),
                     memory=encode(model, torch.from_numpy(frames)), cache_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    assert set(tc) == set(jc) == {"k0", "v0", "ck0", "cv0", "cross_memory", "pos"}
    assert tc["pos"] == int(jc["pos"]) == 20
    for leaf in ("k0", "v0", "ck0", "cv0", "cross_memory"):
        assert tuple(tc[leaf].shape) == jc[leaf].shape, leaf
        np.testing.assert_allclose(_np(tc[leaf]), _np(jc[leaf]), atol=ATOL, err_msg=leaf)


def test_prefill_without_memory_has_no_cross_leaves(setup):
    """As JAX's: no ``ck``/``cv`` without a memory, so a decode step fails
    on the missing leaf in both packages."""
    jcfg, _, jp, model = setup
    toks, _ = _inputs(jcfg, 4)
    _, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=32)
    _, tc = prefill(model, torch.from_numpy(toks), cache_len=32)
    assert set(tc) == set(jc) == {"k0", "v0", "pos"}
    with pytest.raises(KeyError, match="ck0"):
        decode_step(model, torch.from_numpy(toks[:, :1]), tc)


def test_decode_steps_against_jax_and_forward_logits(setup):
    """Two greedy decode steps: logits within ATOL of JAX's decode_step,
    tokens equal, and each step's logits those of the port's own
    forward_logits at that position (tests/test_models.py's parity)."""
    jcfg, _, jp, model = setup
    toks, frames = _inputs(jcfg, 5, s=24)
    jmem = jax_encode(jcfg, jp, jnp.asarray(frames))
    mem = encode(model, torch.from_numpy(frames))
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), memory=jmem, cache_len=32)
    tl, tc = prefill(model, torch.from_numpy(toks), memory=mem, cache_len=32)
    seq = torch.from_numpy(toks)
    for _ in range(2):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        seq = torch.cat([seq, tt], dim=1)
        jl, jc = jax_decode_step(jcfg, jp, jt, jc)
        tl, tc = decode_step(model, tt, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        full = forward_logits(model, seq, memory=mem)
        np.testing.assert_allclose(_np(tl[:, 0]), _np(full[:, -1]), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == 26
    for leaf in ("k0", "v0", "ck0", "cv0"):
        np.testing.assert_allclose(_np(tc[leaf]), _np(jc[leaf]), atol=ATOL, err_msg=leaf)


@pytest.mark.parametrize("h,kv", [(6, 4), (5, 3)])
def test_head_expanded_encoder_decoder(h, kv):
    """The seamless smoke model with H % KV != 0 (no registered config has
    it): encode, prefill and two decode steps against JAX."""
    jcfg = dataclasses.replace(jax_spec(ARCH).smoke, compute_dtype=jnp.float32,
                               n_heads=h, n_kv_heads=kv)
    tcfg = dataclasses.replace(get_spec(ARCH).smoke, compute_dtype=torch.float32,
                               n_heads=h, n_kv_heads=kv)
    jp = init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, frames = _inputs(jcfg, 6)
    jmem = jax_encode(jcfg, jp, jnp.asarray(frames))
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), memory=jmem, cache_len=32)
    tl, tc = prefill(model, torch.from_numpy(toks),
                     memory=encode(model, torch.from_numpy(frames)), cache_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for _ in range(2):
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        jl, jc = jax_decode_step(jcfg, jp, jt, jc)
        tl, tc = decode_step(model, tt, tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)


def test_bf16_within_a_few_rounding_steps():
    """The smoke model in bf16 (JAX keeps f32 parameters and casts; the
    port stores the cast): memory, prefill logits and two decode steps'
    logits within 2^-6 of the largest."""
    jcfg = jax_spec(ARCH).smoke
    tcfg = get_spec(ARCH).smoke
    assert tcfg.compute_dtype == torch.bfloat16
    jp = init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, frames = _inputs(jcfg, 7)
    jmem = jax_encode(jcfg, jp, jnp.asarray(frames))
    mem = encode(model, torch.from_numpy(frames))
    _close(mem, jmem, BF16_RTOL)
    jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), memory=jmem, cache_len=32)
    tl, tc = prefill(model, torch.from_numpy(toks), memory=mem, cache_len=32)
    _close(tl, jl, BF16_RTOL)
    tok = toks[:, -1:]
    for _ in range(2):
        jl, jc = jax_decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = decode_step(model, torch.from_numpy(tok), tc)
        _close(tl, jl, BF16_RTOL)


def test_decode_cache_layout():
    cfg = get_spec(ARCH).model
    cache = make_decode_cache(cfg, 4, 16, "cpu", enc_len=8)
    assert set(cache) == {"k0", "v0", "ck0", "cv0", "pos"}
    assert tuple(cache["ck0"].shape) == (12, 4, 8, 16, 64)
    assert tuple(make_decode_cache(cfg, 1, 16, "cpu")["ck0"].shape) == (12, 1, 0, 16, 64)
    assert set(make_decode_cache(cfg, 1, 16, "cpu", enc_len=None)) == {"k0", "v0", "pos"}


def test_clusters_refuse_the_encoder_decoder(setup, monkeypatch):
    """The JAX cluster builds, then fails at ``serve``: its prefill caches
    no cross K/V and its decode engine's cache has them (ROADMAP §3 item
    7).  The port's refuses before it allocates anything."""
    jcfg, tcfg, _, model = setup
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, 24)
    with pytest.raises(KeyError, match="ck0"):
        JaxCluster(jcfg, scheduler="netkv-full", cache_len=64).serve(
            [JaxRequest(0, toks, 8, 0.0)])

    def no_device(*a, **k):
        raise AssertionError("a device was resolved")

    import repro_torch.serving.cluster as cluster

    monkeypatch.setattr(cluster, "resolve_device", no_device)
    for params in (None, model):
        with pytest.raises(ValueError, match="ROADMAP §3 item 7"):
            DisaggregatedCluster(tcfg, params=params, device="cpu")
    assert ServeRequest(0, toks, 8).max_new == 8


def test_launcher_refuses_to_serve_it(capsys):
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--real", "--arch", ARCH, "--requests", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--real", "--arch", ARCH, "--width", "full", "--device", "cpu"])


def test_launcher_prints_the_jax_launchers_lines(capsys, monkeypatch):
    """The simulator with seamless's KV-size model: with the NumPy scorer
    the two launchers print the same lines."""
    argv = ["--arch", ARCH, "--profile", "chatbot", "--rate", "0.5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jax_serve.main() == 0
    want = capsys.readouterr().out
    assert serve.main(argv + ["--backend", "numpy"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith(f"netkv-full on chatbot ({ARCH} KV) @ 50%:")
