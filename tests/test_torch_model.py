"""The port's dense model against the JAX package's, at the qwen3-14b smoke
size in f32, with weights converted from ``repro.models.init_params``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jax_spec
from repro.models import common as jcommon
from repro.models import attention as jattn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params, prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro_torch.configs import get_spec
from repro_torch.models import (
    Model,
    decode_step,
    init_random_,
    make_decode_cache,
    params_from_jax,
    prefill,
    state_bytes,
)
from repro_torch.models import attention, common

ATOL = 1e-4


@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(jax_spec("qwen3-14b").smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec("qwen3-14b").smoke, compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class TestComponents:
    def test_rms_norm_rope_swiglu(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        np.testing.assert_allclose(
            _np(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
            _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-6)
        pos = np.arange(5)[None, :] + 100
        np.testing.assert_allclose(
            _np(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
            _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), atol=1e-5)
        w = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((16, 32), (16, 32), (32, 16))]
        np.testing.assert_allclose(
            _np(common.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w))),
            _np(jcommon.swiglu(jnp.asarray(x), *map(jnp.asarray, w))), atol=1e-5)

    @pytest.mark.parametrize("h,kv,chunk", [(8, 2, 16), (8, 2, 64), (6, 3, 16)])
    def test_chunked_causal_attention(self, h, kv, chunk):
        """Grouped GQA, through the chunk loop and in one block."""
        rng = np.random.default_rng(h * kv + chunk)
        q = rng.standard_normal((2, 40, h, 16)).astype(np.float32)
        k = rng.standard_normal((2, 40, kv, 16)).astype(np.float32)
        v = rng.standard_normal((2, 40, kv, 16)).astype(np.float32)
        got = attention.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), chunk=chunk)
        want = jattn.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk=chunk)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)

    @pytest.mark.parametrize("h,kv", [(8, 2), (10, 2)])
    def test_decode_attention(self, h, kv):
        rng = np.random.default_rng(h + kv)
        q = rng.standard_normal((2, 1, h, 16)).astype(np.float32)
        k = rng.standard_normal((2, 48, kv, 16)).astype(np.float32)
        v = rng.standard_normal((2, 48, kv, 16)).astype(np.float32)
        got = attention.decode_attention(*map(torch.from_numpy, (q, k, v)), 30)
        want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(30))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


class TestModel:
    def test_params_keep_jax_names_and_layouts(self, cfgs, params):
        jp, model = params
        names = dict(model.named_parameters())
        assert set(names) == {"embed", "out_norm", "lm_head"} | {
            f"layers.{blk}.{leaf}" for blk in jp["layers"] for leaf in jp["layers"][blk]}
        for name, t in names.items():
            node = jp
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(_np(t), np.asarray(node))

    def test_prefill_logits_and_cache(self, cfgs, params):
        jcfg, _ = cfgs
        jp, model = params
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 20))
        jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=64)
        tl, tc = prefill(model, torch.from_numpy(toks), cache_len=64)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        assert tc["pos"] == int(jc["pos"]) == 20
        for leaf in ("k0", "v0"):
            assert tuple(tc[leaf].shape) == jc[leaf].shape
            np.testing.assert_allclose(_np(tc[leaf]), _np(jc[leaf]), atol=ATOL)

    def test_decode_steps_and_greedy_tokens(self, cfgs, params):
        """Six greedy steps: logits within atol, tokens exact."""
        jcfg, _ = cfgs
        jp, model = params
        toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
        jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=64)
        tl, tc = prefill(model, torch.from_numpy(toks), cache_len=64)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        for _ in range(6):
            np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
            jl, jc = jax_decode_step(jcfg, jp, jt, jc)
            tl, tc = decode_step(model, tt, tc)
            np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
            jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        assert tc["pos"] == int(jc["pos"]) == 30
        np.testing.assert_allclose(_np(tc["k0"]), _np(jc["k0"]), atol=ATOL)

    def test_state_bytes(self, cfgs):
        jcfg, tcfg = cfgs
        full_j, full_t = jax_spec("qwen3-14b").model, get_spec("qwen3-14b").model
        for seq in (0, 1, 2048, 32768):
            assert state_bytes(tcfg, seq) == jax_state_bytes(jcfg, seq)
            assert state_bytes(full_t, seq) == jax_state_bytes(full_j, seq)
        assert dataclasses.asdict(get_spec("qwen3-14b").kv_spec()) == \
            dataclasses.asdict(jax_spec("qwen3-14b").kv_spec())

    def test_decode_cache_layout(self, cfgs):
        _, tcfg = cfgs
        cache = make_decode_cache(tcfg, 3, 32, "cpu")
        assert tuple(cache["k0"].shape) == (4, 3, 32, 2, 16) and cache["pos"] == 0

    def test_unported_block_kinds_raise(self, cfgs):
        """Every block kind and head ratio JAX builds, the port builds:
        Mamba blocks (tests/test_torch_ssm.py holds them to JAX), attention
        whose heads do not group over the KV heads (the head-expanded path,
        held to JAX in tests/test_torch_encdec.py and test_torch_vision.py),
        and the encoder-decoder, whose config the port registers."""
        _, tcfg = cfgs
        mamba = dataclasses.replace(tcfg, block_pattern=("mamba",), ffn_pattern=("none",))
        assert "b0.in_proj" in dict(Model(mamba, device="cpu").layers.named_parameters())
        ragged = dataclasses.replace(tcfg, n_kv_heads=3)
        model = init_random_(Model(ragged, device="cpu"), 0)
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 9)))
        logits, cache = prefill(model, toks, cache_len=16)
        logits, cache = decode_step(model, toks[:, :1], cache)
        assert bool(torch.isfinite(logits).all()) and cache["pos"] == 10
        assert tuple(cache["k0"].shape) == (4, 2, 16, 3, 16)
        spec = get_spec("seamless-m4t-medium")
        assert spec.model.is_enc_dec and spec.arch_id == "seamless-m4t-medium"

    def test_random_init_is_seeded(self, cfgs):
        from repro_torch.models import init_random_

        _, tcfg = cfgs
        a = init_random_(Model(tcfg, device="cpu"), 3)
        b = init_random_(Model(tcfg, device="cpu"), 3)
        for (na, ta), (_, tb) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(ta, tb), na
        assert float(a.layers["b0"]["wq"].std()) == pytest.approx(0.02, rel=0.1)
        assert torch.all(a.out_norm == 1)
