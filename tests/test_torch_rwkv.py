"""The port's RWKV-6 slice against the JAX package's, on the CPU: the WKV-6
scan's plain version, the time and channel mixes, the rwkv6 smoke model's
prefill and decode, its serving cluster field by field, and the transfer-
size model of rwkv6-3b.

Inputs come from numpy seeds and cross into each framework as numpy.  The
JAX side runs its Pallas ``rwkv_scan`` in interpret mode through
``repro.kernels.ops``.  The CUDA kernel is held to the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro.models.rwkv as jrwkv
from repro.configs import get_spec as jax_spec
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params, prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.kernels import ops, ref
from repro_torch.models import (
    Model,
    decode_step,
    init_random_,
    make_decode_cache,
    params_from_jax,
    prefill,
    rwkv_channel_mix,
    rwkv_channel_mix_step,
    rwkv_param_specs,
    rwkv_time_mix,
    rwkv_time_mix_step,
    state_bytes,
)
from repro_torch.serving import DisaggregatedCluster, ServeRequest

# Logits and states: the ATOL of test_torch_model.py; the scan: the atol
# tests/test_kernels.py holds the Pallas kernel to.
ATOL = 1e-4
SMOKE_STATE_BYTES = 101_376      # 3 x (2*64*64*4 + 2*128*4): f32 smoke state
FULL_STATE_BYTES = 21_299_200    # 32 x (40*64*64*4 + 2*2560*2): rwkv6-3b


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _scan_inputs(b, t, h, dh, seed):
    """tests/test_kernels.py's distributions: r, k, v, u ~ 0.3 N(0, 1), w in
    (0.45, 0.95)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((b, t, h, dh)))) + 0.45).astype(np.float32)
    u = 0.3 * rng.standard_normal((h, dh)).astype(np.float32)
    return r, k, v, w, u


class TestScan:
    @pytest.mark.parametrize("b,t,h,dh,chunk", [
        (1, 128, 2, 64, 64), (2, 256, 3, 64, 128), (1, 512, 1, 128, 128),
    ])
    def test_matches_jax_ref_and_pallas(self, b, t, h, dh, chunk):
        x = _scan_inputs(b, t, h, dh, seed=t + h)
        y, s = ops.rwkv_scan(*map(torch.from_numpy, x))
        jy, js = jref.rwkv_scan_ref(*map(jnp.asarray, x))
        py, ps = jops.rwkv_scan(*map(jnp.asarray, x), chunk=chunk)
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        assert tuple(s.shape) == (b, h, dh, dh)
        for want_y, want_s in ((jy, js), (py, ps)):
            np.testing.assert_allclose(_np(y), _np(want_y), atol=ATOL)
            np.testing.assert_allclose(_np(s), _np(want_s), atol=ATOL)

    @pytest.mark.parametrize("b,t,h,dh", [(2, 24, 2, 64), (1, 77, 3, 32), (1, 1, 1, 128)])
    def test_ragged_t_matches_jax_ref(self, b, t, h, dh):
        """T that is no multiple of any chunk: the Pallas kernel refuses it,
        the port's scan (and its CUDA kernel) takes it."""
        x = _scan_inputs(b, t, h, dh, seed=7 * t)
        y, s = ops.rwkv_scan(*map(torch.from_numpy, x))
        jy, js = jref.rwkv_scan_ref(*map(jnp.asarray, x))
        np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL)
        np.testing.assert_allclose(_np(s), _np(js), atol=ATOL)

    def test_bf16_inputs_give_bf16_y_and_f32_state(self):
        """Both upcast to f32 and round y once to bf16, so they may differ by
        one rounding step of the output (rtol 2^-7) where the f32 sums
        straddle a rounding boundary."""
        x = _scan_inputs(1, 40, 2, 64, seed=3)
        tx = [torch.from_numpy(a).bfloat16() for a in x]
        y, s = ops.rwkv_scan(*tx)
        jy, js = jref.rwkv_scan_ref(*(jnp.asarray(a, jnp.bfloat16) for a in x))
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
        np.testing.assert_allclose(_np(y), _np(jy), rtol=2.0 ** -7, atol=1e-5)
        np.testing.assert_allclose(_np(s), _np(js), atol=ATOL)

    def test_plain_version_is_the_cpu_route(self):
        x = [torch.from_numpy(a) for a in _scan_inputs(1, 9, 2, 16, seed=0)]
        for got, want in zip(ops.rwkv_scan(*x), ref.rwkv_scan_ref(*x)):
            assert torch.equal(got, want)


# ------------------------------------------------------------------ blocks
D, D_FF = 128, 256


def _block_params(seed):
    """One layer's parameters from a numpy seed, the zero-initialised LoRA
    and decay leaves drawn too so every path is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in rwkv_param_specs(D, D_FF).items():
        if name == "ln_x":
            a = rng.uniform(0.5, 1.5, spec.shape)
        elif name == "decay_base":
            a = rng.uniform(-3.0, 0.5, spec.shape)
        else:
            a = 0.05 * rng.standard_normal(spec.shape)
        out[name] = a.astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


class TestBlocks:
    def test_time_mix(self):
        jp, tp = _both(_block_params(0))
        x = np.random.default_rng(1).standard_normal((2, 13, D)).astype(np.float32)
        jout, (jwkv, jlast) = jrwkv.rwkv_time_mix(jp, jnp.asarray(x))
        tout, (twkv, tlast) = rwkv_time_mix(tp, torch.from_numpy(x))
        np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
        np.testing.assert_allclose(_np(twkv), _np(jwkv), atol=ATOL)
        np.testing.assert_array_equal(_np(tlast), _np(jlast))

    def test_time_mix_step(self):
        jp, tp = _both(_block_params(2))
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 1, D)).astype(np.float32)
        wkv = 0.3 * rng.standard_normal((3, D // 64, 64, 64)).astype(np.float32)
        prev = rng.standard_normal((3, D)).astype(np.float32)
        jout, jwkv, jlast = jrwkv.rwkv_time_mix_step(jp, *map(jnp.asarray, (x, wkv, prev)))
        tout, twkv, tlast = rwkv_time_mix_step(tp, *map(torch.from_numpy, (x, wkv, prev)))
        np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
        np.testing.assert_allclose(_np(twkv), _np(jwkv), atol=ATOL)
        np.testing.assert_array_equal(_np(tlast), _np(jlast))

    def test_channel_mix_and_step(self):
        jp, tp = _both(_block_params(4))
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 11, D)).astype(np.float32)
        jout, jlast = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x))
        tout, tlast = rwkv_channel_mix(tp, torch.from_numpy(x))
        np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
        np.testing.assert_array_equal(_np(tlast), _np(jlast))
        prev = rng.standard_normal((2, D)).astype(np.float32)
        jout, jlast = jrwkv.rwkv_channel_mix_step(jp, jnp.asarray(x[:, :1]), jnp.asarray(prev))
        tout, tlast = rwkv_channel_mix_step(tp, torch.from_numpy(x[:, :1]), torch.from_numpy(prev))
        np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
        np.testing.assert_array_equal(_np(tlast), _np(jlast))


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(jax_spec("rwkv6-3b").smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec("rwkv6-3b").smoke, compute_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def perturbed(cfgs):
    """JAX init with ``mu_lora_b``, ``decay_base`` and ``decay_lora_b`` (zero
    there) overwritten by small seeded values, so that the decay varies and
    the LoRA paths carry weight; the same tree goes to both packages."""
    jcfg, tcfg = cfgs
    tree = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    b0 = tree["layers"]["b0"]
    b0["mu_lora_b"] = (0.05 * rng.standard_normal(b0["mu_lora_b"].shape)).astype(np.float32)
    b0["decay_lora_b"] = (0.05 * rng.standard_normal(b0["decay_lora_b"].shape)).astype(np.float32)
    b0["decay_base"] = rng.uniform(-3.0, 0.5, b0["decay_base"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


class TestModel:
    def test_params_keep_jax_names_and_layouts(self, cfgs, perturbed):
        jp, model = perturbed
        names = dict(model.named_parameters())
        assert set(names) == {"embed", "out_norm", "lm_head"} | {
            f"layers.b0.{leaf}" for leaf in jp["layers"]["b0"]}
        assert set(jp["layers"]) == {"b0"} and "f0" not in model.layers
        for name, t in names.items():
            node = jp
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(_np(t), np.asarray(node))

    def test_prefill_and_two_decode_steps(self, cfgs, perturbed):
        jcfg, _ = cfgs
        jp, model = perturbed
        toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
        jl, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32))
        tl, tc = prefill(model, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
        assert tc["pos"] == int(jc["pos"]) == 24
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        for _ in range(2):
            np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
            for leaf in ("wkv0", "sa0", "sc0"):
                assert tuple(tc[leaf].shape) == jc[leaf].shape
                assert str(tc[leaf].dtype).split(".")[-1] == str(jc[leaf].dtype)
                np.testing.assert_allclose(_np(tc[leaf]), _np(jc[leaf]), atol=ATOL)
            jl, jc = jax_decode_step(jcfg, jp, jt, jc)
            tl, tc = decode_step(model, tt, tc)
            np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
            jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
            tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        assert tc["pos"] == int(jc["pos"]) == 26

    def test_decode_cache_layout(self, cfgs):
        _, tcfg = cfgs
        cache = make_decode_cache(tcfg, 3, 32, "cpu")
        assert set(cache) == {"wkv0", "sa0", "sc0", "pos"} and cache["pos"] == 0
        assert tuple(cache["wkv0"].shape) == (3, 3, 2, 64, 64)
        assert cache["wkv0"].dtype == torch.float32
        assert tuple(cache["sa0"].shape) == tuple(cache["sc0"].shape) == (3, 3, 128)

    def test_unported_periods_still_raise(self, cfgs):
        """The three periods once unported build, the RWKV position's FFN
        dropped as JAX drops it; with 3 heads over 2 KV heads, once
        unported too, the two with an attention position build and run a
        prefill and a decode step on the head-expanded path."""
        _, tcfg = cfgs
        for blocks, ffns in ((("mamba",), ("none",)), (("rwkv",), ("dense",)),
                             (("attn", "rwkv"), ("dense", "none"))):
            cfg = dataclasses.replace(tcfg, block_pattern=blocks, ffn_pattern=ffns,
                                      n_layers=2 * len(blocks))
            names = dict(Model(cfg, device="cpu").named_parameters())
            dropped = tuple(f"layers.f{j}." for j, b in enumerate(blocks) if b == "rwkv")
            assert not any(n.startswith(dropped) for n in names)
            bad = dataclasses.replace(cfg, n_heads=3, n_kv_heads=2)
            model = init_random_(Model(bad, device="cpu"), 0)
            if "attn" in blocks:
                toks = torch.from_numpy(np.arange(10).reshape(2, 5))
                logits, cache = decode_step(model, toks[:, :1], prefill(model, toks, cache_len=8)[1])
                assert bool(torch.isfinite(logits).all()) and cache["pos"] == 6

    @pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-14b"])
    def test_state_bytes_and_kv_spec_equal_jax(self, arch):
        jspec, tspec = jax_spec(arch), get_spec(arch)
        for jm, tm in ((jspec.model, tspec.model), (jspec.smoke, tspec.smoke)):
            assert tm.is_attention_free == jm.is_attention_free
            assert tm.n_attn_layers == jm.n_attn_layers
            for seq in (0, 1, 24, 2048, 32768):
                assert state_bytes(tm, seq) == jax_state_bytes(jm, seq)
        assert dataclasses.asdict(tspec.kv_spec()) == dataclasses.asdict(jspec.kv_spec())
        if arch == "rwkv6-3b":
            kv = tspec.kv_spec()
            assert kv.n_attn_layers == 0 and kv.kv_bytes_per_token == 0
            assert kv.kv_bytes(2048) == kv.fixed_state_bytes == FULL_STATE_BYTES

    def test_full_width_config_copies_jax(self):
        jm, tm = jax_spec("rwkv6-3b").model, get_spec("rwkv6-3b").model
        for f in ("name", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "vocab_size", "block_pattern", "ffn_pattern", "norm_eps"):
            assert getattr(tm, f) == getattr(jm, f), f
        assert tm.compute_dtype == torch.bfloat16 and jm.compute_dtype == jnp.bfloat16


# ----------------------------------------------------------------- serving
def _prefix_workload(vocab):
    """6 requests of 24 tokens, the even ones sharing a 16-token prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, size=16)
    return [(i, np.concatenate([shared, rng.integers(0, vocab, 8)]) if i % 2 == 0
             else rng.integers(0, vocab, size=24), 8, i * 0.05) for i in range(6)]


@pytest.fixture(scope="module")
def served(cfgs):
    """The JAX cluster and the port's cluster on one set of weights; the
    port's decisions record the chosen instance's prefix-hit tokens and the
    bytes Eq. (2) priced."""
    jcfg, tcfg = cfgs
    workload = _prefix_workload(jcfg.vocab_size)
    jres = JaxCluster(jcfg, scheduler="netkv-full", cache_len=64).serve(
        [JaxRequest(*a) for a in workload])
    model = params_from_jax(jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0))),
                            tcfg, device="cpu")
    cluster = DisaggregatedCluster(tcfg, scheduler="netkv-full", cache_len=64, params=model,
                                   device="cpu")
    hits = []
    select = cluster.sched.select

    def recorded(req, prefill_id, cv, view, inflight):
        dec = select(req, prefill_id, cv, view, inflight)
        hits.append((float(cv.hit_tokens[cv.slot_of(dec.instance_id)]), dec.s_eff))
        return dec

    cluster.sched.select = recorded
    tres = cluster.serve([ServeRequest(*a) for a in workload])
    return jres, tres, hits


class TestCluster:
    def test_every_field_equals_jax(self, served):
        jres, tres, _ = served
        assert len(tres) == len(jres) == 6
        for j, t in zip(jres, tres):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert len(t.tokens) == 8

    def test_prefix_hit_is_priced_but_the_state_ships_whole(self, served):
        """The decision sees a 16-token hit on the instance that served the
        shared prefix and Eq. (2) prices s_eff = s_r (1 - 16/24), yet the
        fixed state ships whole: every request moves the same bytes
        (ROADMAP §3)."""
        _, tres, hits = served
        assert [r.transfer_bytes for r in tres] == [SMOKE_STATE_BYTES] * 6
        hit_rows = [(h, s_eff) for h, s_eff in hits if h > 0]
        assert hit_rows and all(h == 16.0 for h, _ in hit_rows)
        for _, s_eff in hit_rows:
            assert s_eff == pytest.approx(SMOKE_STATE_BYTES * (1 - 16 / 24))
        assert all(h == 0.0 for r, (h, _) in zip(tres, hits) if r.request_id % 2)

    def test_launcher_serves_and_simulates_rwkv(self, capsys):
        from repro_torch.launch import serve

        assert serve.main(["--real", "--arch", "rwkv6-3b", "--requests", "2",
                           "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "served 2 requests on cpu" in out and "xfer=101KB" in out
        assert serve.main(["--arch", "rwkv6-3b", "--profile", "chatbot", "--rate", "0.3",
                           "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "netkv-full on chatbot (rwkv6-3b KV) @ 30%:" in out and "TTFT mean=" in out
