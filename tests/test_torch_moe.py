"""The port's MoE slice against the JAX package, on the CPU: ``moe_ffn`` and
``moe_with_residual`` (routing, capacity drops, dispatch chunks), then the
configs, KV-size models, smoke models and smoke clusters of the MoE models
(granite-moe-1b-a400m, arctic-480b) and of the dense three registered with
them (phi3-medium-14b, internlm2-20b, smollm-135m), and the launcher.

Inputs come from numpy seeds and cross into each framework as numpy, in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_spec as jax_spec
from repro.models.common import materialise
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params, prefill as jax_prefill
from repro.models.model import state_bytes as jax_state_bytes
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro_torch.configs import get_spec
from repro_torch.launch import serve
from repro_torch.models import (
    decode_step,
    moe_ffn,
    moe_with_residual,
    params_from_jax,
    prefill,
    state_bytes,
)
from repro_torch.models.moe import route, slot_positions
from repro_torch.serving import DisaggregatedCluster, ServeRequest

ATOL = 1e-4       # logits: tests/test_torch_model.py's, for qwen3-14b
MOE_ATOL = 1e-5   # one MoE FFN's output
MOE_ARCHS = ["granite-moe-1b-a400m", "arctic-480b"]
DENSE_ARCHS = ["phi3-medium-14b", "internlm2-20b", "smollm-135m"]
ARCHS = MOE_ARCHS + DENSE_ARCHS


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _moe_case(arch, b, s, chunks, seed):
    """A smoke MoEConfig (with ``chunks`` dispatch chunks), its JAX params
    (arctic's with the dense residual) and a seeded x (B, S, d), each also
    as torch tensors."""
    smoke = jax_spec(arch).smoke
    cfg = dataclasses.replace(smoke.moe, dispatch_chunks=chunks)
    specs = (jmoe.moe_residual_param_specs(smoke.d_model, smoke.d_ff, cfg)
             if cfg.dense_residual else jmoe.moe_param_specs(smoke.d_model, cfg))
    jp = materialise(specs, jax.random.PRNGKey(seed))
    # Rows of unit scale, as the RMS norm hands them to the FFN.
    x = np.random.default_rng(seed).standard_normal((b, s, smoke.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tcfg = get_spec(arch).smoke.moe
    return cfg, dataclasses.replace(tcfg, dispatch_chunks=chunks), jp, tp, x


def _jax_routing(xf, router, cfg):
    """``repro/models/moe.py::_moe_ffn_once``'s routing and kept mask (its
    lines 81-94, which the function does not return): experts (T, k) and
    keep (T*k,)."""
    t = xf.shape[0]
    cap = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), router.astype(jnp.float32))
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat_e = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(expert_idx), np.asarray(pos < cap)


def _port_routing(xf, router, cfg):
    t = xf.shape[0]
    cap = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    _, _, experts = route(xf, router, cfg.top_k)
    pos, _ = slot_positions(experts, cfg.n_experts)
    return experts.numpy(), (pos < cap).numpy()


# (B, S, dispatch chunks): a prefill of two prompts, S divisible by 4 and not,
# and a decode step of 4 slots, where 4 * k slots compete for capacity.
MOE_CASES = {"prefill": (2, 16, 1), "chunks4": (2, 16, 4), "chunks4-ragged": (2, 18, 4),
             "decode4": (4, 1, 1)}


class TestMoEFFN:
    @pytest.mark.parametrize("case", list(MOE_CASES))
    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_equals_jax(self, arch, case):
        """Per dispatch chunk, experts and kept masks exactly JAX's; the
        output within MOE_ATOL and the aux loss within 1e-6, for moe_ffn and
        (arctic) moe_with_residual."""
        b, s, nc = MOE_CASES[case]
        jcfg, tcfg, jp, tp, x = _moe_case(arch, b, s, nc, seed=b * s + nc)
        nc_used = nc if nc > 1 and s % nc == 0 else 1
        dropped = 0
        for xi in np.split(x, nc_used, axis=1):
            xf = xi.reshape(-1, xi.shape[-1])
            je, jk = _jax_routing(jnp.asarray(xf), jp["router"], jcfg)
            te, tk = _port_routing(torch.from_numpy(xf), tp["router"], tcfg)
            np.testing.assert_array_equal(te, je)
            np.testing.assert_array_equal(tk, jk)
            dropped += int((~tk).sum())
        pairs = [(jmoe.moe_ffn, moe_ffn)]
        if jcfg.dense_residual:
            pairs.append((jmoe.moe_with_residual, moe_with_residual))
        for jfn, tfn in pairs:
            jout, jaux = jfn(jnp.asarray(x), jp, jcfg)
            tout, taux = tfn(torch.from_numpy(x), tp, tcfg)
            assert tout.shape == (b, s, x.shape[-1]) and tout.dtype == torch.float32
            np.testing.assert_allclose(_np(tout), _np(jout), atol=MOE_ATOL)
            assert abs(float(taux) - float(jaux)) <= 1e-6
        if case == "decode4":
            # The capacity is shared by the batch: later slots lose theirs.
            assert dropped > 0
        if case == "chunks4-ragged":
            assert nc_used == 1

    def test_chunks_route_each_chunk_with_its_own_capacity(self):
        """Chunked dispatch equals the chunks run one by one."""
        _, tcfg, _, tp, x = _moe_case("granite-moe-1b-a400m", 2, 16, 4, seed=5)
        out, aux = moe_ffn(torch.from_numpy(x), tp, tcfg)
        one = dataclasses.replace(tcfg, dispatch_chunks=1)
        parts = [moe_ffn(torch.from_numpy(xi), tp, one) for xi in np.split(x, 4, axis=1)]
        assert torch.equal(out, torch.cat([o for o, _ in parts], dim=1))
        assert torch.equal(aux, torch.stack([a for _, a in parts]).mean())

    def test_decode_batch_shares_capacity(self):
        """Reference behaviour, copied (ROADMAP §3): at a decode step of 4
        slots the granite smoke MoE gives each expert 2 slots, so a row's
        output depends on the rows before it.  The first row equals the row
        run alone; a later row that lost an expert differs, in the port and
        in JAX alike."""
        jcfg, tcfg, jp, tp, x = _moe_case("granite-moe-1b-a400m", 4, 1, 1, seed=4)
        batch = _np(moe_ffn(torch.from_numpy(x), tp, tcfg)[0])[:, 0]
        alone = np.stack([_np(moe_ffn(torch.from_numpy(x[i:i + 1]), tp, tcfg)[0])[0, 0]
                          for i in range(4)])
        jalone = np.stack([np.asarray(jmoe.moe_ffn(jnp.asarray(x[i:i + 1]), jp, jcfg)[0])[0, 0]
                           for i in range(4)])
        np.testing.assert_allclose(alone, jalone, atol=MOE_ATOL)
        _, keep = _port_routing(torch.from_numpy(x[:, 0]), tp["router"], tcfg)
        lost = ~keep.reshape(4, -1).all(axis=1)
        err = np.abs(batch - alone).max(axis=1)
        assert not lost[0] and lost.any()
        assert err[0] <= 1e-6 and (err[lost] > 1e-4).all(), err

    def test_ties_go_to_the_lower_expert(self):
        """A router with equal columns gives equal probabilities: the lower
        expert index wins, as lax.top_k orders ties."""
        router = torch.zeros((4, 8))
        xf = torch.ones((3, 4))
        _, gates, experts = route(xf, router, 3)
        assert experts.tolist() == [[0, 1, 2]] * 3
        torch.testing.assert_close(gates, torch.full((3, 3), 1 / 3))
        pos, _ = slot_positions(experts, 8)
        assert pos.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_spec(arch).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return arch, jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                                 device="cpu")


@pytest.mark.parametrize("which", ["model", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, which):
    """Every field of the port's ModelConfig equals the JAX one, ``moe``
    field by field (dtypes by name); the encoder and front-end fields are at
    their defaults; ``remat`` (a training option) is compared too."""
    j = getattr(jax_spec(arch), which)
    t = getattr(get_spec(arch), which)
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    for name, value in tf.items():
        if name == "compute_dtype":
            assert str(value).removeprefix("torch.") == jnp.dtype(jf[name]).name
        else:
            assert value == jf[name], name
    assert (t.moe is None) == (arch in DENSE_ARCHS)
    assert set(jf) == set(tf)
    assert (t.n_enc_layers, t.frontend, t.n_prefix_embeds) == (0, None, 0)
    assert get_spec(arch).source == jax_spec(arch).source


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_spec_and_state_bytes(arch):
    assert dataclasses.asdict(get_spec(arch).kv_spec()) == dataclasses.asdict(
        jax_spec(arch).kv_spec())
    for which in ("model", "smoke"):
        jc, tc = getattr(jax_spec(arch), which), getattr(get_spec(arch), which)
        assert tc.n_attn_layers == jc.n_attn_layers
        for seq in (0, 1, 2048, 32768):
            assert state_bytes(tc, seq) == jax_state_bytes(jc, seq)


def test_params_keep_jax_names(setup):
    """Every leaf of the JAX tree is a parameter of the port under its
    dotted path, the MoE leaves under ``layers.f0.moe``."""
    arch, _, _, jp, model = setup
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path) for path, _ in leaves}
    assert set(dict(model.named_parameters())) == want
    if arch in MOE_ARCHS:
        assert "layers.f0.moe.router" in want


def test_smoke_prefill_and_decode(setup):
    """Prefill, then two greedy decode steps: logits within ATOL, greedy
    tokens and the KV cache as JAX's."""
    _, jcfg, _, jp, model = setup
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
    prefix: every ServeResult field equal, and a prefix hit ships less.  The
    decode engines decode all 4 slots, inactive ones too, so for the MoE
    models the batch shares its experts' capacity as in the JAX engine."""
    _, jcfg, tcfg, _, model = setup
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
    sent = [r.transfer_bytes for r in tres]
    assert min(sent) < max(sent)


def test_launcher_serves_granite_smoke(capsys):
    assert serve.model_config("granite-moe-1b-a400m", "smoke") == dataclasses.replace(
        get_spec("granite-moe-1b-a400m").smoke, compute_dtype=torch.float32)
    assert serve.main(["--real", "--arch", "granite-moe-1b-a400m", "--requests", "2",
                       "--device", "cpu"]) == 0
    assert "served 2 requests on cpu" in capsys.readouterr().out


def test_arctic_full_width_is_refused_before_allocating(monkeypatch):
    """arctic-480b's bf16 weights, the 35 x 128 expert stacks counted, do
    not fit one 80 GB card: the launcher names both byte counts and builds
    nothing.  granite's ~2.8 GB fit."""
    def no_cluster(*a, **k):
        raise AssertionError("a cluster was built")

    cfg = get_spec("arctic-480b").model
    experts = cfg.n_layers * 3 * cfg.moe.n_experts * cfg.d_model * cfg.moe.d_expert * 2
    need = serve.weight_bytes(cfg)
    assert experts < need < experts * 1.02
    monkeypatch.setattr(serve, "build_cluster", no_cluster)
    with pytest.raises(ValueError, match=f"{need:,} bytes .* 80,000,000,000 bytes"):
        serve.main(["--real", "--arch", "arctic-480b", "--width", "full", "--device", "cpu"])
    granite = serve.weight_bytes(get_spec("granite-moe-1b-a400m").model)
    assert 2.7e9 < granite < 2.9e9
