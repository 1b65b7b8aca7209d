"""The published Jamba block in the port against the benchmark's plain
reference (``netkv_bench/reference/jamba.py``, loaded by its path), on
seeded random weights in float32 at a smoke size: d 128, 8 experts top 2.

The port runs the block through ``configs/jamba_v01_52b.py::published``:
attention with no RoPE, the Mamba mixers' dt/B/C norms, top-k gates left
unnormalised and a capacity of every token.  Prefill's logits and each
decode step's through the cache match the reference's full forward; with
any one of the four mechanisms turned back to JAX's block the same
comparison fails; at ``capacity_factor`` = E / k the dispatch is a plain
top-k that drops nothing.

This file imports no JAX: the reference is plain torch.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_spec
from repro_torch.configs.jamba_v01_52b import published
from repro_torch.models import Model
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.moe import MoEConfig, moe_ffn

BENCH = Path(__file__).resolve().parent.parent / "netkv_bench"
N_PROMPT = 37            # no multiple of 8: one dispatch group of 37 tokens
N_DECODE = 6
# Both sides compute in float32 from the same tensors; they sum in other
# orders (the port's scan reads each block of 256 steps out at once, its MoE
# combines a token's k terms in turn, the reference adds expert by expert),
# which moves logits of scale ~3 by ~1e-5 (1.3e-5 measured).  Any one
# mechanism turned off moves them by 0.19 and more.
TOL = dict(rtol=1e-4, atol=1e-4)


def _reference():
    if str(BENCH) not in sys.path:      # the reference imports reference.model beside it
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location("jamba_reference", BENCH / "reference"
                                                  / "jamba.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _cfg(periods: int):
    smoke = get_spec("jamba-v0.1-52b").smoke
    cfg = dataclasses.replace(smoke, n_layers=8 * periods, compute_dtype=torch.float32,
                              moe=dataclasses.replace(smoke.moe, n_experts=8))
    return published(cfg)


def _ref_cfg(cfg) -> dict:
    """The configuration file's keys for ``cfg``, as the reference reads them."""
    return dict(hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.d_head,
                intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layers,
                num_experts=cfg.moe.n_experts, num_experts_per_tok=cfg.moe.top_k,
                rms_norm_eps=cfg.norm_eps, attn_layer_period=8, attn_layer_offset=4,
                expert_layer_period=2, expert_layer_offset=1, mamba_d_state=16,
                mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=cfg.d_model // 16)


def _weights(cfg, seed: int) -> dict:
    """Every parameter of the port's tree drawn from ``seed``: norm scales and
    the skip D about 1, ``a_log`` and ``dt_bias`` so that exp(dt A) decays
    (the benchmark's moments), the rest N(0, 1/fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in Model(cfg, device="meta").named_parameters():
        leaf = name.split(".")[-1]
        t = torch.empty(p.shape, dtype=torch.float32)
        if leaf in ("ln", "out_norm", "dt_norm", "b_norm", "c_norm", "d_skip"):
            t.normal_(1.0, 0.1, generator=gen)
        elif leaf == "a_log":
            t.normal_(1.9, 0.75, generator=gen)
        elif leaf == "dt_bias":
            t.normal_(-4.6, 1.33, generator=gen)
        elif leaf == "conv_b":
            t.normal_(0.0, 0.1, generator=gen)
        else:
            fan_in = p.shape[-1] if name == "embed" else p.shape[-2]
            t.normal_(0.0, fan_in ** -0.5, generator=gen)
        out[name] = t
    return out


def _port_logits(cfg, w, tokens):
    model = Model(cfg, device="meta")
    model.load_state_dict({k: v for k, v in w.items() if k in model.state_dict()},
                          strict=True, assign=True)
    logits, cache = prefill(model, torch.as_tensor(tokens[:N_PROMPT])[None],
                            cache_len=len(tokens) + 16)
    out = [logits[0, -1]]
    for t in tokens[N_PROMPT:]:
        logits, cache = decode_step(model, torch.tensor([[int(t)]]), cache)
        out.append(logits[0, -1])
    return torch.stack(out)


def _tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, N_PROMPT + N_DECODE)


@pytest.mark.parametrize("periods", [1, 2])
def test_prefill_and_decode_match_the_reference(periods):
    cfg = _cfg(periods)
    w = _weights(cfg, 5 + periods)
    tokens = _tokens(cfg)
    got = _port_logits(cfg, w, tokens)
    want = REF.served_logits(w, _ref_cfg(cfg), [(torch.as_tensor(tokens), N_PROMPT)])[0]
    assert got.shape == want.shape == (N_DECODE + 1, cfg.vocab_size)
    torch.testing.assert_close(got, want, **TOL)


def _jax_block(cfg, mechanism):
    """``cfg`` with one mechanism of the published block turned back to JAX's."""
    if mechanism == "rope":
        return dataclasses.replace(cfg, attn_rope=True)
    if mechanism == "inner norms":
        return dataclasses.replace(cfg, mamba_inner_norms=False)
    if mechanism == "renormalised gates":
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, renormalize=True))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))


@pytest.mark.parametrize("mechanism", ["rope", "inner norms", "renormalised gates",
                                       "capacity 1.25"])
def test_each_mechanism_is_needed(mechanism):
    """The port with one mechanism turned off (the same tensors; without the
    inner norms their scales are left out) fails the comparison above."""
    cfg = _cfg(1)
    w = _weights(cfg, 6)
    tokens = _tokens(cfg)
    want = REF.served_logits(w, _ref_cfg(cfg), [(torch.as_tensor(tokens), N_PROMPT)])[0]
    got = _port_logits(_jax_block(cfg, mechanism), w, tokens)
    assert not torch.allclose(got, want, **TOL)
    if mechanism == "capacity 1.25":     # the prompt's dispatch drops; one decode token does not
        assert (got[0] - want[0]).abs().max() > 1e-2


def _plain_top_k(x, p, cfg: MoEConfig):
    """Each token through its top-k experts by the router's f32 softmax, the
    lower index first on a tie, each expert's output times its gate."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p["router"], dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :cfg.top_k], experts[:, :cfg.top_k]
    if cfg.renormalize:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.top_k):
            e = experts[t, j]
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            out[t] += gates[t, j] * (h @ p["w_down"][e])
    return out.view_as(x)


@pytest.mark.parametrize("tokens,chunks,renormalize", [
    (1, 1, False), (4, 1, False), (37, 1, False), (40, 8, False), (37, 1, True)])
def test_full_capacity_is_a_plain_top_k(tokens, chunks, renormalize):
    """At ``capacity_factor`` = E / k every expert takes its whole dispatch
    group: ``moe_ffn`` is a plain top-k that drops no token."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=24, capacity_factor=4.0,
                    dispatch_chunks=chunks, renormalize=renormalize)
    gen = torch.Generator().manual_seed(tokens)
    d = 16
    p = {"router": torch.randn(d, 8, generator=gen),
         "w_gate": torch.randn(8, d, 24, generator=gen) * d ** -0.5,
         "w_up": torch.randn(8, d, 24, generator=gen) * d ** -0.5,
         "w_down": torch.randn(8, 24, d, generator=gen) * 24 ** -0.5}
    x = torch.randn(1, tokens, d, generator=gen)
    got, _ = moe_ffn(x, p, cfg)
    torch.testing.assert_close(got, _plain_top_k(x, p, cfg), rtol=1e-5, atol=1e-5)
    dropping = dataclasses.replace(cfg, capacity_factor=1.0)
    if tokens >= 37:                # the same routing at a capacity of T k / E drops slots
        assert not torch.allclose(moe_ffn(x, p, dropping)[0], got, rtol=1e-5, atol=1e-5)
