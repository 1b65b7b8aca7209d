"""The float32 reference against the program's model at smoke size, both in
float32 from the same tensors: prefill's logits, then each decode step's
through the cache, and the MoE capacity rule with and without dispatch
chunks."""

import copy

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
from nkb import program, weights
from nkb import spec
from reference import model as ref


def _f32(name):
    cfg = copy.deepcopy(spec.config(name))
    cfg["dtype"] = "float32"
    return cfg


def _program_logits(cfg, w, tokens, n_prompt):
    from repro_torch.models.model import decode_step, prefill

    mcfg = program.model_config(cfg)
    model = program.model_with(mcfg, w)
    logits, cache = prefill(model, torch.as_tensor(tokens[:n_prompt])[None],
                            cache_len=len(tokens) + 16)
    out = [logits[0, -1]]
    for t in tokens[n_prompt:]:
        logits, cache = decode_step(model, torch.tensor([[int(t)]]), cache)
        out.append(logits[0, -1])
    return torch.stack(out)


@pytest.mark.parametrize("name,n_prompt", [("dense-smoke", 37), ("moe-smoke", 37),
                                           ("moe-smoke", 40)])
def test_reference_matches_the_program_in_float32(name, n_prompt):
    cfg = _f32(name)
    w = weights.draw(cfg, 5, torch.device("cpu"))
    tokens = np.random.default_rng(3).integers(0, cfg["vocab_size"], n_prompt + 6)
    got = _program_logits(cfg, w, tokens, n_prompt)
    want = ref.served_logits(w, cfg, [(torch.as_tensor(tokens), n_prompt)])[0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dispatch_groups():
    assert ref.dispatch_groups(8, 10, 4) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9), (9, 10)]
    assert ref.dispatch_groups(7, 8, 4) == [(0, 7), (7, 8)]


def test_capacity_drops_late_tokens():
    cfg = _f32("moe-smoke")
    cfg["capacity_factor"] = 0.25      # cap = int(T*k/E/4): most slots dropped
    w = weights.draw(cfg, 1, torch.device("cpu"))
    fw = {k.split(".")[-1]: v[0].float() for k, v in w.items() if ".moe." in k}
    h = torch.randn(16, cfg["hidden_size"], generator=torch.Generator().manual_seed(0))
    full = ref.moe(h, fw, dict(cfg, capacity_factor=100.0), 16, False)
    capped = ref.moe(h, fw, cfg, 16, False)
    torch.testing.assert_close(capped[0], full[0])   # the first token keeps its slots
    assert not torch.allclose(capped, full)


def test_control_is_lower_precision():
    cfg = _f32("dense-smoke")
    w = weights.draw(cfg, 2, torch.device("cpu"))
    seq = [(torch.arange(20) % cfg["vocab_size"], 12)]
    a = ref.served_logits(w, cfg, seq)[0]
    b = ref.served_logits(w, cfg, seq, fp8=True)[0]
    err = (a - b).abs().max() / a.abs().max()
    assert 1e-3 < err < 0.5
