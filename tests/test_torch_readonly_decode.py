"""The read-only (paged) decode on the CPU: ``decode_step(...,
update_cache=False)`` and K4's self term in its plain version, against the
JAX package (the sequence-sharded merge: ``tests/test_torch_seq_sharded.py``).

JAX's read-only decode (``repro/models/model.py::_period_decode`` with
``update_cache=False``) leaves the KV cache as it is, attends to its first
``pos`` rows plus the current token as a self term in the same softmax
(``decode_attention(k_new=, v_new=)``) and returns the token's K/V as
``kf{i}``/``vf{i}``.  The port runs that attention through K4 with
``k_new``/``v_new`` (the plain version here).  Inputs come from numpy seeds;
weights from ``repro.models.init_params`` through ``params_from_jax``; f32
compute, so JAX's bf16 cast of the probabilities is a no-op and the two
agree to f32 rounding (ATOL, as ``tests/test_torch_decode_slots.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL as JAX_ALL
from repro.configs import get_spec as jax_spec
from repro.models import attention as jattn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import encode as jax_encode
from repro.models.model import init_params
from repro.models.model import prefill as jax_prefill
from repro_torch.configs import get_spec
from repro_torch.kernels import ref
from repro_torch.models import decode_step, encode, params_from_jax, prefill
from repro_torch.models import attention as tattn

ATOL = 1e-4      # logits and fragments in f32: tests/test_torch_decode_slots.py's
F32_RTOL = 1e-5  # attention in f32: x max|ref|
CACHE_LEN = 40
PROMPT = 24


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _pair(arch):
    jcfg = dataclasses.replace(jax_spec(arch).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _prefilled(jcfg, jp, model, b, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (b, PROMPT))
    kw_j, kw_t = {}, {}
    if jcfg.frontend == "vision":
        pe = rng.standard_normal((b, jcfg.n_prefix_embeds, jcfg.d_model)).astype(np.float32)
        kw_j["prefix_embeds"], kw_t["prefix_embeds"] = jnp.asarray(pe), torch.from_numpy(pe)
    if jcfg.is_enc_dec:
        fr = rng.standard_normal((b, 12, jcfg.d_model)).astype(np.float32)
        kw_j["memory"] = jax_encode(jcfg, jp, jnp.asarray(fr))
        kw_t["memory"] = encode(model, torch.from_numpy(fr))
    _, jc = jax_prefill(jcfg, jp, jnp.asarray(tokens, jnp.int32), cache_len=CACHE_LEN, **kw_j)
    _, tc = prefill(model, torch.from_numpy(tokens), cache_len=CACHE_LEN, **kw_t)
    return jc, tc, rng


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("arch", JAX_ALL)
def test_readonly_decode_matches_jax(arch, per_slot):
    """A read-only step: logits, every returned leaf
    (``kf``/``vf``, the new states, ``ck``/``cv`` passed through) and ``pos
    + 1`` against JAX's, the same keys; the input cache bitwise unchanged.
    The vector case has a row at the prompt's end, one behind it and one at
    0 (an empty cache: the self term alone)."""
    jcfg, jp, model = _pair(arch)
    jc, tc, rng = _prefilled(jcfg, jp, model, 3, seed=3)
    npfx = jcfg.n_prefix_embeds if jcfg.frontend == "vision" else 0
    if per_slot:
        pos = np.array([PROMPT, PROMPT - 5, 0], np.int32) + np.array([npfx, npfx, 0], np.int32)
        jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in tc.items()}
    tok = rng.integers(0, jcfg.vocab_size, (3, 1))
    jl, jo = jax_decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32), jc, update_cache=False)
    tl, to = decode_step(model, torch.from_numpy(tok), tc, update_cache=False)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=ATOL)
    assert set(to) == set(jo), (sorted(to), sorted(jo))
    for key, leaf in to.items():
        if key == "pos":
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(jo["pos"]))
        else:
            np.testing.assert_allclose(_np(leaf), _np(jo[key]), rtol=0, atol=ATOL, err_msg=key)
    for key, leaf in before.items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(tc[key], leaf), key
        else:
            assert tc[key] == leaf, key


@pytest.mark.parametrize("arch", ["qwen3-14b", "seamless-m4t-medium"])
def test_readonly_fragments_are_the_written_rows(arch):
    """The first period's ``kf``/``vf`` of the read-only step are bitwise
    the rows the default step writes at ``pos`` (the same projections and
    RoPE; later periods see the attention's rounding), its logits agree
    with the default step's, and the default path still advances its cache
    in place."""
    _, _, model = _pair(arch)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, PROMPT)))
    kw = {}
    if model.cfg.is_enc_dec:
        kw["memory"] = encode(model, torch.from_numpy(
            rng.standard_normal((2, 12, model.cfg.d_model)).astype(np.float32)))
    _, cache = prefill(model, tokens, cache_len=CACHE_LEN, **kw)
    tok = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 1)))
    lr, ro = decode_step(model, tok, cache, update_cache=False)
    ld, wr = decode_step(model, tok, cache)
    assert wr is cache and wr["pos"] == PROMPT + 1 == ro["pos"]
    for key in ro:
        if key.startswith(("kf", "vf")):
            assert torch.equal(ro[key][0, :, 0], wr[key[0] + key[2:]][0, :, PROMPT]), key
    _close(lr, ld, F32_RTOL)


def _attn_inputs(rng, b, h, kv, dh, s, dtype=np.float32):
    q = rng.standard_normal((b, h, dh)).astype(dtype)
    k, v = (rng.standard_normal((b, s, kv, dh)).astype(dtype) for _ in range(2))
    kn, vn = (rng.standard_normal((b, kv, dh)).astype(dtype) for _ in range(2))
    return q, k, v, kn, vn


@pytest.mark.parametrize("h,kv", [(8, 2), (6, 6), (6, 4)], ids=["g4", "g1", "h6kv4"])
def test_flash_decode_ref_self_term_matches_jax(h, kv):
    """K4's plain version with ``k_new``/``v_new`` against JAX's
    ``decode_attention(k_new=, v_new=)`` (f32), at pos 0 (the token alone),
    1, part of the cache and all of it, and with per-row lengths one of
    which is 0; the port's ``decode_attention`` too."""
    rng = np.random.default_rng(h * 10 + kv)
    b, dh, s = 3, 32, 40
    q, k, v, kn, vn = _attn_inputs(rng, b, h, kv, dh, s)
    g = -(-h // kv)
    cases = [0, 1, 17, s, np.array([s, 9, 0], np.int32)]
    for pos in cases:
        want = jattn.decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), k_new=jnp.asarray(kn)[:, None],
                                      v_new=jnp.asarray(vn)[:, None])[:, 0]
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        mine = tattn.decode_attention(torch.from_numpy(q)[:, None], torch.from_numpy(k),
                                      torch.from_numpy(v), tpos,
                                      k_new=torch.from_numpy(kn)[:, None],
                                      v_new=torch.from_numpy(vn)[:, None])[:, 0]
        _close(mine, want, F32_RTOL)
        if h % kv == 0:
            got = ref.flash_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), tpos, torch.from_numpy(kn),
                                       torch.from_numpy(vn))
        else:   # the kernel path pads the query heads
            got = tattn.kernel_decode_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                int(np.max(pos)), tpos if isinstance(tpos, torch.Tensor) else None,
                k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn))
        _close(got, want, F32_RTOL)
    # pos 0: the answer is v_new, each query head reading its KV head
    got = ref.flash_decode_ref(torch.from_numpy(q[:, :kv * (h // kv)]) if h % kv == 0 else
                               torch.from_numpy(np.concatenate(
                                   [q, np.zeros((b, kv * g - h, dh), np.float32)], 1)),
                               torch.from_numpy(k), torch.from_numpy(v), 0,
                               torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_allclose(got.numpy(), np.repeat(vn, g, axis=1), rtol=0, atol=1e-6)


def test_bf16_decode_attention_within_one_rounding_step_of_k4_plain():
    """JAX casts the probabilities to bf16 before both products; K4 keeps
    them in f32.  In bf16 the two read-only attentions agree within one
    rounding step of the output (the K4 rule, plus its atol) and a few
    steps of the probabilities' cast."""
    rng = np.random.default_rng(11)
    q, k, v, kn, vn = (torch.from_numpy(x).bfloat16()
                       for x in _attn_inputs(rng, 2, 8, 2, 64, 300))
    for pos in (0, 1, 150, 300):
        want = tattn.decode_attention(q[:, None], k, v, pos, k_new=kn[:, None],
                                      v_new=vn[:, None])[:, 0].float()
        got = ref.flash_decode_ref(q, k, v, pos, kn, vn).float()
        excess = ((got - want).abs() - 2 * 2.0 ** -7 * want.abs() - 2 ** -6).max().item()
        assert excess <= 0, (pos, excess)
