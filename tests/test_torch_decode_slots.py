"""Per-slot decode positions on the CPU: ``decode_step`` with a (B,) vector
``pos``, and K4's plain version with per-row lengths, against the JAX
package.

JAX's ``decode_step`` takes a scalar or a (B,) ``pos`` (its ``per_slot``
branch: each row's K/V lands at its own index, RoPE turns it by its own
position, attention masks past its own ``pos + 1``).  The port's
``decode_step`` does the same, with K4 (``ops.flash_decode``, its plain
version here) given the lengths ``pos + 1``.  Inputs come from numpy seeds
and cross into each framework as numpy; weights come from
``repro.models.init_params`` through ``params_from_jax``; f32 compute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jax_spec
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro.models import attention as jattn
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import encode as jax_encode
from repro.models.model import init_params
from repro.models.model import prefill as jax_prefill
from repro_torch.configs import get_spec
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, encode, params_from_jax, prefill
from repro_torch.models.attention import kernel_decode_attention

ATOL = 1e-4     # logits and cache leaves: tests/test_torch_model.py's
F32_RTOL = 1e-5  # attention in f32: x max|ref|
CACHE_LEN = 40
PROMPT = 24
# (arch, config changes): the dense, MoE, hybrid, head-expanded vision and
# encoder-decoder decode paths; internvl2 at H 6 over KV 4 (H % KV != 0).
CASES = [("qwen3-14b", {}), ("granite-moe-1b-a400m", {}), ("jamba-v0.1-52b", {}),
         ("internvl2-76b", {"n_heads": 6, "n_kv_heads": 4}), ("seamless-m4t-medium", {})]
IDS = ["qwen3", "granite", "jamba", "internvl2-h6kv4", "seamless"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _pair(arch, change):
    jcfg = dataclasses.replace(jax_spec(arch).smoke, compute_dtype=jnp.float32, **change)
    tcfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32, **change)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _prefilled(jcfg, jp, model, b, seed):
    """Both packages' caches after a b-row prompt (behind stub patch
    embeddings for a vision model, over a memory for an encoder-decoder)."""
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


def _held_caches(tc, jc):
    for key, leaf in tc.items():
        if key == "pos":
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(jc["pos"]))
        else:
            np.testing.assert_allclose(_np(leaf), _np(jc[key]), rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("arch,change", CASES, ids=IDS)
def test_vector_pos_decode_matches_jax(arch, change):
    """Three decode steps from per-slot positions several tokens apart (a
    row at the prompt's end, rows behind it that overwrite their later
    entries): logits, every cache leaf and the advanced ``pos`` against
    JAX's per-slot decode."""
    jcfg, tcfg, jp, model = _pair(arch, change)
    jc, tc, rng = _prefilled(jcfg, jp, model, 3, seed=1)
    npfx = jcfg.n_prefix_embeds if jcfg.frontend == "vision" else 0
    pos = np.array([PROMPT, PROMPT - 5, 3], np.int32) + npfx
    jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos.copy())
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (3, 1))
        jl, jc = jax_decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = decode_step(model, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), pos + 3)
    _held_caches({k: v for k, v in tc.items() if k != "cross_memory"}, jc)


@pytest.mark.parametrize(
    "arch,change,update_cache",
    [(*case, True) for case in CASES] + [(*case, False) for case in CASES],
    ids=IDS + [f"{i}-readonly" for i in IDS])
def test_equal_vector_pos_is_the_scalar_step_bitwise(arch, change, update_cache):
    """A vector of equal positions gives the scalar step's logits and cache
    bit for bit (the RoPE angles, the cache writes and K4's split are the
    same), and the scalar step still matches JAX's.  The read-only step
    likewise: its logits and every returned fragment and state."""
    jcfg, tcfg, jp, model = _pair(arch, change)
    jc, tc, rng = _prefilled(jcfg, jp, model, 2, seed=2)
    tc_vec = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in tc.items()}
    tc_vec["pos"] = torch.full((2,), tc["pos"], dtype=torch.int32)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1))
    jl, jc = jax_decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32), jc,
                             update_cache=update_cache)
    tl, tc = decode_step(model, torch.from_numpy(tok), tc, update_cache=update_cache)
    vl, tc_vec = decode_step(model, torch.from_numpy(tok), tc_vec, update_cache=update_cache)
    assert torch.equal(tl, vl)
    assert set(tc) == set(tc_vec)
    for key in tc:
        if key != "pos":
            assert torch.equal(tc[key], tc_vec[key]), key
    assert tc["pos"] == int(tc_vec["pos"][0]) == int(tc_vec["pos"][1])
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=ATOL)


def test_ragged_rows_decode_as_alone():
    """Each row of a ragged dense decode equals that row decoded alone at
    batch 1 from its scalar position (a dense model: no row shares anything
    with another; MoE capacity is shared, ROADMAP §3 item 6)."""
    jcfg, tcfg, jp, model = _pair("qwen3-14b", {})
    _, tc, rng = _prefilled(jcfg, jp, model, 3, seed=3)
    pos = [PROMPT, 17, 1]
    tok = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (3, 1)))
    alone = []
    for b, p in enumerate(pos):
        row = {k: v[:, b:b + 1].clone() for k, v in tc.items() if k != "pos"}
        row["pos"] = p
        alone.append(decode_step(model, tok[b:b + 1], row)[0])
    tc["pos"] = torch.tensor(pos)
    logits, _ = decode_step(model, tok, tc)
    for b in range(3):
        _close(logits[b:b + 1], alone[b], F32_RTOL)


@pytest.mark.parametrize("h,kv", [(8, 2), (4, 4), (6, 4)])
def test_flash_decode_ref_lengths_match_jax(h, kv):
    """The plain K4 with per-row lengths: each row against JAX's
    ``flash_decode_ref`` at its own length, and the batch against JAX's
    ``decode_attention`` with the (B,) lengths; through the padded-head
    path where H % KV != 0."""
    rng = np.random.default_rng(h * 7 + kv)
    b, s, dh = 4, 48, 16
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, dh)).astype(np.float32) for _ in range(2))
    lengths = np.array([s, 31, 16, 1], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = kernel_decode_attention(tq, tk, tv, int(lengths.max()), torch.from_numpy(lengths))
    want = jattn.decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(lengths))[:, 0]
    _close(got, want, F32_RTOL)
    if h % kv:
        return
    direct = ref.flash_decode_ref(tq, tk, tv, torch.from_numpy(lengths))
    for row, n in enumerate(lengths):
        jrow = jax_flash_decode_ref(jnp.asarray(q[row:row + 1]), jnp.asarray(k[row:row + 1]),
                                    jnp.asarray(v[row:row + 1]), int(n))
        _close(direct[row:row + 1], jrow, F32_RTOL)
        _close(ref.flash_decode_ref(tq[row:row + 1], tk[row:row + 1], tv[row:row + 1], int(n)),
               jrow, F32_RTOL)


def test_flash_decode_ref_equal_lengths_are_the_scalar_pos():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 8, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 40, 2, 32)).astype(np.float32))
            for _ in range(2))
    for pos in (1, 17, 40):
        assert torch.equal(ref.flash_decode_ref(q, k, v, pos),
                           ref.flash_decode_ref(q, k, v, torch.full((3,), pos)))
        assert torch.equal(ops.flash_decode(q, k, v, pos),
                           ops.flash_decode(q, k, v, pos, torch.full((3,), pos,
                                                                     dtype=torch.int32)))


def test_kernels_refuse_inputs_that_require_grad():
    """K4 and K7 have no backward: ``ops`` refuses inputs that require
    grad rather than run a plain version the kernel does not match."""
    q = torch.zeros((1, 2, 16), requires_grad=True)
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q, k, k, 4)
    r = torch.zeros((1, 4, 1, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv_scan(r, r.detach(), r.detach(), r.detach(), torch.zeros((1, 64)))
    with torch.no_grad():
        ops.flash_decode(q, k, k, 4)
