"""The CUDA kernels against their plain PyTorch versions, on the card.

Phase 3 of chip_smoke.py at small shapes.  Every test needs a CUDA device
and is marked ``gpu``; the ``cuda`` fixture skips it where there is none.
Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_pack_unpack_bit_exact(cuda, dtype):
    from repro_torch.kernels.kv_pack import kv_pack, kv_unpack

    gen = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.randn((64, 16, 2, 64), generator=gen, device=cuda).to(dtype)
    table = torch.tensor([5, 63, 0, 17, 32], dtype=torch.int32)
    before = build.LAUNCHES["kv_pack"]
    buf = kv_pack(pool, table)
    assert build.LAUNCHES["kv_pack"] == before + 1
    assert torch.equal(buf, ref.kv_pack_ref(pool, table))
    dst = torch.zeros_like(pool)
    assert kv_unpack(dst, buf, table.to(cuda)) is dst
    assert torch.equal(dst, ref.kv_unpack_ref(torch.zeros_like(pool), buf, table))
    with pytest.raises(IndexError):
        kv_pack(pool, torch.tensor([64], dtype=torch.int32))


# (rtol, atol).  Kernel and plain version both sum in f32 and round once to
# the output dtype, so in bf16 they may differ by one rounding step of the
# output, at most 2^-7 of its magnitude; bf16 sums inside would err by more.
FD_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,dh,s", [
    (1, 4, 4, 64, 512), (2, 8, 2, 64, 1000), (2, 16, 8, 128, 512),
    (1, 8, 1, 128, 2048), (2, 10, 2, 128, 300), (3, 8, 2, 16, 77), (1, 8, 2, 256, 130),
])
def test_flash_decode_matches_plain(cuda, dtype, b, h, kv, dh, s):
    from repro_torch.kernels.flash_decode import flash_decode

    rtol, atol = FD_TOL[dtype]
    gen = torch.Generator(device=cuda).manual_seed(b * h + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    for pos in sorted(p for p in {1, 16, 127, 128, 129, s - s // 3, s} if p <= s):
        out = flash_decode(q, k, v, pos).float()
        want = ref.flash_decode_ref(q, k, v, pos).float()
        excess = ((out - want).abs() - rtol * want.abs() - atol).max().item()
        assert excess <= 0, (pos, (out - want).abs().max().item(), excess)


def test_flash_decode_rejects(cuda):
    from repro_torch.kernels.flash_decode import flash_decode

    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 32, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="pos"):
        flash_decode(q, k, k, 0)
    with pytest.raises(ValueError, match="heads"):
        flash_decode(torch.zeros((1, 18, 64), device=cuda), k, k, 1)
    with pytest.raises(TypeError):
        flash_decode(q, k.bfloat16(), k.bfloat16(), 1)


@pytest.mark.parametrize("r,d", [(1, 1), (1, 300), (7, 2048), (64, 513)])
def test_netkv_score_bitwise(cuda, r, d):
    from repro_torch.kernels.netkv_score import netkv_score_cohort

    rng = np.random.default_rng(r * 1000 + d)
    host = dict(
        free_mem=rng.uniform(1e9, 4e11, d).astype(np.float32),
        queued=rng.integers(0, 20, d).astype(np.float32),
        batch=rng.integers(0, 64, d).astype(np.float32),
        hit_rows=rng.uniform(0, 9000, (r, d)).astype(np.float32),
        tier_rows=rng.integers(0, 4, (r, d)).astype(np.int32),
        healthy=(rng.random(d) > 0.15).astype(np.float32),
        iter_scale=rng.uniform(1, 2, d).astype(np.float32))
    tables = ([4.5e11, 1.25e10, 6.25e9, 3.125e9], [1e-6, 3e-6, 8e-6, 1.5e-5],
              list(rng.uniform(0, 0.8, 4)))
    rows = dict(infl=rng.integers(0, 8, (r, 4)).astype(np.float32),
                s_r=rng.uniform(1e9, 4e9, r).astype(np.float32),
                l_r=rng.integers(1, 9000, r).astype(np.float32))
    kw = dict(iter_a=0.0124, iter_b=1.6e-5, m_min=2e9, beta_max=64)

    def run(dev, fn):
        t = {k: torch.from_numpy(v).to(dev) for k, v in {**host, **rows}.items()}
        return fn(t["free_mem"], t["queued"], t["batch"], t["hit_rows"], t["tier_rows"],
                  t["healthy"], t["iter_scale"], *tables, t["infl"], s_r=t["s_r"],
                  input_len=t["l_r"], **kw)

    cost, best = run(cuda, netkv_score_cohort)
    for dev in (cuda, "cpu"):
        p_cost, p_best = run(dev, ref.netkv_score_cohort_ref)
        assert torch.equal(cost.cpu(), p_cost.cpu()), dev
        assert torch.equal(best.cpu(), p_best.cpu()), dev


def test_model_decode_on_card_matches_cpu(cuda):
    """The smoke model in f32: prefill + decode through flash_decode on the
    card against the plain path on the CPU."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, decode_step, init_random_, prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on both sides
    cfg = dataclasses.replace(get_spec("qwen3-14b").smoke, compute_dtype=torch.float32)
    cpu = init_random_(Model(cfg, device="cpu"), 0)
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)))
    lc, cc = prefill(cpu, toks, cache_len=64)
    lg, cg = prefill(gpu, toks.to(cuda), cache_len=64)
    before = build.LAUNCHES["flash_decode"]
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None]
        lc, cc = decode_step(cpu, tok, cc)
        lg, cg = decode_step(gpu, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert build.LAUNCHES["flash_decode"] == before + 4 * cfg.n_layers
