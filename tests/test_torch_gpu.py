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


def _wf_table(seed, n_flows=40, n_links=28, h=6, stall=False):
    """A random water-filling table; ``stall`` adds flows that cross only the
    pad link (no finite share: the loop strands them at inf)."""
    rng = np.random.default_rng(seed)
    caps = np.append(rng.uniform(1e7, 1e9, n_links), np.inf)
    paths = np.full((n_flows, h), n_links, np.int32)
    for f in range(n_flows):
        plen = int(rng.integers(1, h + 1))
        paths[f, :plen] = rng.choice(n_links, plen, replace=False)
    if stall:
        paths[::7] = n_links
    active = rng.random(n_flows) < 0.85
    return paths, caps, active


@pytest.mark.parametrize("seed,stall", [(0, False), (1, False), (2, True), (3, True)])
def test_waterfill_progressive_matches_plain(cuda, seed, stall):
    """K5 against its plain f32 version: every target of a round gets the
    same share, so rates, trace and round count agree bit for bit."""
    from repro_torch.kernels.waterfill import waterfill_progressive

    paths, caps, active = _wf_table(seed, stall=stall)
    args = (torch.from_numpy(paths), torch.from_numpy(caps).float(), torch.from_numpy(active))
    before = build.LAUNCHES["waterfill_progressive"]
    rates, tl, ts, rounds = waterfill_progressive(*(a.to(cuda) for a in args))
    assert build.LAUNCHES["waterfill_progressive"] == before + 1
    for dev in (cuda, "cpu"):
        p_rates, p_tl, p_ts, p_r = ref.waterfill_fixed_point_ref(*(a.to(dev) for a in args))
        assert int(rounds[0]) == p_r > 0
        assert torch.equal(rates.cpu(), p_rates.cpu())
        assert torch.equal(tl.cpu(), p_tl.cpu())
        assert torch.equal(ts.cpu(), p_ts.cpu())
    assert torch.all(rates.cpu()[~args[2]] == 0)
    assert torch.isinf(rates.cpu()).any() == stall


@pytest.mark.parametrize("s,f,lp1", [(1, 5, 4), (54, 119, 58), (7, 300, 130)])
def test_waterfill_fast_matches_plain(cuda, s, f, lp1):
    """K6 against its plain f32 version on S tables at once, with inactive
    rows, an empty table and flows on the pad link only (inf stall).  The
    kernel sums used capacity in flow order, the plain version by a matrix
    product, so rates agree at rtol 1e-4 (the JAX package's tolerance for
    its f32 route) and infinities in the same places."""
    from repro_torch.kernels.waterfill import waterfill_fast

    rng = np.random.default_rng(s * 1000 + f)
    caps = np.concatenate([rng.uniform(1e7, 1e9, (s, lp1 - 1)), np.full((s, 1), np.inf)], 1)
    nh = np.zeros((s, f, lp1))
    for i in range(s):
        for j in range(f):
            for link in rng.choice(lp1, int(rng.integers(1, 5)), replace=False):
                nh[i, j, link] += 1
    nh[:, ::9] = 0.0  # no real link: stranded at inf
    active = rng.random((s, f)) < 0.8
    active[s // 2] = False
    t = {k: torch.from_numpy(v) for k, v in (("caps", caps), ("active", active), ("nh", nh))}
    before = build.LAUNCHES["waterfill_fast"]
    got = waterfill_fast(t["caps"].float().to(cuda), t["active"].to(cuda), t["nh"].float().to(cuda))
    assert build.LAUNCHES["waterfill_fast"] == before + 1
    want = ref.waterfill_rates_fast_ref(t["caps"].float().to(cuda), t["active"].to(cuda),
                                        t["nh"].float().to(cuda))
    f64 = ref.waterfill_rates_fast_ref(t["caps"], t["active"], t["nh"])
    for other in (want.cpu(), f64.float()):
        assert torch.equal(torch.isinf(got.cpu()), torch.isinf(other))
        torch.testing.assert_close(got.cpu(), other, rtol=1e-4, atol=0.0)
    assert torch.all(got[s // 2] == 0)
    assert torch.all(got.cpu()[~t["active"]] == 0)


def test_waterfill_rejects(cuda):
    from repro_torch.kernels.waterfill import waterfill_fast, waterfill_progressive

    caps = torch.ones((2, 5), device=cuda)
    with pytest.raises(TypeError):
        waterfill_fast(caps.double(), torch.ones((2, 3), dtype=torch.bool, device=cuda),
                       torch.ones((2, 3, 5), device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        waterfill_fast(caps, torch.ones((2, 3), dtype=torch.bool, device=cuda),
                       torch.ones((2, 4, 5), device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        waterfill_progressive(torch.zeros((1, 2), dtype=torch.int32), caps[0].cpu(),
                              torch.ones(1, dtype=torch.bool))


def test_waterfill_wrappers_read_nothing_back(cuda):
    """Neither wrapper nor its prep reads a value back to the host, so the
    sweep enqueues its steps ahead of the card and a fixed point costs the
    host no round trip."""
    from repro_torch.kernels.waterfill import waterfill_fast, waterfill_progressive

    paths, caps, active = _wf_table(4)
    args = (torch.from_numpy(paths).to(cuda), torch.from_numpy(caps).float().to(cuda),
            torch.from_numpy(active).to(cuda))
    nh = torch.zeros((2, 3, 5), device=cuda)
    nh[:, :, 1] = 1.0
    fast = (torch.full((2, 5), 1e9, device=cuda), torch.ones((2, 3), dtype=torch.bool, device=cuda), nh)
    waterfill_progressive(*args)
    waterfill_fast(*fast)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        waterfill_progressive(*args)
        waterfill_fast(*fast)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
