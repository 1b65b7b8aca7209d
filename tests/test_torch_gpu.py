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
from repro_torch.kernels.waterfill import random_flow_table, random_incidence

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


def _fd_inputs(cuda, dtype, b, h, kv, dh, s, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


def _fd_check(q, k, v, pos):
    from repro_torch.kernels.flash_decode import flash_decode

    rtol, atol = FD_TOL[q.dtype]
    out = flash_decode(q, k, v, pos).float()
    want = ref.flash_decode_ref(q, k, v, pos).float()
    excess = ((out - want).abs() - rtol * want.abs() - atol).max().item()
    assert excess <= 0, (pos, (out - want).abs().max().item(), excess)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,dh,s", [
    (1, 4, 4, 64, 512), (2, 8, 2, 64, 1000), (2, 16, 8, 128, 512),
    (1, 8, 1, 128, 2048), (2, 10, 2, 128, 300), (3, 8, 2, 16, 77), (1, 8, 2, 256, 130),
])
def test_flash_decode_matches_plain(cuda, dtype, b, h, kv, dh, s):
    q, k, v = _fd_inputs(cuda, dtype, b, h, kv, dh, s, b * h + s)
    for pos in sorted(p for p in {1, 16, 127, 128, 129, s - s // 3, s} if p <= s):
        _fd_check(q, k, v, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,dh,s", [
    (1, 1, 1, 128, 4096),   # one (batch, KV head): many ranges
    (4, 40, 8, 128, 4096),  # qwen3-14b: G 5 at dh 128
    (2, 16, 2, 64, 1024),   # G 8
    (3, 24, 3, 16, 600),    # G 8, dh 16
    (2, 12, 4, 256, 700),   # G 3, dh 256
    (4, 16, 8, 64, 4096),   # granite-moe-1b-a400m: G 2, dh 64
    (4, 40, 10, 128, 4096),  # phi3-medium-14b: G 4
    (4, 48, 8, 128, 4096),  # internlm2-20b: G 6
    (4, 9, 3, 64, 4096),    # smollm-135m: G 3, dh 64
    (4, 32, 8, 128, 4096),  # jamba-v0.1-52b: G 4
    (4, 16, 16, 64, 4096),  # seamless-m4t-medium self-attention: G 1, dh 64
    (4, 16, 16, 64, 2048),  # seamless-m4t-medium cross-attention: pos S_enc
    (4, 64, 8, 128, 4096),  # internvl2-76b: G 8
])
def test_flash_decode_split_boundaries(cuda, dtype, b, h, kv, dh, s):
    """K4 where the split shows: one range (pos under one range), pos on a
    range boundary of a multi-range plan and one past it, and pos = S."""
    from repro_torch.kernels.flash_decode import plan_for

    q, k, v = _fd_inputs(cuda, dtype, b, h, kv, dh, s, 7 * b + dh)
    assert plan_for(q, k, s).n_split > 1
    small = [p for p in range(1, s + 1) if plan_for(q, k, p).n_split == 1]
    full = [p for p in range(2, s + 1)
            if (pl := plan_for(q, k, p)).n_split > 1 and pl.n_split * pl.range_len == p]
    assert small and full
    cases = {1, small[-1], full[0], full[-1], s} | {p + 1 for p in (full[0], full[-1]) if p < s}
    for pos in sorted(cases):
        _fd_check(q, k, v, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_split_is_deterministic(cuda, dtype):
    """Two calls on the same inputs are bitwise equal, one launch counted a
    call, with the ranges merged in one fixed order."""
    from repro_torch.kernels import flash_decode as fd

    q, k, v = _fd_inputs(cuda, dtype, 4, 40, 8, 128, 4096, 3)
    assert fd.plan_for(q, k, 2056).n_split > 1
    before = build.LAUNCHES["flash_decode"]
    first = fd.flash_decode(q, k, v, 2056)
    second = fd.flash_decode(q, k, v, 2056)
    assert build.LAUNCHES["flash_decode"] == before + 2
    assert torch.equal(first, second)


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


def _ragged_cases(q, k, s):
    """Per-row lengths where the split shows: the qwen3-14b serving case,
    rows shorter than one range of the longest row's plan, rows ending on
    a range's edge and one past it, a row at S, all rows of length 1."""
    from repro_torch.kernels.flash_decode import plan_for

    b = q.shape[0]
    longest = min(2056, s)
    r = plan_for(q, k, longest).range_len
    rows = [(longest, longest // 2, 17, 1), (longest, r, r + 1, 2 * r),
            (longest, r - 1, 1, 2 * r - 1), (s, s - 1, r, 3), (1, 1, 1, 1)]
    return [tuple(min(x, s) for x in (row * b)[:b]) for row in rows]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,dh,s", [
    (4, 40, 8, 128, 4096),  # qwen3-14b
    (4, 9, 3, 64, 4096),    # smollm-135m
    (3, 24, 3, 16, 600),    # G 8, dh 16
    (2, 12, 4, 256, 700),   # dh 256
    (4, 16, 16, 64, 300),   # G 1, a short cache
])
def test_flash_decode_per_row_lengths_match_plain(cuda, dtype, b, h, kv, dh, s):
    """K4 with a (B,) int32 vector of lengths against its plain version,
    two calls bitwise equal."""
    from repro_torch.kernels.flash_decode import flash_decode

    q, k, v = _fd_inputs(cuda, dtype, b, h, kv, dh, s, 5 * b + dh)
    rtol, atol = FD_TOL[dtype]
    for lengths in _ragged_cases(q, k, s):
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        out = flash_decode(q, k, v, max(lengths), lens)
        want = ref.flash_decode_ref(q, k, v, lens).float()
        excess = ((out.float() - want).abs() - rtol * want.abs() - atol).max().item()
        assert excess <= 0, (lengths, excess)
        assert torch.equal(out, flash_decode(q, k, v, max(lengths), lens)), lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_equal_lengths_are_the_scalar_launch(cuda, dtype):
    """A vector of equal lengths gives the scalar launch's output bit for
    bit: the same split, the same sums."""
    from repro_torch.kernels.flash_decode import flash_decode

    q, k, v = _fd_inputs(cuda, dtype, 4, 40, 8, 128, 4096, 9)
    for pos in (1, 17, 121, 2056, 4096):
        lens = torch.full((4,), pos, dtype=torch.int32, device=cuda)
        assert torch.equal(flash_decode(q, k, v, pos, lens), flash_decode(q, k, v, pos)), pos


def test_flash_decode_rejects_bad_lengths(cuda):
    from repro_torch.kernels.flash_decode import flash_decode

    q = torch.zeros((2, 4, 64), device=cuda)
    k = torch.zeros((2, 32, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_decode(q, k, k, 4, torch.full((2,), 4, device=cuda))
    with pytest.raises(ValueError, match="lengths"):
        flash_decode(q, k, k, 4, torch.full((3,), 4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, k, 4, torch.full((2,), 4, dtype=torch.int32))


def _fd_self(cuda, dtype, b, kv, dh, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((b, kv, dh), generator=gen, device=cuda).to(dtype) for _ in range(2)]


def _fd_held(out, want, what):
    rtol, atol = FD_TOL[want.dtype]
    want = want.float()
    excess = ((out.float() - want).abs() - rtol * want.abs() - atol).max().item()
    assert excess <= 0, (what, (out.float() - want).abs().max().item(), excess)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,dh,s", [
    (4, 40, 8, 128, 4096),  # qwen3-14b
    (2, 16, 2, 64, 1024),   # G 8
    (3, 24, 3, 16, 600),    # G 8, dh 16
    (2, 12, 4, 256, 700),   # dh 256
    (4, 16, 16, 64, 300),   # G 1, a short cache
])
def test_flash_decode_self_term_matches_plain(cuda, dtype, b, h, kv, dh, s):
    """K4 with ``k_new``/``v_new`` against its plain version: pos 0 (the
    token alone: exactly v_new), 1, a range's edge and one past it, 2056
    and S; per-row lengths with rows of 0; two calls bitwise equal."""
    from repro_torch.kernels.flash_decode import flash_decode, plan_for

    q, k, v = _fd_inputs(cuda, dtype, b, h, kv, dh, s, 13 * b + dh)
    kn, vn = _fd_self(cuda, dtype, b, kv, dh, 3 * b + dh)
    full = [p for p in range(2, s + 1)
            if (pl := plan_for(q, k, p)).n_split > 1 and pl.n_split * pl.range_len == p]
    for pos in sorted({0, 1, full[0], full[0] + 1, min(2056, s), s}):
        out = flash_decode(q, k, v, pos, k_new=kn, v_new=vn)
        _fd_held(out, ref.flash_decode_ref(q, k, v, pos, kn, vn), (pos, "self"))
        assert torch.equal(out, flash_decode(q, k, v, pos, k_new=kn, v_new=vn)), pos
    assert torch.equal(flash_decode(q, k, v, 0, k_new=kn, v_new=vn),
                       vn.repeat_interleave(h // kv, dim=1))
    for lengths in _ragged_cases(q, k, s) + [tuple([0, s] * b)[:b], (0,) * b]:
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        out = flash_decode(q, k, v, max(lengths), lens, kn, vn)
        _fd_held(out, ref.flash_decode_ref(q, k, v, lens, kn, vn), (lengths, "self"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_null_self_is_the_plain_launch(cuda, dtype):
    """Without ``k_new`` the launch is the one of the kernel before the
    self term: the same split, bitwise the same output as with lengths."""
    from repro_torch.kernels.flash_decode import flash_decode

    q, k, v = _fd_inputs(cuda, dtype, 4, 40, 8, 128, 4096, 17)
    for pos in (1, 121, 2056):
        lens = torch.full((4,), pos, dtype=torch.int32, device=cuda)
        assert torch.equal(flash_decode(q, k, v, pos, None, None, None),
                           flash_decode(q, k, v, pos, lens)), pos
        _fd_check(q, k, v, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_flash_decode_partials_and_merge(cuda, dtype, n_shards):
    """K4's partials mode on each sequence shard (the self term on shard 0,
    a shard past every row's end empty) against its plain version, and
    the merge of the shards' partials against one launch over the whole
    cache; per-row lengths too."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partials
    from repro_torch.models.attention import EMPTY_M, merge_partials

    b, h, kv, dh, s = 4, 40, 8, 128, 4096
    q, k, v = _fd_inputs(cuda, dtype, b, h, kv, dh, s, 19 + n_shards)
    kn, vn = _fd_self(cuda, dtype, b, kv, dh, 23)
    step = s // n_shards
    for pos in (2056 if n_shards == 4 else 1500, (2056, 1031, 17, 0)):
        lens = None if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32,
                                                                device=cuda)
        longest = pos if lens is None else max(pos)
        parts = []
        for lo in range(0, s, step):
            kl, vl = k[:, lo:lo + step].contiguous(), v[:, lo:lo + step].contiguous()
            local = min(max(longest - lo, 0), step)
            self_kv = dict(k_new=kn, v_new=vn) if lo == 0 else {}
            got = flash_decode_partials(q, kl, vl, local, lens, start=lo, **self_kv)
            want = ref.flash_decode_partials_ref(q, kl, vl, local, lens, start=lo, **self_kv)
            m_ok = torch.where(want[1] == EMPTY_M, got[1] == EMPTY_M,
                               (got[1] - want[1]).abs() <= 1e-5 * want[1].abs() + 1e-5)
            assert bool(m_ok.all()), (lo, pos)
            torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
            if local == 0 and lo > 0:
                assert bool((got[1] == EMPTY_M).all()) and not got[2].any()
            parts.append(got)
        whole = flash_decode(q, k, v, longest, lens, kn, vn)
        _fd_held(merge_partials(parts, dtype), ref.flash_decode_ref(
            q, k, v, pos if lens is None else lens, kn, vn), (n_shards, pos))
        _fd_held(whole, ref.flash_decode_ref(q, k, v, pos if lens is None else lens, kn, vn),
                 (n_shards, pos, "whole"))


def test_readonly_decode_on_card_matches_cpu(cuda):
    """``decode_step(update_cache=False)`` of the qwen3-14b and jamba smoke
    configs in f32 on the card (K4 with the self term) against the CPU: the
    logits and fragments within FD_TOL's f32 atol, the card's input cache
    unchanged; on the card an int ``pos`` and the equal vector give the same
    step bit for bit."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, decode_step, init_random_, prefill

    for arch in ("qwen3-14b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32)
        cpu = init_random_(Model(cfg, device="cpu"), 0)
        card = Model(cfg, device=cuda)
        card.load_state_dict(cpu.state_dict())
        tokens = torch.randint(0, cfg.vocab_size, (3, 24), generator=torch.Generator().manual_seed(1))
        tok = tokens[:, :1]
        outs = []
        for model, dev in ((cpu, "cpu"), (card, cuda)):
            _, cache = prefill(model, tokens.to(dev), cache_len=40)
            cache["pos"] = torch.tensor([24, 19, 0])
            before = {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}
            logits, out = decode_step(model, tok.to(dev), cache, update_cache=False)
            assert all(torch.equal(cache[k], v) for k, v in before.items())
            outs.append((logits.cpu(), {k: v.cpu() for k, v in out.items()
                                        if isinstance(v, torch.Tensor)}))
            if dev == cuda:
                cache["pos"] = 24
                li, oi = decode_step(model, tok.to(dev), cache, update_cache=False)
                cache["pos"] = torch.full((3,), 24)
                lv, ov = decode_step(model, tok.to(dev), cache, update_cache=False)
                assert torch.equal(li, lv) and oi.keys() == ov.keys()
                assert all(torch.equal(oi[k], ov[k]) for k in oi if k != "pos")
        torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=1e-4)
        for key, leaf in outs[0][1].items():
            torch.testing.assert_close(outs[1][1][key], leaf, rtol=0, atol=1e-4)


def test_kernels_refuse_inputs_that_require_grad_on_the_card(cuda):
    """K4 and K7 have no backward: ``ops`` raises on inputs that require
    grad and does not give way to the plain version."""
    from repro_torch.kernels import ops

    q = torch.zeros((1, 4, 64), device=cuda, requires_grad=True)
    k = torch.zeros((1, 32, 2, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q, k, k, 4)
    r = torch.zeros((1, 8, 1, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv_scan(r, r.detach(), r.detach(), r.detach(), torch.zeros((1, 64), device=cuda))


def test_vector_pos_decode_on_card_matches_cpu(cuda):
    """``decode_step`` with ragged per-slot positions on the card (K4 with
    lengths) against the CPU, and equal positions bitwise the scalar step."""
    from repro_torch.models import decode_step, prefill

    cfg, cpu, gpu = _smoke_pair(cuda, "qwen3-14b")
    tokens = torch.randint(0, cfg.vocab_size, (3, 20), generator=torch.Generator().manual_seed(4))
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        _, cache = prefill(model, tokens.to(dev), cache_len=32)
        scalar = {k: v if k == "pos" else v.clone() for k, v in cache.items()}
        cache["pos"] = torch.tensor([20, 9, 1])
        logits, cache = decode_step(model, tokens[:, :1].to(dev), cache)
        outs.append((logits, cache))
        if dev == cuda:
            equal = {k: v.clone() if k != "pos" else torch.full((3,), 20) for k, v in scalar.items()}
            ls, cs = decode_step(model, tokens[:, :1].to(dev), scalar)
            lv, cv = decode_step(model, tokens[:, :1].to(dev), equal)
            assert torch.equal(ls, lv)
            assert all(torch.equal(cs[k], cv[k]) for k in cs if k != "pos")
    (lc, cc), (lg, cg) = outs
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    assert torch.equal(cg["pos"], cc["pos"])
    for key in cc:
        if key != "pos":
            torch.testing.assert_close(cg[key].cpu(), cc[key], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step (2 microbatches, the arch's optimizer) of the smoke
    config in f32 on the card against the same step on the CPU: loss and
    grad_norm rtol 1e-5 (rwkv6's grad_norm 1e-4), parameters held as the
    CPU tests hold them against JAX (tests/test_torch_train.py)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, init_random_
    from repro_torch.train import make_optimizer, make_train_step, synth_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_spec(arch)
    cfg = dataclasses.replace(spec.smoke, compute_dtype=torch.float32)
    cpu = init_random_(Model(cfg, device="cpu", train_dtype="float32"), 0)
    start = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    gpu = copy.deepcopy(cpu).to(cuda)
    opt = make_optimizer(spec.optimizer, lr=1e-3)
    step = make_train_step(opt, microbatches=2)
    metrics = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        batch = synth_batch(cfg, global_batch=4, seq_len=24, seed=1, step=0, device=dev)
        metrics.append(step(model, opt.init(dict(model.named_parameters())), batch)[2])
    (mc, mg) = metrics
    assert abs(mg["loss"].item() - mc["loss"].item()) <= 1e-5 * abs(mc["loss"].item())
    gn_rtol = 1e-4 if arch == "rwkv6-3b" else 1e-5
    assert abs(mg["grad_norm"].item() - mc["grad_norm"].item()) <= gn_rtol * mc["grad_norm"].item()
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        got, want = pg.detach().cpu(), pc.detach()
        off = (got - want).abs() > 1e-5 * want.abs() + 1e-6
        assert off.float().mean().item() <= 1e-2, name
        update = (want - start[name]).norm().item()
        assert (got - want).norm().item() <= 1e-2 * max(update, 1e-12), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv,dh", [(6, 4, 64), (3, 2, 128), (5, 3, 64), (9, 2, 64)])
def test_padded_heads_match_plain(cuda, dtype, h, kv, dh):
    """H % KV != 0: ``kernel_decode_attention`` pads q to KV * ceil(H/KV)
    heads for K4 (one launch a call) and keeps the first H; held to the
    head-expanded plain reference on the same inputs."""
    from repro_torch.models.attention import decode_attention, kernel_decode_attention

    q, k, v = _fd_inputs(cuda, dtype, 4, h, kv, dh, 1024, h * kv)
    rtol, atol = FD_TOL[dtype]
    for pos in (1, 300, 1024):
        before = build.LAUNCHES["flash_decode"]
        out = kernel_decode_attention(q, k, v, pos).float()
        assert build.LAUNCHES["flash_decode"] == before + 1
        want = ref.flash_decode_ref(
            torch.cat([q, q.new_zeros((4, kv * -(-h // kv) - h, dh))], dim=1), k, v,
            pos)[:, :h].float()
        excess = ((out - want).abs() - rtol * want.abs() - atol).max().item()
        assert excess <= 0, (pos, excess)
        if dtype == torch.float32:
            plain = decode_attention(q[:, None], k, v, pos)[:, 0]
            torch.testing.assert_close(out, plain, atol=2e-5, rtol=0)


def _smoke_pair(cuda, arch, **change):
    """The smoke model of ``arch`` in f32 (``change`` applied to its config)
    on the CPU and the same weights on the card."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, init_random_

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on both sides
    cfg = dataclasses.replace(get_spec(arch).smoke, compute_dtype=torch.float32, **change)
    cpu = init_random_(Model(cfg, device="cpu"), 0)
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


def test_encoder_decoder_on_card_matches_cpu(cuda):
    """The seamless smoke model: encode, prefill with the memory and four
    decode steps on the card (self- and cross-attention through K4, two
    launches a layer a step) against the plain path on the CPU."""
    from repro_torch.models import decode_step, encode, prefill

    cfg, cpu, gpu = _smoke_pair(cuda, "seamless-m4t-medium")
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    mc, mg = encode(cpu, frames), encode(gpu, frames.to(cuda))
    torch.testing.assert_close(mg.cpu(), mc, atol=1e-4, rtol=1e-4)
    lc, cc = prefill(cpu, toks, memory=mc, cache_len=32)
    lg, cg = prefill(gpu, toks.to(cuda), memory=mg, cache_len=32)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    before = build.LAUNCHES["flash_decode"]
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None]
        lc, cc = decode_step(cpu, tok, cc)
        lg, cg = decode_step(gpu, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert build.LAUNCHES["flash_decode"] == before + 4 * 2 * cfg.n_layers


@pytest.mark.parametrize("heads", [{}, {"n_heads": 6, "n_kv_heads": 4}], ids=["smoke", "h6kv4"])
def test_vision_prefix_on_card_matches_cpu(cuda, heads):
    """The internvl2 smoke model (and with 6 heads over 4 KV heads):
    prefill behind stub patch embeddings and four decode steps on the card
    against the CPU."""
    from repro_torch.models import decode_step, prefill

    cfg, cpu, gpu = _smoke_pair(cuda, "internvl2-76b", **heads)
    rng = np.random.default_rng(2)
    pe = torch.from_numpy(rng.standard_normal((2, cfg.n_prefix_embeds, cfg.d_model))
                          .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    lc, cc = prefill(cpu, toks, prefix_embeds=pe, cache_len=48)
    lg, cg = prefill(gpu, toks.to(cuda), prefix_embeds=pe.to(cuda), cache_len=48)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    before = build.LAUNCHES["flash_decode"]
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None]
        lc, cc = decode_step(cpu, tok, cc)
        lg, cg = decode_step(gpu, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert build.LAUNCHES["flash_decode"] == before + 4 * cfg.n_layers
    assert cg["pos"] == cfg.n_prefix_embeds + 24


# chip_smoke.py's phase-3 shapes of K1 and a few cohorts.
K1_SHAPES = [(1, d) for d in (1, 2, 16, 31, 32, 33, 255, 256, 257, 2048, 2049, 8192)] + [
    (64, 2048), (7, 2048), (64, 513), (1, 300)]


def _k1_run(dev, fn, case):
    return fn(**{k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
                 for k, v in case.items()})


def _k1_held(cuda, case):
    """Kernel against its plain version on the card and on the CPU: cost
    rows bitwise, packed results equal; two calls bitwise equal, one launch
    each.  Returns the packed result on the host."""
    from repro_torch.kernels.netkv_score import netkv_score_cohort

    before = build.LAUNCHES["netkv_score_cohort"]
    cost, res = _k1_run(cuda, netkv_score_cohort, case)
    cost2, res2 = _k1_run(cuda, netkv_score_cohort, case)
    assert build.LAUNCHES["netkv_score_cohort"] == before + 2
    assert torch.equal(cost, cost2) and torch.equal(res, res2)
    for dev in (cuda, "cpu"):
        p_cost, p_res = _k1_run(dev, ref.netkv_score_cohort_ref, case)
        assert torch.equal(cost.cpu(), p_cost.cpu()), dev
        assert torch.equal(res.cpu(), p_res.cpu()), dev
    return res.cpu().numpy()


@pytest.mark.parametrize("r,d", K1_SHAPES)
def test_netkv_score_bitwise(cuda, r, d):
    from repro_torch.kernels.netkv_score import score_case

    _k1_held(cuda, score_case(r, d, n_sm=build.sm_count(cuda)))


@pytest.mark.parametrize("d", [2, 33, 257, 2048, 2049, 8192])
@pytest.mark.parametrize("kind", ["edge", "ranks", "none", "one"])
def test_netkv_score_ties_across_ranks_and_infeasible_rows(cuda, kind, d):
    """Equal costs on lanes in different blocks of a row's cluster: the
    lower index is best and the next one second; a row with no feasible
    lane has best cost BIG and no second; one feasible lane, no second."""
    from repro_torch.kernels.netkv_score import BIG, score_case, unpack_result

    case = score_case(2, d, kind, n_sm=build.sm_count(cuda))
    best, best_cost, second, _ = unpack_result(_k1_held(cuda, case))
    lanes = np.flatnonzero(case["healthy"])
    if kind == "none":
        assert (best == 0).all() and (best_cost == np.float32(BIG)).all()
    else:
        assert (best == lanes[0]).all() and (best_cost < BIG / 2).all()
    assert (second == (lanes[1] if len(lanes) > 1 else -1)).all()


def test_score_cohort_snapshot_matches_cpu(cuda):
    """The decision path's snapshot call, through its reused pinned buffers
    as they grow: the packed result and the cost rows of the card equal the
    CPU route's, one launch a call."""
    from repro_torch.kernels.netkv_score import score_cohort_snapshot, score_case

    for r, d in ((1, 16), (1, 2048), (4, 257), (1, 8192), (64, 2048), (1, 33)):
        case = score_case(r, d, n_sm=build.sm_count(cuda))
        kw = dict(case, healthy=case["healthy"] > 0.5)
        before = build.LAUNCHES["netkv_score_cohort"]
        c_card, res_card = score_cohort_snapshot(**kw, device=cuda)
        assert build.LAUNCHES["netkv_score_cohort"] == before + 1
        c_cpu, res_cpu = score_cohort_snapshot(**kw, device=torch.device("cpu"))
        assert isinstance(res_card, np.ndarray) and res_card.shape == (r, 4)
        np.testing.assert_array_equal(res_card, res_cpu)
        assert c_card.device.type == "cuda" and torch.equal(c_card.cpu(), c_cpu)


def test_netkv_score_refused_cluster_raises(cuda, monkeypatch):
    """A launch the card refuses raises; nothing falls back."""
    from repro_torch.kernels import netkv_score as ns

    monkeypatch.setattr(ns, "score_plan", lambda r, d, n_sm: ns.ScorePlan(3, 64, 64, 3 * r))
    before = build.LAUNCHES["netkv_score_cohort"]
    with pytest.raises(RuntimeError, match="netkv_score_cohort"):
        _k1_run(cuda, ns.netkv_score_cohort, ns.score_case(1, 100))
    assert build.LAUNCHES["netkv_score_cohort"] == before


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


@pytest.mark.parametrize("seed,stall", [(0, False), (1, False), (2, True), (3, True)])
def test_waterfill_progressive_matches_plain(cuda, seed, stall):
    """K5 against its plain f32 version: every target of a round gets the
    same share, so rates, trace and round count agree bit for bit."""
    from repro_torch.kernels.waterfill import waterfill_progressive

    paths, caps, active = random_flow_table(seed, stall=stall)
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

    paths, caps, active = random_flow_table(4)
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


def _wf_check_bitwise(cuda, paths, caps, active, layout=None):
    """K5 on the card against its plain version, bit for bit, one launch."""
    from repro_torch.kernels.waterfill import waterfill_progressive, waterfill_progressive_plan

    args = (torch.from_numpy(paths), torch.from_numpy(caps).float(), torch.from_numpy(active))
    plan = waterfill_progressive_plan(*paths.shape, len(caps))
    if layout is not None:
        assert plan.layout == layout, plan
    before = build.LAUNCHES["waterfill_progressive"]
    rates, tl, ts, rounds = waterfill_progressive(*(a.to(cuda) for a in args))
    assert build.LAUNCHES["waterfill_progressive"] == before + 1
    p_rates, p_tl, p_ts, p_r = ref.waterfill_fixed_point_ref(*(a.to(cuda) for a in args))
    assert int(rounds[0]) == p_r
    assert torch.equal(rates, p_rates) and torch.equal(tl, p_tl) and torch.equal(ts, p_ts)
    assert torch.all(rates.cpu()[~args[2]] == 0)
    return rates, p_r


@pytest.mark.parametrize("case", ["f1", "wide", "inactive", "pad_only", "paths", "global"])
def test_waterfill_progressive_edges(cuda, case):
    """K5's shape edges, each bitwise its plain version: one flow; more
    flows and links than 256 threads; every flow inactive; flows only on the
    pad link (no finite share: every active flow stranded at inf); and
    tables past the shared-memory layout (the paths re-read from device
    memory; the link state in device scratch too)."""
    if case == "f1":
        paths, caps, active = random_flow_table(10, n_flows=1)
        active[:] = True
    elif case == "wide":
        paths, caps, active = random_flow_table(11, n_flows=300, n_links=280)
    elif case == "inactive":
        paths, caps, active = random_flow_table(12)
        active[:] = False
    elif case == "pad_only":
        paths, caps, active = random_flow_table(13)
        paths[:] = len(caps) - 1
    elif case == "paths":
        paths, caps, active = random_flow_table(14, n_flows=9000, n_links=2000)
    else:
        paths, caps, active = random_flow_table(15, n_flows=500, n_links=15000)
    layout = {"paths": "paths", "global": "global"}.get(case, "shared")
    rates, rounds = _wf_check_bitwise(cuda, paths, caps, active, layout)
    if case == "inactive":
        assert rounds == 0 and torch.all(rates == 0)
    if case == "pad_only":
        assert rounds == 0 and torch.all(torch.isinf(rates.cpu()[torch.from_numpy(active)]))
    if case == "f1":
        assert rounds == 1


def test_waterfill_progressive_is_deterministic(cuda):
    """Two calls on the same inputs are bitwise equal, one launch counted a
    call."""
    from repro_torch.kernels.waterfill import waterfill_progressive

    paths, caps, active = random_flow_table(16, n_flows=112, n_links=120)
    args = [torch.from_numpy(a).to(cuda) for a in (paths, caps.astype(np.float32), active)]
    before = build.LAUNCHES["waterfill_progressive"]
    first, second = waterfill_progressive(*args), waterfill_progressive(*args)
    assert build.LAUNCHES["waterfill_progressive"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("s,f,lp1,layout", [
    (1, 40, 30, "shared"),       # one scenario
    (3, 300, 58, "shared"),      # more flows than threads
    (4, 119, 100, "shared"),     # links past one 32- or 64-bit mask word
    (2, 1100, 300, "masks"),     # the slab read from device memory
    (1, 3000, 1500, "global"),   # the state and masks in device scratch too
    (1, 64, 14000, "global"),    # a state past shared memory on its own
])
def test_waterfill_fast_shapes(cuda, s, f, lp1, layout):
    """K6 against its plain version in f32 and f64 (rtol 1e-4, infinities
    in the same places, zero rates on inactive rows) across its layouts, a
    hop count of 2 on one link included; two calls bitwise equal."""
    from repro_torch.kernels.waterfill import fast_plan_for, waterfill_fast

    caps, active, nh = random_incidence(s, f, lp1, 7 * s + f)
    t = [torch.from_numpy(a).to(cuda) for a in (caps.astype(np.float32), active, nh)]
    assert fast_plan_for(t[0], t[1]).layout == layout
    before = build.LAUNCHES["waterfill_fast"]
    got = waterfill_fast(*t)
    assert build.LAUNCHES["waterfill_fast"] == before + 1
    want = ref.waterfill_rates_fast_ref(*t)
    f64 = ref.waterfill_rates_fast_ref(t[0].double(), t[1], t[2].double())
    for other in (want, f64.float()):
        assert torch.equal(torch.isinf(got), torch.isinf(other))
        torch.testing.assert_close(got, other, rtol=1e-4, atol=0.0)
    assert torch.all(got[~t[1]] == 0)
    assert bool((torch.isfinite(got) & (got > 0)).any())
    assert torch.equal(got, waterfill_fast(*t))


# y in bf16: both versions sum in f32 and round once, so they may differ by
# one rounding step of the output (rtol 2^-7); f32 y and the state: the
# atol tests/test_kernels.py holds the TPU kernel to.
RWKV_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}


def _rwkv_inputs(cuda, dtype, b, t, h, dh, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (0.3 * torch.randn((b, t, h, dh), generator=gen, device=cuda) for _ in range(3))
    w = 0.5 * torch.sigmoid(torch.randn((b, t, h, dh), generator=gen, device=cuda)) + 0.45
    u = 0.3 * torch.randn((h, dh), generator=gen, device=cuda)
    return [a.to(dtype) for a in (r, k, v, w)] + [u]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,dh", [
    (1, 128, 2, 64), (2, 256, 3, 64), (1, 512, 1, 128), (2, 24, 2, 64), (1, 77, 3, 128),
    (2, 33, 2, 40), (1, 1, 4, 16),
    # column groups of 16: dh 16 (one), 40 (a short last group), 128
    # (eight); T 1, 24, 2047 and 2048 across the staged chunks; B 2; and
    # dh 20, whose bf16 rows are no whole number of 16-byte pieces
    (2, 2048, 2, 16), (1, 2047, 2, 40), (2, 24, 3, 40), (1, 2048, 1, 128),
    (2, 1, 2, 128), (2, 2047, 1, 128), (1, 50, 2, 20),
    # 24 and 32 columns a block (more heads than 16-column blocks fit in
    # one wave): dh 40 and 64 in groups of 24 (short last groups), dh 128
    # in groups of 32
    (1, 100, 50, 40), (1, 300, 40, 64), (1, 64, 40, 128),
])
def test_rwkv_scan_matches_plain(cuda, dtype, b, t, h, dh):
    """K7 against its plain version: dh 64 and 128 and padded widths, ragged
    T, f32 and bf16 inputs."""
    from repro_torch.kernels.rwkv_scan import rwkv_scan

    args = _rwkv_inputs(cuda, dtype, b, t, h, dh, b * t + h * dh)
    before = build.LAUNCHES["rwkv_scan"]
    y, s = rwkv_scan(*args)
    assert build.LAUNCHES["rwkv_scan"] == before + 1
    want_y, want_s = ref.rwkv_scan_ref(*args)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert y.shape == want_y.shape and s.shape == want_s.shape
    rtol, atol = RWKV_TOL[dtype]
    excess = ((y.float() - want_y.float()).abs() - rtol * want_y.float().abs() - atol).max()
    assert excess.item() <= 0, (y.float() - want_y.float()).abs().max().item()
    torch.testing.assert_close(s, want_s, rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rwkv_scan_is_deterministic(cuda, dtype):
    """Two calls on the same inputs are bitwise equal, also on an input
    that is not 16-byte aligned (the wrapper realigns a copy)."""
    from repro_torch.kernels.rwkv_scan import rwkv_scan

    args = _rwkv_inputs(cuda, dtype, 1, 2048, 40, 64, 5)
    first, second = rwkv_scan(*args), rwkv_scan(*args)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    flat = torch.cat([torch.zeros(1, device=cuda, dtype=dtype), args[0].flatten()])
    shifted = flat[1:].view(args[0].shape)
    assert shifted.data_ptr() % 16
    moved = rwkv_scan(shifted, *args[1:])
    assert torch.equal(moved[0], first[0]) and torch.equal(moved[1], first[1])


def test_rwkv_scan_rejects(cuda):
    from repro_torch.kernels.rwkv_scan import rwkv_scan

    x = torch.zeros((1, 8, 2, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((1, 8, 1, 256), device=cuda)
        rwkv_scan(wide, wide, wide, wide, torch.zeros((1, 256), device=cuda))
    with pytest.raises(TypeError):
        rwkv_scan(x, x.bfloat16(), x, x, u)
    with pytest.raises(TypeError):
        rwkv_scan(*(x.half() for _ in range(4)), u)
    with pytest.raises(ValueError, match="shape"):
        rwkv_scan(x, x, x[:, :4].contiguous(), x, u)
    with pytest.raises(ValueError, match="u must"):
        rwkv_scan(x, x, x, x, u[:1])
    with pytest.raises(ValueError, match="contiguous"):
        rwkv_scan(x.transpose(1, 2), x, x, x, u)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv_scan(x, x.cpu(), x, x, u)


def test_rwkv_model_on_card_matches_cpu(cuda):
    """The rwkv6 smoke model in f32: prefill through rwkv_scan on the card
    and decode steps against the plain path on the CPU."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, decode_step, init_random_, prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on both sides
    cfg = dataclasses.replace(get_spec("rwkv6-3b").smoke, compute_dtype=torch.float32)
    cpu = init_random_(Model(cfg, device="cpu"), 0)
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    before = dict(build.LAUNCHES)
    lc, cc = prefill(cpu, toks)
    lg, cg = prefill(gpu, toks.to(cuda))
    assert build.LAUNCHES["rwkv_scan"] == before["rwkv_scan"] + cfg.n_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    for _ in range(3):
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None]
        lc, cc = decode_step(cpu, tok, cc)
        lg, cg = decode_step(gpu, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    for leaf in ("wkv0", "sa0", "sc0"):
        torch.testing.assert_close(cg[leaf].cpu(), cc[leaf], atol=1e-4, rtol=1e-4)
    assert build.LAUNCHES["rwkv_scan"] == before["rwkv_scan"] + cfg.n_layers
    assert build.LAUNCHES["flash_decode"] == before["flash_decode"]


def test_moe_model_on_card_matches_cpu(cuda):
    """The granite-moe smoke model in f32: prefill (MoE dispatch at S 20)
    and decode steps (4 slots x top-4 over 8 experts of capacity 2) on the
    card against the plain path on the CPU."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import Model, decode_step, init_random_, prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on both sides
    cfg = dataclasses.replace(get_spec("granite-moe-1b-a400m").smoke,
                              compute_dtype=torch.float32)
    cpu = init_random_(Model(cfg, device="cpu"), 0)
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 20)))
    lc, cc = prefill(cpu, toks, cache_len=64)
    lg, cg = prefill(gpu, toks.to(cuda), cache_len=64)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    before = build.LAUNCHES["flash_decode"]
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], dim=-1)[:, None]
        lc, cc = decode_step(cpu, tok, cc)
        lg, cg = decode_step(gpu, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert build.LAUNCHES["flash_decode"] == before + 4 * cfg.n_layers


def _moe_inputs(cuda, cfg, d, b, s, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    e, f = cfg.n_experts, cfg.d_expert
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    params = {k: (0.02 * torch.randn(v, generator=gen, device=cuda)).to(dtype)
              for k, v in shapes.items()}
    return params, torch.randn((b, s, d), generator=gen, device=cuda).to(dtype)


def test_moe_ffn_on_card_routes_as_cpu(cuda):
    """The granite smoke MoE in f32: experts and kept slots on the card
    equal the CPU route's, and the output agrees."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models import moe_ffn
    from repro_torch.models.moe import route, slot_positions

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = get_spec("granite-moe-1b-a400m").smoke
    cfg = dataclasses.replace(smoke.moe, dispatch_chunks=4)
    params, x = _moe_inputs(cuda, cfg, smoke.d_model, 4, 16, torch.float32, 0)
    on_cpu = {k: v.cpu() for k, v in params.items()}
    for xi in (x[:, :4], x[:, 4:8], x[:, :1]):
        xf = xi.reshape(-1, smoke.d_model)
        t = xf.shape[0]
        cap = max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
        got, want = route(xf, params["router"], cfg.top_k), route(xf.cpu(), on_cpu["router"],
                                                                  cfg.top_k)
        assert torch.equal(got[2].cpu(), want[2])
        assert torch.equal(slot_positions(got[2], cfg.n_experts)[0].cpu() < cap,
                           slot_positions(want[2], cfg.n_experts)[0] < cap)
    out, aux = moe_ffn(x, params, cfg)
    out_c, aux_c = moe_ffn(x.cpu(), on_cpu, cfg)
    torch.testing.assert_close(out.cpu(), out_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), aux_c, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,s", [(4, 1), (1, 2048)], ids=["decode", "prefill"])
def test_moe_ffn_is_deterministic(cuda, b, s):
    """granite-moe-1b-a400m's MoE at full width in bf16, a decode step of 4
    slots and a 2048-token prefill in 4 dispatch chunks: two calls bitwise
    equal (no op of the dispatch or the combine uses atomics)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import moe_ffn

    full = get_spec("granite-moe-1b-a400m").model
    params, x = _moe_inputs(cuda, full.moe, full.d_model, b, s, torch.bfloat16, 1)
    first, second = moe_ffn(x, params, full.moe), moe_ffn(x, params, full.moe)
    assert first[0].dtype == torch.bfloat16 and bool(torch.isfinite(first[0]).all())
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _mamba_inputs(device, d, b, s, dtype, seed):
    """One Mamba layer's parameters at width ``d`` (a_log, dt_bias and
    conv_b drawn too, so no term is trivial), x (B, S, d) and a decode
    input (B, 1, d), from a seeded generator on the CPU."""
    from repro_torch.models import mamba_param_specs

    gen = torch.Generator().manual_seed(seed)
    params = {k: (spec.scale * torch.randn(spec.shape, generator=gen)).to(dtype)
              for k, spec in mamba_param_specs(d).items()}
    params["a_log"] = torch.rand(params["a_log"].shape, generator=gen).to(dtype)
    params["d_skip"] = torch.ones_like(params["d_skip"])
    x = torch.randn((b, s, d), generator=gen).to(dtype)
    xd = torch.randn((b, 1, d), generator=gen).to(dtype)
    return ({k: v.to(device) for k, v in params.items()}, x.to(device), xd.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [40, 300])
def test_mamba_on_card_matches_cpu(cuda, dtype, s):
    """The Mamba mixer at d_model 128 (S 300 crosses a time block): prefill
    output and final state, then one decode step, on the card against the
    CPU; f32 within 1e-5 x max(1, max|ref|), bf16 within 2^-6 x max|ref|
    (tests/test_torch_ssm.py's tolerances against JAX)."""
    from repro_torch.models import mamba_decode_step, mamba_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    params, x, xd = _mamba_inputs(cuda, 128, 2, s, dtype, s)
    on_cpu = {k: v.cpu() for k, v in params.items()}

    def held(got, want):
        want = want.float()
        scale = want.abs().max().item()
        tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -6 * scale
        assert (got.cpu().float() - want).abs().max().item() <= tol

    out, st = mamba_forward(params, x)
    out_c, st_c = mamba_forward(on_cpu, x.cpu())
    for got, want in ((out, out_c), (st["ssm"], st_c["ssm"]), (st["conv"], st_c["conv"])):
        held(got, want)
    step, st1 = mamba_decode_step(params, xd, {k: v.to(cuda) for k, v in st_c.items()})
    step_c, st1_c = mamba_decode_step(on_cpu, xd.cpu(), st_c)
    for got, want in ((step, step_c), (st1["ssm"], st1_c["ssm"]), (st1["conv"], st1_c["conv"])):
        held(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_is_deterministic(cuda, dtype):
    """Two prefills and two decode steps on the same inputs are bitwise
    equal."""
    from repro_torch.models import mamba_decode_step, mamba_forward

    params, x, xd = _mamba_inputs(cuda, 256, 2, 300, dtype, 3)
    (o1, s1), (o2, s2) = mamba_forward(params, x), mamba_forward(params, x)
    assert torch.equal(o1, o2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    (d1, t1), (d2, t2) = mamba_decode_step(params, xd, s1), mamba_decode_step(params, xd, s1)
    assert torch.equal(d1, d2) and all(torch.equal(t1[k], t2[k]) for k in t1)
