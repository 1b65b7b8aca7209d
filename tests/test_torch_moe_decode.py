"""K8, the MoE FFN of a decode step over its routed experts
(``kernels/moe_decode.py``, ``csrc/moe_decode.cu``), and the rule in
``models/moe.py`` that routes a decode step to it.

On the CPU: the plain version (``ref.moe_decode_ref``) against the ``bmm``
path over all experts in f32 at decode shapes where no slot drops (E 16 top
2 at capacity factor 8, the arctic-style MoE beside a dense FFN, every lane
alike and every lane distinct); where the rule engages and where it keeps
the ``bmm`` path (granite's decode, a prefill, capacity factor 1.25), by the
calls that reach ``ops.moe_decode``; the launch plan.  On the card (``gpu``,
skipped without one): the kernel against its plain version at Jamba2-Mini's
decode shape and at a ragged small one, unrouted experts' weights never
read (NaN there leaves the output unchanged), two calls bitwise equal, and
the graphed step of the published Jamba smoke model bitwise its eager step
with K8 counted through the replays.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_decode.py

This file imports no JAX: the machine with the card has none.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_spec
from repro_torch.configs.jamba_v01_52b import published
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.moe_decode import ALIGN, MAX_ROWS, ROW_BYTES, held_rows, plan
from repro_torch.models import moe
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_with_residual, route

# f32 on the CPU: the plain version and the bmm path take the same products
# in other batch shapes, so their sums differ in the last bits only.
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _params(cfg: MoEConfig, d: int, d_ff: int = 0, seed: int = 0, dtype=torch.float32,
            device="cpu"):
    """Router and experts (and a dense residual FFN of width d_ff) drawn at
    the scale of the model's init, on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    e, f = cfg.n_experts, cfg.d_expert
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    if d_ff:
        shapes.update(res_gate=(d, d_ff), res_up=(d, d_ff), res_down=(d_ff, d))
    return {k: (torch.randn(s, generator=gen) * s[-2] ** -0.5).to(dtype).to(device)
            for k, s in shapes.items()}


def _x(b: int, d: int, seed: int, alike: bool, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1 if alike else b, 1, d), generator=gen)
    return x.expand(b, 1, d).contiguous().to(dtype).to(device)


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls that reach ``ops.moe_decode`` (on the CPU the plain
    version, on the card the kernel)."""
    calls = []
    real = ops.moe_decode

    def count(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(ops, "moe_decode", count)
    return calls


def _bmm_path(monkeypatch, fn, *args):
    """``fn`` with K8's rule declined: the dispatch and the bmm over every
    expert."""
    with monkeypatch.context() as m:
        m.setattr(moe, "decodes_routed", lambda *a: False)
        return fn(*args)


# --------------------------------------------------------------- CPU: twin
JAMBA_LIKE = MoEConfig(n_experts=16, top_k=2, d_expert=96, capacity_factor=8.0,
                       dispatch_chunks=8, renormalize=False)


@pytest.mark.parametrize("alike", [False, True], ids=["distinct", "alike"])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_plain_equals_bmm_path_e16_top2(monkeypatch, counted, b, alike):
    """E 16, top 2, capacity factor 8 (no drop): the plain version through
    ``moe_ffn`` against the bmm path, output and aux loss; lanes alike route
    to one pair of experts (each takes all B rows), distinct ones spread."""
    d = 64
    p, x = _params(JAMBA_LIKE, d, seed=b), _x(b, d, seed=10 + b, alike=alike)
    out, aux = moe_ffn(x, p, JAMBA_LIKE)
    want, want_aux = _bmm_path(monkeypatch, moe_ffn, x, p, JAMBA_LIKE)
    assert counted == [b]
    torch.testing.assert_close(out, want, **F32_TOL)
    assert torch.equal(aux, want_aux)
    experts = route(x[:, 0], p["router"], 2, False)[2]
    assert (len(experts.unique()) == 2) == (alike or b == 1)


@pytest.mark.parametrize("alike", [False, True], ids=["distinct", "alike"])
def test_plain_equals_bmm_path_arctic_style(monkeypatch, counted, alike):
    """The arctic-style MoE beside a dense FFN (``moe_with_residual``) at
    capacity factor E / k, renormalised gates: the plain version's sum
    against the bmm path's."""
    cfg = dataclasses.replace(get_spec("arctic-480b").smoke.moe, capacity_factor=4.0)
    d = get_spec("arctic-480b").smoke.d_model
    p, x = _params(cfg, d, d_ff=160, seed=3), _x(4, d, seed=4, alike=alike)
    out, _ = moe_with_residual(x, p, cfg)
    want, _ = _bmm_path(monkeypatch, moe_with_residual, x, p, cfg)
    assert counted == [4]
    torch.testing.assert_close(out, want, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_rounds_where_the_bmm_path_rounds(monkeypatch, dtype):
    """At the published Jamba smoke MoE (E 4, top 2, cf 2), in the compute
    dtype on the CPU: the plain version called directly equals the bmm
    path's output in f32 to its rounding and in bf16 bit for bit (both round
    g, u, silu, h, y, the gated terms and each sum, from f32 products)."""
    smoke = published(get_spec("jamba-v0.1-52b").smoke)
    cfg, d = smoke.moe, smoke.d_model
    p = _params(cfg, d, seed=7, dtype=dtype)
    xf = _x(4, d, seed=8, alike=False, dtype=dtype)[:, 0]
    _, gates, experts = route(xf, p["router"], cfg.top_k, cfg.renormalize)
    got = ref.moe_decode_ref(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
    pos, _ = moe.slot_positions(experts, cfg.n_experts)
    want = moe.dispatch_bmm(xf, experts, gates, pos, 4, p)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **F32_TOL)


# --------------------------------------------------------------- CPU: rule
GRANITE = get_spec("granite-moe-1b-a400m").smoke.moe     # E 8, top 4, cf 1.25
JAMBA_V01 = get_spec("jamba-v0.1-52b").smoke.moe          # E 4, top 2, cf 1.25


@pytest.mark.parametrize("case,cfg,b,s,engages", [
    ("granite-decode", GRANITE, 4, 1, False),        # cap 1 < T 4
    ("cf1.25-decode", JAMBA_V01, 4, 1, False),       # cap 2 < T 4
    ("jamba-like-prefill-chunks-of-1", JAMBA_LIKE, 1, 8, False),   # 8 dispatch chunks of S 1
    ("jamba-like-prefill", JAMBA_LIKE, 2, 5, False),
    ("jamba-like-decode", JAMBA_LIKE, 4, 1, True),   # cap 4 = T
    ("granite-one-lane", GRANITE, 1, 1, True),       # cap 1 = T 1: nothing can drop
    ("jamba-like-past-held-rows", JAMBA_LIKE, MAX_ROWS + 1, 1, False),
])
def test_rule_takes_only_no_drop_decodes(counted, case, cfg, b, s, engages):
    """The rule reads the input's shape and the configuration: K8 where S =
    1, T within the rows it holds and cap >= T; the bmm path otherwise,
    whatever the dispatch chunks."""
    d = 64
    p = _params(cfg, d, seed=1)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(2))
    assert moe.decodes_routed(x, p, cfg) == engages
    moe_ffn(x, p, cfg)
    assert counted == ([b] if engages else [])


def test_rule_declines_gradients_and_meta(counted):
    """Training differentiates the bmm path (K8 has no backward), and meta
    tensors (the dry run's) have no kernel route."""
    d = 64
    p = _params(JAMBA_LIKE, d, seed=1)
    x = torch.randn((4, 1, d))
    assert moe.decodes_routed(x, p, JAMBA_LIKE)
    grad = {k: v.clone().requires_grad_() for k, v in p.items()}
    assert not moe.decodes_routed(x, grad, JAMBA_LIKE)
    with torch.no_grad():
        assert moe.decodes_routed(x, grad, JAMBA_LIKE)
    meta = {k: v.to("meta") for k, v in p.items()}
    assert not moe.decodes_routed(x.to("meta"), meta, JAMBA_LIKE)
    out, _ = moe_ffn(x, grad, JAMBA_LIKE)
    out.sum().backward()
    assert counted == [] and grad["w_down"].grad is not None


@pytest.mark.parametrize("arch,calls_a_step", [
    ("jamba-v0.1-52b published", 4),     # 4 MoE layers of 8, cap 4 = T 4
    ("jamba-v0.1-52b", 0),               # JAX's block: cf 1.25
    ("granite-moe-1b-a400m", 0),         # cap 1 < T 4
    ("internlm2-20b", 0),                # a dense FFN
])
@torch.no_grad()
def test_decode_steps_of_smoke_models(counted, arch, calls_a_step):
    """A served step of 4 lanes: every MoE layer of the published Jamba
    block goes through K8's route, no layer of the others; the prefill
    never does."""
    from repro_torch.models import Model, decode_step, init_random_, prefill

    spec = get_spec(arch.split()[0]).smoke
    cfg = published(spec) if arch.endswith("published") else spec
    model = init_random_(Model(dataclasses.replace(cfg, compute_dtype=torch.float32),
                               device="cpu"), 0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator().manual_seed(0))
    logits, cache = prefill(model, tokens, cache_len=32)
    assert counted == []
    tok = logits.argmax(-1)
    for _ in range(3):
        logits, cache = decode_step(model, tok, cache)
        tok = logits.argmax(-1)
    assert counted == [4] * (3 * calls_a_step)
    if calls_a_step:
        assert calls_a_step == sum(f == "moe" for f in cfg.ffn_pattern) * cfg.n_periods


# --------------------------------------------------------------- CPU: plan
@pytest.mark.parametrize("t,d,f,dtype", [
    (4, 4096, 14336, torch.bfloat16),     # Jamba2-Mini's decode
    (1, 4096, 14336, torch.bfloat16),
    (8, 4096, 14336, torch.bfloat16),
    (2, 7168, 4864, torch.float32),       # arctic's widths in f32
    (3, 200, 328, torch.bfloat16),        # ragged
    (5, 128, 96, torch.float32),
    (1, 8, 8, torch.float32),
])
def test_plan_covers_f_and_fits_shared_memory(t, d, f, dtype):
    p = plan(t, d, f, dtype)
    size = dtype.itemsize
    assert p.rows >= t and p.rows & (p.rows - 1) == 0 and p.rows <= MAX_ROWS
    assert p.rows * d * size <= ROW_BYTES and p.rows * p.range_len * size <= ROW_BYTES
    assert p.range_len % ALIGN == 0
    assert (p.n_split - 1) * p.range_len < f <= p.n_split * p.range_len
    assert plan(t, d, f, dtype) == p                  # shapes alone decide it
    if (t, d, f) == (4, 4096, 14336):
        assert p == (4, 4, 3584)


def test_plan_refuses_what_the_kernel_cannot_take():
    assert held_rows(4096, torch.bfloat16) == 8 and held_rows(7168, torch.float32) == 2
    assert held_rows(ROW_BYTES, torch.float32) == 0
    with pytest.raises(ValueError):
        plan(3, 7168, 4864, torch.float32)          # 3 rows round up to 4: past what fits
    with pytest.raises(ValueError):
        plan(4, 100, 96, torch.bfloat16)            # d not a multiple of 8


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's f32 products in full
    return torch.device("cuda")


# The kernel and its plain version both take f32 products and round at the
# same places; they differ in the order of the f32 sums, which moves a
# rounded intermediate by one step in rare elements.  f32: the sums' order
# alone.  bf16: one rounding step of the largest output (a token's two
# terms may cancel, so a step of a term shows on a small output), and most
# elements bit for bit (a rounding put elsewhere would move most of them).
K8_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}
K8_EQUAL_SHARE = 0.9


def _card_case(cuda, t, d, f, e, k, dtype, seed, renormalize=False):
    cfg = MoEConfig(n_experts=e, top_k=k, d_expert=f, capacity_factor=e / k,
                    renormalize=renormalize)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    p = {n: (torch.randn(s, generator=gen, device=cuda) * s[-2] ** -0.5).to(dtype)
         for n, s in shapes.items()}
    xf = torch.randn((t, d), generator=gen, device=cuda).to(dtype)
    _, gates, experts = route(xf, p["router"], k, renormalize)
    return cfg, p, xf, gates, experts


def _k8_check(got, want):
    rtol, atol = K8_TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * float(want.float().abs().max()))
    if want.dtype == torch.bfloat16:
        assert float((got == want).float().mean()) >= K8_EQUAL_SHARE


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (4, 4096, 14336, 16, 2),    # Jamba2-Mini's decode: T 4, d 4096, f 14,336, E 16, top 2
    (3, 200, 328, 5, 2),        # ragged: T not a power of two, d and f not multiples of 64
    (8, 96, 40, 3, 3),          # every expert of every token: 8 rows a block
    (1, 64, 16, 2, 1),
], ids=["jamba2-mini", "ragged", "all-experts", "tiny"])
@torch.no_grad()
def test_kernel_equals_plain(cuda, shape, dtype):
    from repro_torch.kernels.moe_decode import moe_decode

    t, d, f, e, k = shape
    if dtype == torch.float32 and d == 4096:
        d, f = 1024, 3584                      # f32 at a quarter of the widths: 0.7 GB of weights
    _, p, xf, gates, experts = _card_case(cuda, t, d, f, e, k, dtype, seed=t + d)
    before = build.LAUNCHES["moe_decode"]
    got = moe_decode(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_decode"] == before + 1
    want = ref.moe_decode_ref(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
    assert got.shape == (t, d) and got.dtype == dtype
    _k8_check(got, want)
    assert torch.equal(got, moe_decode(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"]))


@pytest.mark.gpu
@pytest.mark.parametrize("alike", [False, True], ids=["distinct", "alike"])
@torch.no_grad()
def test_unrouted_experts_are_not_read(cuda, alike):
    """At Jamba2-Mini's shape in bf16: NaN in every weight of every expert
    no token routes to leaves the output bitwise as it was."""
    from repro_torch.kernels.moe_decode import moe_decode

    _, p, xf, gates, experts = _card_case(cuda, 4, 4096, 14336, 16, 2, torch.bfloat16, seed=5)
    if alike:
        xf = xf[:1].expand(4, -1).contiguous()
        _, gates, experts = route(xf, p["router"], 2, False)
    want = moe_decode(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
    unrouted = sorted(set(range(16)) - set(experts.unique().tolist()))
    assert len(unrouted) >= 16 - 8 and (len(unrouted) == 14) == alike
    for n in ("w_gate", "w_up", "w_down"):
        p[n][unrouted] = float("nan")
    got = moe_decode(xf, experts, gates, p["w_gate"], p["w_up"], p["w_down"])
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_graphed_jamba_step_is_its_eager_step(cuda, dtype):
    """The published Jamba smoke model, 4 lanes: a step replayed from its
    graph (K4's plan at the bucket's top is its plan at pos + 1 = 256) is
    the eager step bit for bit, caches too, with K8 on every MoE layer of
    both: ``build.LAUNCHES["moe_decode"]`` grows by the MoE layers at each
    eager step and at each replay."""
    from repro_torch.models import Model, decode_step, init_random_, make_decode_cache
    from repro_torch.models.decode_graph import DecodeGraphs

    cfg = dataclasses.replace(published(get_spec("jamba-v0.1-52b").smoke), compute_dtype=dtype)
    model = init_random_(Model(cfg, device=cuda), 0)
    n_moe = sum(f == "moe" for f in cfg.ffn_pattern) * cfg.n_periods
    cache = make_decode_cache(cfg, 4, 1024, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name, v in cache.items():
        if name != "pos":
            v.copy_(torch.randn(v.shape, generator=gen, device=cuda))
    graphs = DecodeGraphs(model, cache, 4)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=torch.Generator().manual_seed(2))
    for step in range(3):                    # eager warm-up, capture, replay
        eager = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
        cache["pos"] = eager["pos"] = 255
        before = build.LAUNCHES["moe_decode"]
        got, _ = decode_step(model, tok, cache, graphs=graphs)
        got = got.clone()
        torch.cuda.synchronize()
        assert build.LAUNCHES["moe_decode"] == before + n_moe
        want, _ = decode_step(model, tok.to(cuda), eager)
        torch.cuda.synchronize()
        assert build.LAUNCHES["moe_decode"] == before + 2 * n_moe
        assert torch.equal(got, want), step
        for k, v in eager.items():
            if k != "pos":
                assert torch.equal(cache[k], v), (step, k)
    stats = graphs.stats()      # the first step is eager where no graph has run in the process
    assert stats["replays"] + stats["eager"] == 3 and stats["captures"] == 1
