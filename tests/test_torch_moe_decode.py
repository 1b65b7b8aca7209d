"""K8, the MoE FFN of a decode step over its routed experts
(``kernels/moe_decode.py``, ``csrc/moe_decode.cu``), K9, the routing and
capacity rule that feeds it (``kernels/moe_route.py``, ``csrc/moe_route.cu``),
and the rule in ``models/moe.py`` that routes a decode step to them.

On the CPU: K8's plain version (``ref.moe_decode_ref``) against the ``bmm``
path over all experts in f32 at decode shapes where no slot drops (E 16 top
2 at capacity factor 8, the arctic-style MoE beside a dense FFN, every lane
alike and every lane distinct) and where slots drop (granite's smoke MoE at
capacity 1 and 2, capacity factor 1.25), on K9's plain version
(``ref.moe_route_ref``), which is held bitwise to ``route``,
``slot_positions``, the aux loss and the kept gates; where the rule engages
and where it keeps the ``bmm`` path (a prefill, its dispatch chunks, more
rows than K8 holds, more experts than K9 takes), by the calls that reach
``ops.moe_route`` and ``ops.moe_decode``; the launch plan.  On the card
(``gpu``, skipped without one): K8 against its plain version at Jamba2-Mini's
decode shape and at a ragged small one, unrouted experts' weights never read
(NaN there leaves the output unchanged), two calls bitwise equal; K9 against
its plain version at granite's and Jamba2-Mini's widths, T 1-8, ties to the
lower index, two calls bitwise equal; and the graphed steps of the published
Jamba and the granite smoke models bitwise their eager steps with K9 and K8
counted through the replays.

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


def _count(monkeypatch, name: str) -> list:
    """The rows of each call that reaches ``ops.<name>`` (on the CPU the
    plain version, on the card the kernel)."""
    calls = []
    real = getattr(ops, name)

    def count(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(ops, name, count)
    return calls


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls that reach ``ops.moe_decode`` (K8)."""
    return _count(monkeypatch, "moe_decode")


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls that reach ``ops.moe_route`` (K9)."""
    return _count(monkeypatch, "moe_route")


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


# --------------------------------------------------------------- CPU: K9 twin
GRANITE = get_spec("granite-moe-1b-a400m").smoke.moe     # E 8, top 4, cf 1.25
JAMBA_V01 = get_spec("jamba-v0.1-52b").smoke.moe          # E 4, top 2, cf 1.25
# The routings K9 is held to: granite's smoke MoE at capacity 1 and 2 for B 4
# (capacity factors 0.5 and 1.25), jamba-v0.1's at cf 1.25 (E 4: a router
# vector spans two rows), the no-drop jamba-like MoE with unnormalised gates.
ROUTINGS = {"granite-cap1": dataclasses.replace(GRANITE, capacity_factor=0.5),
            "granite-cap2": GRANITE, "cf1.25": JAMBA_V01, "jamba-like": JAMBA_LIKE}


def _routing_chain(xf, router, cfg: MoEConfig):
    """What the ``bmm`` path computes of the routing: ``route``,
    ``slot_positions``, the aux loss and ``dispatch_bmm``'s kept gates."""
    t, e, k = xf.shape[0], cfg.n_experts, cfg.top_k
    probs, gates, experts = route(xf, router, k, cfg.renormalize)
    pos, counts = moe.slot_positions(experts, e)
    aux = ref.moe_aux_loss(counts, probs, k)
    kept = torch.where(pos < moe.capacity(t, cfg), gates.reshape(-1), 0.0)
    return experts, kept.view(t, k), aux


@pytest.mark.parametrize("alike", [False, True], ids=["distinct", "alike"])
@pytest.mark.parametrize("b", [1, 3, 4, 8])
@pytest.mark.parametrize("name", list(ROUTINGS))
def test_plain_route_is_the_routing_chain(name, b, alike):
    """K9's plain version, bitwise: the experts, the kept gates (a dropped
    slot's gate 0) and the aux loss of the routing chain it replaces."""
    cfg = ROUTINGS[name]
    d = 64
    p = _params(cfg, d, seed=b)
    xf = _x(b, d, seed=20 + b, alike=alike)[:, 0]
    got = ref.moe_route_ref(xf, p["router"], cfg.top_k, moe.capacity(b, cfg), cfg.renormalize)
    want = _routing_chain(xf, p["router"], cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if name == "granite-cap1" and b > 1:
        assert bool((got[1] == 0).any())         # slots drop


def test_plain_route_ties_go_to_the_lower_expert():
    """Equal router columns: every token takes experts 0..k-1 at gate 1/k,
    and token t's slots sit at position t, so tokens past the capacity (2)
    keep nothing."""
    cfg = MoEConfig(n_experts=8, top_k=3, d_expert=8, capacity_factor=1.5)
    router = torch.ones((64, 8))
    xf = torch.randn((4, 64), generator=torch.Generator().manual_seed(3))
    got = ref.moe_route_ref(xf, router, 3, moe.capacity(4, cfg))
    assert got[0].tolist() == [[0, 1, 2]] * 4
    torch.testing.assert_close(got[1], torch.tensor([[1 / 3] * 3] * 2 + [[0.0] * 3] * 2))
    assert all(torch.equal(g, w) for g, w in zip(got, _routing_chain(xf, router, cfg)))


@pytest.mark.parametrize("alike", [False, True], ids=["distinct", "alike"])
@pytest.mark.parametrize("name", ["granite-cap1", "granite-cap2", "cf1.25"])
def test_routed_equals_bmm_path_where_slots_drop(monkeypatch, counted, routed, name, alike):
    """Decodes of 4 lanes where slots drop: ``moe_ffn`` on K9's and K8's
    plain versions against the ``bmm`` path in f32, output to F32_TOL and
    the aux loss equal; lanes alike leave lanes 1-3 no slot at capacity 1."""
    cfg = ROUTINGS[name]
    d = 64
    p, x = _params(cfg, d, seed=5), _x(4, d, seed=6, alike=alike)
    out, aux = moe_ffn(x, p, cfg)
    want, want_aux = _bmm_path(monkeypatch, moe_ffn, x, p, cfg)
    assert counted == [4] and routed == [4]
    torch.testing.assert_close(out, want, **F32_TOL)
    assert torch.equal(aux, want_aux)
    kept = _routing_chain(x[:, 0], p["router"], cfg)[1]
    assert bool((kept == 0).any())
    if alike and name == "granite-cap1":
        assert bool((kept[1:] == 0).all()) and bool((out[1:] == 0).all())


# --------------------------------------------------------------- CPU: rule
@pytest.mark.parametrize("case,cfg,b,s,engages", [
    ("granite-decode", GRANITE, 4, 1, True),         # cap 2 < T 4: slots drop
    ("cf1.25-decode", JAMBA_V01, 4, 1, True),        # cap 2 < T 4
    ("jamba-like-prefill-chunks-of-1", JAMBA_LIKE, 1, 8, False),   # 8 dispatch chunks of S 1
    ("jamba-like-prefill", JAMBA_LIKE, 2, 5, False),
    ("jamba-like-decode", JAMBA_LIKE, 4, 1, True),   # cap 4 = T
    ("granite-one-lane", GRANITE, 1, 1, True),       # cap 1 = T 1
    ("jamba-like-past-held-rows", JAMBA_LIKE, MAX_ROWS + 1, 1, False),
    ("e128-decode", MoEConfig(n_experts=128, top_k=2, d_expert=96), 4, 1, False),  # E > 64
    ("e48-decode", MoEConfig(n_experts=48, top_k=2, d_expert=96), 4, 1, False),  # no power of 2
])
def test_rule_takes_decodes_at_any_capacity(counted, routed, case, cfg, b, s, engages):
    """The rule reads the input's shape and the configuration: K9 and K8
    where S = 1, T within the rows K8 holds and E within what K9 takes, at
    any capacity; the bmm path otherwise, whatever the dispatch chunks."""
    d = 64
    p = _params(cfg, d, seed=1)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(2))
    assert moe.decodes_routed(x, p, cfg) == engages
    moe_ffn(x, p, cfg)
    assert counted == ([b] if engages else []) and routed == counted


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
    ("jamba-v0.1-52b", 4),               # JAX's block: cf 1.25, slots drop
    ("granite-moe-1b-a400m", 3),         # cap 2 < T 4
    ("internlm2-20b", 0),                # a dense FFN
])
@torch.no_grad()
def test_decode_steps_of_smoke_models(counted, routed, arch, calls_a_step):
    """A served step of 4 lanes: every MoE layer of a MoE model goes through
    K9 and K8, whatever its capacity, no layer of a dense one; the prefill
    never does."""
    from repro_torch.models import Model, decode_step, init_random_, prefill

    spec = get_spec(arch.split()[0]).smoke
    cfg = published(spec) if arch.endswith("published") else spec
    model = init_random_(Model(dataclasses.replace(cfg, compute_dtype=torch.float32),
                               device="cpu"), 0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator().manual_seed(0))
    logits, cache = prefill(model, tokens, cache_len=32)
    assert counted == [] and routed == []
    tok = logits.argmax(-1)
    for _ in range(3):
        logits, cache = decode_step(model, tok, cache)
        tok = logits.argmax(-1)
    assert counted == [4] * (3 * calls_a_step) and routed == counted
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


def _graphed_step_is_its_eager_step(cuda, cfg):
    """Three steps of 4 lanes (eager warm-up, capture, replay), each against
    the eager step on a copy of the cache: logits and caches bit for bit,
    K9 and K8 launched once a MoE layer by each, replays included."""
    from repro_torch.models import Model, decode_step, init_random_, make_decode_cache
    from repro_torch.models.decode_graph import DecodeGraphs

    model = init_random_(Model(cfg, device=cuda), 0)
    n_moe = sum(f == "moe" for f in cfg.ffn_pattern) * cfg.n_periods
    cache = make_decode_cache(cfg, 4, 1024, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name, v in cache.items():
        if name != "pos":
            v.copy_(torch.randn(v.shape, generator=gen, device=cuda))
    graphs = DecodeGraphs(model, cache, 4)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=torch.Generator().manual_seed(2))
    kernels = ("moe_decode", "moe_route")
    for step in range(3):                    # eager warm-up, capture, replay
        eager = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
        cache["pos"] = eager["pos"] = 255
        before = {n: build.LAUNCHES[n] for n in kernels}
        got, _ = decode_step(model, tok, cache, graphs=graphs)
        got = got.clone()
        torch.cuda.synchronize()
        assert all(build.LAUNCHES[n] == before[n] + n_moe for n in kernels), step
        want, _ = decode_step(model, tok.to(cuda), eager)
        torch.cuda.synchronize()
        assert all(build.LAUNCHES[n] == before[n] + 2 * n_moe for n in kernels), step
        assert torch.equal(got, want), step
        for k, v in eager.items():
            if k != "pos":
                assert torch.equal(cache[k], v), (step, k)
    stats = graphs.stats()      # the first step is eager where no graph has run in the process
    assert stats["replays"] + stats["eager"] == 3 and stats["captures"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_graphed_jamba_step_is_its_eager_step(cuda, dtype):
    """The published Jamba smoke model, 4 lanes: a step replayed from its
    graph (K4's plan at the bucket's top is its plan at pos + 1 = 256) is
    the eager step bit for bit, caches too, with K9 and K8 on every MoE
    layer of both: ``build.LAUNCHES`` grows by the MoE layers at each eager
    step and at each replay."""
    cfg = dataclasses.replace(published(get_spec("jamba-v0.1-52b").smoke), compute_dtype=dtype)
    _graphed_step_is_its_eager_step(cuda, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_graphed_granite_step_is_its_eager_step(cuda, dtype):
    """The granite smoke model (E 8, top 4, capacity 2 at 4 lanes: slots
    drop), as the Jamba test above: the replayed step is the eager step bit
    for bit, K9 and K8 once a MoE layer each."""
    cfg = dataclasses.replace(get_spec("granite-moe-1b-a400m").smoke, compute_dtype=dtype)
    _graphed_step_is_its_eager_step(cuda, cfg)


# K9 at the widths of the two served MoE models: (d, E, k, capacity factor,
# renormalize) of granite-moe-1b-a400m and Jamba2-Mini.
ROUTE_SHAPES = {"granite": (1024, 32, 8, 1.25, True), "jamba2-mini": (4096, 16, 2, 8.0, False)}
# The kernel sums the logits in another order than cuBLAS: probabilities
# within f32 rounding; an expert is compared only where the plain version's
# k-th and (k+1)-th probabilities lie further apart than that.
ROUTE_RTOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", range(1, MAX_ROWS + 1))
@pytest.mark.parametrize("shape", list(ROUTE_SHAPES))
@torch.no_grad()
def test_route_kernel_equals_plain(cuda, shape, t, dtype):
    """K9 against its plain version on the card: experts equal on every row
    whose k-th and (k+1)-th probabilities are apart (and the kept gates of
    rows from the first one that is not on), gates and the aux loss at
    ROUTE_RTOL; two calls bitwise equal; one launch a call."""
    from repro_torch.kernels.moe_route import moe_route

    d, e, k, cf, renorm = ROUTE_SHAPES[shape]
    cfg = MoEConfig(n_experts=e, top_k=k, d_expert=8, capacity_factor=cf, renormalize=renorm)
    gen = torch.Generator(device=cuda).manual_seed(t * 100 + e)
    router = (torch.randn((d, e), generator=gen, device=cuda) * d ** -0.5).to(dtype)
    xf = torch.randn((t, d), generator=gen, device=cuda).to(dtype)
    cap = moe.capacity(t, cfg)
    before = build.LAUNCHES["moe_route"]
    experts, kept, aux = moe_route(xf, router, k, cap, renorm)
    torch.cuda.synchronize()
    assert build.LAUNCHES["moe_route"] == before + 1
    w_experts, w_kept, w_aux = ref.moe_route_ref(xf, router, k, cap, renorm)
    assert experts.dtype == torch.int64 and kept.dtype == aux.dtype == torch.float32
    assert experts.shape == kept.shape == (t, k) and aux.shape == ()
    probs = torch.softmax(xf.float() @ router.float(), dim=-1).sort(dim=-1, descending=True)[0]
    apart = (probs[:, k - 1] - probs[:, k]) > ROUTE_RTOL * probs[:, k - 1] if k < e else \
        torch.ones(t, dtype=torch.bool, device=cuda)
    assert torch.equal(experts[apart], w_experts[apart])
    settled = int(apart.long().cumprod(0).sum())          # rows before the first near tie
    torch.testing.assert_close(kept[:settled], w_kept[:settled], rtol=ROUTE_RTOL, atol=0)
    if settled == t:
        torch.testing.assert_close(aux, w_aux, rtol=ROUTE_RTOL, atol=0)
    assert bool((experts >= 0).all() and (experts < e).all())
    again = moe_route(xf, router, k, cap, renorm)
    assert all(torch.equal(a, b) for a, b in zip((experts, kept, aux), again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(ROUTE_SHAPES))
@torch.no_grad()
def test_route_kernel_ties_go_to_the_lower_expert(cuda, shape):
    """Planted ties: router columns equal in pairs (2j, 2j + 1) give equal
    probabilities, and of a pair the lower index ranks first: a token that
    takes 2j + 1 takes 2j just before it.  Every column equal: every token
    takes experts 0..k-1, and tokens past the capacity keep no gate."""
    from repro_torch.kernels.moe_route import moe_route

    d, e, k, _, renorm = ROUTE_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(7)
    half = (torch.randn((d, e // 2), generator=gen, device=cuda) * d ** -0.5).bfloat16()
    xf = torch.randn((8, d), generator=gen, device=cuda).bfloat16()
    experts, _, _ = moe_route(xf, half.repeat_interleave(2, dim=1).contiguous(), k, 8, renorm)
    for row in experts.tolist():
        for i, ex in enumerate(row):
            if ex % 2:
                assert i > 0 and row[i - 1] == ex - 1, row
    same = half[:, :1].expand(d, e).contiguous()
    experts, kept, _ = moe_route(xf, same, k, 2, renorm)
    assert experts.tolist() == [list(range(k))] * 8
    gate = 1 / k if renorm else 1 / e
    torch.testing.assert_close(kept[:2], torch.full((2, k), gate, device=cuda),
                               rtol=ROUTE_RTOL, atol=0)
    assert bool((kept[2:] == 0).all())
