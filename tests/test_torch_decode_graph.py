"""The decode step replayed as CUDA graphs (``models/decode_graph.py``).

On the CPU: the buckets cover every length, the device-only step body at a
bucket's top is the eager scalar step bit for bit (a dense and a MoE smoke
model and the published Jamba hybrid's, on both sides of two bucket edges),
the rule that decides where a graph engages, and the trace names.  On the card (``gpu``, skipped without
one): a profiler session round replays records every kernel of the graph
after its stamp, replays against the eager step over bucket edges, and the
engine's counts.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_graph.py

This file imports no JAX: the machine with the card has none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import hosttrace
from repro_torch.configs import get_spec
from repro_torch.configs.jamba_v01_52b import published
from repro_torch.kernels import build
from repro_torch.models import Model, decode_step, init_random_, make_decode_cache
from repro_torch.models.decode_graph import DecodeGraphs, bucket_top, eager_reason
from repro_torch.models.model import decode_body
from repro_torch.models.sharding import axis_rules
from repro_torch.serving import DecodeEngine, PrefillEngine

JAMBA = "jamba-v0.1-52b published"        # the published block of configs/jamba_v01_52b.py
ARCHS = ["internlm2-20b", "granite-moe-1b-a400m", JAMBA]   # dense, MoE, Mamba + attention
CACHE_LEN = 1024
SLOTS = 4
EDGES = [254, 255, 256, 511, 512]      # positions p: lengths p + 1 each side of 256 and 512
GRAPHED = ["internlm2-20b", "granite-moe-1b-a400m", "qwen3-14b", "phi3-medium-14b",
           "smollm-135m", "llama3-70b", "internvl2-76b", "arctic-480b", "jamba-v0.1-52b"]


@pytest.fixture(autouse=True)
def recorder_off():
    hosttrace.disable()
    yield
    hosttrace.disable()


def _smoke(arch):
    if arch == JAMBA:
        return published(get_spec("jamba-v0.1-52b").smoke)
    return get_spec(arch).smoke


def _model(arch, device="cpu", dtype=torch.float32):
    cfg = dataclasses.replace(_smoke(arch), compute_dtype=dtype)
    return init_random_(Model(cfg, device=device), 0)


def _filled_cache(model, seed, batch=SLOTS, cache_len=CACHE_LEN):
    """A decode cache whose K/V rows are all drawn from ``seed``."""
    cache = make_decode_cache(model.cfg, batch, cache_len, model.device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for k, v in cache.items():
        if k != "pos":
            v.copy_(torch.randn(v.shape, generator=gen, device=v.device))
    return cache


def _clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


# ---------------------------------------------------------------- buckets
@pytest.mark.parametrize("cache_len", [4096, 3000, 1024, 300, 256, 64])
def test_bucket_top_covers_every_length(cache_len):
    tops = [bucket_top(n, cache_len) for n in range(1, cache_len + 1)]
    for n, top in enumerate(tops, start=1):
        assert n <= top <= cache_len
        assert top == cache_len or (top >= 256 and top & (top - 1) == 0)
        assert top == min(cache_len, max(256, 1 << (n - 1).bit_length()))   # the least such
    assert tops == sorted(tops)
    assert len(set(tops)) <= 5
    if cache_len == 4096:
        assert sorted(set(tops)) == [256, 512, 1024, 2048, 4096]
    for n in (0, cache_len + 1):
        with pytest.raises(ValueError):
            bucket_top(n, cache_len)


# ---------------------------------------------------- the device-only body
@pytest.mark.parametrize("pos", EDGES)
@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_body_at_the_bucket_top_is_the_scalar_step_bitwise(arch, pos):
    """``decode_body`` with every lane at ``pos`` and K4 planned over the
    bucket's top gives the eager scalar step's logits, tokens and cache bit
    for bit (the eager step is the body planned at ``pos + 1``, which the
    model tests hold against JAX; K4's plain version reads each row's
    length)."""
    model = _model(arch)
    scalar = _filled_cache(model, seed=1)
    body = _clone(scalar)
    scalar["pos"] = pos
    tok = torch.randint(0, model.cfg.vocab_size, (SLOTS, 1),
                        generator=torch.Generator().manual_seed(pos))
    want, scalar = decode_step(model, tok, scalar)
    got = decode_body(model, tok, torch.full((SLOTS,), pos), body,
                      bucket_top(pos + 1, CACHE_LEN))
    assert torch.equal(got, want)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert scalar["pos"] == pos + 1 and body["pos"] == 0     # the body leaves pos as it is
    for k, v in scalar.items():
        if k != "pos":
            assert torch.equal(body[k], v), k


# -------------------------------------------------------- where it engages
def _meta(arch, **change):
    cfg = dataclasses.replace(get_spec(arch).smoke, **change)
    return Model(cfg, device="meta"), make_decode_cache(cfg, 2, 8, "meta")


@pytest.mark.parametrize("arch", GRAPHED)
def test_attention_decoders_wait_only_for_a_card(arch):
    """Every decoder of attention blocks, or of attention and Mamba blocks,
    with dense or MoE FFNs passes the rule but for the device: off a CUDA
    device its step runs eagerly."""
    model, cache = _meta(arch)
    assert eager_reason(model, cache, True) == "not on a CUDA device"


@pytest.mark.parametrize("arch,reason", [
    ("rwkv6-3b", "rwkv blocks"), ("seamless-m4t-medium", "encoder-decoder")])
def test_other_blocks_run_eagerly(arch, reason):
    model, cache = _meta(arch)
    assert eager_reason(model, cache, True) == reason


def test_mamba_blocks_need_an_attention_block():
    """A graph's buckets are those of the K/V cache: a model of Mamba blocks
    alone has none, and decodes eagerly."""
    model, cache = _meta("jamba-v0.1-52b", block_pattern=("mamba",) * 8)
    assert eager_reason(model, cache, True) == "no attention block"


def test_readonly_mesh_and_per_slot_decodes_run_eagerly():
    model, cache = _meta("internlm2-20b")
    assert eager_reason(model, cache, False) == "read-only decode"
    with axis_rules({"batch": ("data",)}):
        assert eager_reason(model, cache, True) == "mesh rules"
    cache["pos"] = torch.tensor([3, 5])
    assert eager_reason(model, cache, True) == "per-slot positions"


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_engine_steps_run_eagerly(arch):
    """On the CPU every engine step is eager and counted so; the runner
    declines a cache that is not its own."""
    model = _model(arch)
    pe = PrefillEngine(0, model, 64)
    de = DecodeEngine(1, model, n_slots=SLOTS, cache_len=64)
    rng = np.random.default_rng(0)
    de.admit(7, pe.run(7, rng.integers(0, model.cfg.vocab_size, 11)), 4)
    out = [de.step() for _ in range(3)]
    assert [len(e) for e in out] == [1, 1, 1]
    assert de.graph_stats == {"replays": 0, "captures": 0, "eager": 3, "graphs": 0,
                              "capture_s": 0.0, "pool_bytes": 0}
    other = _clone(de.cache)
    assert DecodeGraphs(model, de.cache, SLOTS).run(torch.zeros((SLOTS, 1), dtype=torch.long),
                                                    other, True) is None


def test_trace_names_are_appended():
    assert hosttrace.NAMES[:6] == ("decode.step", "decode.enqueue", "decode.readback",
                                   "layer.attn", "layer.ffn", "k4.launch")
    assert (hosttrace.STEP, hosttrace.ENQUEUE, hosttrace.READBACK, hosttrace.ATTN,
            hosttrace.FFN, hosttrace.K4_LAUNCH) == tuple(range(6))
    assert hosttrace.NAMES[hosttrace.GRAPH] == "decode.graph" and hosttrace.GRAPH == 6
    assert hosttrace.NAMES[7:] == ("layer.mamba", "prefill.run")
    assert (hosttrace.MAMBA, hosttrace.PREFILL) == (7, 8)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products on both sides
    return torch.device("cuda")


def _engine(model, lengths, max_new, seed=3):
    pe = PrefillEngine(0, model, CACHE_LEN)
    de = DecodeEngine(1, model, n_slots=SLOTS, cache_len=CACHE_LEN)
    rng = np.random.default_rng(seed)
    for rid, (n, m) in enumerate(zip(lengths, max_new)):
        de.admit(rid, pe.run(rid, rng.integers(0, model.cfg.vocab_size, n)), m)
    return de


def _top(de):
    return bucket_top(int(max(de._pos[i] for i, s in enumerate(de.slots) if s.active)) + 1,
                      CACHE_LEN)


@pytest.mark.gpu
def test_profiler_records_every_replayed_kernel(cuda):
    """Graphs captured before a ``torch.profiler`` session, and one
    captured inside it, replay inside it: the trace holds K4's split kernel
    attention layers x replays times, each starting after its ``k4.launch``
    stamp (laid on the trace's clock through the record's clock pair)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model("internlm2-20b", cuda)
    de = _engine(model, (245,), (40,))
    while _top(de) == 256 and int(de._pos.max()) < 250:     # warm, capture bucket 256
        de.step()
    before = dict(de.graph_stats)
    assert before["captures"] == 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(12):                                 # crosses 256: captures 512 inside
            de.step()
    rec = hosttrace.last_profiled()
    de.step()                                               # switches the recorder off
    after = de.graph_stats
    replays = after["replays"] - before["replays"] - 1
    assert replays == 12 and after["captures"] == 2
    graph_spans = [i for i in range(len(rec)) if rec.name[i] == hosttrace.GRAPH]
    assert len(graph_spans) == 12
    assert [rec.b[i] for i in graph_spans].count(1) == 1
    assert all(rec.name[rec.parent[i]] == hosttrace.ENQUEUE for i in graph_spans)
    assert not any(rec.name[i] in (hosttrace.ATTN, hosttrace.FFN) for i in range(len(rec)))
    n_attn = model.cfg.n_attn_layers
    k4 = sorted(ev.time_range.start for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and "flash_decode_split" in ev.name)
    stamps = rec.stamp_t
    assert len(k4) == len(stamps) == n_attn * replays
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    shift = rec.clock[1] - rec.clock[0] - start_ns
    lags = [k - (s + shift) / 1e3 for s, k in zip(stamps, k4)]
    assert min(lags) > 0, lags[:8]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()
def test_replay_matches_eager_across_bucket_edges(cuda, arch):
    """A step replayed from its bucket's graph against the eager scalar step
    on a copy of the cache: the same tokens; the logits bitwise where K4's
    plan at the bucket's top is the plan at ``pos + 1``, else within f32
    rounding; the caches alike."""
    from repro_torch.kernels.flash_decode import split_plan

    model = _model(arch, cuda)
    cfg = model.cfg
    cache = _filled_cache(model, seed=1)
    graphs = DecodeGraphs(model, cache, SLOTS)
    gen = torch.Generator().manual_seed(2)
    for p in (253, 254, 255, 256, 257, 510, 511, 512, 513):
        tok = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=gen)
        eager = _clone(cache)                   # both sides start each step alike
        cache["pos"] = eager["pos"] = p
        got, _ = decode_step(model, tok, cache, graphs=graphs)
        got = got.clone()
        want, _ = decode_step(model, tok.to(cuda), eager)
        assert cache["pos"] == eager["pos"] == p + 1
        assert torch.equal(got.argmax(-1), want.argmax(-1)), p
        plans = {split_plan(SLOTS, cfg.n_kv_heads, n, build.sm_count(cuda), cfg.d_head * 4)
                 for n in (p + 1, bucket_top(p + 1, CACHE_LEN))}
        if len(plans) == 1:
            assert torch.equal(got, want), p
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        for k, v in eager.items():
            if k != "pos":
                torch.testing.assert_close(cache[k], v, atol=1e-4, rtol=0)
    stats = graphs.stats()
    assert stats["replays"] + stats["eager"] == 9 and stats["graphs"] <= 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_stats_count_the_steps(cuda, arch):
    """An engine whose lanes cross bucket edges: at most one capture a
    bucket used, replays = steps - eager, K4's launch count grows by the
    graph's calls at each replay, and the tokens are an eager engine's."""
    model = _model(arch, cuda)
    lengths, max_new = (240, 505), (30, 12)   # tops 512, 1024, then 256, 512
    de, ref = _engine(model, lengths, max_new), _engine(model, lengths, max_new)
    ref._graphs = None                          # every step of ref eager
    tops, steps, launched = set(), 0, build.LAUNCHES["flash_decode"]
    out, want = [], []
    while any(s.active for s in de.slots):
        tops.add(_top(de))
        out.append(de.step())
        want.append(ref.step())
        steps += 1
    stats = de.graph_stats
    assert out == want
    assert tops == {512, 1024, 256}
    assert stats["captures"] == stats["graphs"] <= len(tops)
    assert stats["replays"] == steps - stats["eager"]
    assert build.LAUNCHES["flash_decode"] - launched == 2 * steps * model.cfg.n_attn_layers
