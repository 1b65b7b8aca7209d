"""The decode path's host spans (``repro_torch.hosttrace``): recording
changes no result, each step's spans nest as documented, nothing is
recorded with the recorder off, and recording follows a ``torch.profiler``
session.  A dense and a MoE smoke model, on the CPU; the published Jamba
hybrid's smoke model for the prefill's and the Mamba blocks' spans; the
``gpu`` case holds the K4 launch stamps to ``build.LAUNCHES`` on the card.

This file imports no JAX: the machine with the card has none.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import hosttrace
from repro_torch.configs import get_spec
from repro_torch.configs.jamba_v01_52b import published
from repro_torch.kernels import build
from repro_torch.models import Model, decode_step, init_random_
from repro_torch.serving import DecodeEngine, DisaggregatedCluster, PrefillEngine, ServeRequest

ARCHS = ["internlm2-20b", "granite-moe-1b-a400m"]   # a dense and a MoE FFN
# the published block of configs/jamba_v01_52b.py: one period of attention at
# position 4 and seven Mamba blocks, dense and MoE FFNs in turn
JAMBA = "jamba-v0.1-52b published"
CACHE_LEN = 64
SLOTS = 4


@pytest.fixture(autouse=True)
def recorder_off():
    hosttrace.disable()
    yield
    hosttrace.disable()


def _model(arch, device="cpu"):
    smoke = published(get_spec("jamba-v0.1-52b").smoke) if arch == JAMBA else \
        get_spec(arch).smoke
    cfg = dataclasses.replace(smoke, compute_dtype=torch.float32)
    return init_random_(Model(cfg, device=device), 0)


def _layers(cfg, lanes):
    """(name, layer, b) of each block and FFN span an eager step records."""
    out = []
    for layer, (blk, ffn) in enumerate(zip(cfg.block_pattern * cfg.n_periods,
                                           cfg.ffn_pattern * cfg.n_periods)):
        out.append((hosttrace.ATTN, layer, 0) if blk == "attn" else
                   (hosttrace.MAMBA, layer, lanes))
        out.append((hosttrace.FFN, layer, int(ffn != "dense")))
    return out


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lengths]


def _engine(model, lengths=(9, 14), max_new=5):
    """A decode engine of ``SLOTS`` slots holding a request a prompt."""
    pe = PrefillEngine(0, model, CACHE_LEN)
    de = DecodeEngine(1, model, n_slots=SLOTS, cache_len=CACHE_LEN)
    for rid, prompt in enumerate(_prompts(model.cfg.vocab_size, lengths)):
        de.admit(rid, pe.run(rid, prompt), max_new)
    return de


def _steps(de, n):
    return [de.step() for _ in range(n)]


def _step_of(rec, i):
    """The ``decode.step`` span that holds span ``i``."""
    while rec.name[i] != hosttrace.STEP:
        i = rec.parent[i]
    return i


def _children(rec, parent):
    return [j for j in range(len(rec)) if rec.parent[j] == parent]


def _serve(arch, on):
    c = DisaggregatedCluster(_model(arch).cfg, n_prefill=2, n_decode=2, n_slots=SLOTS,
                             cache_len=CACHE_LEN, seed=5, params=_model(arch), device="cpu")
    reqs = [ServeRequest(rid, p, 4) for rid, p in
            enumerate(_prompts(c.cfg.vocab_size, (7, 20, 33)))]
    if on:
        hosttrace.enable()
    results = c.serve(reqs)
    rec = hosttrace.disable()
    return results, c.walls, rec


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_the_same_with_the_recorder_on(arch):
    off, walls_off, none = _serve(arch, False)
    on, walls_on, rec = _serve(arch, True)
    assert none is None and len(rec) > 0
    assert [dataclasses.asdict(r) for r in on] == [dataclasses.asdict(r) for r in off]
    strip = [{k: v for k, v in w.items() if not k.endswith("_s")} for w in walls_off]
    assert [{k: v for k, v in w.items() if not k.endswith("_s")} for w in walls_on] == strip
    assert [sorted(w) for w in walls_on] == [sorted(w) for w in walls_off]


@pytest.mark.parametrize("arch", ARCHS + [JAMBA])
def test_logits_and_cache_are_the_same_with_the_recorder_on(arch):
    de = _engine(_model(arch))
    cache = de.cache
    cache["pos"] = int(de._pos.max())
    tokens = torch.as_tensor(de._tokens)[:, None]
    c_off, c_on = copy.deepcopy(cache), copy.deepcopy(cache)
    logits_off, c_off = decode_step(de.model, tokens, c_off)
    rec = hosttrace.enable()
    logits_on, c_on = decode_step(de.model, tokens, c_on)
    hosttrace.disable()
    assert len(rec) == 2 * de.model.cfg.n_layers
    assert torch.equal(logits_on, logits_off)
    assert set(c_on) == set(c_off)
    for k, v in c_off.items():
        assert torch.equal(c_on[k], v) if isinstance(v, torch.Tensor) else c_on[k] == v, k


@pytest.mark.parametrize("arch", ARCHS + [JAMBA])
def test_each_step_nests_its_spans(arch):
    model = _model(arch)
    cfg = model.cfg
    de = _engine(model)
    rec = hosttrace.enable()
    n = 3
    _steps(de, n)
    assert hosttrace.disable() is rec
    steps = [i for i in range(len(rec)) if rec.name[i] == hosttrace.STEP]
    assert len(steps) == n
    assert all(rec.parent[i] == -1 for i in steps)
    assert all(t1 >= t0 for t0, t1 in zip(rec.t0, rec.t1))       # every span closed
    for i in steps:
        assert (rec.a[i], rec.b[i]) == (2, SLOTS)                  # 2 of 4 lanes serve
        kids = _children(rec, i)
        assert [rec.name[j] for j in kids] == [hosttrace.ENQUEUE, hosttrace.READBACK]
        enq, rb = kids
        assert rec.t0[i] <= rec.t0[enq] <= rec.t1[enq] <= rec.t0[rb] <= rec.t1[rb] <= rec.t1[i]
        assert _children(rec, rb) == []
        layers = _children(rec, enq)
        assert [(rec.name[j], rec.a[j], rec.b[j]) for j in layers] == _layers(cfg, SLOTS)
        ends = [rec.t0[enq]] + [t for j in layers for t in (rec.t0[j], rec.t1[j])] + \
            [rec.t1[enq]]
        assert ends == sorted(ends)                                  # in order, no overlap
        assert all(_children(rec, j) == [] for j in layers)
    # the plain K4 on the CPU launches nothing: no stamps
    assert rec.stamp_t == []


@pytest.mark.parametrize("arch", ARCHS + [JAMBA])
def test_nothing_is_recorded_with_the_recorder_off(arch):
    model = _model(arch)
    before = hosttrace.last_profiled()
    de = _engine(model)
    assert hosttrace.for_step() is None
    _steps(de, 2)
    assert hosttrace.RECORDER is None and hosttrace.disable() is None
    assert hosttrace.last_profiled() is before


def test_recording_follows_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    de = _engine(_model(ARCHS[0]), max_new=8)
    _steps(de, 1)
    assert hosttrace.RECORDER is None
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(de, 2)
    rec = hosttrace.last_profiled()
    assert rec is not None and hosttrace.RECORDER is rec
    assert [rec.name[i] for i in range(len(rec))].count(hosttrace.STEP) == 2
    n = len(rec)
    _steps(de, 1)                   # the first step after the session switches it off
    assert hosttrace.RECORDER is None and len(rec) == n
    assert hosttrace.last_profiled() is rec


def test_an_explicit_recorder_outlives_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    de = _engine(_model(ARCHS[0]), max_new=8)
    rec = hosttrace.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(de, 1)
    _steps(de, 1)
    assert hosttrace.disable() is rec
    assert [rec.name[i] for i in range(len(rec))].count(hosttrace.STEP) == 2


def test_prefill_records_its_mamba_blocks():
    """A prefill records ``prefill.run`` (a = its prompt's tokens) at the
    top, and inside it one ``layer.mamba`` span a Mamba block (a = layer, b
    = tokens mixed), in order, each closed inside its parent."""
    model = _model(JAMBA)
    cfg = model.cfg
    pe = PrefillEngine(0, model, CACHE_LEN)
    prompt = _prompts(cfg.vocab_size, (13,))[0]
    rec = hosttrace.enable()
    pe.run(0, prompt)
    assert hosttrace.disable() is rec
    assert rec.name[0] == hosttrace.PREFILL and rec.parent[0] == -1
    assert (rec.a[0], rec.b[0]) == (13, 0)
    kids = _children(rec, 0)
    assert len(rec) == 1 + len(kids)
    want = [(hosttrace.MAMBA, layer, 13) for layer in range(cfg.n_layers)
            if cfg.block_pattern[layer % len(cfg.block_pattern)] == "mamba"]
    assert [(rec.name[j], rec.a[j], rec.b[j]) for j in kids] == want
    ends = [rec.t0[0]] + [t for j in kids for t in (rec.t0[j], rec.t1[j])] + [rec.t1[0]]
    assert ends == sorted(ends)
    assert rec.stamp_t == []


def test_a_prefill_that_opens_a_profiler_session_records():
    """``PrefillEngine.run`` follows a profiler session as a decode step
    does: a prefill first in the session starts the record."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(JAMBA)
    pe = PrefillEngine(0, model, CACHE_LEN)
    prompt = _prompts(model.cfg.vocab_size, (9,))[0]
    with profile(activities=[ProfilerActivity.CPU]):
        pe.run(0, prompt)
    rec = hosttrace.last_profiled()
    assert rec is not None and hosttrace.RECORDER is rec
    assert [rec.name[i] for i in range(len(rec)) if rec.parent[i] == -1] == [hosttrace.PREFILL]
    assert rec.a[0] == 9 and all(t >= 0 for t in rec.t1)
    pe.run(1, prompt)               # the first prefill after the session switches it off
    assert hosttrace.RECORDER is None and hosttrace.last_profiled() is rec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_k4_stamps_count_its_launches(cuda, arch):
    model = _model(arch, device=cuda)
    de = _engine(model)
    before, replays_before = build.LAUNCHES["flash_decode"], de.graph_stats["replays"]
    rec = hosttrace.enable()
    out = _steps(de, 3)
    hosttrace.disable()
    assert all(len(e) == 2 for e in out)
    assert len(rec.stamp_t) == build.LAUNCHES["flash_decode"] - before == 3 * model.cfg.n_layers
    # a step whose enqueue holds a decode.graph span stamps inside it, any other step inside
    # its attention blocks
    replayed = {_step_of(rec, i) for i in range(len(rec)) if rec.name[i] == hosttrace.GRAPH}
    assert len(replayed) == de.graph_stats["replays"] - replays_before >= 2
    for p in rec.stamp_parent:
        assert rec.name[p] == (hosttrace.GRAPH if _step_of(rec, p) in replayed else hosttrace.ATTN)
    assert set(rec.stamp_name) == {hosttrace.K4_LAUNCH}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_k4_stamps_sit_in_the_attention_blocks_of_eager_steps(cuda, arch):
    """With the engine's graphs off every step is eager on the card: each
    K4 launch stamped once, inside its attention block."""
    model = _model(arch, device=cuda)
    de = _engine(model)
    de._graphs = None
    before = build.LAUNCHES["flash_decode"]
    rec = hosttrace.enable()
    _steps(de, 3)
    hosttrace.disable()
    assert len(rec.stamp_t) == build.LAUNCHES["flash_decode"] - before == 3 * model.cfg.n_layers
    assert all(rec.name[p] == hosttrace.ATTN for p in rec.stamp_parent)
    assert [rec.name[i] for i in range(len(rec))].count(hosttrace.ATTN) == 3 * model.cfg.n_layers
