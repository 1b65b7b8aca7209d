"""The Jamba stack (``stacks/jamba.py``), its reference (``reference/jamba.py``)
and the Mamba prefill metric: the drawn tensors are the program's parameter
tree, the program's config is the published block, the work of a decode
step and the transfer's layout on fixed inputs and against the program's own
pack, the reference against the program in float32, the reader on hand-made
records, and rehearsals of a jamba-smoke cell on the CPU."""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
from nkb import correct, harness, program, program_trace, spec, stacks, weights
from reference import jamba as ref

SMOKE, FULL = "jamba-smoke", "jamba2-mini-16l"
CELL = "jamba-smoke.smoke-closed"
SEED = 2 ** 31 + 101
# A rehearsal's window: a CPU decode step of the smoke hybrid (16 layers, bf16)
# takes 0.05-0.3 s as the host is loaded, so the traced stretch (from 0.35 of
# the window) has steps before it and inside it.
WINDOW_S = 6.0
ht = program.engine_module.hosttrace


def _meta_weights(cfg):
    return {name: torch.empty(shape, dtype=getattr(torch, dt), device="meta")
            for name, shape, dt, _, _ in stacks.of(cfg).weight_specs(cfg)}


# ---------------------------------------------------------------- the stack
@pytest.mark.parametrize("name", [SMOKE, FULL])
def test_drawn_tensors_are_the_program_tree(name):
    """``model_with`` loads the stack's tensors strictly: every name of the
    program's ``state_dict`` drawn, no other, in the program's shapes."""
    cfg = spec.config(name)
    mcfg = program.model_config(cfg)
    model = program.model_with(mcfg, _meta_weights(cfg))
    specs = {n: s for n, s, *_ in stacks.of(cfg).weight_specs(cfg)}
    assert set(specs) == set(model.state_dict())
    assert all(tuple(t.shape) == specs[n] for n, t in model.state_dict().items())
    assert {n.split(".")[-1] for n in specs if n.startswith("layers.b0.")} >= {
        "dt_norm", "b_norm", "c_norm", "a_log", "dt_bias"}


def test_program_config_is_the_published_block():
    m = program.model_config(spec.config(FULL))
    got = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    assert got.pop("moe") == m.moe
    assert got == dict(
        name=FULL, d_model=4096, n_layers=16, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=65536,
        block_pattern=("mamba",) * 4 + ("attn",) + ("mamba",) * 3,
        ffn_pattern=("dense", "moe") * 4, qk_norm=False, n_enc_layers=0, frontend=None,
        n_prefix_embeds=0, rope_theta=1e6, norm_eps=1e-6, attn_chunk=1024,
        compute_dtype=torch.bfloat16, remat=False)
    assert (m.attn_rope, m.mamba_inner_norms, m.n_periods, m.n_attn_layers) == (False, True, 2, 2)
    assert dataclasses.asdict(m.moe) == dict(n_experts=16, top_k=2, d_expert=14336,
                                             capacity_factor=8.0, dense_residual=False,
                                             dispatch_chunks=8)
    assert m.moe.renormalize is False


@pytest.mark.parametrize("key,value", [("mamba_d_state", 32), ("mamba_dt_rank", 128),
                                       ("capacity_factor", 1.25)])
def test_a_configuration_the_program_cannot_run_is_refused(key, value):
    cfg = dict(spec.config(FULL), **{key: value})
    with pytest.raises(ValueError, match=key):
        stacks.of(cfg).model_fields(cfg)


def test_decode_step_work_on_fixed_inputs():
    """One lane reads its two routed experts of each MoE layer (12.1 GB of
    weights, the stage's 8 MoE layers), eight lanes every expert (51.6 GB):
    the reckoning of the cell's memory; each lane adds its Mamba states (14
    layers, read and written) and its K/V rows of the 2 attention layers."""
    cfg = spec.config(FULL)
    work = stacks.of(cfg).decode_step_work
    one, eight = work(cfg, [0]), work(cfg, [0] * 8)
    assert one == (12126404480.0, 12117639168.0)
    assert eight == (51698982784.0, 96941113344.0)
    experts = 8 * 2 * 3 * 4096 * 14336 * 2            # 2 more experts in each MoE layer
    state = 14 * 2 * (8192 * 16 * 4 + 3 * 8192 * 2)    # a lane's ssm and conv, read, written
    kv_row = 2 * 2 * 8 * 128 * 2                        # 2 layers, K and V, a position
    assert work(cfg, [0, 100])[0] - one[0] == experts + state + kv_row * 102 + 4096 * 2
    assert work(cfg, []) == (0.0, 0.0)


def test_transfer_layout_is_the_programs_pack():
    """The pack of the program's own prefill of a 37-token prompt at smoke
    size: its tables and leaves shipped whole are the stack's layout, and
    the check finds nothing wrong."""
    from repro_torch.models.model import prefill
    from repro_torch.serving.transfer import pack_transfer

    cfg = spec.config(SMOKE)
    w = weights.draw(cfg, 3, torch.device("cpu"))
    model = program.model_with(program.model_config(cfg), w)
    cache_len = cfg["deployment"]["cache_len"]
    _, cache = prefill(model, torch.arange(37)[None] % 256, cache_len=cache_len)
    buffers, nbytes = pack_transfer(cache, 0)
    pack = dict(pos=37, hit_pages=0, nbytes=nbytes,
                tables={k: t for k, (_, t) in buffers.items() if t is not None},
                whole={k: b.numel() * b.element_size() for k, (b, t) in buffers.items()
                       if t is None})
    tables, whole = stacks.of(cfg).transfer_layout(cfg, 37, cache_len // 16)
    assert pack["tables"] == tables and pack["whole"] == whole
    assert sorted(tables) == ["k4", "v4"] and len(whole) == 14
    assert correct.transfer_mismatches([pack], [{"tables": tables}], cfg, {37}) == []


def test_transfer_layout_at_full_size():
    cfg = spec.config(FULL)
    tables, whole = stacks.of(cfg).transfer_layout(cfg, 3584, 256)
    assert tables["k4"] == tables["v4"] == tuple(range(224)) + tuple(range(256, 480))
    assert sum(whole.values()) == 8_028_160            # 8.03 MB of Mamba state
    assert whole["ssm0"] == 2 * 8192 * 16 * 4 and whole["conv7"] == 2 * 3 * 8192 * 2


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("n_prompt", [37, 40])
def test_reference_matches_the_program_in_float32(n_prompt):
    """Prefill's logits and each decode step's through the cache, both in
    float32 from the same tensors: equal within the rounding of summing in
    other orders."""
    from repro_torch.models.model import decode_step, prefill

    cfg = copy.deepcopy(spec.config(SMOKE))
    cfg["dtype"] = "float32"
    w = weights.draw(cfg, 5, torch.device("cpu"))
    model = program.model_with(program.model_config(cfg), w)
    tokens = np.random.default_rng(3).integers(0, cfg["vocab_size"], n_prompt + 6)
    logits, cache = prefill(model, torch.as_tensor(tokens[:n_prompt])[None],
                            cache_len=n_prompt + 16)
    got = [logits[0, -1]]
    for t in tokens[n_prompt:]:
        logits, cache = decode_step(model, torch.tensor([[int(t)]]), cache)
        got.append(logits[0, -1])
    want = ref.served_logits(w, cfg, [(torch.as_tensor(tokens), n_prompt)])[0]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_padded_sequences_scan_as_alone():
    """The reference scans several sequences at once, padded: each one's
    logits are those it gives alone, within the rounding of the readout's
    batched product, which sums in another order for two sequences than
    for one."""
    cfg = copy.deepcopy(spec.config(SMOKE))
    cfg["dtype"] = "float32"
    w = weights.draw(cfg, 4, torch.device("cpu"))
    seqs = [(torch.arange(30) % 256, 20), (torch.arange(9, 21), 5)]
    both = ref.served_logits(w, cfg, seqs)
    for s, got in zip(seqs, both):
        torch.testing.assert_close(got, ref.served_logits(w, cfg, [s])[0], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------- the reader
PERF_ON_S = 1.0


def _ns(us):
    return int(PERF_ON_S * 1e9 + us * 1e3)


def _record(prefills):
    """Top-level spans, each (name, t0, t1, a, children as (name, t0, t1))
    in microseconds from the stretch's start."""
    rec = ht.HostTrace()

    def span(name, t0, t1, parent, a=0, b=0):
        for col, v in zip((rec.name, rec.t0, rec.t1, rec.parent, rec.a, rec.b),
                          (name, _ns(t0), _ns(t1), parent, a, b)):
            col.append(v)
        return len(rec.t0) - 1

    for name, t0, t1, a, kids in prefills:
        i = span(name, t0, t1, -1, a)
        for k, (kid, k0, k1) in enumerate(kids):
            span(kid, k0, k1, i, k, a)
    return rec


def _run(window_us=10_000.0):
    stretch = types.SimpleNamespace(perf_on=PERF_ON_S, t_on=0.5, t_off=0.5 + window_us / 1e6)
    return types.SimpleNamespace(rec=types.SimpleNamespace(stretch=stretch, t0=PERF_ON_S - 0.5))


@pytest.fixture
def recorded(monkeypatch):
    def use(rec, names=("PREFILL", "MAMBA")):
        fake = types.SimpleNamespace(**{k: getattr(ht, k) for k in names},
                                     last_profiled=lambda: rec)
        monkeypatch.setattr(program_trace, "_hosttrace", lambda: fake)
    return use


M, P, S = ht.MAMBA, ht.PREFILL, ht.STEP
# A prefill of 2,000 tokens whose Mamba blocks take 300 + 500 us, one of 500
# tokens with 100 us, a decode step's Mamba block (not a prefill's), a
# prefill still open at the stretch's end, and one that began before it.
RECORD = [(P, 100, 2000, 2000, [(M, 200, 500), (ht.ATTN, 500, 600), (M, 600, 1100)]),
          (S, 2100, 2500, 4, [(M, 2200, 2300)]),
          (P, 3000, 3500, 500, [(M, 3100, 3200)]),
          (P, 9000, 11_000, 800, [(M, 9100, 9900)]),
          (P, -300, 400, 100, [(M, -200, 300)])]


def test_reader_on_a_record_with_prefills(recorded):
    recorded(_record(RECORD))
    read = harness.load_reader("mamba_prefill_ms.batch")
    # (0.8 ms / 2 + 0.1 ms / 0.5) / 2 per 1,000 tokens
    assert read(_run()) == pytest.approx((0.8 / 2 + 0.1 / 0.5) / 2)


def test_reader_without_a_prefill_in_the_stretch(recorded):
    recorded(_record([r for r in RECORD if r[0] != P or r[1] >= 9000 or r[1] < 0]))
    assert harness.load_reader("mamba_prefill_ms.batch")(_run()) is None
    recorded(_record([(P, 100, 2000, 2000, [(ht.ATTN, 200, 500)])]))    # no Mamba block
    assert harness.load_reader("mamba_prefill_ms.batch")(_run()) is None


def test_reader_without_the_programs_names(recorded):
    recorded(_record(RECORD), names=("MAMBA",))        # a program with no prefill.run
    assert harness.load_reader("mamba_prefill_ms.batch")(_run()) is None
    run = _run()
    run.rec.stretch = None
    recorded(_record(RECORD))
    assert harness.load_reader("mamba_prefill_ms.batch")(run) is None


# ------------------------------------------------------------- rehearsals
@pytest.fixture
def one_thread():
    """One host thread for torch's CPU kernels, as ``run.py`` sets: test
    workers that each take every core would pace the window's steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(trace, one_thread):
    r = harness.run_cell(CELL, SEED, WINDOW_S, trace, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["transfer_mismatches"]["value"] == 0
    names = set(r["metrics"])
    if trace:
        assert {"decode_step_ms.batch", "decode_mfu_pct.batch", "prefill_ms.batch",
                "transfer_ms.batch", "decode_graph_pct.batch"} <= names
        assert r["metrics"].get("mamba_prefill_ms.batch", {"value": 1.0})["value"] > 0
    else:
        assert names == {"out_tok_s", "setup_s"}


def test_the_control_is_not_correct(one_thread):
    """The fp8 reference in the program's place passes a compared limit that
    the program keeps, at smoke size."""
    r = harness.run_cell(CELL, SEED, WINDOW_S, False, device="cpu", control=True)
    assert r["correct"], r["checks"]
    errs = np.concatenate(r["readings"]["control"][1])
    control = {"logit_rel_err_median": float(np.median(errs)),
               "logit_rel_err_p90": float(np.percentile(errs, 90))}
    compared = {k: c["limit"] for k, c in r["checks"].items()
                if c["limit"] is not None and k in control}
    assert compared and any(control[k] > lim for k, lim in compared.items()), (control,
                                                                               compared)
