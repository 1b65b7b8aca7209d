"""Each configuration file against its source, and BENCHMARK.json against
the benchmark's contract as far as the files can show it."""

import json
import re

import pytest

import _paths  # noqa: F401
from nkb import harness, spec

# The sources' widths (config.json of each model; InternLM2: arXiv:2403.17297).
PUBLISHED = {
    "internlm2-20b": dict(hidden_size=6144, intermediate_size=16384, num_attention_heads=48,
                          num_key_value_heads=8, num_hidden_layers=48, vocab_size=92544,
                          rope_theta=1000000, rms_norm_eps=1e-05, tie_word_embeddings=False),
    "granite-moe-1b-a400m": dict(hidden_size=1024, intermediate_size=512, num_attention_heads=16,
                                 num_key_value_heads=8, num_hidden_layers=24,
                                 num_local_experts=32, num_experts_per_tok=8, vocab_size=49155,
                                 rope_theta=10000, rms_norm_eps=1e-06, tie_word_embeddings=True),
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_widths_are_the_sources(name):
    cfg = spec.config(name)
    for key, value in PUBLISHED[name].items():
        assert cfg[key] == value, key
    assert cfg["reduced"] == []


def test_granite_keeps_its_published_multipliers():
    """Granite's muP multipliers stand in the file as published; that the
    port does not apply them is a departure, not a cut."""
    cfg = spec.config("granite-moe-1b-a400m")
    assert (cfg["embedding_multiplier"], cfg["logits_scaling"], cfg["residual_multiplier"],
            cfg["attention_multiplier"]) == (12.0, 6.0, 0.22, 0.015625)
    assert any("muP" in d for d in cfg["departures"])


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_program_registers_the_same_widths(name):
    from repro_torch.configs import get_spec

    from nkb import program

    mine, theirs = program.model_config(spec.config(name)), get_spec(name).model
    for f in ("d_model", "n_layers", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert (mine.moe is None) == (theirs.moe is None)
    if mine.moe is not None:
        assert mine.moe == theirs.moe


def test_benchmark_names_and_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["netkv_bench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(set(names)) == len(names) and len(set(cells)) == len(cells)
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("netkv_bench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == spec.config(c["name"])["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        f = spec.workload(w["name"])
        assert (f["config"], f["traffic"]) == (w["config"], w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        harness.load_reader(m["name"])
        for cell in m.get("workloads", cells):
            assert cell in cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:     # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(spec.metrics_of(bench, cell, False)) >= 2
        assert spec.metrics_of(bench, cell, True)
