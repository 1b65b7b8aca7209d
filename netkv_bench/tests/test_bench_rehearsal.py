"""End-to-end rehearsals of a run on the CPU at smoke sizes, through
workload files that BENCHMARK.json does not list, and the check that
decides ``correct`` seeing each fault the served path can have."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import _paths
from nkb import harness

CELLS = ["dense-smoke.smoke-open", "moe-smoke.smoke-closed"]
SEED = 2 ** 31 + 101


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    r = harness.run_cell(cell, SEED, 1.5, trace, device="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-2] == "checks"      # the last key once _detail is taken off
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = set(r["metrics"])
    if trace:
        assert {"decode_step_ms.batch", "decode_mfu_pct.batch", "prefill_ms.batch",
                "transfer_ms.batch"} <= names
        assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert names == {"out_tok_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values() if m["unit"] != "%")


def _alter_tokens(cluster):
    for de in cluster.decode:
        orig = de.step

        def step(orig=orig):
            return [(rid, (tok + 1) % 256) for rid, tok in orig()]
        de.step = step


def _drop_landed_pages(cluster):
    from repro_torch.serving import cluster as mod

    orig = mod.unpack_transfer

    def unpack(buffers, like, *a, **k):
        out = orig(buffers, like, *a, **k)
        for name, leaf in out.items():
            if name[0] in "kv" and leaf.dim() == 5:
                leaf[:, :, : leaf.shape[2] // 2 // 16 * 16] = 0
        return out
    mod.unpack_transfer = unpack
    return lambda: setattr(mod, "unpack_transfer", orig)


def _other_instance(cluster):
    orig = cluster.sched.select
    ids = [d.instance_id for d in cluster.decode]

    def select(info, *a, **k):
        d = orig(info, *a, **k)
        d.instance_id = ids[(ids.index(d.instance_id) + 1) % len(ids)]
        return d
    cluster.sched.select = select


def _ship_a_page_less(cluster):
    from repro_torch.serving import cluster as mod

    orig = mod.pack_transfer

    def pack(cache, hit_pages, *a, **k):
        return orig(cache, hit_pages + 1, *a, **k)
    mod.pack_transfer = pack
    return lambda: setattr(mod, "pack_transfer", orig)


def _step_keeps_its_state(cluster):
    """Each decode step attends and returns its logits but lands no K/V
    (the read-only step) while the position moves on."""
    from repro_torch.serving import engine as mod

    orig = mod.decode_step

    def decode_step(model, tokens, cache, *a, **k):
        logits, _ = orig(model, tokens, cache, update_cache=False)
        cache["pos"] = cache["pos"] + 1
        return logits, cache
    mod.decode_step = decode_step
    return lambda: setattr(mod, "decode_step", orig)


FAULTS = [_alter_tokens, _drop_landed_pages, _other_instance, _ship_a_page_less,
          _step_keeps_its_state]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(cell, fault):
    undo = []

    def corrupt(cluster):
        u = fault(cluster)
        if u:
            undo.append(u)
    try:
        r = harness.run_cell(cell, SEED, 1.5, False, device="cpu", corrupt=corrupt)
    finally:
        for u in undo:
            u()
    assert not r["correct"], r["checks"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path does not run")
    out = subprocess.run([sys.executable, "netkv_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=_paths.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_needs_the_program(tmp_path):
    shutil.copy(_paths.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_paths.BENCH, tmp_path / "netkv_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['netkv_bench']\n"
            "from nkb import harness\n"
            f"print(harness.run_cell({CELLS[0]!r}, 1, 1.0, False, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "repro_torch" in out.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_run_on_the_card(card):
    out = subprocess.run([sys.executable, "netkv_bench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=_paths.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The fp8 reference in the program's place reads past a compared limit
    that the program itself keeps, at smoke size (on the card at the cells'
    own sizes: ``control.py``)."""
    r = harness.run_cell(cell, SEED, 1.5, False, device="cpu", control=True)
    assert r["correct"], r["checks"]
    (gaps, errs) = r["readings"]["control"]
    control = {"logit_gap": max(g.max() for g in gaps),
               "logit_rel_err": max(e.max() for e in errs),
               "logit_rel_err_median": float(np.median(np.concatenate(errs))),
               "logit_rel_err_p90": float(np.percentile(np.concatenate(errs), 90))}
    compared = {k: c["limit"] for k, c in r["checks"].items()
                if c["limit"] is not None and k in control}
    assert any(control[k] > lim for k, lim in compared.items()), (control, compared)
