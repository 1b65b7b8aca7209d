"""The layer-stack seam (``nkb.stacks``): the decoder stack gives the same
weights, program config, work counts and transfer verdicts as the harness
gave before the seam (the values below were read from the tree before it),
a stack is added as files alone, and a stack with no file is refused by
name."""

import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

import _paths
from nkb import correct, program, spec, stacks, weights

SEED = 2 ** 31 + 7
DIGESTS = {
    "dense-smoke": "40714707b7171a432310d68e18fa96f0564cb673740b6e138716a93913a03d8d",
    "moe-smoke": "447eb434f6d5b1c8e9981d908cbde4dd3e91fe3e885a43b2ecf7712f40d638cb",
}
_COMMON = dict(block_pattern=("attn",), qk_norm=False, n_enc_layers=0, frontend=None,
               n_prefix_embeds=0, attn_chunk=1024, compute_dtype="torch.bfloat16", remat=False)
FIELDS = {
    "dense-smoke": dict(name="dense-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab_size=256, ffn_pattern=("dense",), moe=None,
                        rope_theta=1000000.0, norm_eps=1e-05, **_COMMON),
    "moe-smoke": dict(name="moe-smoke", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=32, vocab_size=256, ffn_pattern=("moe",),
                      moe=dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=1.25,
                               dense_residual=False, dispatch_chunks=4),
                      rope_theta=10000.0, norm_eps=1e-06, **_COMMON),
    "internlm2-20b": dict(name="internlm2-20b", d_model=6144, n_layers=48, n_heads=48,
                          n_kv_heads=8, d_head=128, d_ff=16384, vocab_size=92544,
                          ffn_pattern=("dense",), moe=None, rope_theta=1000000.0,
                          norm_eps=1e-05, **_COMMON),
    "granite-moe-1b-a400m": dict(name="granite-moe-1b-a400m", d_model=1024, n_layers=24,
                                 n_heads=16, n_kv_heads=8, d_head=64, d_ff=512,
                                 vocab_size=49155, ffn_pattern=("moe",),
                                 moe=dict(n_experts=32, top_k=8, d_expert=512,
                                          capacity_factor=1.25, dense_residual=False,
                                          dispatch_chunks=4),
                                 rope_theta=10000.0, norm_eps=1e-06, **_COMMON),
}
POSITIONS = ([0], [3583, 100, 17, 0], [5] * 9)
WORK = {
    "dense-smoke": [(181632.0, 180736.0), (1130752.0, 2617344.0), (198272.0, 1649664.0)],
    "moe-smoke": [(134528.0, 133632.0), (1231104.0, 2428928.0), (298624.0, 1225728.0)],
    "internlm2-20b": [(38585536512.0, 38585106432.0), (39314202624.0, 158705123328.0),
                      (38597627904.0, 347319042048.0)],
    "granite-moe-1b-a400m": [(857419776.0, 857315328.0), (2851522560.0, 3792986112.0),
                             (2672373760.0, 7720261632.0)],
}


def _bad(needed):
    return ["3 packs, 2 unpacks", "pack 1: pos 40 is no prompt's length",
            "pack 1: 1 hit pages for a unique prompt",
            "pack 1: page tables differ from pages 0..2 of each layer",
            f"pack 1: 5 bytes shipped, {needed} needed",
            "unpack 1: landed tables differ from the shipped ones"]


XFER = {"dense-smoke": _bad(12288), "moe-smoke": _bad(12288), "internlm2-20b": _bad(9437184)}


def _digest(cfg):
    h = hashlib.sha256()
    for name, t in weights.draw(cfg, SEED, torch.device("cpu")).items():
        h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weights_are_drawn_bit_for_bit(name):
    assert _digest(spec.config(name)) == DIGESTS[name]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_program_config_field_by_field(name):
    m = program.model_config(spec.config(name))
    got = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    got["compute_dtype"] = str(got["compute_dtype"])
    got["moe"] = None if got["moe"] is None else dataclasses.asdict(got["moe"])
    assert got == FIELDS[name]


@pytest.mark.parametrize("name", sorted(WORK))
def test_decode_step_work_is_unchanged(name):
    cfg = spec.config(name)
    assert [stacks.of(cfg).decode_step_work(cfg, p) for p in POSITIONS] == WORK[name]


def _packs(cfg, whole=None):
    """A sound pack of a 37-token prompt, an unsound one (pos, hit pages,
    tables, bytes), the sound one again; two unpacks, the second unsound."""
    pages = cfg["deployment"]["cache_len"] // 16
    kv_page = cfg["num_key_value_heads"] * cfg["head_dim"] * 2 * 16
    t = tuple(p * pages + g for p in range(cfg["num_hidden_layers"]) for g in range(3))
    whole = whole or {}
    good = dict(pos=37, hit_pages=0, tables={"k0": t, "v0": t}, whole=whole,
                nbytes=2 * len(t) * kv_page + sum(whole.values()))
    bad = dict(pos=40, hit_pages=1, tables={"k0": t[1:]}, whole={}, nbytes=5)
    return [good, bad, good], [{"tables": good["tables"]}, {"tables": {"k0": t}}]


@pytest.mark.parametrize("name", sorted(XFER))
def test_transfer_mismatches_are_unchanged(name):
    cfg = spec.config(name)
    packs, unpacks = _packs(cfg)
    assert correct.transfer_mismatches(packs, unpacks, cfg, {37}) == XFER[name]
    assert correct.transfer_mismatches(packs[:1], unpacks[:1], cfg, {37}) == []


def test_a_leaf_shipped_whole_that_the_stack_does_not_expect():
    cfg = spec.config("dense-smoke")
    packs, unpacks = _packs(cfg, whole={"ssm0": 4096})
    assert correct.transfer_mismatches(packs[:1], unpacks[:1], cfg, {37}) == [
        "pack 0: leaves shipped whole [('ssm0', 4096)], expected []",
        "pack 0: 16384 bytes shipped, 12288 needed"]


def test_the_default_stack_is_the_decoder():
    cfg = spec.config("internlm2-20b")
    assert "layer_stack" not in cfg and stacks.name_of(cfg) == "decoder"
    assert stacks.of(cfg).__file__ == str(_paths.BENCH / "stacks" / "decoder.py")
    assert stacks.of(cfg).reference.served_logits


# ---------------------------------------------------------------- a stack as files
REHEARSAL = """
import json, sys
sys.path[:0] = ['netkv_bench', {src!r}]
from nkb import harness, stacks
loaded = set()

def load(name, load=stacks.load):
    mod = load(name)
    loaded.add(mod.__file__)
    return mod

stacks.load = load
r = harness.run_cell({cell!r}, {seed}, 1.5, {trace}, device='cpu')
print(json.dumps(dict(correct=r['correct'], metrics=sorted(r['metrics']),
                      checks={{k: c['value'] for k, c in r['checks'].items()}},
                      stacks=sorted(loaded))))
"""


def _copy_with(tmp_path, stack, stack_source=None):
    """The benchmark's folder and BENCHMARK.json copied to ``tmp_path``, with
    a configuration ``dense-copy`` (dense-smoke's numbers) naming ``stack``,
    a cell of it, and, where given, the stack's file."""
    shutil.copy(_paths.ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "netkv_bench"
    shutil.copytree(_paths.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    if stack_source is not None:
        shutil.copy(stack_source, bench / "stacks" / f"{stack}.py")
    cfg = dict(spec.config("dense-smoke"), name="dense-copy", layer_stack=stack)
    (bench / "configs" / "dense-copy.json").write_text(json.dumps(cfg, indent=2))
    cell = dict(json.loads((bench / "workloads" / "dense-smoke.smoke-open.json").read_text()),
                config="dense-copy")
    (bench / "workloads" / "dense-copy.smoke-open.json").write_text(json.dumps(cell))
    return "dense-copy.smoke-open"


def _run_in(tmp_path, cell, trace):
    code = REHEARSAL.format(src=str(_paths.ROOT / "src"), cell=cell, seed=2 ** 31 + 101,
                            trace=trace)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=600)


@pytest.mark.parametrize("trace", [False, True])
def test_a_stack_is_added_as_files(tmp_path, trace):
    """A copy of the decoder stack under a new name, a configuration naming
    it and a cell of it: the run loads that file and is correct."""
    cell = _copy_with(tmp_path, "decoder_copy", _paths.BENCH / "stacks" / "decoder.py")
    out = _run_in(tmp_path, cell, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["stacks"] == [str(tmp_path / "netkv_bench" / "stacks" / "decoder_copy.py")]
    assert r["checks"]["transfer_mismatches"] == 0 and r["checks"]["decision_mismatches"] == 0
    if trace:
        assert {"decode_mfu_pct.batch", "decode_step_ms.batch"} <= set(r["metrics"])
    else:
        assert r["metrics"] == ["out_tok_s", "setup_s"]


def test_a_stack_with_no_file_is_named(tmp_path):
    cell = _copy_with(tmp_path, "no_such_stack")
    out = _run_in(tmp_path, cell, False)
    assert out.returncode != 0 and out.stdout == ""
    assert "FileNotFoundError: no layer stack named 'no_such_stack'" in out.stderr
    assert str(tmp_path / "netkv_bench" / "stacks" / "no_such_stack.py") in out.stderr
