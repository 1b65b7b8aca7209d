"""Byte and operation counts against counts by hand at smoke sizes (a
decode step's, the decoder stack's ``decode_step_work``)."""

import pytest

import _paths  # noqa: F401
from nkb import roofline, spec, stacks
from nkb.roofline import Dims


def _work(name, positions):
    cfg = spec.config(name)
    return stacks.of(cfg).decode_step_work(cfg, positions)


@pytest.fixture
def dense():
    return Dims(spec.config("dense-smoke"))


@pytest.fixture
def moe():
    return Dims(spec.config("moe-smoke"))


def test_dims_come_from_the_stack(dense, moe):
    # K4 runs once an attention layer; the MoE flag is the stack's expert count
    assert (dense.attn_layers, dense.experts, moe.attn_layers, moe.experts) == (2, 0, 2, 8)
    assert (dense.heads, dense.kv, dense.dh, dense.vocab) == (4, 2, 16, 256)


def test_k4_call_bytes(dense):
    # q and out: 4 lanes x 4 heads x 16 x 2 B each; K and V: 4 lanes x 100 rows x 2 KV x 16 x 2 B
    assert roofline.k4_call_bytes(dense, 4, 100) == 2 * 4 * 4 * 16 * 2 + 2 * 4 * 100 * 2 * 16 * 2


def test_pack_call_bytes(dense):
    # 10 pages of 16 rows x 2 KV heads x 16 x 2 B, read and written
    assert roofline.pack_call_bytes(dense, 10) == 2 * 10 * 16 * 2 * 16 * 2


def test_decode_step_dense():
    d, L, ff, v = 64, 2, 128, 256
    attn = d * 64 + 2 * d * 32 + 64 * d
    weights = L * (2 * attn + 2 * 3 * d * ff + 2 * 2 * d) + 2 * d * v + 4 * d
    keys = (100 + 1) + (7 + 1)
    kv = L * 2 * (2 * 16 * 2) * (keys + 2)
    nbytes, flops = _work("dense-smoke", [100, 7])
    assert nbytes == weights + kv + 2 * d * 2
    assert flops == 2 * 2 * (L * (attn + 3 * d * ff) + d * v) + 4 * L * 4 * 16 * keys


def test_decode_step_moe_reads_routed_experts():
    d, L, f, e, k = 64, 2, 32, 8, 2
    one = _work("moe-smoke", [10])[0]
    two = _work("moe-smoke", [10, 10])[0]
    # a second token routes k more experts (of 3 d f weights each) and reads its own KV
    assert two - one == L * k * 3 * d * f * 2 + L * 2 * (2 * 16 * 2) * 12 + d * 2
    many = _work("moe-smoke", [10] * 9)[0]
    nine = _work("moe-smoke", [10] * 10)[0]
    # past E/k tokens every expert is read already
    assert nine - many == L * 2 * (2 * 16 * 2) * 12 + d * 2
    assert e // k < 9


def test_bound_names_what_binds():
    t, by = roofline.bound(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound(1.0, 989e12)
    assert t == pytest.approx(1.0) and by == "operations"
