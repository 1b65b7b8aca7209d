"""The launch plans the CUDA wrappers compute on the host, on the CPU.

``kernels/flash_decode.py::split_plan`` cuts the first ``pos`` keys of each
(batch, KV head) into the ranges of K4's split kernel, for a given SM count;
``kernels/rwkv_scan.py::column_plan`` sizes K7's groups of state columns and
``padded_width`` rounds K7's head width up to whole 16-byte rows;
``kernels/waterfill.py::waterfill_progressive_plan`` and
``waterfill_fast_plan`` place K5's and K6's arrays in shared or device
memory; ``kernels/netkv_score.py::score_plan`` sizes K1's cluster of blocks
a row.  None reaches the card, so all are held here: the ranges and column
groups cover their span exactly once, none is empty, a range fits a block's
shared-memory tile, a block's shared bytes stay within the card's 227 KB,
and the grid fits CUDA's launch limits.
"""

import pytest
from hypothesis_compat import given, settings, st

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import netkv_score as ns
from repro_torch.kernels import rwkv_scan as rk
from repro_torch.kernels import waterfill as wf
from repro_torch.kernels.rwkv_scan import MAX_HEAD_DIM, padded_width

H100_SMS = 132


def _ranges(plan, pos):
    return [(i * plan.range_len, min((i + 1) * plan.range_len, pos))
            for i in range(plan.n_split)]


def _check_plan(batch, n_kv, pos, n_sm, row_bytes):
    plan = fd.split_plan(batch, n_kv, pos, n_sm, row_bytes)
    ranges = _ranges(plan, pos)
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(pos)), plan            # [0, pos) once, in order
    assert all(hi > lo for lo, hi in ranges), plan      # no range is empty
    assert 1 <= plan.range_len <= fd.MAX_RANGE
    assert plan.range_len * row_bytes <= max(fd.TILE_BYTES, row_bytes)
    assert 1 <= plan.n_split <= fd.MAX_GRID_Y
    assert batch * n_kv <= fd.MAX_GRID_X
    return plan


# (batch, KV heads, pos, SMs, row bytes): the qwen3-14b decode shapes in
# bf16 (rows of 256 bytes) and f32, one (batch, KV head), the widest and
# narrowest rows the kernel takes, pos of 1, around range edges, and long.
@pytest.mark.parametrize("batch,n_kv,pos,n_sm,row_bytes", [
    (4, 8, 2056, H100_SMS, 256), (4, 8, 2048, H100_SMS, 256), (4, 8, 4096, H100_SMS, 256),
    (4, 8, 2056, H100_SMS, 512), (1, 8, 2049, H100_SMS, 256), (1, 1, 4096, H100_SMS, 256),
    (1, 1, 1, H100_SMS, 256), (4, 8, 1, H100_SMS, 256), (4, 8, 15, H100_SMS, 256),
    (4, 8, 16, H100_SMS, 256), (4, 8, 17, H100_SMS, 256), (2, 2, 300, H100_SMS, 1024),
    (3, 3, 600, H100_SMS, 32), (64, 8, 4096, H100_SMS, 256), (1, 1, 131072, H100_SMS, 1024),
    (2, 4, 777, 1, 256), (2, 4, 777, 7, 64), (512, 64, 8192, H100_SMS, 256),
])
def test_split_plan_covers_pos(batch, n_kv, pos, n_sm, row_bytes):
    _check_plan(batch, n_kv, pos, n_sm, row_bytes)


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 64), n_kv=st.integers(1, 16), pos=st.integers(1, 20000),
       n_sm=st.integers(1, 200), row_bytes=st.sampled_from([32, 64, 128, 256, 512, 1024]))
def test_split_plan_covers_pos_property(batch, n_kv, pos, n_sm, row_bytes):
    _check_plan(batch, n_kv, pos, n_sm, row_bytes)


def test_split_plan_at_the_serving_shape():
    """qwen3-14b decode at pos 2056 in bf16: the 32 (batch, KV head) pairs
    get 17 balanced ranges of 121 keys, 544 blocks on 132 SMs, where the
    first design launched 32."""
    plan = fd.split_plan(4, 8, 2056, H100_SMS, 128 * 2)
    assert plan == fd.SplitPlan(17, 121)
    assert 4 * 8 * plan.n_split == 544 > 4 * 8


def test_split_plan_fills_the_card_and_keeps_short_caches_whole():
    # A pos under one range is one range: its block writes the output, with
    # no partials to merge.
    for pos in range(1, fd.MIN_RANGE + 1):
        assert fd.split_plan(4, 8, pos, H100_SMS, 256).n_split == 1
    # More ranges on a card with more SMs, never fewer.
    counts = [fd.split_plan(1, 8, 3000, n, 256).n_split for n in (1, 16, 66, 132, 264)]
    assert counts == sorted(counts) and counts[0] < counts[-1]
    # At least BLOCKS_PER_SM blocks an SM where the keys allow it.
    plan = fd.split_plan(1, 8, 3000, H100_SMS, 256)
    assert 8 * plan.n_split >= fd.BLOCKS_PER_SM * H100_SMS


def _row_keys(plan, length):
    """Keys range i holds for a row of ``length`` under a plan cut over the
    longest row: the kernel's min(range_len, length - i * range_len), none
    where that is <= 0."""
    return [max(0, min(plan.range_len, length - i * plan.range_len))
            for i in range(plan.n_split)]


@pytest.mark.parametrize("batch,n_kv,lengths,row_bytes", [
    (4, 8, (2056, 1031, 17, 1), 256),     # qwen3-14b's per-slot decode
    (4, 3, (4096, 4095, 128, 3), 128),    # smollm-135m
    (2, 16, (300, 16), 128),
    (3, 1, (1, 1, 1), 256),
])
def test_split_plan_over_the_longest_row(batch, n_kv, lengths, row_bytes):
    """With per-row lengths the plan is the scalar plan of the longest row;
    each row's non-empty ranges cover [0, length) once, in order, the empty
    ones (an empty partial each) all come after them, and a row of the
    longest length fills every range as the scalar launch does."""
    longest = max(lengths)
    plan = fd.split_plan(batch, n_kv, longest, H100_SMS, row_bytes)
    for length in lengths:
        keys = _row_keys(plan, length)
        assert sum(keys) == length
        full = [n for n in keys if n > 0]
        assert keys[:len(full)] == full and all(n == 0 for n in keys[len(full):])
        assert all(n == plan.range_len for n in full[:-1])
        if length == longest:
            assert len(full) == plan.n_split
            assert [hi - lo for lo, hi in _ranges(plan, longest)] == keys


@pytest.mark.parametrize("args", [
    (4, 8, 0, H100_SMS, 256), (0, 8, 10, H100_SMS, 256), (4, 8, 10, 0, 256),
    (4, 8, 10, H100_SMS, 0), (1, 1, fd.MAX_GRID_Y * fd.MAX_RANGE + 1, H100_SMS, 16),
])
def test_split_plan_rejects(args):
    with pytest.raises(ValueError):
        fd.split_plan(*args)


@pytest.mark.parametrize("element_size", [2, 4])
def test_rwkv_padded_width(element_size):
    """K7 runs dh rounded up to whole 16-byte rows, never wider than it
    must, and the widths it runs stay within its 128-row state."""
    per = 16 // element_size
    for dh in range(1, MAX_HEAD_DIM + 1):
        width = padded_width(dh, element_size)
        assert width * element_size % 16 == 0
        assert dh <= width < dh + per
        assert width <= MAX_HEAD_DIM
        assert (width == dh) == (dh % per == 0)


def _check_columns(batch, n_heads, dh, n_sm):
    width = rk.column_plan(batch, n_heads, dh, n_sm)
    assert width in rk.COLUMN_WIDTHS
    groups = [(c, min(c + width, dh)) for c in range(0, dh, width)]
    assert [j for lo, hi in groups for j in range(lo, hi)] == list(range(dh))
    assert all(hi > lo for lo, hi in groups)
    blocks = batch * n_heads * len(groups)
    assert 1 <= blocks <= rk.MAX_GRID_X
    for other in rk.COLUMN_WIDTHS:  # no width puts fewer blocks on the busiest SM
        other_blocks = batch * n_heads * -(-dh // other)
        assert -(-blocks // n_sm) <= -(-other_blocks // n_sm)
    return width, blocks


@pytest.mark.parametrize("batch,n_heads,dh,n_sm,want", [
    (1, 40, 64, H100_SMS, 24),    # rwkv6-3b prefill: 120 blocks, one an SM
    (1, 4, 64, H100_SMS, 16),     # one wave either way: the narrowest
    (2, 40, 64, H100_SMS, 24),    # 240 blocks, 2 an SM, as 160 of 32 (320 of 16: 3)
    (1, 50, 40, H100_SMS, 24),    # dh 40: 100 blocks against 150
    (1, 40, 128, H100_SMS, 24),   # 240 blocks, 2 an SM, as 160 of 32
    (2, 2, 16, H100_SMS, 16),     # one group whatever the width
    (8, 40, 64, H100_SMS, 32),
    (1, 33, 64, H100_SMS, 16),    # 132 blocks of 16 fill the card once
])
def test_column_plan(batch, n_heads, dh, n_sm, want):
    assert _check_columns(batch, n_heads, dh, n_sm)[0] == want


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 16), n_heads=st.integers(1, 128), dh=st.integers(1, 128),
       n_sm=st.integers(1, 200))
def test_column_plan_property(batch, n_heads, dh, n_sm):
    _check_columns(batch, n_heads, dh, n_sm)


@pytest.mark.parametrize("args", [(0, 40, 64, H100_SMS), (1, 0, 64, H100_SMS),
                                  (1, 40, 0, H100_SMS), (1, 40, 64, 0)])
def test_column_plan_rejects(args):
    with pytest.raises(ValueError):
        rk.column_plan(*args)


# ------------------------------------------------- water-filling (K5, K6)
def _check_progressive(n_flows, n_hops, n_links1):
    plan = wf.waterfill_progressive_plan(n_flows, n_hops, n_links1)
    links = 16 * n_links1 + n_flows            # link state and flags, unpadded
    paths = 4 * n_flows * n_hops
    assert plan.smem_bytes <= wf.SMEM_MAX
    assert plan.threads % 32 == 0 and wf.MIN_THREADS <= plan.threads <= wf.MAX_THREADS
    if plan.layout == "shared":
        assert plan.smem_bytes >= links + paths and plan.scratch_bytes == 0
    elif plan.layout == "paths":
        assert plan.smem_bytes >= links and plan.scratch_bytes == 0
        assert wf.RED_BYTES + links + paths > wf.SMEM_MAX   # only where they do not fit
    else:
        assert plan.layout == "global" and plan.scratch_bytes >= links
        assert wf.RED_BYTES + links > wf.SMEM_MAX
    return plan


def _check_fast(n_scen, n_flows, n_links1, n_sm):
    plan = wf.waterfill_fast_plan(n_scen, n_flows, n_links1, n_sm)
    z = wf.fast_sizes(n_flows, n_links1)
    assert plan.smem_bytes <= wf.SMEM_MAX
    assert plan.threads % 32 == 0 and wf.MIN_THREADS <= plan.threads <= wf.MAX_THREADS
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.threads % plan.lanes == 0
    assert plan.lanes == 1 or plan.threads // plan.lanes >= n_links1   # a group a link
    inside = {"global": [], "masks": [z.state, z.masks],
              "shared": [z.state, z.masks, z.slab]}[plan.layout]
    assert plan.smem_bytes == sum(inside)
    assert plan.scratch_bytes == (z.state + z.masks) - sum(inside[:2])
    # Every array of a region, one bit a mask entry and 4 bytes an f32.
    assert z.state >= 13 * n_links1 + 9 * n_flows
    assert z.masks >= (n_flows * n_links1) // 4
    assert z.slab >= 4 * n_flows * n_links1 + 16
    return plan


def test_waterfill_fast_plan_at_the_sweep_shape():
    """exp11's sweep step (54 scenarios, 119 flows, 57 links + pad): the
    state, masks and slab all in shared memory, ~33 KB a block, 4 lanes a
    link on 256 threads."""
    plan = _check_fast(54, 119, 58, H100_SMS)
    assert plan.layout == "shared"
    assert plan.smem_bytes <= 227 * 1024 and plan.smem_bytes < 34 * 1024
    assert (plan.threads, plan.lanes) == (256, 4)


def test_waterfill_progressive_plan_at_the_largest_flowplane_table():
    """The largest FlowPlane table of the simulate phase (112 flows x 6
    hops, 121 links): everything in shared memory, one block of 256."""
    plan = _check_progressive(112, 6, 121)
    assert plan.layout == "shared" and plan.scratch_bytes == 0
    assert plan.smem_bytes < 8 * 1024 and plan.threads == 256


@pytest.mark.parametrize("args,layout", [
    ((9000, 6, 2001), "paths"), ((500, 6, 15001), "global"), ((200000, 1, 10), "paths"),
    ((0, 6, 1), "shared"), ((1, 6, 29), "shared"), ((300, 6, 281), "shared"),
])
def test_waterfill_progressive_plan_large_tables(args, layout):
    """Tables past shared memory take the device-memory layouts instead of
    raising."""
    assert _check_progressive(*args).layout == layout


@pytest.mark.parametrize("args,layout", [
    ((2, 1100, 300, H100_SMS), "masks"), ((1, 3000, 1500, H100_SMS), "global"),
    ((1, 20000, 8000, H100_SMS), "global"),
    ((1, 64, 14000, H100_SMS), "global"),    # the state alone past shared memory
    ((0, 10, 5, H100_SMS), "shared"),
    ((1, 0, 1, H100_SMS), "shared"), ((7, 300, 130, H100_SMS), "shared"),
    # more scenarios than SMs: two blocks an SM must both fit, so the slab
    # of (200, 119, 58)'s blocks stays and (200, 300, 130)'s goes; eight,
    # and (1000, 119, 58)'s goes too
    ((200, 119, 58, H100_SMS), "shared"), ((200, 300, 130, H100_SMS), "masks"),
    ((1000, 119, 58, H100_SMS), "masks"),
])
def test_waterfill_fast_plan_large_tables(args, layout):
    assert _check_fast(*args).layout == layout


@settings(max_examples=300, deadline=None)
@given(n_scen=st.integers(0, 5000), n_flows=st.integers(0, 30000),
       n_links1=st.integers(1, 30000), n_sm=st.integers(1, 200))
def test_waterfill_fast_plan_property(n_scen, n_flows, n_links1, n_sm):
    _check_fast(n_scen, n_flows, n_links1, n_sm)


@settings(max_examples=300, deadline=None)
@given(n_flows=st.integers(0, 300000), n_hops=st.integers(0, 16),
       n_links1=st.integers(1, 40000))
def test_waterfill_progressive_plan_property(n_flows, n_hops, n_links1):
    _check_progressive(n_flows, n_hops, n_links1)


@pytest.mark.parametrize("args", [(-1, 6, 10), (10, -1, 10), (10, 6, 0), (2 ** 28, 8, 10)])
def test_waterfill_progressive_plan_rejects(args):
    with pytest.raises(ValueError):
        wf.waterfill_progressive_plan(*args)


@pytest.mark.parametrize("args", [(-1, 10, 5, H100_SMS), (1, -1, 5, H100_SMS),
                                  (1, 10, 0, H100_SMS), (1, 10, 5, 0),
                                  (wf.MAX_GRID_X + 1, 10, 5, H100_SMS)])
def test_waterfill_fast_plan_rejects(args):
    with pytest.raises(ValueError):
        wf.waterfill_fast_plan(*args)


def _check_score_plan(r, d, n_sm):
    plan = ns.score_plan(r, d, n_sm)
    ranges = ns.block_ranges(plan, d)
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(d)), plan                  # [0, D) once, in rank order
    assert plan.cluster in (1, 2, 4, 8), plan
    assert plan.grid == r * plan.cluster
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= ns.MAX_THREADS
    assert plan.span % 32 == 0 and plan.threads <= plan.span
    assert ranges[0][1] > 0                                 # rank 0 holds lanes
    # A cluster only where one block would hold more than MAX_THREADS lanes.
    assert plan.cluster == 1 or d > (plan.cluster // 2) * ns.MAX_THREADS
    return plan


# The shapes of chip_smoke.py's phase 3, the decide phase's pools, R 64.
@pytest.mark.parametrize("d", [1, 2, 16, 31, 32, 33, 64, 255, 256, 257, 1024, 2048, 2049,
                               8192])
@pytest.mark.parametrize("r", [1, 4, 64])
def test_score_plan_covers_the_row(r, d):
    _check_score_plan(r, d, H100_SMS)


@settings(max_examples=300, deadline=None)
@given(r=st.integers(1, 4096), d=st.integers(1, 100000), n_sm=st.integers(1, 200))
def test_score_plan_property(r, d, n_sm):
    _check_score_plan(r, d, n_sm)


def test_score_plan_at_the_decide_shape():
    """One decision over 2048 instances: 8 blocks of 256 threads, one lane a
    thread (the first design walked 2048 lanes with one block); the
    simulator's 16-instance pool: one block of one warp; a 64-row cohort:
    clusters of 2, 128 blocks on 132 SMs."""
    assert ns.score_plan(1, 2048, H100_SMS) == ns.ScorePlan(8, 256, 256, 8)
    assert ns.score_plan(1, 16, H100_SMS) == ns.ScorePlan(1, 32, 32, 1)
    assert ns.score_plan(1, 33, H100_SMS) == ns.ScorePlan(1, 64, 64, 1)
    assert ns.score_plan(64, 2048, H100_SMS) == ns.ScorePlan(2, 256, 1024, 128)
    # Ranks 0 and 1 of D 257 meet at lane 160: a tie there crosses the cluster.
    assert ns.block_ranges(ns.score_plan(1, 257, H100_SMS), 257) == [(0, 160), (160, 257)]


@pytest.mark.parametrize("args", [(0, 16, H100_SMS), (1, 0, H100_SMS), (1, 16, 0),
                                  (-1, 16, H100_SMS), (ns.MAX_GRID_X + 1, 16, H100_SMS)])
def test_score_plan_rejects(args):
    with pytest.raises(ValueError):
        ns.score_plan(*args)
