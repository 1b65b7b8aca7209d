"""The port's parity oracles and the rest of ``core/`` against the JAX
package's: ``core/reference.py`` (the retired per-candidate ladder),
``cluster/reference.py`` (the retired per-object flow network),
``core/propositions.py`` (Propositions 1 and 2) and ``core/netkv_vec.py``
(the vectorised scorer of ``repro/core/netkv_jax.py``).

The first three are verbatim NumPy copies: their sources must equal the
originals' but for the two-line header, and they must behave equal on the
same seeded inputs, decisions and flow states bit for bit.  The scorer runs
in torch f32 on the CPU here; it must choose what JAX's ``score_pool``
chooses, costs within rtol 1e-6, on ``tests/test_schedulers.py``'s pool.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as jcluster
import repro.core as jcore
import repro.core.propositions as jprops
import repro_torch.cluster as tcluster
import repro_torch.core as tcore
import repro_torch.core.propositions as tprops
from repro.cluster.reference import ReferenceFlowNetwork as JaxRefNet
from repro.core.netkv_jax import JaxNetKV, PoolArrays as JaxPool, score_pool
from repro.core.reference import REFERENCE_LADDER as JAX_LADDER
from repro.core.reference import make_reference_scheduler as jax_make_ref
from repro_torch.cluster.reference import ReferenceFlowNetwork as TorchRefNet
from repro_torch.core import netkv_vec
from repro_torch.core.reference import REFERENCE_LADDER, make_reference_scheduler

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("path", ["core/reference.py", "cluster/reference.py",
                                  "core/propositions.py"])
def test_copies_are_verbatim(path):
    with open(os.path.join(SRC, "repro", path)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", path)) as f:
        lines = f.read().splitlines(keepends=True)
    assert lines[0].startswith("# The port's own copy of ")
    assert "".join(lines[2:]) == original


def _pool(core, rng, n, req):
    return [core.CandidateState(
        instance_id=i + 1, free_memory=float(rng.uniform(1e9, 4e11)),
        queued=int(rng.integers(0, 10)), batch_size=int(rng.integers(0, 64)),
        hit_tokens=float(rng.integers(0, req.input_len)), healthy=bool(rng.random() > 0.15),
        iter_scale=float(rng.uniform(1.0, 2.0))) for i in range(n)]


def _oracle(core, rng, n):
    from importlib import import_module

    oracle = import_module(core.__name__ + ".oracle")
    tiers = rng.integers(0, 4, n + 1)
    return oracle.OracleView(tier_of=lambda p, d: int(tiers[d % len(tiers)]),
                             tier_bandwidth=oracle.PAPER_TIER_BANDWIDTH,
                             tier_latency=oracle.PAPER_TIER_LATENCY,
                             congestion={t: float(rng.uniform(0, 0.8)) for t in range(4)})


@pytest.mark.parametrize("name", sorted(JAX_LADDER))
def test_reference_ladder_equals_the_original(name):
    """Each rung of the copied reference ladder picks what the original picks
    (instance, cost, tier, s_eff, transfer time, bit for bit) over a sequence
    of seeded pools, consuming its tie-break RNG stream the same way, and
    the port's vectorised ladder agrees with it (the parity it is kept
    for)."""
    assert sorted(REFERENCE_LADDER) == sorted(JAX_LADDER)
    made = []
    for core, mk in ((jcore, jax_make_ref), (tcore, make_reference_scheduler)):
        made.append((core, mk(name, core.H100_TP4_ITER, 64, m_min=1e9, seed=3)))
    vec = tcore.make_scheduler(name, tcore.H100_TP4_ITER, 64, m_min=1e9, seed=3)
    for step in range(6):
        decisions = []
        for core, sched in made:
            rng = np.random.default_rng(step)
            req = core.RequestInfo(step, 8192, 8192 * 320 * 1024)
            cands = _pool(core, rng, 24, req)
            view = _oracle(core, rng, 24)
            decisions.append(sched.select(req, 0, cands, view, core.SelfContentionTracker()))
        rng = np.random.default_rng(step)
        req = tcore.RequestInfo(step, 8192, 8192 * 320 * 1024)
        cands = _pool(tcore, rng, 24, req)
        view = _oracle(tcore, rng, 24)
        decisions.append(vec.select(req, 0, cands, view, tcore.SelfContentionTracker()))
        fields = [None if d is None else (d.instance_id, d.cost, d.tier, d.s_eff,
                                          d.est_transfer_time) for d in decisions]
        assert fields[0] == fields[1] == fields[2], (step, fields)


TREE = dict(n_pods=2, racks_per_pod=2, servers_per_rack=2, gpus_per_server=8)


def _drive(net_a, net_b, seed, n_ops=60):
    """The same op sequence through two reference networks: flow rates,
    residual bytes and paths equal after every op, then the same completion
    order, finish times and per-tier bytes."""
    servers = [(p, r, s) for p in range(2) for r in range(2) for s in range(2)]
    wl = np.random.default_rng(seed + 0xF10)
    done_a, done_b, open_pairs, now = [], [], [], 0.0

    def state(net):
        return {fid: (f.rate, f.bytes_remaining, f.path) for fid, f in net.flows.items()}

    for _ in range(n_ops):
        now += float(wl.exponential(0.003))
        op = wl.random()
        if op < 0.55 or not open_pairs:
            i, j = wl.choice(len(servers), 2, replace=False)
            nbytes = float(wl.uniform(1e6, 5e8))
            open_pairs.append(tuple(
                net.start_transfer(servers[i], servers[j], nbytes, now,
                                   on_complete=lambda t, tt, d=done: d.append(
                                       (t.transfer_id, tt)), n_flows=4)
                for net, done in ((net_a, done_a), (net_b, done_b))))
        elif op < 0.75:
            na, nb = net_a.next_completion_time(now), net_b.next_completion_time(now)
            assert na == nb
            if na is not None:
                now = na
                net_a.advance(now)
                net_b.advance(now)
        elif op < 0.9:
            net_a.refresh_rates(now)
            net_b.refresh_rates(now)
        else:
            ta, tb = open_pairs.pop(int(wl.integers(len(open_pairs))))
            if not ta.done:
                net_a.abort_transfer(ta, now)
                net_b.abort_transfer(tb, now)
        open_pairs = [(a, b) for a, b in open_pairs if not a.done]
        assert state(net_a) == state(net_b)
    while (na := net_a.next_completion_time(now)) is not None:
        assert na == net_b.next_completion_time(now)
        now = na
        net_a.advance(now)
        net_b.advance(now)
    assert net_b.next_completion_time(now) is None
    assert done_a == done_b


@pytest.mark.parametrize("seed", range(3))
def test_reference_flow_network_equals_the_original(seed):
    """The copied ``ReferenceFlowNetwork`` against the original, and
    against the port's ``FlowPlane``, which its docstring holds to it."""
    _drive(JaxRefNet(jcluster.FatTree(**TREE), jcluster.BackgroundTraffic(0.0), seed=seed),
           TorchRefNet(tcluster.FatTree(**TREE), tcluster.BackgroundTraffic(0.0), seed=seed),
           seed)
    _drive(TorchRefNet(tcluster.FatTree(**TREE), tcluster.BackgroundTraffic(0.0), seed=seed),
           tcluster.FlowPlane(tcluster.FatTree(**TREE), tcluster.BackgroundTraffic(0.0),
                              seed=seed), seed)


def test_propositions_equal_the_original():
    rng = np.random.default_rng(5)
    for _ in range(200):
        kw = dict(s_r=float(rng.uniform(1e8, 1e10)), B1=float(rng.uniform(1e9, 1e11)),
                  k=float(rng.uniform(1, 8)), c1=float(rng.uniform(0, 0.9)),
                  c3=float(rng.uniform(0, 0.9)), rho1=float(rng.uniform(0, 1)),
                  rho2=float(rng.uniform(0, 1)), t_queue_d1=float(rng.uniform(0, 0.1)),
                  t_queue_d2=float(rng.uniform(0, 0.1)))
        a, b = jprops.Prop1Instance(**kw), tprops.Prop1Instance(**kw)
        for fn in ("prop1_rhs", "prop1_condition", "prop1_latencies"):
            assert getattr(jprops, fn)(a) == getattr(tprops, fn)(b)
        args = [float(x) for x in rng.uniform(0, 1, 4)] + [float(rng.uniform(0, 0.3))]
        args[0] *= 1e11
        args[2] *= 1e10
        assert jprops.prop2_epsilon_bound(*args[:4]) == tprops.prop2_epsilon_bound(*args[:4])
        assert (jprops.prop2_ordering_preserved(*args)
                == tprops.prop2_ordering_preserved(*args))


def _scheduler_pool(core, seed, n):
    """``tests/test_schedulers.py::TestJaxScorerEquivalence``'s pool."""
    from importlib import import_module

    oracle = import_module(core.__name__ + ".oracle")
    req = core.RequestInfo(0, 8192, 8192 * 320 * 1024)
    rng = np.random.default_rng(seed)
    cands = [core.CandidateState(
        instance_id=i, free_memory=float(rng.uniform(1e9, 4e11)),
        queued=int(rng.integers(0, 10)), batch_size=int(rng.integers(0, 64)),
        hit_tokens=float(rng.integers(0, req.input_len)), healthy=bool(rng.random() > 0.1),
        iter_scale=float(rng.uniform(1.0, 2.0))) for i in range(n)]
    tiers = rng.integers(0, 4, n)
    view = oracle.OracleView(tier_of=lambda p, d: int(tiers[d]),
                             tier_bandwidth=oracle.PAPER_TIER_BANDWIDTH,
                             tier_latency=oracle.PAPER_TIER_LATENCY,
                             congestion={t: float(rng.uniform(0, 0.8)) for t in range(4)})
    return req, cands, tiers, view


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 7), (2, 24), (3, 24), (4, 1000)])
def test_score_pool_chooses_what_jax_chooses(seed, n):
    """``netkv_vec`` (torch f32, CPU) against ``repro.core.netkv_jax``:
    the same winner (or the same refusal), costs at rtol 1e-6, infeasible
    lanes +inf in both; the batched scorer row by row too."""
    req, cands, tiers, view = _scheduler_pool(jcore, seed, n)
    treq, tcands, _, tview = _scheduler_pool(tcore, seed, n)
    jidx, jcosts = JaxNetKV(jcore.H100_TP4_ITER, 64, m_min=1e9).select_arrays(
        JaxPool.from_candidates(cands, tiers), req.kv_bytes, req.input_len, view, [0, 1, 0, 2])
    rung = netkv_vec.JaxNetKV(tcore.H100_TP4_ITER, 64, m_min=1e9)
    assert rung.name == "netkv-jax"
    pool = netkv_vec.PoolArrays.from_candidates(tcands, tiers, device="cpu")
    tidx, tcosts = rung.select_arrays(pool, treq.kv_bytes, treq.input_len, tview, [0, 1, 0, 2])
    assert tidx == jidx
    jc, tc = np.asarray(jcosts), tcosts.numpy()
    assert tc.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(tc), np.isinf(jc))
    fin = np.isfinite(jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-6)
    kv = np.array([req.kv_bytes, req.kv_bytes / 3], np.float32)
    ln = np.array([req.input_len, 512], np.float32)
    infl = np.array([[0, 1, 0, 2], [3, 0, 0, 0]], np.int32)
    args = (view.bandwidth_array(), view.latency_array(), view.congestion_array())
    tb_costs, tb_idx = netkv_vec.score_pool_batched(
        pool, torch.from_numpy(kv), torch.from_numpy(ln), *args, torch.from_numpy(infl),
        tcore.H100_TP4_ITER.a, tcore.H100_TP4_ITER.b, 1e9, beta_max=64)
    for r in range(2):   # JAX's vmapped scorer maps its beta_max too: held row by row
        jc, ji = score_pool(
            JaxPool.from_candidates(cands, tiers), jnp.float32(kv[r]), jnp.float32(ln[r]),
            *(jnp.asarray(a, jnp.float32) for a in args), jnp.asarray(infl[r]),
            jnp.float32(jcore.H100_TP4_ITER.a), jnp.float32(jcore.H100_TP4_ITER.b),
            jnp.float32(1e9), beta_max=64)
        jc = np.asarray(jc)
        fin = np.isfinite(jc)
        if fin.any():
            assert int(tb_idx[r]) == int(ji)
        np.testing.assert_array_equal(np.isinf(tb_costs[r].numpy()), ~fin)
        np.testing.assert_allclose(tb_costs[r].numpy()[fin], jc[fin], rtol=1e-6)
