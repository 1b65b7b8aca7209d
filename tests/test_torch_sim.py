"""The port's event-loop simulator against the JAX package's, on the CPU.

The port keeps its own copies of the simulator's NumPy modules (traces,
EventPlane, InstancePlane, RadixPlane, TracePlane, metrics, DispatchPlane,
the batch and multi-hop schedulers, ``run_sim``).  Seeded drives go through
both packages and must agree:

* ``generate_trace``: every request field;
* ``run_sim``: every ``RunMetrics`` field except ``decision_latency_*``,
  which are host-clock timings;
* the dispatch ``Decision`` stream and per-request outcomes, as
  ``tests/test_dispatchplane.py`` reads them;
* the kernel scoring backend: the port's ``netkv_score_cohort`` plain
  version (``backend="kernel", device="cpu"``) against the JAX Pallas
  backend in interpret mode on a burst drive that forms cohorts, decisions
  and decision forensics rows (the JAX backend derives its runner-up from
  the whole cost row, the port from the kernel's packed result).
"""

import dataclasses
import math

import pytest

import repro.sim as jsim
import repro.traces as jtraces
import repro_torch.sim as tsim
import repro_torch.traces as ttraces

CLOCK_FIELDS = {"decision_latency_mean", "decision_latency_p99"}
GPU64 = dict(n_pods=2, racks_per_pod=2, servers_per_rack=2)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _assert_metrics_equal(mj, mt):
    fj, ft = dataclasses.asdict(mj), dataclasses.asdict(mt)
    assert fj.keys() == ft.keys()
    assert CLOCK_FIELDS <= fj.keys()
    diff = {k: (fj[k], ft[k]) for k in fj
            if k not in CLOCK_FIELDS and not _same(fj[k], ft[k])}
    assert not diff


def _trace_pair(profile, **kw):
    return (jtraces.generate_trace(profile, **kw),
            ttraces.generate_trace(profile, **kw))


def _faults(pkg):
    return [pkg.FaultEvent(time=1.2, kind="kill_decode", instance_id=4),
            pkg.FaultEvent(time=2.0, kind="add_decode")]


# --------------------------------------------------------------- traces
@pytest.mark.parametrize("profile,seed", [("chatbot", 0), ("rag", 3), ("long_context", 7)])
def test_generate_trace_equal(profile, seed):
    tj, tt = _trace_pair(profile, duration=6.0, target_rps=9.0, seed=seed)
    assert len(tj) > 10
    assert [dataclasses.astuple(r) for r in tj] == [dataclasses.astuple(r) for r in tt]


def test_profiles_equal():
    for name, prof in jtraces.PROFILES.items():
        assert dataclasses.asdict(prof) == dataclasses.asdict(ttraces.PROFILES[name])
        assert jtraces.profile_capacity(name) == ttraces.profile_capacity(name)


# -------------------------------------------------------------- run_sim
RUNS = {
    "netkv-full-plane": dict(scheduler="netkv-full", dispatch_mode="plane"),
    "netkv-full-reference": dict(scheduler="netkv-full", dispatch_mode="reference"),
    "cla": dict(scheduler="cla"),
    "netkv-batch": dict(scheduler="netkv-batch"),
    "netkv-multihop": dict(scheduler="netkv-multihop", background=0.4),
    "chunked-streaming": dict(scheduler="netkv-full", chunk_tokens=512,
                              prefill_token_budget=1024, kv_streaming=True),
    "deflection": dict(scheduler="netkv-full", n_prefill=2, chunk_tokens=2048,
                       prefill_token_budget=4096, deflection="on",
                       deflect_threshold=0.3),
    "fault": dict(scheduler="netkv-full", faults="kill+add"),
}


def _cfg(pkg, kw):
    kw = dict(kw)
    if kw.pop("faults", None):
        kw["faults"] = _faults(pkg)
    kw.setdefault("background", 0.2)
    return pkg.SimConfig(seed=1, warmup=0.5, measure=2.5, **GPU64, **kw)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_sim_equal(name):
    profile = "rag" if name == "deflection" else "chatbot"
    tj, tt = _trace_pair(profile, duration=3.0, target_rps=8.0, seed=1)
    mj = jsim.run_sim(_cfg(jsim, RUNS[name]), tj)
    mt = tsim.run_sim(_cfg(tsim, RUNS[name]), tt)
    assert mj.n_measured > 5
    if name == "deflection":
        assert mj.deflected_frac > 0
    if name == "fault":
        assert mj.requeues > 0
    _assert_metrics_equal(mj, mt)


# ------------------------------------------------------ decision stream
def _burst(pkg, bursts=6, width=4):
    """Same-arrival bursts (``tests/test_dispatchplane.py::_burst_trace``):
    their prefills finish at one instant, so dispatch cohorts form."""
    Request = (jtraces if pkg is jsim else ttraces).Request
    trace, rid = [], 0
    for b in range(bursts):
        t = 0.1 + 0.4 * b
        for i in range(width):
            hashes = tuple(f"b{b}-{i}-{j}" for j in range(8))
            trace.append(Request(rid, t, 1024, 64, hashes, rid, 1.0))
            rid += 1
    return trace


def _drive(pkg, sched, mode="plane", bursts=6, **kw):
    cfg = pkg.SimConfig(scheduler=sched, dispatch_mode=mode, warmup=0.5,
                        measure=4.0, seed=3, **GPU64, **kw)
    sim = pkg.Simulation(cfg)
    sim.loop.trace_log = []
    sizes = []
    orig = sim._cohort_selector
    sim._cohort_selector = lambda items, reqs, now: (
        sizes.append(len(items)), orig(items, reqs, now))[1]
    sim.run(_burst(pkg, bursts), drain=10.0)
    outs = [(rs.req.request_id, rs.prefill_instance, rs.decode_instance, rs.tier,
             rs.s_eff, rs.rejected, rs.requeues, rs.prefill_end, rs.transfer_end,
             rs.first_token, rs.finish, rs.tokens_out, rs.hit_tokens, rs.sched_time)
            for rs in sim.records]
    return outs, sim.loop.trace_log, sizes


@pytest.mark.parametrize("sched,mode", [("netkv-full", "plane"), ("netkv-full", "reference"),
                                        ("netkv-pred", "plane"), ("rr", "plane")])
def test_decision_stream_equal(sched, mode):
    oj, lj, sj = _drive(jsim, sched, mode)
    ot, lt, st = _drive(tsim, sched, mode)
    assert ot == oj
    assert lt == lj
    assert st == sj
    if mode == "plane":
        assert max(st) >= 2  # a multi-request cohort formed


def test_kernel_backend_matches_pallas_backend():
    """K1's plain version (``device="cpu"``) in both dispatch paths of the
    port against the JAX Pallas backend: the cohort rows of one launch and
    the single-row launches give the same decisions."""
    oj, lj, sj = _drive(jsim, "netkv-full", bursts=3,
                        scheduler_kwargs={"backend": "pallas"})
    ot, lt, st = _drive(tsim, "netkv-full", bursts=3,
                        scheduler_kwargs={"backend": "kernel", "device": "cpu"})
    assert max(st) >= 2
    assert st == sj
    assert ot == oj
    assert lt == lj


def _forensics(pkg, **kw):
    cfg = pkg.SimConfig(scheduler="netkv-full", dispatch_mode="plane", warmup=0.5,
                        measure=4.0, seed=3, trace=True, trace_decisions=1, **GPU64, **kw)
    sim = pkg.Simulation(cfg)
    sim.run(_burst(pkg, 3), drain=10.0)
    return sim.trace.forensics_rows()


def test_kernel_backend_forensics_rows_match_pallas_backend():
    """Every decision's forensics row, traced with ``trace_decisions=1``:
    the port reads winner and runner-up from the kernel's packed result,
    the JAX Pallas backend masks the winner in the whole f32 cost row and
    takes its first argmin, as the port did before the packed result.
    Row for row equal, NaN fields included."""
    rj = _forensics(jsim, scheduler_kwargs={"backend": "pallas"})
    rt = _forensics(tsim, scheduler_kwargs={"backend": "kernel", "device": "cpu"})
    assert rt and len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)), (a, b)
    assert any(r[5] >= 0 for r in rt)                  # a runner-up was recorded
    assert all(r[5] < 0 or r[9] <= r[10] for r in rt)  # the winner costs no more
