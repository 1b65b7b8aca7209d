"""The port's water-filling and ScenarioPlane against the JAX package's, on
the CPU.

* ``threefry_uniform`` equals ``jax.random.uniform`` bit for bit: it is the
  sweep's tie-break jitter;
* the plain water-filling loops (``kernels/ref.py``) in f64 equal the JAX
  f64 route: the progressive fixed point bit for bit, rates and bottleneck
  trace, against ``repro.kernels.waterfill_rates`` and the port's FlowPlane;
  the parallel-bottleneck fixed point at rtol 1e-9, atol 1e-6;
* the same loops in f32, the plain versions of the K5/K6 kernels, against
  the JAX Pallas route in interpret mode;
* ``cohort_step`` in both clamp modes against the jitted JAX function;
* ``ScenarioPlane(backend="torch")`` against the JAX ``"jax"`` sweep: decode
  instances, tokens, ``t_first``/``t_fin`` and the counts bit for bit, the
  float summaries at rtol 1e-12 (XLA contracts some f64 ``a + b*c`` into an
  FMA, PyTorch does not, and sums reduce in another order);
* a batched row equals the solo run, and ``backend="kernel"`` (the f32
  plain version on the CPU) agrees with ``"torch"`` to within one step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.scenarios as jsc
from repro.cluster import BackgroundTraffic as JBackground, FatTree as JFatTree, FlowPlane as JFlowPlane
from repro.core.jaxutil import enable_f64
from repro.kernels import waterfill_rates as jax_waterfill_rates
from repro.kernels import waterfill_rates_fast as jax_waterfill_fast
from repro_torch.cluster import BackgroundTraffic, FatTree, FlowPlane
from repro_torch.kernels import ref
from repro_torch.kernels.waterfill import waterfill_rates
from repro_torch.sim import scenarios as tsc

TREE_64 = dict(n_pods=2, racks_per_pod=2, servers_per_rack=2, gpus_per_server=8)
SUMMARY_FLOATS = ("ttft_mean", "ttft_p50", "ttft_p95", "ttft_p99", "tbt_mean",
                  "slo_attainment", "goodput_rps")
EXACT = ("n_measured", "n_served", "tokens", "t_first", "t_fin", "inst")


# ------------------------------------------------------------------ helpers
def _loaded_plane(pkg, seed, n_transfers=40, bg=0.2, nic_policy="hash"):
    """A FlowPlane mid-drive (``tests/test_scenarioplane.py::_loaded_plane``)
    of either package."""
    tree_cls, plane_cls, bg_cls = pkg
    tree = tree_cls(**TREE_64, nics_per_server=2)
    plane = plane_cls(tree, bg_cls(bg), seed=seed, nic_policy=nic_policy)
    rng = np.random.default_rng(seed + 7)
    servers = [(p, r, s) for p in range(2) for r in range(2) for s in range(2)]
    now = 0.0
    for _ in range(n_transfers):
        now += float(rng.exponential(0.002))
        i, j = rng.choice(len(servers), 2, replace=False)
        plane.start_transfer(servers[i], servers[j], float(rng.uniform(1e7, 5e8)), now,
                             on_complete=lambda t, tt: None, n_flows=4)
    plane._wf_trace = []
    plane.refresh_rates(now)
    return plane


PORT = (FatTree, FlowPlane, BackgroundTraffic)
JAXPKG = (JFatTree, JFlowPlane, JBackground)


def _random_table(seed):
    """``tests/test_scenarioplane.py::_random_table``."""
    rng = np.random.default_rng(seed)
    n_links = int(rng.integers(4, 28))
    n_flows = int(rng.integers(1, 40))
    h = int(rng.integers(2, 7))
    caps = np.append(rng.uniform(1e7, 1e9, n_links), np.inf)
    paths = np.full((n_flows, h), n_links, np.int32)
    for f in range(n_flows):
        plen = int(rng.integers(1, min(h, n_links) + 1))
        paths[f, :plen] = rng.choice(n_links, plen, replace=False)
    active = rng.random(n_flows) < 0.85
    return paths, caps, active


def _nhops(paths, n_links1):
    nh = np.zeros((paths.shape[0], n_links1))
    for f in range(paths.shape[0]):
        for link in paths[f]:
            nh[f, int(link)] += 1
    nh[:, -1] = 0.0
    return nh


def _fast_ref(caps, active, nh, dtype):
    t = lambda a: torch.from_numpy(np.asarray(a))
    return ref.waterfill_rates_fast_ref(t(caps).to(dtype)[None], t(active)[None],
                                        t(nh).to(dtype)[None])[0].numpy()


# ------------------------------------------------------------- threefry
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 5])
def test_threefry_uniform_bitwise(seed):
    enable_f64()
    for shape in ((119, 12), (21, 12), (7,)):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float64))
        assert np.array_equal(tsc.threefry_uniform(seed, shape), want), shape


# ------------------------------------------------- progressive fixed point
@pytest.mark.parametrize("seed,nic", [(0, "hash"), (1, "rail-affine")])
def test_progressive_f64_matches_flowplane_and_jax(seed, nic):
    jplane = _loaded_plane(JAXPKG, seed, nic_policy=nic)
    plane = _loaded_plane(PORT, seed, nic_policy=nic)
    slots = plane._ordered_slots()
    assert np.array_equal(plane.f_rate[slots], jplane.f_rate[jplane._ordered_slots()])
    paths = plane.f_path[slots].astype(np.int32)
    caps = plane._resid_caps.copy()
    rates, tl, ts, r = waterfill_rates(paths, caps, backend="torch", device="cpu")
    assert np.array_equal(rates.numpy(), plane.f_rate[slots])
    assert r == len(plane._wf_trace) > 1
    assert tl[:r].tolist() == [link for link, _ in plane._wf_trace]
    assert np.array_equal(ts[:r].numpy(), np.array([s for _, s in plane._wf_trace]))
    jr, jtl, jts, jn = jax_waterfill_rates(paths, caps, backend="jax")
    assert int(jn) == r
    assert np.array_equal(np.asarray(jr), rates.numpy())
    assert np.array_equal(np.asarray(jtl), tl.numpy())
    assert np.array_equal(np.asarray(jts), ts.numpy())


@pytest.mark.parametrize("seed", range(8))
def test_progressive_f64_random_tables_bitwise(seed):
    paths, caps, active = _random_table(seed)
    rates, tl, ts, r = waterfill_rates(paths, caps, active, backend="torch", device="cpu")
    jr, jtl, jts, jn = jax_waterfill_rates(paths, caps, active, backend="jax")
    assert int(jn) == r
    assert np.array_equal(np.asarray(jr), rates.numpy())
    assert np.array_equal(np.asarray(jtl), tl.numpy())
    assert np.array_equal(np.asarray(jts), ts.numpy())
    assert np.all(rates.numpy()[~active] == 0.0)


def test_progressive_inf_stall_strands_the_rest():
    """Flows whose every hop is the pad link have no finite share: the loop
    strands them at inf after fixing the others, in both packages."""
    caps = np.array([4e8, 1e8, np.inf])
    paths = np.array([[0, 1], [2, 2], [1, 2]], np.int32)
    for backend in ("torch", "kernel"):
        rates, tl, ts, r = waterfill_rates(paths, caps, backend=backend, device="cpu")
        assert r == 1 and tl[0] == 1
        assert rates.tolist() == [5e7, float("inf"), 5e7]
    jr, _, _, jn = jax_waterfill_rates(paths, caps, backend="jax")
    assert int(jn) == 1 and np.asarray(jr).tolist() == [5e7, np.inf, 5e7]


@pytest.mark.parametrize("seed", [3, 14])
def test_progressive_f32_matches_pallas(seed):
    """K5's plain version against the Pallas route in interpret mode (the
    same f32 shares and first minimum): rtol 1e-4 holds, and on these
    tables the two agree bit for bit, rates and trace."""
    paths, caps, active = _random_table(seed)
    rates, tl, ts, r = waterfill_rates(paths, caps, active, backend="kernel", device="cpu")
    assert rates.dtype == torch.float32
    jr, jtl, jts, jn = jax_waterfill_rates(paths, caps, active, backend="pallas")
    np.testing.assert_allclose(rates.numpy(), np.asarray(jr), rtol=1e-4)
    assert int(jn) == r
    assert np.array_equal(np.asarray(jr), rates.numpy())
    assert np.array_equal(np.asarray(jtl), tl.numpy())
    f64, *_ = waterfill_rates(paths, caps, active, backend="torch", device="cpu")
    np.testing.assert_allclose(rates.double().numpy(), f64.numpy(), rtol=1e-4)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        waterfill_rates(np.zeros((1, 2), np.int32), np.array([1.0, np.inf]),
                        backend="jax", device="cpu")


# ----------------------------------------------- parallel-bottleneck solver
@pytest.mark.parametrize("seed", range(6))
def test_fast_f64_matches_jax(seed):
    paths, caps, active = _random_table(seed)
    want = np.asarray(jax_waterfill_fast(jnp.asarray(paths), jnp.asarray(caps),
                                         jnp.asarray(active)))
    got = _fast_ref(caps, active, _nhops(paths, caps.shape[0]), torch.float64)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_fast_f32_matches_pallas(seed):
    """K6's plain version against the Pallas route (interpret mode)."""
    paths, caps, active = _random_table(seed)
    nh = _nhops(paths, caps.shape[0])
    want = np.asarray(jax_waterfill_fast(None, jnp.asarray(caps), jnp.asarray(active),
                                         nhops=jnp.asarray(nh), use_pallas=True,
                                         interpret=True))
    got = _fast_ref(caps, active, nh, torch.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fast_batched_rows_equal_solo():
    """A batch of tables of one shape: each row equals its own solo run
    (a lane that has converged idles while the others finish)."""
    rng = np.random.default_rng(5)
    s, f, n_links, h = 6, 24, 15, 4
    caps = np.concatenate([rng.uniform(1e7, 1e9, (s, n_links)), np.full((s, 1), np.inf)], 1)
    active = rng.random((s, f)) < 0.8
    active[2] = False  # an empty table
    nh = np.stack([_nhops(np.stack([rng.choice(n_links + 1, h) for _ in range(f)]),
                          n_links + 1) for _ in range(s)])
    for dtype in (torch.float64, torch.float32):
        t = lambda a: torch.from_numpy(a)
        batch = ref.waterfill_rates_fast_ref(t(caps).to(dtype), t(active), t(nh).to(dtype))
        for i in range(s):
            solo = _fast_ref(caps[i], active[i], nh[i], dtype)
            assert np.array_equal(batch[i].numpy(), solo), (dtype, i)
        assert torch.all(batch[2] == 0)


# ------------------------------------------------------------ cohort step
def _cohort_args(seed, rows=64, k=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 9, rows), rng.integers(1, 10, rows), rng.integers(0, k, rows),
            np.arange(rows, dtype=np.int64), rng.uniform(0.0, 4e8, rows),
            rng.random(rows) < 0.8, rng.random(k) < 0.7,
            np.append(rng.uniform(0.0, 1e9, k), 0.0))


@pytest.mark.parametrize("exact", [True, False])
def test_cohort_step_matches_jax(exact):
    enable_f64()
    for seed in range(4):
        args = _cohort_args(seed)
        want = jsc.cohort_step_jit(*(jnp.asarray(a) for a in args), kv_per_token=1e5,
                                   exact_clamp=exact)
        got = tsc.cohort_step(*(torch.from_numpy(a) for a in args), kv_per_token=1e5,
                              exact_clamp=exact)
        for name, w, g in zip(("tokens", "live", "pinned", "first", "fin", "fin_per_inst"),
                              want, got):
            w, g = np.asarray(w), g.numpy()
            if name == "pinned":
                # The pad slot is a no-op accumulator that nothing reads.
                w, g = w[:-1], g[:-1]
            assert np.array_equal(w, g), (seed, name)


# ------------------------------------------------------------- the sweep
def _specs(pkg):
    """``tests/test_scenarioplane.py::_sweep_specs``."""
    base = dict(warmup=0.5, measure=2.0, drain=1.5, target_rps=8.0)
    return [
        pkg.ScenarioSpec(seed=0, scheduler="netkv-full", **base),
        pkg.ScenarioSpec(seed=0, scheduler="cla", **base),
        pkg.ScenarioSpec(seed=1, scheduler="netkv-static", chunk_tokens=256,
                         kv_streaming=True, **base),
        pkg.ScenarioSpec(seed=1, scheduler="netkv-full", nic_policy="rail-affine",
                         background=0.3, rewires=((1.0, {2: 0.5, 3: 0.5}),), **base),
    ]


def _jax_sweep_with_instances(specs):
    """The JAX sweep with each request's decode instance: the final loop
    state's instance column rides in the high bits of the token column to
    the summary, which unpacks it.  Nothing in the JAX package changes."""
    orig_loop, orig_summarize = jax.lax.fori_loop, jsc._summarize

    def loop(lo, hi, body, st):
        st = orig_loop(lo, hi, body, st)
        return (st[0] + ((st[2].astype(jnp.int64) + 1) << 32),) + tuple(st[1:])

    def summarize(arrival, slo, out_len, t_first, t_fin, tokens, *rest):
        out = orig_summarize(arrival, slo, out_len, t_first, t_fin,
                             tokens & 0xFFFFFFFF, *rest)
        out["inst"] = (tokens >> 32) - 1
        return out

    jax.lax.fori_loop, jsc._summarize = loop, summarize
    try:
        return jsc.ScenarioPlane(specs, dt=0.01).sweep(detail=True)
    finally:
        jax.lax.fori_loop, jsc._summarize = orig_loop, orig_summarize


@pytest.fixture(scope="module")
def sweeps():
    jout = _jax_sweep_with_instances(_specs(jsc))
    plane = tsc.ScenarioPlane(_specs(tsc), dt=0.01, device="cpu")
    return jout, plane, plane.sweep(detail=True)


def test_sweep_matches_jax(sweeps):
    jout, _, out = sweeps
    assert set(out) == set(jout)
    for key in EXACT:
        assert np.array_equal(out[key], np.asarray(jout[key])), key
    assert np.all(out["inst"] >= -1) and np.any(out["inst"] >= 0)
    for key in SUMMARY_FLOATS:
        np.testing.assert_allclose(out[key], np.asarray(jout[key]), rtol=1e-12,
                                   atol=0, equal_nan=True, err_msg=key)


def test_sweep_shapes_and_sanity(sweeps):
    _, plane, out = sweeps
    s = len(plane.scenarios)
    for key in ("n_measured", "n_served") + SUMMARY_FLOATS:
        assert out[key].shape == (s,), key
    assert np.all(out["n_measured"] > 0)
    assert np.all(out["n_served"] <= out["n_measured"])
    served = out["n_served"] > 0
    assert np.all(np.isfinite(out["ttft_p50"][served]))
    att = out["slo_attainment"]
    assert np.all((att >= 0.0) & (att <= 1.0) | np.isnan(att))
    assert set(plane.sweep()) == {"n_measured", "n_served", *SUMMARY_FLOATS}


def test_batched_rows_match_solo_runs(sweeps):
    _, plane, batched = sweeps
    for i, spec in enumerate(plane.scenarios):
        solo = tsc.ScenarioPlane([spec], dt=0.01, device="cpu",
                                 max_requests=plane.max_requests).sweep(detail=True)
        for key, val in batched.items():
            assert np.array_equal(val[i], solo[key][0], equal_nan=True), (key, i)


def test_kernel_backend_close_to_torch(sweeps):
    """The f32 water-filling (K6's plain version on the CPU) against the f64
    loop: the same counts and decode instances; f32 rates may move a
    transfer's finish, so each request's first and last token lie within
    one step (dt) of the f64 run's."""
    _, plane, out = sweeps
    k_out = tsc.ScenarioPlane(plane.scenarios, dt=0.01, backend="kernel",
                              device="cpu").sweep(detail=True)
    for key in ("n_measured", "n_served", "inst"):
        assert np.array_equal(k_out[key], out[key]), key
    for key in ("t_first", "t_fin"):
        assert np.all(np.abs(k_out[key] - out[key]) <= plane.dt * (1 + 1e-9)), key
    for key in ("ttft_mean", "ttft_p50", "ttft_p95", "ttft_p99"):
        np.testing.assert_allclose(k_out[key], out[key], atol=plane.dt, rtol=0, err_msg=key)


def test_plane_rejects_bad_grids():
    a = tsc.ScenarioSpec(seed=0)
    with pytest.raises(ValueError):
        tsc.ScenarioPlane([a, tsc.ScenarioSpec(seed=0, n_pods=4)], device="cpu")
    with pytest.raises(ValueError):
        tsc.ScenarioPlane([a, tsc.ScenarioSpec(seed=0, measure=a.measure + 1.0)], device="cpu")
    with pytest.raises(ValueError):
        tsc.ScenarioPlane([a], backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        tsc.ScenarioPlane([], device="cpu")
    sp = tsc.ScenarioSpec(seed=0, warmup=0.5, measure=2.0, drain=1.5, target_rps=8.0)
    plane = tsc.ScenarioPlane([sp], device="cpu")
    with pytest.raises(ValueError):
        tsc.ScenarioPlane([sp], max_requests=plane.max_requests - 1, device="cpu")


def test_specs_mirror_jax():
    assert [f.name for f in dataclasses.fields(tsc.ScenarioSpec)] == \
        [f.name for f in dataclasses.fields(jsc.ScenarioSpec)]
    assert tsc._SCHED_FLAGS == jsc._SCHED_FLAGS
