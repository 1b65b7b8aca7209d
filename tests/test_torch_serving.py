"""The port's serving slice against the JAX package's: transfer tables and
bytes, the disaggregated cluster field by field, the scheduler ladder and
the kernel scoring backend; plus the port's import and device rules."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as jax_spec
from repro.models import init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import prefill as jax_prefill
from repro.serving import DisaggregatedCluster as JaxCluster
from repro.serving import ServeRequest as JaxRequest
from repro.serving import (
    merge_chunk_buffers as jax_merge,
    pack_transfer as jax_pack,
    pack_transfer_chunk as jax_pack_chunk,
    unpack_transfer as jax_unpack,
)
from repro_torch.configs import get_spec
from repro_torch.models import decode_step, params_from_jax, prefill
from repro_torch.serving import (
    DisaggregatedCluster,
    ServeRequest,
    merge_chunk_buffers,
    pack_transfer,
    pack_transfer_chunk,
    unpack_transfer,
)

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_spec("qwen3-14b").smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_spec("qwen3-14b").smoke, compute_dtype=torch.float32)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, model


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _caches(setup, n_tok, seed=1):
    jcfg, _, jp, model = setup
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (1, n_tok))
    _, jc = jax_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), cache_len=64)
    _, tc = prefill(model, torch.from_numpy(toks), cache_len=64)
    return toks, jc, tc


def _same_buffers(tb, jb):
    assert set(tb) == set(jb)
    for name, (buf, table) in tb.items():
        jbuf, jtable = jb[name]
        assert table == jtable, name
        np.testing.assert_allclose(_np(buf), _np(jbuf), atol=1e-4)


class TestTransfer:
    @pytest.mark.parametrize("hit_pages", [0, 1, 2, 4])
    def test_pack_tables_and_bytes(self, setup, hit_pages):
        _, jc, tc = _caches(setup, 64)
        tb, tn = pack_transfer(tc, hit_pages)
        jb, jn = jax_pack(jc, hit_pages)
        assert tn == jn
        _same_buffers(tb, jb)

    def test_chunks_conserve_bytes_and_merge(self, setup):
        _, jc, tc = _caches(setup, 48)
        t_chunks, j_chunks, total = [], [], 0
        for start, end, final in ((0, 2, False), (2, 3, False), (3, None, True)):
            b, n = pack_transfer_chunk(tc, 1, start, end, final=final)
            jb, jn = jax_pack_chunk(jc, 1, start, end, final=final)
            assert n == jn
            _same_buffers(b, jb)
            t_chunks.append(b)
            j_chunks.append(jb)
            total += n
        assert total == pack_transfer(tc, 1)[1]
        _same_buffers(merge_chunk_buffers(t_chunks), jax_merge(j_chunks))

    def test_unpack_roundtrip_decodes_like_jax(self, setup):
        """Unpack zero-fills the hit pages exactly as the JAX package does,
        and a decode step from the landed caches agrees."""
        jcfg, _, jp, model = setup
        toks, jc, tc = _caches(setup, 40)
        tb, _ = pack_transfer(tc, 1)
        jb, _ = jax_pack(jc, 1)
        rebuilt, jrebuilt = unpack_transfer(tb, tc), jax_unpack(jb, jc)
        for leaf in ("k0", "v0"):
            np.testing.assert_allclose(_np(rebuilt[leaf]), _np(jrebuilt[leaf]), atol=1e-4)
            assert not rebuilt[leaf][:, :, :16].any()  # the hit page stays zero
        rebuilt["pos"], jrebuilt["pos"] = tc["pos"], jc["pos"]
        tl, _ = decode_step(model, torch.from_numpy(toks[:, -1:]), rebuilt)
        jl, _ = jax_decode_step(jcfg, jp, jnp.asarray(toks[:, -1:], jnp.int32), jrebuilt)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4)


def _serve_netkv_workload(vocab):
    """examples/serve_netkv.py: 8 requests, the even ones sharing a prefix."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, size=16)
    out = []
    for i in range(8):
        if i % 2 == 0:
            prompt = np.concatenate([shared, rng.integers(0, vocab, 8)])
        else:
            prompt = rng.integers(0, vocab, size=24)
        out.append((i, prompt, 8, i * 0.05))
    return out


def _repeat_workload(vocab):
    """One 48-token prompt served three times: the later two are full hits."""
    shared = np.random.default_rng(1).integers(0, vocab, size=48)
    return [(i, shared.copy(), 4, i * 0.5) for i in range(3)]


def _ladder_workload(vocab):
    rng = np.random.default_rng(2)
    return [(i, rng.integers(0, vocab, size=16), 3, 0.0) for i in range(3)]


def _serve_both(setup, workload, scheduler="netkv-full"):
    jcfg, tcfg, _, model = setup
    jres = JaxCluster(jcfg, scheduler=scheduler, cache_len=64).serve(
        [JaxRequest(*a) for a in workload])
    tres = DisaggregatedCluster(tcfg, scheduler=scheduler, cache_len=64, params=model,
                                device="cpu").serve([ServeRequest(*a) for a in workload])
    return jres, tres


class TestCluster:
    @pytest.mark.parametrize("workload", [_serve_netkv_workload, _repeat_workload])
    def test_every_field_equals_jax(self, setup, workload):
        jres, tres = _serve_both(setup, workload(setup[0].vocab_size))
        assert len(tres) == len(jres)
        for j, t in zip(jres, tres):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    def test_repeat_prompt_copies_the_zero_filled_hit(self, setup):
        """The JAX package lands a full prefix hit as zero pages; the port
        copies that (ROADMAP §3), so the repeats ship 0 bytes and decode
        from the zeroed cache."""
        _, tres = _serve_both(setup, _repeat_workload(setup[0].vocab_size))
        assert [r.transfer_bytes for r in tres] == [49152, 0, 0]
        assert tres[1].tokens == tres[2].tokens != tres[0].tokens

    @pytest.mark.parametrize("scheduler", ["rr", "cla", "netkv-static", "netkv-full"])
    def test_ladder_decisions_equal_jax(self, setup, scheduler):
        jres, tres = _serve_both(setup, _ladder_workload(setup[0].vocab_size), scheduler)
        for j, t in zip(jres, tres):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _seeded_pool(n, seed):
    from repro_torch.core import CandidateState, ClusterView, OracleView
    from repro_torch.core.oracle import PAPER_TIER_BANDWIDTH, PAPER_TIER_LATENCY

    rng = np.random.default_rng(seed)
    cands = [CandidateState(i, float(rng.uniform(1e10, 4e11)), int(rng.integers(0, 8)),
                            int(rng.integers(0, 64)), float(rng.integers(0, 8192)),
                            healthy=bool(rng.random() > 0.1))
             for i in range(n)]
    tiers = rng.integers(0, 4, n)
    view = OracleView(lambda p, d: int(tiers[d % n]), PAPER_TIER_BANDWIDTH,
                      PAPER_TIER_LATENCY, {t: float(rng.uniform(0, 0.5)) for t in range(4)})
    return ClusterView.from_candidates(cands, tier_fn=view.tier_of), view


class TestKernelBackend:
    @pytest.mark.parametrize("seed,n", [(0, 48), (1, 240), (2, 1008), (3, 2048)])
    def test_pick_within_rtol_of_numpy_minimum(self, seed, n):
        """Ties may break differently (lowest index vs a seeded draw), so the
        pick is held to the NumPy minimum cost, as the JAX package holds its
        Pallas backend."""
        from repro_torch.core import (H100_TP4_ITER, RequestInfo, SelfContentionTracker,
                                      make_scheduler)

        cv, view = _seeded_pool(n, seed)
        req = RequestInfo(0, 8192, 8192 * 320 * 1024)
        kern = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel", device="cpu")
        plain = make_scheduler("netkv-full", H100_TP4_ITER, 64)
        infl = SelfContentionTracker()
        infl.incr(0, 2)
        dec = kern.select(req, 0, cv, view, infl)
        infl.decr(0, dec.tier)
        s_eff, mask = plain._prep(req, cv)
        cost = (plain._xfer_vec(req, cv, 0, view, infl, s_eff, cv.tier_row(0))
                + plain._t_queue_vec(cv) + plain._t_decode_vec(cv))
        best = float(cost[mask].min())
        got = float(cost[cv.slot_of(dec.instance_id)])
        assert abs(got - best) <= 1e-5 * best
        assert dec.cost == pytest.approx(best, rel=1e-5)

    def test_infeasible_pool_is_rejected(self):
        from repro_torch.core import H100_TP4_ITER, RequestInfo, make_scheduler

        cv, view = _seeded_pool(16, 5)
        cv.healthy[:cv.n] = False
        kern = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel", device="cpu")
        assert kern.select(RequestInfo(0, 8192, 1e9), 0, cv, view) is None

    def test_unported_paths_raise(self):
        """The encoder-decoder and vision architectures are ported: both
        specs resolve to the JAX package's configs; an unknown arch raises."""
        from repro.configs import get_spec as jax_spec
        from repro_torch.configs import ALL, get_spec as port_spec

        for arch in ("seamless-m4t-medium", "internvl2-76b"):
            spec = port_spec(arch)
            assert spec.arch_id == arch and spec.source == jax_spec(arch).source
            assert dataclasses.asdict(spec.kv_spec()) == dataclasses.asdict(
                jax_spec(arch).kv_spec())
        assert port_spec("seamless-m4t-medium").model.is_enc_dec
        assert port_spec("internvl2-76b").model.n_prefix_embeds == 256
        assert len(ALL) == 11
        with pytest.raises(KeyError, match="unknown arch"):
            port_spec("no-such-arch")

    def test_cohort_and_batch_paths_run(self):
        """The cohort walk and netkv-batch, which raised before the simulator
        was ported, run and agree with sequential selection."""
        from repro_torch.core import (H100_TP4_ITER, CohortItem, CohortSelector, NetKVBatch,
                                      RequestInfo, make_scheduler)

        assert isinstance(make_scheduler("netkv-batch", H100_TP4_ITER, 64), NetKVBatch)
        cv, view = _seeded_pool(32, 4)
        items = [CohortItem(RequestInfo(k, 4096, 4096 * 320 * 1024.0), k % 2) for k in range(3)]
        hits = np.zeros((3, cv.n))
        seq = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel", device="cpu")
        sel = make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel", device="cpu")
        walk = sel.select_cohort(items, cv, view, None, hit_matrix=hits)
        assert isinstance(walk, CohortSelector)
        for k, it in enumerate(items):
            cv.hit_tokens[:cv.n] = 0.0
            assert walk.select_row(k) == seq.select(it.req, it.prefill_id, cv, view, None)


class TestPortRules:
    def test_port_imports_nothing_of_jax_or_repro(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=str(SRC)),
                             timeout=300)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.strip()) > 40

    def test_entry_points_refuse_to_run_without_a_card(self, setup):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        from repro_torch.core import H100_TP4_ITER, make_scheduler
        from repro_torch.kernels.build import resolve_device

        tcfg = setup[1]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DisaggregatedCluster(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_scheduler("netkv-full", H100_TP4_ITER, 64, backend="kernel")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)

    def test_launcher(self, capsys):
        from repro_torch.launch import serve

        assert serve.main(["--profile", "chatbot", "--rate", "0.3", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "netkv-full on chatbot (llama3-70b KV) @ 30%:" in out and "TTFT mean=" in out
        assert serve.main(["--real", "--requests", "2", "--device", "cpu"]) == 0
        assert "served 2 requests on cpu" in capsys.readouterr().out
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                serve.main(["--profile", "chatbot"])

    def test_chip_smoke_imports_nothing_of_jax_or_repro(self):
        import ast

        tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        roots = {name.split(".")[0] for name in names}
        assert "repro_torch" in roots
        assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots
