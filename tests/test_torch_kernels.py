"""The port's plain kernel versions against the JAX package's kernels.

Inputs come from numpy seeds and cross into each framework as numpy; the
JAX side runs its Pallas kernels in interpret mode through
``repro.kernels.ops`` and its pure-jnp oracles in ``repro.kernels.ref``.
Tolerances are those of tests/test_kernels.py.  On the CPU ``ops`` routes
to the plain versions; the CUDA kernels are held to them on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

import repro.kernels.ops as jops
import repro.kernels.ref as jref
from repro.kernels.netkv_score import _netkv_score_cohort_np
from repro_torch.kernels import ops, ref
from repro_torch.kernels.netkv_score import BIG, unpack_result

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same f32 numpy values as a JAX and a torch array of ``dtype``
    (both round f32 -> bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class TestKVPack:
    @given(data=st.data())
    @settings(max_examples=15, deadline=None)
    def test_roundtrip_matches_jax(self, data):
        n_pages = data.draw(st.integers(4, 32))
        n_sel = data.draw(st.integers(1, n_pages))
        table = data.draw(st.permutations(range(n_pages)))[:n_sel]
        x = np.random.default_rng(n_pages).standard_normal((n_pages, 16, 2, 64)).astype(np.float32)
        jpool, tpool = _pair(x, "float32")
        jt = jnp.asarray(table, jnp.int32)
        tt = torch.tensor(table, dtype=torch.int32)
        buf = ops.kv_pack(tpool, tt)
        np.testing.assert_array_equal(_np32(buf), _np32(jops.kv_pack(jpool, jt)))
        got = ops.kv_unpack(torch.zeros_like(tpool), buf, tt)
        want = jops.kv_unpack(jnp.zeros_like(jpool), jops.kv_pack(jpool, jt), jt)
        np.testing.assert_array_equal(_np32(got), _np32(want))

    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_dtypes_bit_exact(self, dtype):
        x = np.random.default_rng(0).standard_normal((8, 16, 4, 128)).astype(np.float32)
        jpool, tpool = _pair(x, dtype)
        table = [7, 0, 3]
        buf = ops.kv_pack(tpool, torch.tensor(table, dtype=torch.int32))
        assert buf.dtype == tpool.dtype
        np.testing.assert_array_equal(
            _np32(buf), _np32(jref.kv_pack_ref(jpool, jnp.asarray(table, jnp.int32))))
        np.testing.assert_array_equal(
            _np32(buf), _np32(jops.kv_pack(jpool, jnp.asarray(table, jnp.int32))))
        pool = torch.zeros_like(tpool)
        out = ops.kv_unpack(pool, buf, torch.tensor(table, dtype=torch.int32))
        assert out is pool  # in place, into the caller's pool
        want = jref.kv_unpack_ref(jnp.zeros_like(jpool), jnp.asarray(_np32(buf), jpool.dtype),
                                  jnp.asarray(table, jnp.int32))
        np.testing.assert_array_equal(_np32(pool), _np32(want))


class TestFlashDecode:
    @pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
    @pytest.mark.parametrize("b,h,kv,dh,s", [
        (1, 4, 4, 64, 512),     # MHA
        (2, 8, 2, 64, 1024),    # GQA 4:1
        (2, 16, 8, 128, 512),   # GQA 2:1, d_head 128
        (1, 8, 1, 128, 2048),   # MQA
        (2, 10, 2, 16, 96),     # GQA 5:1 (qwen3-14b's group), S off any block
    ])
    def test_matches_jax_ref(self, dtype, tol, b, h, kv, dh, s):
        rng = np.random.default_rng(b * 1000 + h * 10 + s)
        xs = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh))]
        (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in xs)
        pos = s - s // 3
        out = ops.flash_decode(tq, tk, tv, pos)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(_np32(out), _np32(jref.flash_decode_ref(jq, jk, jv, pos)),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("pos", [1, 128, 256, 512])
    def test_pos_boundaries_vs_pallas(self, pos):
        """pos on the Pallas kernel's block boundaries and pos = 1, against
        the interpret-mode kernel itself."""
        rng = np.random.default_rng(1)
        q = rng.standard_normal((1, 4, 64)).astype(np.float32)
        k = rng.standard_normal((1, 512, 2, 64)).astype(np.float32)
        v = rng.standard_normal((1, 512, 2, 64)).astype(np.float32)
        out = ops.flash_decode(*(torch.from_numpy(x) for x in (q, k, v)), pos)
        want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                                 block_s=128)
        np.testing.assert_allclose(_np32(out), _np32(want), atol=3e-5)

    def test_matches_jax_decode_attention(self):
        """The port's decode substitution: flash_decode == the JAX model's
        XLA decode path."""
        from repro.models.attention import decode_attention

        rng = np.random.default_rng(2)
        q = rng.standard_normal((2, 8, 64)).astype(np.float32)
        k = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
        v = rng.standard_normal((2, 256, 4, 64)).astype(np.float32)
        out = ops.flash_decode(*(torch.from_numpy(x) for x in (q, k, v)), 200)
        want = decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(200))[:, 0]
        np.testing.assert_allclose(_np32(out), _np32(want), atol=3e-5)


def _score_case(seed: int, r: int, d: int):
    rng = np.random.default_rng(seed)
    pool = dict(
        free_mem=rng.uniform(1e9, 4e11, d),
        queued=rng.integers(0, 20, d).astype(np.float32),
        batch=rng.integers(0, 64, d).astype(np.float32),
        hit_rows=rng.uniform(0, 9000, (r, d)),
        tier_rows=rng.integers(0, 4, (r, d)),
        healthy=(rng.random(d) > 0.15).astype(np.float32),
        iter_scale=rng.uniform(1, 2, d),
        tier_bw=[4.5e11, 1.25e10, 6.25e9, 3.125e9],
        tier_lat=[1e-6, 3e-6, 8e-6, 1.5e-5],
        congestion=rng.uniform(0, 0.8, 4),
        infl_rows=rng.integers(0, 8, (r, 4)).astype(np.float32),
    )
    kw = dict(s_r=rng.uniform(1e9, 4e9, r), input_len=rng.integers(1, 9000, r).astype(float),
              iter_a=0.0124, iter_b=1.6e-5, m_min=2e9, beta_max=64)
    return pool, kw


def _torch_args(pool, kw):
    args = {k: (torch.from_numpy(np.asarray(v)) if k not in ("tier_bw", "tier_lat", "congestion")
                else v) for k, v in pool.items()}
    tkw = dict(kw, s_r=torch.from_numpy(kw["s_r"]), input_len=torch.from_numpy(kw["input_len"]))
    return args, tkw


class TestNetKVScore:
    @given(seed=st.integers(0, 1000), r=st.integers(1, 6), d=st.integers(1, 300))
    @settings(max_examples=25, deadline=None)
    def test_bitwise_vs_numpy_twin(self, seed, r, d):
        pool, kw = _score_case(seed, r, d)
        c_np, b_np = _netkv_score_cohort_np(
            pool["free_mem"], pool["queued"], pool["batch"], pool["hit_rows"],
            pool["tier_rows"], pool["healthy"], pool["iter_scale"], pool["tier_bw"],
            pool["tier_lat"], pool["congestion"], pool["infl_rows"], **kw)
        args, tkw = _torch_args(pool, kw)
        c_t, res = ops.netkv_score_cohort(*args.values(), **tkw)
        assert c_t.dtype == torch.float32 and res.dtype == torch.int32
        np.testing.assert_array_equal(c_t.numpy().view(np.uint32), c_np.view(np.uint32))
        np.testing.assert_array_equal(res[:, 0].numpy(), b_np)

    @given(seed=st.integers(0, 1000), d=st.integers(1, 300))
    @settings(max_examples=15, deadline=None)
    def test_allclose_and_argmin_vs_pallas(self, seed, d):
        pool, kw = _score_case(seed, 1, d)
        kw = dict(kw, s_r=2.6e9, input_len=8192.0)
        c_k, b_k = jops.netkv_score(
            pool["free_mem"], pool["queued"], pool["batch"], pool["hit_rows"][0],
            pool["tier_rows"][0], pool["healthy"], pool["iter_scale"], pool["tier_bw"],
            pool["tier_lat"], pool["congestion"], pool["infl_rows"][0], **kw)
        args, _ = _torch_args(pool, {"s_r": np.array([2.6e9]), "input_len": np.array([8192.0])})
        tkw = dict(kw, s_r=torch.tensor([2.6e9]), input_len=torch.tensor([8192.0]))
        c_t, res = ops.netkv_score_cohort(*args.values(), **tkw)
        c_k = np.asarray(c_k)
        finite = c_k < 1e38
        if finite.any():
            np.testing.assert_allclose(c_t[0].numpy()[finite], c_k[finite], rtol=1e-5)
        assert int(res[0, 0]) == int(b_k)

    @pytest.mark.parametrize("r", [2, 5, 64])
    def test_cohort_row_equals_single_row_call(self, r):
        pool, kw = _score_case(r, r, 257)
        args, tkw = _torch_args(pool, kw)
        costs, res = ops.netkv_score_cohort(*args.values(), **tkw)
        for i in range(r):
            row = dict(args, hit_rows=args["hit_rows"][i:i + 1],
                       tier_rows=args["tier_rows"][i:i + 1],
                       infl_rows=args["infl_rows"][i:i + 1])
            c1, r1 = ops.netkv_score_cohort(
                *row.values(), **dict(tkw, s_r=tkw["s_r"][i:i + 1],
                                      input_len=tkw["input_len"][i:i + 1]))
            assert torch.equal(c1[0], costs[i]) and torch.equal(r1[0], res[i])

    @pytest.mark.parametrize("d", [1, 2, 33, 257])
    @pytest.mark.parametrize("kind", ["ties", "infeasible", "one_feasible"])
    def test_packed_result_vs_numpy_twin(self, kind, d):
        """best, best_cost, second and second_cost against the JAX package's
        f32 twin and the forensics runner-up as it was derived from the full
        cost row: the first argmin with best masked to +inf, kept only when
        its cost is below BIG / 2."""
        pool, kw = _score_case(d, 3, d)
        rng = np.random.default_rng(d)
        if kind == "ties":
            # Few distinct costs: equal columns, two hit levels, two tiers.
            pool.update(queued=np.full(d, 2.0), batch=np.full(d, 8.0),
                        iter_scale=np.ones(d), healthy=np.ones(d),
                        free_mem=np.full(d, 4e11),
                        hit_rows=rng.choice([0.0, 4096.0], (3, d)),
                        tier_rows=rng.choice([1, 2], (3, d)),
                        infl_rows=np.ones((3, 4)))
        else:
            healthy = np.zeros(d)
            if kind == "one_feasible":
                healthy[rng.integers(d)] = 1.0
            pool.update(healthy=healthy, free_mem=np.full(d, 4e11))
        c_np, b_np = _netkv_score_cohort_np(*pool.values(), **kw)
        args, tkw = _torch_args(pool, kw)
        c_t, res = ops.netkv_score_cohort(*args.values(), **tkw)
        np.testing.assert_array_equal(c_t.numpy().view(np.uint32), c_np.view(np.uint32))
        best, best_cost, second, second_cost = unpack_result(res.numpy())
        for i, c in enumerate(c_np):
            j = int(np.argmin(c))
            assert (int(best[i]), best_cost[i]) == (j, c[j]) and j == int(b_np[i])
            masked = c.copy()
            masked[j] = np.inf
            jj = int(np.argmin(masked))
            want = jj if d > 1 and float(masked[jj]) < BIG / 2 else -1
            assert int(second[i]) == want
            assert second_cost[i].view(np.uint32) == masked[jj].view(np.uint32)
        if kind == "infeasible":
            assert (best_cost == np.float32(BIG)).all() and (second == -1).all()
        if kind == "ties" and d > 2:
            assert (best_cost == second_cost).any()   # a tie decided by index

    def test_matches_core_cost_model(self):
        """One candidate against the port's scalar cost model (its copy of
        repro.core.cost)."""
        from repro_torch.core.cost import H100_TP4_ITER, post_prefill_latency

        c, _ = ops.netkv_score_cohort(
            torch.tensor([4e11]), torch.tensor([3.0]), torch.tensor([62.0]),
            torch.tensor([[4096.0]]), torch.tensor([[2]], dtype=torch.int32),
            torch.tensor([1.0]), torch.tensor([1.0]),
            [4.5e11, 1.25e10, 6.25e9, 3.125e9], [1e-6, 3e-6, 8e-6, 1.5e-5],
            [0, 0, 0.2, 0.3], torch.tensor([[0.0, 0.0, 1.0, 0.0]]),
            s_r=torch.tensor([3.2e9]), input_len=torch.tensor([8192.0]),
            iter_a=H100_TP4_ITER.a, iter_b=H100_TP4_ITER.b, m_min=1e9, beta_max=64)
        expect = post_prefill_latency(
            s_r=3.2e9, hit_tokens=4096, input_len=8192, tier_bw=6.25e9,
            congestion=0.2, n_inflight=1, tier_latency=8e-6, q_d=3, beta_d=62,
            beta_max=64, iter_model=H100_TP4_ITER)
        assert abs(float(c[0, 0]) - expect) / expect < 1e-5


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        pool = torch.arange(4 * 16 * 2 * 8, dtype=torch.float32).reshape(4, 16, 2, 8)
        out = ops.kv_pack(pool, torch.tensor([2, 0], dtype=torch.int32))
        assert torch.equal(out, pool[[2, 0]])

    def test_other_devices_have_no_route(self):
        pool = torch.empty((4, 16, 2, 8), device="meta")
        with pytest.raises(ValueError, match="no kernel route"):
            ops.kv_pack(pool, torch.tensor([0], dtype=torch.int32))

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        from repro_torch.kernels.flash_decode import flash_decode
        from repro_torch.kernels.kv_pack import kv_pack

        with pytest.raises(ValueError, match="CUDA"):
            kv_pack(torch.zeros(4, 16, 2, 8), torch.tensor([0], dtype=torch.int32))
        with pytest.raises(ValueError, match="CUDA"):
            flash_decode(torch.zeros(1, 4, 64), torch.zeros(1, 8, 2, 64),
                         torch.zeros(1, 8, 2, 64), 1)
