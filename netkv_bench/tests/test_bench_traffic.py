"""The generator: a mix fixes its sequence, the run's seed its tokens, and
a mix holds nothing the generator does not read."""

import numpy as np
import pytest

import _paths  # noqa: F401
from nkb import spec, traffic

MIXES = ["chat-batch", "smoke-open", "smoke-closed"]


def _rate(mix):
    return 0.5 if mix["loop"] == "open" else None


@pytest.mark.parametrize("name", MIXES)
def test_sequence_is_fixed_by_the_mix(name):
    mix = spec.traffic(name)
    a, b = traffic.sequence(mix, _rate(mix)), traffic.sequence(mix, _rate(mix))
    assert [(r.prompt_len, r.max_new, r.gap_s) for r in a] == \
        [(r.prompt_len, r.max_new, r.gap_s) for r in b]
    assert len(a) == mix["schedule_length"]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = spec.traffic(name)
    reqs = traffic.sequence(mix, _rate(mix))
    for key, attr in (("prompt_tokens", "prompt_len"), ("output_tokens", "max_new")):
        s = mix[key]
        x = np.array([getattr(r, attr) for r in reqs])
        assert x.min() >= s["min"] and x.max() <= s["max"]
        if s["dist"] == "lognormal":
            assert abs(np.median(x) / s["median"] - 1) < 0.1, (key, np.median(x))


def test_chat_batch_is_the_papers_chatbot_profile():
    """The mix's lengths are the chatbot profile's (the port's copy of the
    paper's Sec. VI-A generator), clipped where the cache forces it."""
    from repro_torch.traces import mooncake

    mix = spec.traffic("chat-batch")
    prof = mooncake.PROFILES["chatbot"]
    rng = np.random.default_rng(3)
    src_in = np.minimum(mooncake._sample_input_lengths(rng, 40_000, prof),
                        mix["prompt_tokens"]["max"])
    src_out = np.clip(rng.lognormal(prof.out_mu, prof.out_sigma, 40_000), 1,
                      mix["output_tokens"]["max"])
    mine = np.random.default_rng(4)
    my_in = traffic.draw_lengths(mix["prompt_tokens"], mine, 40_000)
    my_out = traffic.draw_lengths(mix["output_tokens"], mine, 40_000)
    assert mix["prompt_tokens"]["min"] == prof.min_input
    assert mix["output_tokens"]["median"] == pytest.approx(np.exp(prof.out_mu))
    assert mix["output_tokens"]["sigma"] == prof.out_sigma
    for a, b in ((src_in, my_in), (src_out, my_out)):
        qa, qb = np.percentile(a, [10, 25, 50, 75, 90]), np.percentile(b, [10, 25, 50, 75, 90])
        assert np.all(np.abs(qb / qa - 1) < 0.04), (qa, qb)


@pytest.mark.parametrize("key,value", [("arrivals", "bursty"), ("shared_prefix", 0.75),
                                       ("think_s", 1.0), ("greedy", False)])
def test_a_key_the_generator_does_not_read_is_refused(key, value):
    mix = dict(spec.traffic("chat-batch"), **{key: value})
    with pytest.raises(ValueError, match=key):
        traffic.sequence(mix)


def test_a_length_key_the_generator_does_not_read_is_refused():
    mix = spec.traffic("smoke-closed")
    bad = dict(mix, prompt_tokens=dict(mix["prompt_tokens"], zipf=1.1))
    with pytest.raises(ValueError, match="zipf"):
        traffic.sequence(bad)
    bad = dict(mix, prompt_tokens=dict(mix["prompt_tokens"], dist="pareto"))
    with pytest.raises(ValueError, match="pareto"):
        traffic.sequence(bad)


def test_mixture_weights():
    spec_ = {"dist": "lognormal_mixture", "parts": [[0.75, 100, 0.01], [0.25, 10_000, 0.01]],
             "min": 1, "max": 100_000}
    x = traffic.draw_lengths(spec_, np.random.default_rng(0), 20_000)
    assert abs((x > 1000).mean() - 0.25) < 0.01
    with pytest.raises(ValueError):
        traffic.draw_lengths(dict(spec_, parts=[[0.5, 100, 0.1]]), np.random.default_rng(0), 3)


def test_open_loop_rate():
    mix = dict(spec.traffic("smoke-open"), schedule_length=512)
    for rate in (0.3, 0.6):
        reqs = traffic.sequence(mix, rate)
        due = traffic.open_due_times(reqs)
        assert due[0] == 0.0 and np.all(np.diff(due) >= 0)
        assert abs(len(reqs) / due[-1] / rate - 1) < 0.15
    with pytest.raises(ValueError):
        traffic.sequence(mix, None)


def test_closed_loop_has_no_gaps():
    reqs = traffic.sequence(spec.traffic("chat-batch"))
    assert all(r.gap_s == 0.0 for r in reqs)


def test_a_workload_file_holds_its_keys_only(tmp_path, monkeypatch):
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "x.json").write_text(
        '{"config": "moe-smoke", "traffic": "smoke-closed", "rate_rps": null, "clients": 4,'
        ' "think_s": 1.0}')
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    with pytest.raises(ValueError, match="think_s"):
        spec.workload("x")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 33 + 5])
def test_tokens_follow_the_seed(seed):
    lens = [5, 17, 3]
    a = traffic.prompt_tokens(seed, lens, 1000)
    b = traffic.prompt_tokens(seed, lens, 1000)
    c = traffic.prompt_tokens(seed + 1, lens, 1000)
    assert [len(x) for x in a] == lens
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.min() >= 0 and x.max() < 1000 for x in a)
