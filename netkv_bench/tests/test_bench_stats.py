"""Rates over the whole window."""

import pytest

import _paths  # noqa: F401
from nkb import readers, stats
from nkb.spans import Req


def _req(rid, due, times, counts=None, prompt=10, max_new=4):
    r = Req(rid, prompt, max_new, due)
    r.token_times = list(times)
    r.token_counts = counts or ([2] + [1] * (len(times) - 1) if times else [])
    r.tokens = [0] * sum(r.token_counts)
    return r


def test_tokens_and_rate_over_the_window():
    reqs = [_req(0, 0.0, [1.0, 2.0, 3.0]), _req(1, 1.0, [9.0, 11.0])]
    assert stats.tokens_in_window(reqs, 10.0) == 4 + 2

    class Run:
        requests = reqs
        window_s = 10.0
    assert readers.out_tok_s(Run) == pytest.approx(0.6)
