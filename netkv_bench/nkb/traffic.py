"""The one traffic generator: a mix file's lengths and loop, the request
contents from ``--seed``.

A mix fixes its request sequence (prompt lengths, output lengths and, for
an open loop, unit exponential gaps) from its own ``schedule_seed``, so
that every run serves the same work in the same order; the run's seed
draws the token ids of every prompt (and, elsewhere, the weights).  A
permutation by the run's seed changed the 90th percentile of TTFT by 30-80%
between seeds at 0.8 of the knee with ~35 requests in a window (a queue
simulation with the service times of an open-loop cell), far more than two
runs of one seed differ.

A mix file holds only the keys below, and a length only the keys of its
distribution: any other key is refused, so that a mix cannot ask for
traffic (bursts, shared prefixes, think time) that this generator does not
make and silently get plain traffic instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIX_KEYS = {"loop", "prompt_tokens", "output_tokens", "schedule_seed", "schedule_length",
            "source", "cuts", "why"}
LENGTH_KEYS = {"lognormal": {"dist", "median", "sigma", "min", "max"},
               "lognormal_mixture": {"dist", "parts", "min", "max"}}


@dataclasses.dataclass
class Request:
    index: int          # position in the mix's sequence; the request id
    prompt_len: int
    max_new: int        # output tokens, the prefill's first one included
    gap_s: float        # open loop: unit gap / rate before the next one; else 0


def draw_lengths(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths, rounded and clipped to [min, max], of a log-normal
    ``{"dist": "lognormal", median, sigma, min, max}`` or of a mixture
    ``{"dist": "lognormal_mixture", "parts": [[weight, median, sigma], ...],
    min, max}`` (a part picked by weight, then its log-normal drawn)."""
    dist = spec.get("dist")
    if dist not in LENGTH_KEYS:
        raise ValueError(f"unknown length distribution {dist!r}")
    if set(spec) != LENGTH_KEYS[dist]:
        raise ValueError(f"a {dist} length takes exactly {sorted(LENGTH_KEYS[dist])}; "
                         f"got {sorted(spec)}")
    if dist == "lognormal":
        parts = np.array([[1.0, spec["median"], spec["sigma"]]], dtype=np.float64)
    else:
        parts = np.array(spec["parts"], dtype=np.float64)
        if parts.ndim != 2 or parts.shape[1] != 3 or abs(parts[:, 0].sum() - 1.0) > 1e-9:
            raise ValueError("parts are [weight, median, sigma] rows whose weights sum to 1")
    pick = np.searchsorted(np.cumsum(parts[:, 0])[:-1], rng.random(n), side="right")
    x = parts[pick, 1] * np.exp(parts[pick, 2] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def sequence(mix: dict, rate_rps: float | None = None) -> list[Request]:
    """The mix's fixed request sequence; an open loop's gaps at
    ``rate_rps``.  Drawn in one order (prompts, outputs, gaps) from
    ``schedule_seed``, so a mix file alone fixes it."""
    extra = set(mix) - MIX_KEYS
    if extra:
        raise ValueError(f"the generator does not read {sorted(extra)}")
    n = int(mix["schedule_length"])
    rng = np.random.default_rng(int(mix["schedule_seed"]))
    prompts = draw_lengths(mix["prompt_tokens"], rng, n)
    outputs = draw_lengths(mix["output_tokens"], rng, n)
    units = rng.standard_exponential(n)
    if mix["loop"] == "open":
        if not rate_rps or rate_rps <= 0:
            raise ValueError("an open loop needs a positive rate_rps in its workload file")
        gaps = units / float(rate_rps)
    elif mix["loop"] == "closed":
        gaps = np.zeros(n)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return [Request(i, int(p), int(o), float(g))
            for i, (p, o, g) in enumerate(zip(prompts, outputs, gaps))]


def open_due_times(reqs: list[Request]) -> np.ndarray:
    """Seconds from the window's start at which each request is due: the
    first at 0, each later one a gap after the one before."""
    gaps = np.array([r.gap_s for r in reqs])
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def prompt_tokens(seed: int, lengths, vocab: int) -> list[np.ndarray]:
    """Token ids of every prompt, uniform over the vocabulary, from the run's
    seed (any non-negative integer): one draw for the whole sequence."""
    lengths = np.asarray(lengths, dtype=np.int64)
    rng = np.random.default_rng(int(seed))
    flat = rng.integers(0, vocab, size=int(lengths.sum()), dtype=np.int64)
    return np.split(flat, np.cumsum(lengths)[:-1])
