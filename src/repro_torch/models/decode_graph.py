"""CUDA graphs of the writing decode step: one a (decode engine, K4 plan
bucket).

An eager decode step of an attention decoder (or of the Mamba hybrid)
launches ~60-100 kernels a layer, each a few microseconds of device time
behind ~20 us of host time, so the host paces it.  :class:`DecodeGraphs` captures the step's whole
chain of kernels, :func:`models.model.decode_body` (the same kernels in the
same order, with the same weights, caches and dtypes, K4 included), and
replays one graph a step.

Semantics.  The engine decodes every lane at the furthest active slot's
scalar ``pos``; the graph feeds that ``p`` to all B lanes as a position
vector, so each lane's K/V lands at ``p`` and K4 reads ``p + 1`` rows of
each through its per-row lengths.  K4's split is planned at the top of
``p + 1``'s bucket (:func:`bucket_top`), which only adds ranges past every
row's length: they write empty partials, which the combine weighs 0.

Inputs.  A pinned (2, B) int64 host buffer (tokens, positions) and one
non-blocking copy into the runner's static device buffer, which every
graph of the runner reads.  The logits go to the runner's static buffer
(B, 1, V), rewritten by its next step.

Memory.  Every graph of the process takes its intermediates from one pool,
captured on one side stream; graphs replay one at a time on the current
stream, so they can share it.  The device's and the host's caching
allocators each count the graphs that use a pool and take it back when none
is left, after which a capture into it fails; so a graph of one kernel,
captured into the pool first and held for the process, keeps it open for
the engines that come after a dropped one.  The static inputs and logits
are allocated outside that pool, so no other graph's replay writes over
them.

When it engages (:func:`eager_reason`): the inputs alone decide, with no
flag.  The first step of the process that a graph would take runs eagerly
(``decode_step``'s own path), so that cuBLAS, K4's library and the
allocator are warm before any capture; a graph is captured the first time
its bucket is used on its engine, then replayed.

Tracing (``hosttrace``).  A capture runs with the recorder off: its
kernels do not run, so no ``layer.*`` span or ``k4.launch`` stamp is
recorded for them.  A replayed step records ``decode.graph`` (a = the
bucket's top, b = 1 where the step captured the graph) round the staging
copy and the replay, and a ``k4.launch`` stamp for each K4 call of the
graph just before the replay call that launches them.
``build.LAUNCHES["flash_decode"]``, ``["moe_decode"]`` (K8) and
``["moe_route"]`` (K9) grow by the graph's calls at each replay, as they grow
by an eager step's.
"""

from __future__ import annotations

import time

import torch

from .. import hosttrace
from ..kernels import build
from .model import Model, _positions, decode_body
from .sharding import current_mesh, current_rules

BUCKET_FLOOR = 256                        # the smallest bucket's top
GRAPHED_BLOCKS = ("attn", "mamba")
GRAPHED_FFNS = ("dense", "moe", "moe_res")
COUNTED = ("flash_decode", "moe_decode", "moe_route")  # kernels a replay counts

_POOL = None     # the memory pool every graph of the process takes its intermediates from
_STREAM = None   # the side stream every capture runs on
_ANCHOR = None   # a graph of one kernel in that pool, held so that the pool stays open
_WARM = False    # a step that a graph would take has run eagerly in this process


def bucket_top(n: int, cache_len: int) -> int:
    """The top of the bucket of length ``n`` (1 <= n <= cache_len): the
    smallest power of two at least ``max(n, BUCKET_FLOOR)``, at most
    ``cache_len``.  A cache of 4096 has the tops 256, 512, 1024, 2048 and
    4096."""
    if not 1 <= n <= cache_len:
        raise ValueError(f"length {n} outside [1, {cache_len}]")
    return min(cache_len, 1 << (max(n, BUCKET_FLOOR) - 1).bit_length())


def eager_reason(model: Model, cache: dict, update_cache: bool) -> str | None:
    """Why a decode step of ``model`` over ``cache`` runs eagerly, or None
    where its graph engages: the writing decode of a decoder whose blocks
    are attention, or attention and Mamba (the hybrid's mixers write their
    states in place), with dense or MoE FFNs, at a scalar position, its
    weights and cache on a CUDA device, outside mesh rules."""
    cfg = model.cfg
    if not update_cache:
        return "read-only decode"
    if current_mesh() is not None or current_rules():
        return "mesh rules"
    if cfg.is_enc_dec:
        return "encoder-decoder"
    blocks = sorted(set(cfg.block_pattern) - set(GRAPHED_BLOCKS))
    if blocks:
        return f"{'/'.join(blocks)} blocks"
    if cfg.is_attention_free:
        return "no attention block"
    ffns = sorted(set(cfg.ffn_pattern) - set(GRAPHED_FFNS))
    if ffns:
        return f"{'/'.join(ffns)} FFN"
    if getattr(cache["pos"], "ndim", 0):
        return "per-slot positions"
    leaves = [v for k, v in cache.items() if k != "pos"]
    if model.device.type != "cuda" or any(not t.is_cuda for t in leaves):
        return "not on a CUDA device"
    return None


def _open_pool(dev: torch.device) -> None:
    """The process's pool, side stream and anchor graph, made at the first
    capture."""
    global _POOL, _STREAM, _ANCHOR
    if _POOL is not None:
        return
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
    anchor = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        anchor.capture_begin(pool=pool)
        try:
            torch.zeros(1, device=dev)
        finally:
            anchor.capture_end()
    _POOL, _STREAM, _ANCHOR = pool, stream, anchor


class DecodeGraphs:
    """The graphs of one decode engine, over its ``cache`` of ``batch``
    lanes (a graph holds the cache's addresses), by bucket top; and how
    often they engaged: :meth:`stats`."""

    def __init__(self, model: Model, cache: dict, batch: int):
        self.model, self.cache, self.batch = model, cache, batch
        attn = [i for i, blk, _, _ in _positions(model.cfg) if blk == "attn"]
        self.cache_len = cache[f"k{attn[0]}"].shape[2] if attn else 0
        # top -> (graph, its calls of each COUNTED kernel)
        self._graphs: dict[int, tuple[torch.cuda.CUDAGraph, dict[str, int]]] = {}
        self._host = self._static = self._logits = self._copied = None
        self.replays = self.captures = self.eager = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    def stats(self) -> dict:
        """Replayed, captured and eager steps; graphs held, seconds spent
        capturing and bytes the captures added to the device's reserve."""
        return {"replays": self.replays, "captures": self.captures, "eager": self.eager,
                "graphs": len(self._graphs), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}

    def run(self, token: torch.Tensor, cache: dict, update_cache: bool):
        """The step's logits (B, 1, V) where the graph takes the step; None,
        counted eager, where the caller runs it eagerly: where the rule
        declines it, and the first step of the process that it takes.
        ``token`` (B, 1) on the host or the device; ``cache["pos"]`` is left
        for the caller to advance."""
        global _WARM
        engages = (cache is self.cache and tuple(token.shape) == (self.batch, 1)
                   and eager_reason(self.model, cache, update_cache) is None)
        if not (engages and _WARM):
            _WARM = _WARM or engages      # the first step a graph would take warms up
            self.eager += 1
            return None
        if self._static is None:
            self._allocate()
        pos = int(cache["pos"])
        top = bucket_top(pos + 1, self.cache_len)
        held = self._graphs.get(top)
        tr = hosttrace.RECORDER
        if tr is not None:
            i_graph = tr.begin(hosttrace.GRAPH, top, int(held is None))
        self._stage(token, pos)
        if held is None:
            held = self._graphs[top] = self._capture(top)
        graph, calls = held
        if tr is not None:
            for _ in range(calls["flash_decode"]):
                tr.stamp(hosttrace.K4_LAUNCH)
        graph.replay()
        for name, n in calls.items():
            build.LAUNCHES[name] += n
        self.replays += 1
        if tr is not None:
            tr.end(i_graph)
        return self._logits

    def _allocate(self) -> None:
        dev, cfg = self.model.device, self.model.cfg
        self._host = torch.zeros((2, self.batch), dtype=torch.int64, pin_memory=True)
        self._static = torch.zeros((2, self.batch), dtype=torch.int64, device=dev)
        self._logits = torch.empty((self.batch, 1, cfg.vocab_size), dtype=cfg.compute_dtype,
                                   device=dev)
        self._copied = torch.cuda.Event()

    def _stage(self, token: torch.Tensor, pos: int) -> None:
        """Tokens and positions into the static buffer: into the pinned
        buffer on the host, then one non-blocking copy."""
        self._copied.synchronize()          # the last copy out of the pinned buffer is done
        self._host[0].copy_(token.reshape(-1))
        self._host[1].fill_(pos)
        self._static.copy_(self._host, non_blocking=True)
        self._copied.record()

    def _capture(self, top: int) -> tuple[torch.cuda.CUDAGraph, dict[str, int]]:
        """Capture :func:`decode_body` at ``top`` on the side stream, into
        the shared pool, with the recorder off; returns the graph and its
        calls of each COUNTED kernel (taken back out of ``build.LAUNCHES``:
        captured kernels do not run)."""
        dev = self.model.device
        _open_pool(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        recorder, hosttrace.RECORDER = hosttrace.RECORDER, None
        launched = {name: build.LAUNCHES[name] for name in COUNTED}
        _STREAM.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(_STREAM):
                graph.capture_begin(pool=_POOL)
                try:
                    self._logits.copy_(decode_body(self.model, self._static[0][:, None],
                                                   self._static[1], self.cache, top))
                finally:
                    graph.capture_end()
        finally:
            hosttrace.RECORDER = recorder
            calls = {name: build.LAUNCHES[name] - n for name, n in launched.items()}
            build.LAUNCHES.update(launched)
        torch.cuda.current_stream(dev).wait_stream(_STREAM)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        return graph, calls
