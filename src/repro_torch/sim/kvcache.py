# The port's own copy of repro/sim/kvcache.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""RadixPlane: array-backed multi-instance prefix KV cache (§III-B).

Block size B_tok = 16 tokens.  A request's content is a sequence of block
hashes; the cache hit length lambda_r(d) is B_tok times the longest common
*block-aligned prefix* between the request and instance d's cache contents —
a hit requires every earlier block to also be present (LCP semantics, not
set membership).

The retired per-instance ``BlockCache`` (an ``OrderedDict`` LRU, kept
verbatim in ``sim/reference.py`` and re-exported here) answered
``hit_tokens`` with one Python dict walk *per candidate per scheduling
decision* — the O(|D| * blocks) loop the scheduler hot path at 1000-GPU
scale is made of.  ``RadixPlane`` keeps every decode instance's cache in one
shared columnar structure:

* **Interned block ids** — each distinct block hash is interned once into a
  dense id; presence is a packed uint64 bitmask row per block over instance
  slots (``present[block_id, word]``), so membership of one request's m
  blocks against all D instances is a single fancy-index + shift broadcast.
* **Broadcast LCP** — ``hit_row`` computes lambda_r(d) for *all* instances
  at once: chunked leading-ones count over the (m, D) membership matrix,
  with instances eliminated from later chunks the moment they miss (the
  vector analogue of the per-instance early-exit walk).
* **Array LRU clocks** — each instance's recency order is an append-only
  int64 log of block ids with lazy invalidation: insert/touch append (and
  invalidate the block's previous log entry), eviction pops from the head
  skipping invalidated entries.  This reproduces the ``OrderedDict``
  ``move_to_end`` / ``popitem(last=False)`` order exactly
  (``tests/test_radixplane.py`` proves it on random hash streams).

All counters (hits/misses/evictions) and byte accounting match the retired
``BlockCache`` bit-for-bit; ``reset_instance`` mirrors the reference's
cache replacement on instance failure (counters reset too).
"""

from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np

from ..core.cost import B_TOK, n_blocks
from .reference import BlockCache  # retired single-instance LRU (parity oracle)

__all__ = ["B_TOK", "BlockCache", "RadixPlane", "n_blocks"]

_ONE = np.uint64(1)


class RadixPlane:
    """Columnar LRU prefix cache over every decode instance's HBM budget."""

    def __init__(self, bytes_per_block: float, *, block_capacity: int = 1024,
                 instance_capacity: int = 16):
        self.bytes_per_block = float(bytes_per_block)
        self.n = 0                                  # registered instances
        self._intern: dict[Hashable, int] = {}      # block hash -> dense id
        self._hash_of: list[Hashable] = []          # dense id -> block hash
        self._free_bids: list[int] = []             # recycled dense ids
        self._bcap = max(int(block_capacity), 64)
        self._icap = max(int(instance_capacity), 1)
        self._W = (self._icap + 63) // 64
        self.present = np.zeros((self._bcap, self._W), np.uint64)
        # Per-slot word/bit coordinates for the broadcast membership gather.
        self._word = np.arange(self._icap, dtype=np.intp) // 64
        self._bit = (np.arange(self._icap, dtype=np.uint64) % np.uint64(64))
        # How many instances currently hold each block: when it drops to
        # zero the dense id (and its presence row) is recycled, so memory
        # tracks *resident* distinct blocks, not blocks ever seen — the
        # same boundedness the per-instance BlockCache had.
        self._refcnt = np.zeros(self._bcap, np.int64)
        # Per-instance scalar columns.
        self.budget = np.zeros(self._icap, np.float64)
        self.count = np.zeros(self._icap, np.int64)     # resident blocks
        self.hits = np.zeros(self._icap, np.int64)
        self.misses = np.zeros(self._icap, np.int64)
        self.evictions = np.zeros(self._icap, np.int64)
        # Per-instance LRU clock: append-only log of block ids (-1 = stale
        # entry, lazily skipped), head cursor, block id -> log index.  The
        # log is a plain int list: appends/invalidations are O(1) C-level
        # ops on the per-admit path, compacted when stale entries dominate.
        self._log: list[list[int]] = []
        self._head: list[int] = []
        self._pos: list[dict[int, int]] = []

    # ------------------------------------------------------------ membership
    def add_instance(self, budget_bytes: float) -> int:
        """Register one decode instance; returns its (stable) slot."""
        if self.n == self._icap:
            self._grow_instances()
        s = self.n
        self.n += 1
        self.budget[s] = float(budget_bytes)
        self._log.append([])
        self._head.append(0)
        self._pos.append({})
        return s

    def _grow_instances(self) -> None:
        icap = self._icap * 2
        for name in ("budget", "count", "hits", "misses", "evictions"):
            old = getattr(self, name)
            new = np.zeros(icap, old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)
        W = (icap + 63) // 64
        if W > self._W:
            present = np.zeros((self._bcap, W), np.uint64)
            present[:, : self._W] = self.present
            self.present = present
            self._W = W
        self._icap = icap
        self._word = np.arange(icap, dtype=np.intp) // 64
        self._bit = (np.arange(icap, dtype=np.uint64) % np.uint64(64))

    def _grow_blocks(self) -> None:
        bcap = self._bcap * 2
        present = np.zeros((bcap, self._W), np.uint64)
        present[: self._bcap] = self.present
        self.present = present
        refcnt = np.zeros(bcap, np.int64)
        refcnt[: self._bcap] = self._refcnt
        self._refcnt = refcnt
        self._bcap = bcap

    def _block_id(self, h: Hashable) -> int:
        bid = self._intern.get(h)
        if bid is None:
            if self._free_bids:
                bid = self._free_bids.pop()
                self._hash_of[bid] = h
            else:
                bid = len(self._hash_of)
                if bid == self._bcap:
                    self._grow_blocks()
                self._hash_of.append(h)
            self._intern[h] = bid
        return bid

    def _release_bid(self, bid: int) -> None:
        """Last holder evicted the block: recycle its dense id."""
        del self._intern[self._hash_of[bid]]
        self._hash_of[bid] = None
        self._free_bids.append(bid)

    # --------------------------------------------------------------- LRU log
    def _maybe_compact(self, s: int) -> None:
        """Rewrite the log when stale (invalidated) entries dominate."""
        log = self._log[s]
        if len(log) > 64 and len(log) > 4 * len(self._pos[s]):
            live = [b for b in log[self._head[s]:] if b >= 0]
            self._log[s] = live
            self._head[s] = 0
            pos = self._pos[s]
            for j, b in enumerate(live):
                pos[b] = j

    def _evict_one(self, s: int) -> None:
        log, head = self._log[s], self._head[s]
        while log[head] < 0:
            head += 1
        bid = log[head]
        log[head] = -1
        self._head[s] = head + 1
        del self._pos[s][bid]
        self.present[bid, s >> 6] &= ~(_ONE << self._bit[s])
        self._refcnt[bid] -= 1
        if self._refcnt[bid] == 0:
            self._release_bid(bid)
        self.count[s] -= 1
        self.evictions[s] += 1

    def _evict_to_limit(self, s: int, limit: float) -> None:
        # Same float comparison sequence as the reference's
        # ``while bytes_used > limit`` loop.
        bpb = self.bytes_per_block
        n = int(self.count[s])
        while n > 0 and n * bpb > limit:
            self._evict_one(s)
            n -= 1

    # ------------------------------------------------------------------- API
    def bytes_used(self, s: int) -> float:
        return float(self.count[s]) * self.bytes_per_block

    def contains(self, s: int, h: Hashable) -> bool:
        bid = self._intern.get(h)
        return bid is not None and bid in self._pos[s]

    def lcp_blocks(self, s: int, hashes: Sequence[Hashable]) -> int:
        """|LCP_block(h_r, K_s)| for a single instance (scalar walk)."""
        pos = self._pos[s]
        intern = self._intern
        n = 0
        for h in hashes:
            bid = intern.get(h)
            if bid is None or bid not in pos:
                break
            n += 1
        return n

    def hit_tokens(self, s: int, hashes: Sequence[Hashable], input_len: int) -> int:
        """lambda_r(s) = B_tok * LCP, clamped to the true input length."""
        return min(self.lcp_blocks(s, hashes) * B_TOK, input_len)

    def hit_row(self, hashes: Sequence[Hashable], input_len: int,
                out: np.ndarray | None = None) -> np.ndarray:
        """lambda_r(d) for one request against ALL instances — one broadcast.

        Chunked leading-ones count over the packed presence bitmask:
        instances drop out of later chunks as soon as they miss, so total
        work tracks the reference's early-exit walks, vectorised over D.
        """
        n = self.n
        res = out if out is not None else np.zeros(n, np.float64)
        # A hash never inserted anywhere is absent from every cache, so the
        # LCP of every instance is capped at the first unknown block.
        ids: list[int] = []
        intern = self._intern
        for h in hashes:
            bid = intern.get(h)
            if bid is None:
                break
            ids.append(bid)
        if not ids or n == 0:
            res[:n] = 0.0
            return res
        lcp = self._lcp_row(np.asarray(ids, np.intp))
        np.minimum(lcp * B_TOK, float(input_len), out=res[:n])
        return res

    def _lcp_row(self, idv: np.ndarray) -> np.ndarray:
        """(n,) leading-ones LCP block count for one interned-id prefix."""
        n = self.n
        lcp = np.zeros(n, np.int64)
        alive = np.arange(n, dtype=np.intp)
        word, bit = self._word, self._bit
        for c in range(0, len(idv), 64):
            sub = self.present[idv[c:c + 64]]                  # (ch, W)
            m = (sub[:, word[alive]] >> bit[alive]) & _ONE     # (ch, |alive|)
            bad = m == 0
            anybad = bad.any(axis=0)
            lcp[alive] += np.where(anybad, bad.argmax(axis=0), sub.shape[0])
            alive = alive[~anybad]
            if alive.size == 0:
                break
        return lcp

    def hit_rows(self, reqs: Sequence) -> np.ndarray:
        """Stacked ``hit_row`` for a dispatch cohort: the (R, n) lambda matrix.

        Shared prefixes are the common case inside a same-timestamp cohort
        (agentic trees, RAG fan-out), so identical interned-id prefixes reuse
        one broadcast LCP through a tuple-keyed memo.  Row k is bit-identical
        to ``hit_row(reqs[k].block_hashes, reqs[k].input_len)`` against the
        cache state at call time.
        """
        n = self.n
        H = np.zeros((len(reqs), n), np.float64)
        intern = self._intern
        memo: dict[tuple, np.ndarray] = {}
        for k, req in enumerate(reqs):
            ids: list[int] = []
            for h in req.block_hashes:
                bid = intern.get(h)
                if bid is None:
                    break
                ids.append(bid)
            if not ids or n == 0:
                continue
            key = tuple(ids)
            lcp = memo.get(key)
            if lcp is None:
                memo[key] = lcp = self._lcp_row(np.asarray(ids, np.intp))
            np.minimum(lcp * B_TOK, float(req.input_len), out=H[k])
        return H

    def touch(self, s: int, hashes: Sequence[Hashable]) -> None:
        """Mark blocks as recently used (move to MRU end of the clock log)."""
        pos = self._pos[s]
        log = self._log[s]
        intern = self._intern
        hit = miss = 0
        for h in hashes:
            bid = intern.get(h)
            j = pos.get(bid) if bid is not None else None
            if j is not None:
                log[j] = -1
                pos[bid] = len(log)
                log.append(bid)
                hit += 1
            else:
                miss += 1
        self.hits[s] += hit
        self.misses[s] += miss
        self._maybe_compact(s)

    def insert(self, s: int, hashes: Sequence[Hashable],
               protected: float = 0.0) -> None:
        """Insert blocks at MRU, evicting LRU entries beyond budget.

        ``protected`` bytes are pinned elsewhere (active batches) and shrink
        the evictable budget.
        """
        pos = self._pos[s]
        log = self._log[s]
        block_id = self._block_id
        fresh: list[int] = []
        for h in hashes:
            bid = block_id(h)
            j = pos.get(bid)
            if j is not None:
                log[j] = -1
            else:
                fresh.append(bid)
            pos[bid] = len(log)
            log.append(bid)
        if fresh:
            # One fancy-indexed OR for every newly-present block.
            idx = np.asarray(fresh, np.intp)
            self.present[idx, s >> 6] |= _ONE << self._bit[s]
            self._refcnt[idx] += 1
            self.count[s] += len(fresh)
        self._maybe_compact(s)
        self._evict_to_limit(s, max(float(self.budget[s]) - protected, 0.0))

    def evict_to(self, s: int, protected: float) -> None:
        self._evict_to_limit(s, max(float(self.budget[s]) - protected, 0.0))

    def evict_cohort(self, slots: np.ndarray, protected: np.ndarray) -> None:
        """``evict_to`` across a cohort: one vector over-budget test, the
        per-block eviction loop only runs where growth overran the budget."""
        limits = np.maximum(self.budget[slots] - protected, 0.0)
        over = (self.count[slots] * self.bytes_per_block > limits).nonzero()[0]
        for j in over:
            self._evict_to_limit(int(slots[j]), float(limits[j]))

    def reset_instance(self, s: int) -> None:
        """Instance failure: drop contents AND counters (the reference swaps
        in a brand-new BlockCache, so hits/misses/evictions restart at 0)."""
        pos = self._pos[s]
        if pos:
            idx = np.fromiter(pos, np.intp, len(pos))
            self.present[idx, s >> 6] &= ~(_ONE << self._bit[s])
            self._refcnt[idx] -= 1
            for bid in idx[self._refcnt[idx] == 0].tolist():
                self._release_bid(bid)
        self._pos[s] = {}
        self._log[s] = []
        self._head[s] = 0
        self.count[s] = 0
        self.hits[s] = 0
        self.misses[s] = 0
        self.evictions[s] = 0
