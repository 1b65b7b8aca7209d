"""Serving engines of the port: prefill + slot-based continuous-batching
decode, on real weights (``repro/serving/engine.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import hosttrace
from ..models.decode_graph import DecodeGraphs
from ..models.model import Model, decode_step, make_decode_cache, prefill


@dataclasses.dataclass
class PrefillResult:
    request_id: int
    cache: dict                  # per-request decode cache (B=1)
    last_logits: torch.Tensor
    first_token: int
    kv_bytes: int


class PrefillEngine:
    def __init__(self, instance_id: int, model: Model, cache_len: int):
        self.instance_id = instance_id
        self.model = model
        self.cache_len = cache_len

    def run(self, request_id: int, tokens: np.ndarray) -> PrefillResult:
        tr = hosttrace.for_step()
        if tr is not None:
            i_run = tr.begin(hosttrace.PREFILL, len(tokens))
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.model.device)[None, :]
        logits, cache = prefill(self.model, toks, cache_len=self.cache_len)
        nxt = int(torch.argmax(logits[0, -1]))
        if tr is not None:
            tr.end(i_run)
        kv_bytes = sum(v.numel() * v.element_size()
                       for k, v in cache.items() if k != "pos")
        return PrefillResult(request_id, cache, logits, nxt, kv_bytes)


@dataclasses.dataclass
class Slot:
    request_id: int = -1
    tokens_out: list = dataclasses.field(default_factory=list)
    max_new: int = 0
    active: bool = False


class DecodeEngine:
    """Fixed-slot continuous batching over one shared batched cache; every
    step decodes all slots at the scalar position of the furthest active
    slot (inactive slots decode into their own lanes, unread).  Where the
    input takes it, a step replays a CUDA graph of this engine's
    (``models/decode_graph.py``); :attr:`graph_stats` counts how often."""

    def __init__(self, instance_id: int, model: Model, *, n_slots: int,
                 cache_len: int):
        self.instance_id = instance_id
        self.model = model
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.slots = [Slot() for _ in range(n_slots)]
        self.cache = make_decode_cache(model.cfg, n_slots, cache_len, model.device)
        self._pos = np.zeros(n_slots, np.int64)      # per-slot position
        self._tokens = np.zeros(n_slots, np.int64)   # next input token
        self._graphs = DecodeGraphs(model, self.cache, n_slots)

    @property
    def graph_stats(self) -> dict:
        """Steps replayed from a graph, graphs captured, steps run eagerly
        (``DecodeGraphs.stats``)."""
        return self._graphs.stats()

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    @property
    def beta(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def admit(self, request_id: int, pre: PrefillResult, max_new: int) -> int:
        """Land a transferred prefill cache into a free slot (in place)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        for k, v in self.cache.items():
            if k == "pos":
                continue
            src = pre.cache[k]
            if src.dim() >= 2 and src.shape[1] == 1:      # (P, 1, ...) batch lane
                if k.startswith(("k", "v")) and src.dim() == 5:
                    src_fit = src[:, 0, : self.cache_len]
                    v[:, slot, : src_fit.shape[1]].copy_(src_fit)
                else:
                    v[:, slot].copy_(src[:, 0])
        self._pos[slot] = int(pre.cache["pos"])
        self._tokens[slot] = pre.first_token
        s = self.slots[slot]
        s.request_id = request_id
        s.tokens_out = [pre.first_token]
        s.max_new = max_new
        s.active = True
        return slot

    def step(self) -> list[tuple[int, int]]:
        """One decode iteration for all active slots; returns the
        [(request_id, token)] emitted and retires finished slots."""
        if self.beta == 0:
            return []
        tr = hosttrace.for_step()
        if tr is not None:
            i_step = tr.begin(hosttrace.STEP, self.beta, self.n_slots)
            i_part = tr.begin(hosttrace.ENQUEUE)
        active = [i for i, s in enumerate(self.slots) if s.active]
        self.cache["pos"] = int(self._pos[active].max())
        tokens = torch.from_numpy(self._tokens)[:, None]
        logits, _ = decode_step(self.model, tokens, self.cache, graphs=self._graphs)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        if tr is not None:
            tr.end(i_part)
            i_part = tr.begin(hosttrace.READBACK)
        nxt = nxt.tolist()
        if tr is not None:
            tr.end(i_part)
        emitted = []
        for i in active:
            tok = int(nxt[i])
            s = self.slots[i]
            s.tokens_out.append(tok)
            self._tokens[i] = tok
            self._pos[i] += 1
            emitted.append((s.request_id, tok))
            if len(s.tokens_out) >= s.max_new:
                s.active = False
        if tr is not None:
            tr.end(i_step)
        return emitted
