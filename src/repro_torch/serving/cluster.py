"""Disaggregated serving cluster of the port: real models + NetKV routing +
timed fabric (``repro/serving/cluster.py``).

Prefill and decode engines hold real weights on one device and share one
parameter set; the KV cache moves through ``kv_pack``/``kv_unpack``; the
flow-level fat-tree gives transfer timing; a ladder policy picks the decode
instance per request.  Held field by field against the JAX cluster
(tests/test_torch_serving.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from ..cluster.network import BackgroundTraffic, FlowNetwork
from ..cluster.topology import FatTree, make_instances
from ..core.cost import B_TOK, IterTimeModel
from ..core.oracle import NetworkCostOracle, SelfContentionTracker
from ..core.schedulers import RequestInfo, make_scheduler
from ..core.view import ClusterView
from ..kernels.build import resolve_device
from ..models.model import Model, ModelConfig, init_random_
from .engine import DecodeEngine, PrefillEngine
from .transfer import pack_transfer, unpack_transfer


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    prompt: np.ndarray
    max_new: int
    arrival: float = 0.0


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: list[int]
    prefill_instance: int
    decode_instance: int
    tier: int
    transfer_bytes: int
    ttft: float           # simulated-clock TTFT
    transfer_time: float


class DisaggregatedCluster:
    """Small-cluster executable disaggregated serving with NetKV routing.

    ``params`` takes a :class:`Model` (for instance weights converted with
    ``models.convert.params_from_jax``); when it is ``None`` the weights are
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    ``device=None`` means the card; without one the constructor raises.

    It serves decoder-only models; a vision model text only, as the JAX
    cluster does (its prefill engine passes no prefix embeddings).  An
    encoder-decoder is refused before anything is allocated: the JAX
    cluster's prefill caches no cross K/V, so its decode engine fails at
    ``admit`` (ROADMAP §3 item 7)."""

    def __init__(self, cfg: ModelConfig, *, scheduler: str = "netkv-full",
                 n_prefill: int = 2, n_decode: int = 4, n_slots: int = 4,
                 cache_len: int = 256, seed: int = 0,
                 tree: FatTree | None = None, background: float = 0.2,
                 params: Model | None = None, device=None):
        if cfg.is_enc_dec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: the cluster's prefill engine takes no "
                "encoder memory, so the JAX cluster cannot serve it either (ROADMAP §3 "
                "item 7); run it through models.encode, prefill(memory=...) and decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cache_len = cache_len
        if params is None:
            params = init_random_(Model(cfg, device=self.device), seed)
        elif params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, cluster on {self.device}")
        self.model = params
        self.tree = tree or FatTree()
        self.net = FlowNetwork(self.tree, BackgroundTraffic(background), seed=seed)
        pre_meta, dec_meta = make_instances(self.tree, tp=4,
                                            n_prefill=max(n_prefill, 1))
        pre_meta = pre_meta[:n_prefill]
        dec_meta = dec_meta[:n_decode]
        self.prefill = [PrefillEngine(m.instance_id, params, cache_len)
                        for m in pre_meta]
        self.decode = [DecodeEngine(m.instance_id, params, n_slots=n_slots,
                                    cache_len=cache_len)
                       for m in dec_meta]
        self._server_of = {m.instance_id: m.server for m in (*pre_meta, *dec_meta)}
        self.iter_model = IterTimeModel(a=0.0124, b=1.6e-5)
        self.oracle = NetworkCostOracle(
            tier_of=lambda a, b: self.tree.tier(self._server_of[a], self._server_of[b]),
            topology=self.tree,
            telemetry_fn=lambda now: self.net.tier_congestion(now),
        )
        self.inflight = SelfContentionTracker()
        self.sched = make_scheduler(scheduler, self.iter_model, beta_max=n_slots,
                                    m_min=0.0)
        self.clock = 0.0
        # Per-decode-instance block-hash sets for the prefix-hit signal.
        self._cached_hashes: dict[int, set] = {d.instance_id: set() for d in self.decode}
        # Host wall seconds per served request and its decode step count.
        # Prefill and decode end in a host read of device results, so their
        # clocks cover the device work; transfer_s is the host time of pack,
        # fabric timing, unpack and admit, whose device work may finish
        # inside the first decode step.
        self.walls: list[dict] = []

    # ------------------------------------------------------------------ serve
    def _hit_pages(self, decode_id: int, prompt: np.ndarray) -> int:
        cached = self._cached_hashes[decode_id]
        pages = 0
        for start in range(0, len(prompt) - len(prompt) % B_TOK, B_TOK):
            if hash(tuple(prompt[start:start + B_TOK].tolist())) in cached:
                pages += 1
            else:
                break
        return pages

    def _remember(self, decode_id: int, prompt: np.ndarray) -> None:
        cached = self._cached_hashes[decode_id]
        for start in range(0, len(prompt) - len(prompt) % B_TOK, B_TOK):
            cached.add(hash(tuple(prompt[start:start + B_TOK].tolist())))

    def serve(self, requests: Sequence[ServeRequest]) -> list[ServeResult]:
        results = []
        for req in sorted(requests, key=lambda r: r.arrival):
            self.clock = max(self.clock, req.arrival)
            # 1. prefill (round robin over the prefill engines).
            pe = self.prefill[req.request_id % len(self.prefill)]
            w0 = time.perf_counter()
            pre = pe.run(req.request_id, req.prompt)
            w1 = time.perf_counter()
            prefill_time = 5e-5 * len(req.prompt) + 0.015
            t_prefill_done = self.clock + prefill_time

            # 2. decode-instance selection (Algorithm 1 over columnar state).
            view = self.oracle.view(t_prefill_done)
            cv = ClusterView(tier_fn=view.tier_of, capacity=len(self.decode))
            for d in self.decode:
                cv.add_instance(
                    d.instance_id,
                    free_memory=float(len(d.free_slots())) * 1e12,  # slot-gated
                    queued=0,
                    batch=d.beta,
                    hit_tokens=float(self._hit_pages(d.instance_id, req.prompt) * B_TOK),
                    healthy=len(d.free_slots()) > 0,
                )
            info = RequestInfo(req.request_id, len(req.prompt), float(pre.kv_bytes))
            decision = self.sched.select(info, pe.instance_id, cv, view, self.inflight)
            assert decision is not None, "no feasible decode instance"
            de = next(d for d in self.decode if d.instance_id == decision.instance_id)

            # 3. pack + timed transfer + unpack (real tensors move).
            hit_pages = self._hit_pages(de.instance_id, req.prompt)
            w2 = time.perf_counter()
            buffers, nbytes = pack_transfer(pre.cache, hit_pages)
            done = []
            self.net.start_transfer(
                self._server_of[pe.instance_id], self._server_of[de.instance_id],
                float(max(nbytes, 1)), t_prefill_done,
                on_complete=lambda tr, t: done.append(t), n_flows=4,
            )
            t = t_prefill_done
            while not done:
                nxt = self.net.next_completion_time(t)
                if nxt is None:
                    break
                t = nxt
                self.net.advance(t)
            t_transfer_done = done[0] if done else t_prefill_done
            cache = unpack_transfer(buffers, pre.cache)
            cache["pos"] = pre.cache["pos"]
            pre_landed = dataclasses.replace(pre, cache=cache)

            # 4. decode until done.
            de.admit(req.request_id, pre_landed, req.max_new)
            w3 = time.perf_counter()
            if self.sched.uses_self_contention:
                self.inflight.decr(pe.instance_id, decision.tier)
            self._remember(de.instance_id, req.prompt)
            toks = [pre.first_token]
            steps = 0
            while any(s.active and s.request_id == req.request_id for s in de.slots):
                emitted = de.step()
                steps += 1
                toks.extend(t for rid, t in emitted if rid == req.request_id)
            self.walls.append(dict(request_id=req.request_id, prefill_s=w1 - w0,
                                   transfer_s=w3 - w2,
                                   decode_s=time.perf_counter() - w3,
                                   decode_steps=steps))
            t_first = t_transfer_done + self.iter_model(de.beta + 1)
            results.append(ServeResult(
                request_id=req.request_id,
                tokens=toks,
                prefill_instance=pe.instance_id,
                decode_instance=de.instance_id,
                tier=decision.tier,
                transfer_bytes=nbytes,
                ttft=t_first - req.arrival + prefill_time,
                transfer_time=t_transfer_done - t_prefill_done,
            ))
            self.clock = t_transfer_done
        return results
