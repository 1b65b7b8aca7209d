# The port's own copy of repro/sim/trace.py, kept verbatim so that repro_torch imports
# nothing of the JAX package; tests/test_torch_sim.py holds the two equal.
"""TracePlane: columnar request-lifecycle tracing and decision forensics.

The observability engine in the repo's plane idiom: spans and forensics
rows live in parallel columns (struct-of-arrays, appended live and
materialised per-request at ``finalize``), are derived exclusively from
*sim* time (never wall clock), and are bit-exact across both event
engines (``EventPlane`` / reference heap) and both dispatch modes
(``CohortSelector`` / per-request ``select()``) — the parity suites
assert span-set and timestamp equality the same way they assert
outcomes.

Three layers:

1. **Lifecycle spans** — per-request ``queue → prefill (per chunk under
   ChunkPlane) → xfer (per stream segment under kv_streaming, with tier
   and the bottleneck link from FlowPlane's water-fill) → admit_wait →
   first_iter → decode``.  Endpoint timestamps already live on
   ``RequestState`` and are parity-guaranteed, so whole-phase spans are
   derived at ``finalize(records)``; only chunk spans, transfer
   segments and latency-only hops are emitted live, each behind an
   ``is not None`` guard so tracing-off allocates nothing on the hot
   path.
2. **Decision forensics** — for each (cohort) selection, the winner and
   runner-up candidates' per-component cost breakdown (cache / load /
   transfer / congestion terms of Eq. (4)/(6)/(7)), captured under a
   deterministic sampling stride (a call counter, never RNG or wall
   clock, so the sampled set is identical across dispatch modes).
3. **Exporters** — Chrome/Perfetto trace-event JSON (one track per
   instance plus a scheduler track) and ``ttft_breakdown.csv`` rows,
   plus the ``ttft_attribution`` summary feeding ``RunMetrics``.

``TraceSession`` aggregates many runs (one benchmark process) into a
single combined trace.json + ttft_breakdown.csv artifact pair.
"""

from __future__ import annotations

import csv
import json
import os
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .instances import RequestState

# Span kinds (the trace-event ``name``):
#   queue      arrival -> prefill_start          (prefill track)
#   prefill    prefill_start -> prefill_end      (prefill track)
#   chunk      one ChunkPlane iteration's slice  (prefill track; a=tokens, b=done)
#   xfer       prefill_end -> transfer_end       (decode track; a=s_eff)
#   xfer_seg   one Transfer on the wire          (decode track; a=bytes, b=bottleneck link)
#   lat        latency-only hop (0 bytes)        (decode track)
#   admit_wait transfer_end -> admit_time        (decode track)
#   first_iter admit_time -> first_token         (decode track)
#   decode     first_token -> finish             (decode track; a=tokens_out)
#   deflect    one deflected-prefill chunk slice (decode track; a=tokens, b=done)
#   role_flip  RolePlane P:D transition instant  (decode track; a=new role)
SPAN_KINDS = (
    "queue", "prefill", "chunk", "xfer", "xfer_seg", "lat",
    "admit_wait", "first_iter", "decode", "deflect", "role_flip",
)
_PREFILL_TRACK = frozenset(("queue", "prefill", "chunk"))

FORENSICS_COLUMNS = (
    "time", "kind", "request_id", "prefill_id", "win", "run",
    "tier_win", "tier_run", "congestion",
    "cost_win", "cost_run", "cache_win", "cache_run",
    "load_win", "load_run", "xfer_win", "xfer_run",
)

BREAKDOWN_COLUMNS = (
    "run", "request_id", "arrival", "queue_wait", "prefill", "xfer",
    "admit_wait", "first_iter", "ttft", "xfer_share", "tier",
    "prefill_instance", "decode_instance", "hit_tokens", "requeues",
)


def _mean(a) -> float:
    return float(np.mean(a)) if len(a) else float("nan")


def _pct(a, q) -> float:
    return float(np.percentile(a, q)) if len(a) else float("nan")


class TracePlane:
    """Columnar span + forensics store for one ``Simulation`` run."""

    __slots__ = (
        "now", "_stride", "_n_dec",
        "s_kind", "s_req", "s_t0", "s_t1", "s_inst", "s_tier", "s_a", "s_b",
        "_dec", "_seg_seen",
    )

    def __init__(self, decision_stride: int = 1):
        self.now = 0.0  # sim time of the in-flight decision (set by the dispatcher)
        self._stride = max(1, int(decision_stride))
        self._n_dec = 0
        # Span columns (struct-of-arrays; one append per span).
        self.s_kind: list[str] = []
        self.s_req: list[int] = []
        self.s_t0: list[float] = []
        self.s_t1: list[float] = []
        self.s_inst: list[int] = []
        self.s_tier: list[int] = []
        self.s_a: list[float] = []
        self.s_b: list[float] = []
        self._dec: list[tuple] = []
        self._seg_seen: set[int] = set()

    # ------------------------------------------------------------------
    # live emission (hot-path callers guard on ``trace is not None``)

    def span(self, kind, req, t0, t1, inst, tier=-1, a=0.0, b=-1.0) -> None:
        self.s_kind.append(kind)
        self.s_req.append(int(req))
        self.s_t0.append(float(t0))
        self.s_t1.append(float(t1))
        self.s_inst.append(int(inst))
        self.s_tier.append(int(tier))
        self.s_a.append(float(a))
        self.s_b.append(float(b))

    def chunk(self, rs, inst, t0, t1, take, done, kind: str = "chunk") -> None:
        """One prefill chunk finishing an instance iteration (``kind=
        "deflect"`` when the chunk ran on a decode host via RolePlane)."""
        self.span(kind, rs.req.request_id, t0, t1, inst,
                  a=float(take), b=float(done))

    def role_flip(self, iid, now, role) -> None:
        """One RolePlane P:D transition (zero-duration instant)."""
        self.span("role_flip", -1, now, now, iid, a=float(role))

    def segment(self, rs, transfer) -> None:
        """One completed KV ``Transfer`` (deduped across callback paths)."""
        tid = transfer.transfer_id
        if tid in self._seg_seen:
            return
        self._seg_seen.add(tid)
        end = transfer.finish_time
        self.span("xfer_seg", rs.req.request_id, transfer.start_time,
                  transfer.start_time if end is None else end,
                  rs.decode_instance, tier=transfer.tier,
                  a=transfer.total_bytes, b=float(transfer.bottleneck_link))

    def lat_segment(self, rs, t0, t1) -> None:
        """A latency-only (zero-byte) transfer hop."""
        self.span("lat", rs.req.request_id, t0, t1, rs.decode_instance,
                  tier=rs.tier)

    # ------------------------------------------------------------------
    # decision forensics

    def want_decision(self) -> bool:
        """Deterministic sampling: counts every decision, records each
        ``decision_stride``-th.  The counter advances on both dispatch
        modes' call sites in lockstep, so the sampled set is identical."""
        n = self._n_dec
        self._n_dec = n + 1
        return n % self._stride == 0

    def decision(self, kind, request_id, prefill_id, win, run,
                 tier_win, tier_run, congestion,
                 cost_win, cost_run, cache_win, cache_run,
                 load_win, load_run, xfer_win, xfer_run) -> None:
        self._dec.append((
            float(self.now), kind, int(request_id), int(prefill_id),
            int(win), int(run), int(tier_win), int(tier_run),
            float(congestion),
            float(cost_win), float(cost_run), float(cache_win),
            float(cache_run), float(load_win), float(load_run),
            float(xfer_win), float(xfer_run),
        ))

    # ------------------------------------------------------------------
    # finalisation + views

    def finalize(self, records) -> None:
        """Derive whole-phase lifecycle spans from ``RequestState`` rows.

        The endpoint timestamps are the same fields the parity suites
        already assert bit-equal across engines, so derived spans are
        parity-free by construction."""
        for rs in records:
            rid = rs.req.request_id
            arr = rs.req.arrival
            if rs.prefill_start >= 0.0:
                self.span("queue", rid, arr, rs.prefill_start,
                          rs.prefill_instance)
                if rs.prefill_end >= rs.prefill_start:
                    self.span("prefill", rid, rs.prefill_start,
                              rs.prefill_end, rs.prefill_instance)
            if rs.transfer_end >= 0.0 and rs.prefill_end >= 0.0:
                self.span("xfer", rid, rs.prefill_end, rs.transfer_end,
                          rs.decode_instance, tier=rs.tier, a=rs.s_eff)
                if rs.admit_time >= 0.0:
                    self.span("admit_wait", rid, rs.transfer_end,
                              rs.admit_time, rs.decode_instance,
                              tier=rs.tier)
            if rs.first_token >= 0.0 and rs.admit_time >= 0.0:
                self.span("first_iter", rid, rs.admit_time, rs.first_token,
                          rs.decode_instance)
            if rs.finish >= 0.0 and rs.first_token >= 0.0:
                self.span("decode", rid, rs.first_token, rs.finish,
                          rs.decode_instance, a=float(rs.tokens_out))

    def spans(self) -> list[tuple]:
        """Canonical span list (insertion order) for parity asserts."""
        return list(zip(self.s_kind, self.s_req, self.s_t0, self.s_t1,
                        self.s_inst, self.s_tier, self.s_a, self.s_b))

    def forensics_rows(self) -> list[tuple]:
        return list(self._dec)

    def columns(self) -> dict[str, np.ndarray]:
        """Span columns as arrays (the struct-of-arrays view)."""
        return {
            "kind": np.asarray(self.s_kind, dtype=object),
            "req": np.asarray(self.s_req, dtype=np.int64),
            "t0": np.asarray(self.s_t0, dtype=np.float64),
            "t1": np.asarray(self.s_t1, dtype=np.float64),
            "inst": np.asarray(self.s_inst, dtype=np.int64),
            "tier": np.asarray(self.s_tier, dtype=np.int64),
            "a": np.asarray(self.s_a, dtype=np.float64),
            "b": np.asarray(self.s_b, dtype=np.float64),
        }

    # ------------------------------------------------------------------
    # exporters

    def to_chrome_events(self, pid: int = 1, label: str = "run") -> list[dict]:
        """Chrome/Perfetto trace-event list: ``ph:"X"`` duration slices
        on one track (tid) per instance, decisions as ``ph:"i"`` instants
        on the scheduler track (tid 0).  ts/dur are sim-microseconds."""
        ev: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        }, {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "scheduler"},
        }]
        named: set[int] = set()
        for kind, req, t0, t1, inst, tier, a, b in self.spans():
            tid = 0 if inst < 0 else int(inst) + 1
            if tid not in named and tid != 0:
                named.add(tid)
                side = "prefill" if kind in _PREFILL_TRACK else "decode"
                ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": f"{side} {inst}"}})
            ev.append({
                "name": kind, "cat": "lifecycle", "ph": "X", "pid": pid,
                "tid": tid, "ts": t0 * 1e6, "dur": max(0.0, t1 - t0) * 1e6,
                "args": {"req": req, "tier": tier, "a": a, "b": b},
            })
        for row in self._dec:
            args = dict(zip(FORENSICS_COLUMNS, row))
            ev.append({
                "name": f"select:{row[1]}", "cat": "decision", "ph": "i",
                "pid": pid, "tid": 0, "ts": row[0] * 1e6, "s": "t",
                "args": args,
            })
        return ev


# ----------------------------------------------------------------------
# TTFT attribution (records -> per-phase shares; NaN-safe)


def ttft_attribution(records, window) -> dict[str, float]:
    """Per-phase TTFT attribution over the measurement window.

    Returns means and p95s of queue wait (arrival -> prefill start),
    prefill, admit wait (last KV byte -> batch admission) and the
    transfer *share* of TTFT.  NaN-safe on degenerate windows per the
    ``summarize`` contract (empty -> NaN columns)."""
    lo, hi = window
    done = [r for r in records
            if lo <= r.req.arrival < hi and not r.rejected
            and r.first_token >= 0.0]
    qw = [r.prefill_start - r.req.arrival for r in done
          if r.prefill_start >= 0.0]
    pf = [r.prefill_end - r.prefill_start for r in done
          if r.prefill_end >= 0.0 and r.prefill_start >= 0.0]
    aw = [r.admit_time - r.transfer_end for r in done
          if r.admit_time >= 0.0 and r.transfer_end >= 0.0]
    xs = [(r.transfer_end - r.prefill_end) / r.ttft for r in done
          if r.transfer_end >= 0.0 and r.prefill_end >= 0.0 and r.ttft > 0.0]
    return {
        "queue_wait_mean": _mean(qw), "queue_wait_p95": _pct(qw, 95),
        "prefill_mean": _mean(pf), "prefill_p95": _pct(pf, 95),
        "admit_wait_mean": _mean(aw), "admit_wait_p95": _pct(aw, 95),
        "xfer_share_mean": _mean(xs), "xfer_share_p95": _pct(xs, 95),
    }


def ttft_breakdown_rows(records, run: str = "") -> list[dict]:
    """One ``ttft_breakdown.csv`` row per finished request."""
    rows = []
    for rs in records:
        if rs.first_token < 0.0:
            continue
        arr = rs.req.arrival
        qw = rs.prefill_start - arr if rs.prefill_start >= 0.0 else float("nan")
        pf = (rs.prefill_end - rs.prefill_start
              if rs.prefill_end >= 0.0 and rs.prefill_start >= 0.0
              else float("nan"))
        xf = (rs.transfer_end - rs.prefill_end
              if rs.transfer_end >= 0.0 and rs.prefill_end >= 0.0
              else float("nan"))
        aw = (rs.admit_time - rs.transfer_end
              if rs.admit_time >= 0.0 and rs.transfer_end >= 0.0
              else float("nan"))
        fi = (rs.first_token - rs.admit_time
              if rs.admit_time >= 0.0 else float("nan"))
        ttft = rs.ttft
        rows.append({
            "run": run, "request_id": rs.req.request_id, "arrival": arr,
            "queue_wait": qw, "prefill": pf, "xfer": xf, "admit_wait": aw,
            "first_iter": fi, "ttft": ttft,
            "xfer_share": xf / ttft if ttft > 0.0 else float("nan"),
            "tier": rs.tier, "prefill_instance": rs.prefill_instance,
            "decode_instance": rs.decode_instance,
            "hit_tokens": rs.hit_tokens, "requeues": rs.requeues,
        })
    return rows


# ----------------------------------------------------------------------
# process-wide session (benchmark aggregation)


class TraceSession:
    """Aggregates the traces of every ``Simulation`` run while active.

    ``Simulation`` auto-enables its ``TracePlane`` and registers
    ``(label, trace, records)`` here at the end of ``run()``.  Harnesses
    set ``context`` so arms are distinguishable; gates that must measure
    traced-off throughput set ``paused`` around their arms."""

    def __init__(self):
        self.runs: list[tuple[str, TracePlane, list]] = []
        self.context = ""
        self.paused = False

    @property
    def n_runs(self) -> int:
        return len(self.runs)

    def register(self, scheduler: str, trace: TracePlane, records) -> None:
        prefix = f"{self.context}/" if self.context else ""
        self.runs.append((f"{prefix}{scheduler}#{len(self.runs)}",
                          trace, records))

    def write(self, out_dir, max_chrome: int = 4) -> list[str]:
        """Write ``trace.json`` (first ``max_chrome`` runs, one pid each)
        and ``ttft_breakdown.csv`` (all runs).  Returns written paths."""
        os.makedirs(out_dir, exist_ok=True)
        events: list[dict] = []
        for pid, (label, trace, _records) in enumerate(
                self.runs[:max_chrome], start=1):
            events.extend(trace.to_chrome_events(pid=pid, label=label))
        jpath = os.path.join(out_dir, "trace.json")
        with open(jpath, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
        cpath = os.path.join(out_dir, "ttft_breakdown.csv")
        with open(cpath, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(BREAKDOWN_COLUMNS))
            w.writeheader()
            for label, _trace, records in self.runs:
                for row in ttft_breakdown_rows(records, run=label):
                    w.writerow(row)
        return [jpath, cpath]


_SESSION: TraceSession | None = None


def enable_tracing(on: bool = True) -> TraceSession | None:
    """Start (or stop) a process-wide trace session; returns it."""
    global _SESSION
    _SESSION = TraceSession() if on else None
    return _SESSION


def trace_session() -> TraceSession | None:
    """The active session, or None (paused sessions count as inactive)."""
    if _SESSION is not None and _SESSION.paused:
        return None
    return _SESSION
