"""Discrete-event disaggregated-serving simulator of the port (copies of
``repro.sim``'s NumPy planes) and the ScenarioPlane sweep in PyTorch.

``repro.sim.cohort_step_jit`` has no counterpart here: PyTorch runs eagerly,
so :func:`cohort_step` is the one entry point."""

from .engine import (
    LANE_ARRIVAL, LANE_CLOCK, LANE_FAULT, LANE_GENERIC, LANE_NET,
    LANE_PREFILL, LANE_REWIRE, LANE_ROLE, LANE_TICK, LANE_NAMES, N_LANES,
    EventLoop, EventPlane, make_event_loop,
)
from .kvcache import B_TOK, BlockCache, RadixPlane, n_blocks
from .instances import (
    ChunkPlane, DecodeHandle, InstancePlane, PrefillHandle, RequestState,
)
from .reference import (
    ChunkedPrefillSim, DecodeSim, PrefillSim, ReferenceInstanceEngine,
)
from .metrics import RunMetrics, aggregate_seeds, summarize
from .scenarios import ScenarioPlane, ScenarioSpec, cohort_step
from .simulator import FaultEvent, RewireEvent, SimConfig, Simulation, run_sim
from .trace import (
    TracePlane, TraceSession, enable_tracing, trace_session,
    ttft_attribution, ttft_breakdown_rows,
)

__all__ = [
    "EventLoop", "EventPlane", "make_event_loop",
    "LANE_GENERIC", "LANE_ARRIVAL", "LANE_FAULT", "LANE_REWIRE", "LANE_NET",
    "LANE_TICK", "LANE_CLOCK", "LANE_ROLE", "LANE_PREFILL", "LANE_NAMES",
    "N_LANES",
    "B_TOK", "BlockCache", "RadixPlane", "n_blocks",
    "ChunkPlane", "InstancePlane", "DecodeHandle", "PrefillHandle",
    "ChunkedPrefillSim", "DecodeSim", "PrefillSim", "ReferenceInstanceEngine",
    "RequestState", "RunMetrics", "aggregate_seeds", "summarize",
    "ScenarioPlane", "ScenarioSpec", "cohort_step",
    "FaultEvent", "RewireEvent", "SimConfig", "Simulation", "run_sim",
    "TracePlane", "TraceSession", "enable_tracing", "trace_session",
    "ttft_attribution", "ttft_breakdown_rows",
]
