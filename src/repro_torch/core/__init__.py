"""NetKV core of the port: cost model, network cost oracle, scheduler ladder
(the port's own copies of ``repro.core``'s NumPy modules)."""

from .cost import (
    B_TOK,
    GBPS,
    GiB,
    H100_TP4_ITER,
    H100_TP4_PREFILL,
    IterTimeModel,
    ModelKVSpec,
    PrefillTimeModel,
    post_prefill_latency,
    transfer_time,
)
from .oracle import (
    NetworkCostOracle,
    OracleView,
    PAPER_TIER_BANDWIDTH,
    PAPER_TIER_LATENCY,
    SelfContentionTracker,
    TIERS,
)
from .schedulers import (
    LADDER,
    CandidateState,
    Decision,
    NetKVFull,
    RequestInfo,
    Scheduler,
    make_scheduler,
)
from .view import ClusterView, as_cluster_view

__all__ = [k for k in dir() if not k.startswith("_")]
