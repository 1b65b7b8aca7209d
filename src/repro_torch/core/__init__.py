"""NetKV core of the port: cost model, network cost oracle, scheduler ladder,
cohort dispatch (the port's own copies of ``repro.core``'s NumPy modules)."""

from .cost import (
    B_TOK,
    GBPS,
    GiB,
    H100_TP4_ITER,
    H100_TP4_PREFILL,
    IterTimeModel,
    LLAMA3_70B_KV,
    ModelKVSpec,
    PrefillTimeModel,
    effective_bandwidth,
    effective_bandwidth_tiers,
    effective_transfer_bytes,
    first_decode_time,
    post_prefill_latency,
    queue_time,
    transfer_time,
)
from .oracle import (
    EWMACongestionPredictor,
    NetworkCostOracle,
    OracleView,
    PAPER_TIER_BANDWIDTH,
    PAPER_TIER_LATENCY,
    SelfContentionTracker,
    TransferIntent,
    TIERS,
)
from .view import ClusterView, as_cluster_view
from .schedulers import (
    CandidateState,
    CacheAware,
    CacheLoadAware,
    Decision,
    LADDER,
    LoadAware,
    NetKVFull,
    NetKVPredictive,
    NetKVStatic,
    NetKVTopoOnly,
    RequestInfo,
    RoundRobin,
    Scheduler,
    make_scheduler,
)
from .batch_assign import NetKVBatch
from .dispatch import CohortItem, CohortSelector, supports_cohort
from .multihop import NetKVMultiHop, StagingStore

__all__ = [k for k in dir() if not k.startswith("_")]
