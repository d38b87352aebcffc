"""Online serving runtime (DESIGN.md §7).

Sits on top of ``repro_torch.serve``: micro-batching scheduler, plan cache,
workload monitor + drift detector, and the background re-tuner that
shadow-builds a re-tuned configuration and atomically swaps it in.
"""
from repro_torch.online.monitor import (DriftDetector, DriftReport, WorkloadMonitor,
                                  reference_histogram, total_variation)
from repro_torch.online.plancache import PlanCache
from repro_torch.online.retuner import BackgroundRetuner, RetuneEvent
from repro_torch.online.runtime import OnlineRuntime, RuntimeConfig
from repro_torch.online.scheduler import MicroBatcher, Ticket
from repro_torch.online.semcache import (SemanticCache, SemCacheConfig,
                                   TenantSemCaches)
from repro_torch.online.trace import (TimedMutation, TimedQuery, burst_trace,
                                churn_trace, diurnal_trace, hot_item_trace,
                                make_trace, row_batch, steady_trace,
                                tenant_skew_trace)

__all__ = [
    "BackgroundRetuner", "DriftDetector", "DriftReport", "MicroBatcher",
    "OnlineRuntime", "PlanCache", "RetuneEvent", "RuntimeConfig",
    "SemCacheConfig", "SemanticCache", "TenantSemCaches", "Ticket",
    "TimedMutation", "TimedQuery", "WorkloadMonitor", "burst_trace",
    "churn_trace", "diurnal_trace", "hot_item_trace", "make_trace",
    "reference_histogram", "row_batch", "steady_trace", "tenant_skew_trace",
    "total_variation",
]
