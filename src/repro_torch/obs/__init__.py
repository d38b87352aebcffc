"""Unified observability: metrics registry, per-ticket span tracing,
and a runtime timeline, all behind the zero-cost-when-disabled
:class:`Observer` seam (DESIGN.md §14).

Render captured state with :mod:`repro_torch.launch.obs_report`.
"""
from .metrics import (COUNTER, GAUGE, HISTOGRAM, Histogram, MetricsRegistry,
                      MetricsSnapshot, hist_quantile, hist_summary)
from .observer import NULL_OBSERVER, NullObserver, Observer
from .timeline import Timeline, TimelineEvent
from .tracing import Span, Trace

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM",
    "Histogram", "MetricsRegistry", "MetricsSnapshot",
    "hist_quantile", "hist_summary",
    "NULL_OBSERVER", "NullObserver", "Observer",
    "Timeline", "TimelineEvent",
    "Span", "Trace",
]
