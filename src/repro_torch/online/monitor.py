"""Workload monitor + drift detector (DESIGN.md §7).

The monitor keeps a sliding window of observed queries (their vids — i.e.
which columns/modalities traffic actually touches) and can rebuild a
``Workload`` from that window for re-tuning. Drift is the total-variation
distance between the window's vid histogram and the histogram of the
workload the current configuration was tuned for: 0 when serving exactly
the tuned mix, 1 when the observed mix is disjoint from it.
"""
from __future__ import annotations

import threading
from collections import Counter, deque
from dataclasses import dataclass

import numpy as np

from repro_torch.core.types import Query, Vid, Workload


def reference_histogram(workload: Workload) -> dict[Vid, float]:
    """Probability mass per vid for the tuned workload (probs summed)."""
    hist: dict[Vid, float] = {}
    for q, p in workload:
        hist[q.vid] = hist.get(q.vid, 0.0) + float(p)
    return hist


def total_variation(p: dict[Vid, float], q: dict[Vid, float]) -> float:
    keys = set(p) | set(q)
    return 0.5 * sum(abs(p.get(k, 0.0) - q.get(k, 0.0)) for k in keys)


class WorkloadMonitor:
    """Sliding window over the served query stream."""

    def __init__(self, window: int = 256):
        self.window = window
        self._queries: deque[Query] = deque(maxlen=window)
        self.total_observed = 0
        # the serving thread appends while a thread-mode retune reads the
        # window — iterating a deque under concurrent append raises
        self._lock = threading.Lock()

    def observe(self, query: Query) -> None:
        with self._lock:
            self._queries.append(query)
            self.total_observed += 1

    def __len__(self) -> int:
        return len(self._queries)

    def _snapshot(self) -> list[Query]:
        with self._lock:
            return list(self._queries)

    def histogram(self) -> dict[Vid, float]:
        queries = self._snapshot()
        if not queries:
            return {}
        counts = Counter(q.vid for q in queries)
        return {vid: c / len(queries) for vid, c in counts.items()}

    def column_usage(self) -> dict[int, float]:
        """Fraction of windowed queries touching each column (feature
        usage — which modalities are hot)."""
        queries = self._snapshot()
        if not queries:
            return {}
        counts: Counter = Counter()
        for q in queries:
            counts.update(q.vid)
        return {c: counts[c] / len(queries) for c in sorted(counts)}

    def observed_workload(self, reps_per_vid: int = 3) -> Workload:
        """The window as a tuning workload: up to ``reps_per_vid`` most
        recent queries per vid, weighted by that vid's window frequency."""
        queries = self._snapshot()
        if not queries:
            raise ValueError("empty observation window")
        counts = Counter(q.vid for q in queries)
        recent: dict[Vid, list[Query]] = {}
        for q in reversed(queries):  # newest first
            bucket = recent.setdefault(q.vid, [])
            if len(bucket) < reps_per_vid:
                bucket.append(q)
        queries: list[Query] = []
        probs: list[float] = []
        for vid, reps in recent.items():
            for q in reps:
                queries.append(q)
                probs.append(counts[vid] / len(reps))
        return Workload(queries=queries, probs=np.asarray(probs))


@dataclass
class DriftReport:
    drift: float          # total-variation distance to the tuned histogram
    drifted: bool         # drift >= threshold with a full-enough window
    window: int           # current window occupancy
    observed: dict        # window vid histogram
    reference: dict       # tuned vid histogram


class DriftDetector:
    """Thresholded total-variation drift vs the tuned workload.

    ``min_window`` gates detection until the window holds enough queries
    for the histogram to be meaningful; ``rearm()`` swaps in the histogram
    of the freshly re-tuned workload so the detector measures drift against
    whatever configuration is currently serving.
    """

    def __init__(self, reference: dict[Vid, float], threshold: float = 0.35,
                 min_window: int = 64):
        self.reference = dict(reference)
        self.threshold = threshold
        self.min_window = min_window

    def check(self, monitor: WorkloadMonitor) -> DriftReport:
        observed = monitor.histogram()
        drift = total_variation(observed, self.reference)
        return DriftReport(
            drift=drift,
            drifted=len(monitor) >= self.min_window and drift >= self.threshold,
            window=len(monitor), observed=observed,
            reference=dict(self.reference))

    def rearm(self, workload: Workload) -> None:
        self.reference = reference_histogram(workload)
