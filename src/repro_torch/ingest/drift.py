"""Data-drift detection: the data-side twin of ``online.monitor``.

PR 2's drift loop watches the QUERY mix (total-variation over vid
histograms); this detector watches the DATA. Two signals, both cheap
because the table maintains them incrementally:

  - **delta fraction** — live delta rows / live rows. Even
    distribution-neutral churn degrades the tuned configuration's cost
    model (every query pays the delta scan), so a large-enough delta is
    drift regardless of geometry;
  - **centroid shift** — per column, the cosine distance between the live
    centroid at (re)arm time and the live centroid now (``MutableTable``
    keeps per-column live sums, so this is O(d) per check, never a
    rescan). Shifting centroids mean the estimator sample and the index
    statistics the configuration was tuned on no longer describe the
    table.

A firing detector means the TUNING is stale, not just the snapshot: the
runtime's response is compact + rebuild ``Mint`` over the materialized
table + retune (``IngestRuntime.maintain`` → ``data_retune``), after
which ``rearm`` re-baselines both signals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.ingest.table import MutableTable


def _unit(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclass
class DataDriftReport:
    delta_fraction: float
    churn_fraction: float       # rows mutated since rearm / live rows
    dead_fraction: float
    centroid_shift: dict        # column -> 1 - cos(ref centroid, live centroid)
    max_shift: float
    mutated_rows: int           # rows touched since the last rearm
    drifted: bool
    reason: str | None          # which signal fired


class DataDriftDetector:
    """Thresholded delta-fraction + centroid-shift drift on one table.

    ``delta_threshold`` fires on the UNCOMPACTED delta (serving overhead);
    ``churn_threshold`` fires on cumulative churn since the last rearm —
    compactions fold the delta but do NOT reset this, so a table that
    churned 30% through many small compactions still triggers a retune."""

    def __init__(self, table: MutableTable,
                 delta_threshold: float = 0.25,
                 churn_threshold: float = 0.3,
                 shift_threshold: float = 0.15,
                 min_mutated_rows: int = 64):
        self.table = table
        self.delta_threshold = delta_threshold
        self.churn_threshold = churn_threshold
        self.shift_threshold = shift_threshold
        self.min_mutated_rows = min_mutated_rows
        self._ref_centroids: list[np.ndarray] = []
        self._ref_mutations = 0
        self.rearm()

    def _mutated_rows(self) -> int:
        log = self.table.log
        return (log.inserted + log.deleted + log.upserted
                - self._ref_mutations)

    def rearm(self) -> None:
        """Re-baseline against the CURRENT live table (called after a
        data-drift retune installed a configuration tuned for it)."""
        self._ref_centroids = [
            _unit(self.table.live_mean(c))
            for c in range(self.table.base.n_cols)]
        log = self.table.log
        self._ref_mutations = log.inserted + log.deleted + log.upserted

    def check(self) -> DataDriftReport:
        shifts = {}
        for c, ref in enumerate(self._ref_centroids):
            live = _unit(self.table.live_mean(c))
            shifts[c] = float(1.0 - np.dot(ref, live))
        max_shift = max(shifts.values()) if shifts else 0.0
        delta_fraction = self.table.delta_fraction
        mutated = self._mutated_rows()
        churn = mutated / max(self.table.n_live, 1)
        reason = None
        if mutated >= self.min_mutated_rows:
            if delta_fraction >= self.delta_threshold:
                reason = f"delta_fraction {delta_fraction:.3f}"
            elif churn >= self.churn_threshold:
                reason = f"churn_fraction {churn:.3f}"
            elif max_shift >= self.shift_threshold:
                reason = f"centroid_shift {max_shift:.4f}"
        return DataDriftReport(
            delta_fraction=delta_fraction, churn_fraction=float(churn),
            dead_fraction=self.table.dead_fraction,
            centroid_shift=shifts, max_shift=max_shift,
            mutated_rows=mutated, drifted=reason is not None, reason=reason)
