"""Sampled selectivity estimation + access-path cost model (DESIGN.md §12).

The planner chooses between three access paths per (query, predicate):

  pre     gather the matching rows, brute-force only those.
          cost ≈ dim(q)·sel·N·(1 + GATHER_OVERHEAD) + BITMAP_COST·N
  masked  full fused scan with the keep bitmap composed into the kernel's
          row mask.   cost ≈ dim(q)·N + BITMAP_COST·N
  post    unfiltered index probe with eks inflated by 1/sel, candidates
          filtered afterwards (``core/planner.py::_plan_cost(selectivity=)``).

With GATHER_OVERHEAD = 1 a gathered row costs twice a streamed row
(scattered DMA reads full cache lines / HBM bursts regardless of use), so
pre and masked cross at sel = 1 / (1 + GATHER_OVERHEAD) = 0.5: pre wins
clearly at percent-level selectivities, masked/post from ~50% up. The
same constant drives ``launch/roofline.py::modeled_scan_bytes``'s
``gather_amplification`` so the byte model and the planner tell one story.

Costs are in the paper's unit (dim-weighted distance computations);
BITMAP_COST charges the attribute-column pass that every filtered path
pays once per row.
"""
from __future__ import annotations

import math

import numpy as np

GATHER_OVERHEAD = 1.0   # extra cost per gathered row vs streamed row
BITMAP_COST = 1.0       # bitmap evaluation, per row, in dim-units


def prefilter_cost(qdim: float, n_rows: float, sel: float) -> float:
    return qdim * sel * n_rows * (1.0 + GATHER_OVERHEAD) + BITMAP_COST * n_rows


def masked_scan_cost(qdim: float, n_rows: float) -> float:
    return qdim * n_rows + BITMAP_COST * n_rows


def inflate_eks(eks, sel: float, n_rows: int) -> list:
    """Post-filter over-fetch: ek/sel so ~ek survivors remain after the
    filter, capped at the table size."""
    floor = 1.0 / max(float(n_rows), 1.0)
    s = max(float(sel), floor)
    return [min(int(math.ceil(ek / s)), int(n_rows)) if ek > 0 else 0
            for ek in eks]


class SelectivityEstimator:
    """Uniform row-sample selectivity estimate with add-half smoothing.

    ``estimate(pred)`` evaluates ``pred``'s bitmap over a fixed seeded
    sample of live ids and returns (hits + 0.5) / (n + 1) — never exactly
    0 or 1, so the planner stays defined; exact-zero matches are caught by
    the engine's bitmap guard, not the estimator. Results are cached per
    (predicate, attribute version); ``refresh`` re-samples after churn."""

    def __init__(self, attrs, ids, sample_size: int = 512, seed: int = 0):
        self.attrs = attrs
        self.sample_size = int(sample_size)
        self.seed = int(seed)
        self._draws = 0
        self._cache: dict = {}
        self.refresh(ids)

    def refresh(self, ids) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        rng = np.random.default_rng(self.seed + self._draws)
        self._draws += 1
        take = min(self.sample_size, ids.size)
        self.sample = (np.sort(rng.choice(ids, size=take, replace=False))
                       if take else ids)
        self._cache.clear()

    def estimate(self, pred) -> float:
        if pred is None:
            return 1.0
        key = (pred, self.attrs.version)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        n = self.sample.size
        if n == 0:
            return 1.0
        hits = int(self.attrs.bitmap(pred, self.sample).sum())
        est = (hits + 0.5) / (n + 1.0)
        if len(self._cache) > 4096:
            self._cache.clear()
        self._cache[key] = est
        return est
