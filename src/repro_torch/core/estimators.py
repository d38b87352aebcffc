"""Cost / Recall / Storage estimators (paper Section 3.3.2).

Graph ANN indexes have no closed-form cost or recall, so MINT samples the
database (~1%), builds *sample* indexes per column, measures

    numDist(q, x, ek)  — number of score computations (cost proxy), and
    recall@ek          — |top-ek(index) ∩ top-ek(exact)| / ek,

then fits a **linear** model for numDist (paper Fig. 5) and a **logarithmic**
model for recall (paper Fig. 6), per (column, index-kind). Multi-column
indexes reuse per-column fits by averaging slopes/intercepts (paper's
heuristic — "we heuristically use the average slopes and intercepts across
columns").

Scale note (documented deviation): the paper tunes at N=1M where the 1%
sample (10k rows) is >> k=100; rank structure near the head is treated as
scale-free (see DESIGN.md). We therefore enforce a minimum sample size of
``min_sample_rows`` so sample ranks remain meaningful at bench scale.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import IndexSpec
from repro_torch.data.vectors import MultiVectorDatabase, make_queries
from repro_torch.index.base import exact_topk
from repro_torch.index.registry import BUILDERS


@dataclass
class LinearFit:
    slope: float
    intercept: float

    def __call__(self, ek: np.ndarray | float) -> np.ndarray | float:
        return self.slope * np.asarray(ek, dtype=np.float64) + self.intercept


@dataclass
class LogFit:
    alpha: float
    beta: float
    lo: float = 0.05
    hi: float = 1.0

    def __call__(self, ek: np.ndarray | float) -> np.ndarray | float:
        ek = np.maximum(np.asarray(ek, dtype=np.float64), 1.0)
        return np.clip(self.alpha * np.log(ek) + self.beta, self.lo, self.hi)


def fit_linear(x: np.ndarray, y: np.ndarray) -> LinearFit:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    a, b = np.polyfit(x, y, 1)
    return LinearFit(slope=float(max(a, 1e-6)), intercept=float(b))


def fit_log(x: np.ndarray, y: np.ndarray) -> LogFit:
    x = np.maximum(np.asarray(x, np.float64), 1.0)
    y = np.asarray(y, np.float64)
    a, b = np.polyfit(np.log(x), y, 1)
    return LogFit(alpha=float(a), beta=float(b))


@dataclass
class ColumnStats:
    cost: LinearFit    # numDist(ek), full-database scale (fraction-scaled fit)
    recall: LogFit     # recall(ek), full-database scale (fraction-scaled fit)
    # raw measured recall curve (full-scale ek grid, mean recall) — used for
    # the reliability floor by monotone interpolation (no extrapolation)
    rec_eks: np.ndarray = field(default_factory=lambda: np.asarray([1.0]))
    rec_vals: np.ndarray = field(default_factory=lambda: np.asarray([1.0]))


@dataclass
class EstimatorBundle:
    """Trained estimators for one database: per (column, kind) fits."""

    stats: dict[tuple[int, str], ColumnStats]
    dims: list[int]
    n_rows: int
    sample_rate: float
    train_seconds: float
    # per-item retrieval reliability target for ek inflation (see inflate_ek)
    theta_hit: float = 0.95

    # ---- multi-column width correction (beyond-paper refinement) ----
    # The paper averages per-column fits for multi-column indexes. We refine
    # with ONE extra sample index on the all-columns concatenation, measured
    # at training, and geometrically interpolate between the single-column
    # average (width 1) and the all-columns fit (width m) in column count.
    def _width(self, spec: IndexSpec) -> float:
        m = len(self.dims)
        if m <= 1 or ("__all__", spec.kind) not in self.stats:
            return 0.0
        return (len(spec.vid) - 1) / max(m - 1, 1)

    # ---- cost (paper Eq. 5): cost_idx = dim(x) * numDist(ek) ----
    def num_dist(self, spec: IndexSpec, ek: np.ndarray | float) -> np.ndarray | float:
        fits = [self.stats[(c, spec.kind)].cost for c in spec.vid]
        slope = float(np.mean([f.slope for f in fits]))
        intercept = float(np.mean([f.intercept for f in fits]))
        w = self._width(spec)
        if w > 0:
            af = self.stats[("__all__", spec.kind)].cost
            slope = slope ** (1 - w) * max(af.slope, 1e-6) ** w
            intercept = (max(intercept, 1.0) ** (1 - w)
                         * max(af.intercept, 1.0) ** w)
        est = slope * np.asarray(ek, np.float64) + intercept
        # an index scan never computes more distances than a flat scan
        return np.clip(est, 0.0, float(self.n_rows))

    def index_dim(self, spec: IndexSpec) -> int:
        return int(sum(self.dims[c] for c in spec.vid))

    def cost_idx(self, spec: IndexSpec, ek: np.ndarray | float) -> np.ndarray | float:
        return self.index_dim(spec) * self.num_dist(spec, ek)

    # ---- recall (paper Fig. 6): ANN quality of the index itself ----
    def ann_recall(self, spec: IndexSpec, ek: np.ndarray | float) -> np.ndarray | float:
        fits = [self.stats[(c, spec.kind)].recall for c in spec.vid]
        alpha = float(np.mean([f.alpha for f in fits]))
        beta = float(np.mean([f.beta for f in fits]))
        return LogFit(alpha, beta)(ek)

    def reliable_ek(self, spec: IndexSpec) -> float:
        """Depth at which the index's recall reaches theta_hit — recall
        curves are threshold-like (below this depth even head items are
        missed; above it retrieval is near-exact). Interpolated from the
        measured curve; never extrapolated beyond the measured grid."""
        def floor_of(st: ColumnStats) -> float:
            vals, eks = st.rec_vals, st.rec_eks
            if vals[-1] <= self.theta_hit:
                return float(eks[-1])
            # first crossing, linear interpolation in log-ek space
            return float(np.exp(np.interp(
                self.theta_hit, vals, np.log(np.maximum(eks, 1.0)))))

        floor = float(np.mean([floor_of(self.stats[(c, spec.kind)])
                               for c in spec.vid]))
        w = self._width(spec)
        if w > 0:
            all_floor = floor_of(self.stats[("__all__", spec.kind)])
            floor = max(floor, 1.0) ** (1 - w) * max(all_floor, 1.0) ** w
        return float(np.clip(floor, 1.0, self.n_rows))

    def inflate_ek(self, spec: IndexSpec, rank: np.ndarray) -> np.ndarray:
        """ek required so an item at exact partial-rank ``rank`` is actually
        retrieved by the approximate search: max(rank, reliable_ek)."""
        rank = np.maximum(np.asarray(rank, np.float64), 1.0)
        floor = self.reliable_ek(spec)
        return np.ceil(np.minimum(np.maximum(rank, floor), float(self.n_rows)))


DEFAULT_KINDS = ("hnsw", "diskann", "ivf")


def train_estimators(
    db: MultiVectorDatabase,
    kinds: tuple[str, ...] = DEFAULT_KINDS,
    sample_rate: float = 0.01,
    min_sample_rows: int = 2000,
    n_train_queries: int = 8,
    k: int = 100,
    seed: int = 0,
    device=None,
) -> EstimatorBundle:
    """One-time training (paper Fig. 12: amortized across workloads). The
    sample indexes are built and searched on ``device``."""
    t0 = time.time()
    rate = max(sample_rate, min(1.0, min_sample_rows / db.n_rows))
    sample, _ = db.sample(rate, seed=seed)
    n_s = sample.n_rows
    # grid spans both the k-relative head and the DB-fraction regime
    ek_grid = np.unique(np.clip(np.asarray(
        [k // 2, k, 2 * k, 4 * k, 8 * k, n_s // 64, n_s // 16, n_s // 4]),
        8, max(n_s - 1, 8)))

    scale = db.n_rows / n_s  # fraction-scaling: sample is a miniature DB

    def measure(key, data: np.ndarray, qvecs: list[np.ndarray], kind: str):
        idx = BUILDERS[kind](data, seed=seed, device=device)
        heads = [set(exact_topk(data, qv, k)[0].tolist()) for qv in qvecs]
        xs, nd_ys, rec_ys, head_ys = [], [], [], []
        for ek in ek_grid:
            nds, recs, hds = [], [], []
            for qv, head in zip(qvecs, heads):
                res = idx.search(qv, int(ek))
                exact_ids, _ = exact_topk(data, qv, int(ek))
                got = set(res.ids.tolist())
                inter = len(got & set(exact_ids.tolist()))
                nds.append(res.num_dist)
                recs.append(inter / max(len(exact_ids), 1))
                # head reliability: fraction of the exact top-k retrieved at
                # scan depth ek — drives the planner's ek floor (recall@ek
                # above conflates head hits with deep-tail hits)
                hds.append(len(got & head) / max(len(head), 1))
            xs.append(float(ek))
            nd_ys.append(float(np.mean(nds)))
            rec_ys.append(float(np.mean(recs)))
            head_ys.append(float(np.mean(hds)))
        x_arr = np.asarray(xs)
        nd_arr = np.asarray(nd_ys)
        rec_arr = np.asarray(head_ys)
        paper_rec_arr = np.asarray(rec_ys)
        # Drop saturated points (whole sample scanned) — they corrupt the
        # linear fit; keep at least the three smallest-ek points.
        keep = nd_arr < 0.8 * n_s
        keep[: min(3, len(keep))] = True
        # fraction-scale to full-database coordinates (DESIGN.md §3):
        #   numDist_full(ek·S) ≈ numDist_sample(ek)·S ; recall transfers at
        #   equal database fraction.
        stats[key] = ColumnStats(
            cost=fit_linear(x_arr[keep] * scale, nd_arr[keep] * scale),
            recall=fit_log(x_arr * scale, paper_rec_arr),
            rec_eks=x_arr * scale,
            rec_vals=np.maximum.accumulate(rec_arr),
        )

    stats: dict[tuple, ColumnStats] = {}
    for c in range(db.n_cols):
        train_qs = make_queries(sample, [(c,)] * n_train_queries, k=k, seed=seed + 31 * c)
        for kind in kinds:
            measure((c, kind), sample.columns[c],
                    [q.vectors[c] for q in train_qs], kind)
    if db.n_cols >= 2:
        # one extra all-columns sample index per kind: anchors the
        # multi-column width correction (DESIGN.md — beyond-paper refinement)
        all_vid = tuple(range(db.n_cols))
        all_qs = make_queries(sample, [all_vid] * n_train_queries, k=k, seed=seed + 977)
        for kind in kinds:
            measure(("__all__", kind), sample.concat(all_vid),
                    [q.concat() for q in all_qs], kind)
    return EstimatorBundle(
        stats=stats,
        dims=db.dims,
        n_rows=db.n_rows,
        sample_rate=rate,
        train_seconds=time.time() - t0,
    )


@dataclass
class StorageEstimator:
    """Paper Section 5.1: 'we use the number of indexes as the storage'
    (degree fixed at 16). mode='bytes' uses items × degree × edge size."""

    n_rows: int
    mode: str = "count"
    degree: int = 16
    edge_bytes: int = 4

    def storage(self, config) -> float:
        if self.mode == "count":
            return float(len(config))
        return float(len(config) * self.n_rows * self.degree * self.edge_bytes)
