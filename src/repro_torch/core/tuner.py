"""MINT facade (paper Fig. 1) + baselines (PerColumn / PerQuery) + the
real-execution evaluation harness used by the benchmarks.

The tuner works entirely on *hypothetical* indexes (estimator sample); the
``execute_*`` functions below materialize real indexes and measure actual
cost (numDist × dim, the paper's latency proxy), wall time, and true recall
against full-database ground truth.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.estimators import (EstimatorBundle, StorageEstimator,
                                   train_estimators)
from repro_torch.core.planner import QueryPlanner
from repro_torch.core.searcher import BeamSearchParams, ConfigurationSearcher
from repro_torch.core.types import (Constraints, IndexSpec, Query, QueryPlan,
                              TenantId, TuningResult, Workload)
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.base import exact_topk
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device


@dataclass
class Mint:
    """Index tuner: train estimators once per database, then tune workloads."""

    db: MultiVectorDatabase
    index_kind: str = "hnsw"
    seed: int = 0
    sample_rate: float = 0.01
    min_sample_rows: int = 2000
    estimators: EstimatorBundle | None = None
    # filtered search (DESIGN.md §12): optional AttributeStore keyed by the
    # table's stable ids. When set, planners get a sampled selectivity
    # estimator, filtered workload queries cost out their access paths
    # (pre/masked/post), and tune() therefore shifts index choice with the
    # workload's filter distribution — heavily filtered traffic plans to
    # pre-filter gathers, which need no index at all.
    attributes: object = None
    filter_sample: int = 512
    # where the sample indexes are built and searched: None means the CUDA
    # card (raises without one); "cpu" runs the plain versions
    device: object = None
    _sample: MultiVectorDatabase | None = None
    _selest: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def train(self) -> EstimatorBundle:
        if self.estimators is None:
            self.estimators = train_estimators(
                self.db, kinds=(self.index_kind,),
                sample_rate=self.sample_rate,
                min_sample_rows=self.min_sample_rows, seed=self.seed,
                device=self.device)
            self._sample, _ = self.db.sample(self.estimators.sample_rate,
                                             seed=self.seed)
        return self.estimators

    def selectivity_estimator(self, ids=None):
        """Sampled selectivity estimator over the attribute store (None
        when no attributes are attached). Shared across planners so the
        per-predicate cache amortizes. ``ids`` overrides the sampled id
        population (default: the base row ids 0..n-1) — post-compaction
        callers pass the live STABLE ids, which are no longer a range."""
        if self.attributes is None:
            return None
        if self._selest is None:
            from repro_torch.filter.selectivity import SelectivityEstimator
            self._selest = SelectivityEstimator(
                self.attributes,
                np.arange(self.db.n_rows) if ids is None else ids,
                sample_size=self.filter_sample, seed=self.seed)
        elif ids is not None:
            self._selest.refresh(ids)
        return self._selest

    def planner(self, constraints: Constraints) -> QueryPlanner:
        self.train()
        return QueryPlanner(estimators=self.estimators, database=self.db,
                            theta_recall=constraints.theta_recall,
                            seed=self.seed, attributes=self.attributes,
                            selectivity=self.selectivity_estimator(),
                            dp_device=self.device)

    def tune(self, workload: Workload, constraints: Constraints,
             params: BeamSearchParams | None = None,
             warm_start: TuningResult | None = None) -> TuningResult:
        params = params or BeamSearchParams(index_kind=self.index_kind)
        params.index_kind = self.index_kind
        planner = self.planner(constraints)
        extra = ([frozenset(warm_start.configuration)]
                 if warm_start is not None and warm_start.configuration else [])
        searcher = ConfigurationSearcher(planner, workload, constraints, params,
                                         extra_seeds=extra)
        result = searcher.search()
        result.trace.append({"what_if_calls": searcher.what_if_calls,
                             "cache_hits": searcher.cache_hits,
                             "train_seconds": self.estimators.train_seconds,
                             "warm_start": warm_start is not None})
        return result

    def retune(self, workload: Workload, constraints: Constraints,
               params: BeamSearchParams | None = None,
               warm_start: TuningResult | None = None) -> TuningResult:
        """Incremental re-tune for the online runtime: estimators are
        reused (same database), and the beam search is warm-started by
        seeding it with the currently serving configuration — the search
        starts from the serving state instead of from scratch, so a small
        drift converges in very few iterations while a large one can still
        walk to a different configuration."""
        return self.tune(workload, constraints, params=params,
                         warm_start=warm_start)

    # ---- baselines (paper Section 5.1 'Approaches') ----
    def per_column(self, workload: Workload, constraints: Constraints) -> TuningResult:
        """One index per column; each query planned over its columns' indexes."""
        cols = sorted({c for q in workload.queries for c in q.vid})
        config = frozenset(IndexSpec(vid=(c,), kind=self.index_kind) for c in cols)
        return self._fixed_config_result(config, workload, constraints)

    def per_query(self, workload: Workload, constraints: Constraints) -> TuningResult:
        """One exact-vid index per distinct query column set (latency lower
        bound; violates storage in the paper's workloads)."""
        config = frozenset(IndexSpec(vid=q.vid, kind=self.index_kind)
                           for q in workload.queries)
        return self._fixed_config_result(config, workload, constraints)

    def _fixed_config_result(self, config: frozenset, workload: Workload,
                             constraints: Constraints) -> TuningResult:
        planner = self.planner(constraints)
        cost = 0.0
        plans = {}
        for q, p in workload:
            plan = planner.plan(q, config)
            plans[q.qid] = plan
            cost += p * plan.est_cost
        storage = StorageEstimator(self.db.n_rows, constraints.storage_mode).storage(config)
        return TuningResult(configuration=config, plans=plans,
                            est_workload_cost=cost, storage=storage)


# --------------------------------------------------------------------------
# Joint cross-tenant tuning: one storage budget, many workloads
# --------------------------------------------------------------------------


@dataclass
class TenantTask:
    """One tenant's tuning inputs for ``tune_tenants``. ``constraints``
    carries the tenant's recall target and storage mode; its
    ``theta_storage`` acts as a per-tenant CAP on what the allocator may
    hand this tenant (<= the global budget). ``weight`` is the tenant's
    traffic share in the aggregate objective."""

    mint: Mint
    workload: Workload
    constraints: Constraints
    weight: float = 1.0
    warm_start: TuningResult | None = None


@dataclass
class JointTuningResult:
    """Per-tenant allocations + tuning results under one global budget."""

    allocations: dict[TenantId, int]          # storage units per tenant
    results: dict[TenantId, TuningResult]
    total_cost: float                         # Σ weight · est_workload_cost
    total_storage: float
    feasible: bool                            # every tenant recall-feasible
    curves: dict[TenantId, dict[int, float]]  # budget -> est cost (inf = infeasible)
    trace: list[dict] = field(default_factory=list)

    def describe(self) -> str:
        lines = [f"joint tuning: total_cost={self.total_cost:.1f} "
                 f"storage={self.total_storage} feasible={self.feasible}"]
        for t in sorted(self.allocations):
            r = self.results[t]
            lines.append(f"  {t}: budget={self.allocations[t]} "
                         f"cost={r.est_workload_cost:.1f} "
                         f"|config|={len(r.configuration)}")
        return "\n".join(lines)


def tune_tenants(tenants: dict[TenantId, TenantTask], global_storage: int,
                 params: BeamSearchParams | None = None,
                 equal_split: bool = False) -> JointTuningResult:
    """Split one global storage budget across tenants (paper constraint (3)
    applied to a SHARED device): per tenant, walk a budget ladder with the
    beam search — each rung warm-started from the previous rung's winner
    via ``ConfigurationSearcher(extra_seeds=...)``, what-if plan cache
    shared across rungs — then allocate units by GREEDY KNAPSACK on the
    marginal cost drop: every tenant starts at its cheapest feasible rung
    and each remaining unit goes to the tenant whose next rung buys the
    largest weighted cost reduction. ``equal_split=True`` skips the greedy
    step and gives every tenant ``global_storage // n`` units (the baseline
    the tenant benchmark compares against).

    Budgets are in the tenants' storage units ("count" mode: number of
    indexes). Tenants whose minimum feasible rung cannot fit the remaining
    budget are still assigned their best rung; the result's ``feasible``
    flag reports whether every tenant met recall within its allocation."""
    if not tenants:
        raise ValueError("tune_tenants needs at least one tenant")
    budget = int(global_storage)
    if budget < len(tenants):
        raise ValueError(f"global storage {budget} cannot give each of "
                         f"{len(tenants)} tenants one unit")

    curves: dict[TenantId, dict[int, float]] = {}
    ladders: dict[TenantId, dict[int, TuningResult]] = {}
    caps: dict[TenantId, int] = {}
    trace: list[dict] = []
    for name, task in sorted(tenants.items()):
        # per-tenant copy with the kind the tenant's estimators were trained
        # on (same guard as Mint.tune) — tenants may use different kinds
        p = replace(params or BeamSearchParams(),
                    index_kind=task.mint.index_kind)
        planner = task.mint.planner(task.constraints)
        seeds = ([frozenset(task.warm_start.configuration)]
                 if task.warm_start is not None
                 and task.warm_start.configuration else [])
        searcher = ConfigurationSearcher(planner, task.workload,
                                         task.constraints, p,
                                         extra_seeds=seeds)
        cap = min(budget, int(task.constraints.theta_storage))
        caps[name] = max(cap, 1)
        curve: dict[int, float] = {}
        ladder: dict[int, TuningResult] = {}
        prev: frozenset | None = None
        for b in range(1, caps[name] + 1):
            result = searcher.search_at_budget(float(b), warm=prev)
            ladder[b] = result
            feasible = searcher.is_feasible(result, theta_storage=float(b))
            curve[b] = result.est_workload_cost if feasible else float("inf")
            prev = result.configuration or prev
        # the ladder is monotone in principle (more budget never hurts) but
        # the beam is heuristic — enforce it so greedy gains are >= 0
        for b in range(2, caps[name] + 1):
            if curve[b] > curve[b - 1]:
                curve[b], ladder[b] = curve[b - 1], ladder[b - 1]
        curves[name] = curve
        ladders[name] = ladder
        trace.append({"tenant": name, "cap": caps[name],
                      "what_if_calls": searcher.what_if_calls,
                      "cache_hits": searcher.cache_hits})

    names = sorted(tenants)
    if equal_split:
        share = budget // len(names)
        extra = budget - share * len(names)
        alloc = {}
        for i, name in enumerate(names):
            alloc[name] = min(max(share + (1 if i < extra else 0), 1),
                              caps[name])
    else:
        # start every tenant at its cheapest FEASIBLE rung (or rung 1)
        alloc = {}
        for name in names:
            feas = [b for b, c in curves[name].items() if np.isfinite(c)]
            alloc[name] = min(feas) if feas else 1
        # if the cheapest-feasible starts overflow the budget, walk back the
        # least-damaging rungs until the global constraint holds (the
        # squeezed tenants' infeasibility is reported via ``feasible``)
        while sum(alloc.values()) > budget:
            def pain(n: TenantId) -> float:
                lo = curves[n][alloc[n] - 1]
                if not np.isfinite(lo):
                    return float("inf")  # stepping down loses feasibility
                return (lo - curves[n][alloc[n]]) * tenants[n].weight
            alloc[min((n for n in names if alloc[n] > 1), key=pain)] -= 1
        remaining = budget - sum(alloc.values())
        while remaining > 0:
            best, best_gain = None, 0.0
            for name in names:
                b = alloc[name]
                if b + 1 > caps[name]:
                    continue
                lo = curves[name][b + 1]
                hi = curves[name][b]
                if not np.isfinite(lo):
                    continue
                gain = ((hi - lo) if np.isfinite(hi) else float("inf"))
                gain *= tenants[name].weight
                if gain > best_gain:
                    best, best_gain = name, gain
            if best is None:
                break  # no tenant can convert another unit into cost
            alloc[best] += 1
            remaining -= 1

    results = {name: ladders[name][alloc[name]] for name in names}
    feasible = all(np.isfinite(curves[name][alloc[name]]) for name in names)
    total_cost = float(sum(tenants[n].weight * results[n].est_workload_cost
                           for n in names))
    total_storage = float(sum(r.storage for r in results.values()))
    trace.append({"mode": "equal_split" if equal_split else "greedy",
                  "allocations": dict(alloc), "budget": budget})
    return JointTuningResult(allocations=alloc, results=results,
                             total_cost=total_cost,
                             total_storage=total_storage,
                             feasible=feasible, curves=curves, trace=trace)


# --------------------------------------------------------------------------
# Real execution (materialized indexes) — measurement harness
# --------------------------------------------------------------------------


@dataclass
class ExecutionMetrics:
    qid: int
    cost: float          # dim-weighted distance computations (paper proxy)
    wall_ms: float
    recall: float        # vs full-DB exact ground truth
    num_dist: int
    eks: dict[str, int] = field(default_factory=dict)
    ids: np.ndarray | None = None  # retrieved top-k item ids


def execute_plan(db: MultiVectorDatabase, store: IndexStore, query: Query,
                 plan: QueryPlan, gt_ids: np.ndarray | None = None,
                 cstore=None) -> ExecutionMetrics:
    """Per-query CPU reference: per-index scans, then full-score rerank
    (Eq. 4-6 accounting), and measure true recall@k. Batched serving goes
    through ``serve.engine.BatchEngine`` (same accounting); this
    path stays as the numpy oracle the batched engine is tested against.
    ``cstore`` (a ``serve.columnstore.ColumnStore``) caches the per-vid
    concats instead of rebuilding them per call."""
    if getattr(query, "predicate", None) is not None:
        raise NotImplementedError(
            "filtered queries execute through serve.engine.BatchEngine "
            "(attach_filters) — this per-query oracle is unfiltered")
    t0 = time.time()
    k = query.k
    concat = cstore.host if cstore is not None else db.concat
    if gt_ids is None:
        gt_ids, _ = exact_topk(concat(query.vid), query.concat(), k)
    gt = set(int(i) for i in gt_ids)

    # unused (ek == 0) indexes incur no scan, no rerank, no cost — the same
    # filtering the planner's _plan_cost applies
    used = [(x, int(ek)) for x, ek in zip(plan.indexes, plan.eks) if ek > 0]

    if not used:  # flat scan fallback
        ids, _ = exact_topk(concat(query.vid), query.concat(), k)
        wall = (time.time() - t0) * 1e3
        cost = query.dim() * db.n_rows
        rec = len(gt & set(int(i) for i in ids)) / max(len(gt), 1)
        return ExecutionMetrics(query.qid, cost, wall, rec, db.n_rows, {}, ids=ids)

    cand: list[np.ndarray] = []
    cost = 0.0
    num_dist = 0
    eks = {}
    for spec, ek in used:
        idx = store.get(spec)
        res = idx.search(query.concat(spec.vid), ek)
        cand.append(res.ids)
        cost += idx.dim * res.num_dist
        num_dist += res.num_dist
        eks[spec.name] = ek

    single_exact = len(used) == 1 and used[0][0].vid == query.vid
    if single_exact:
        ids = cand[0][:k]
    else:
        # rerank: full score over union (cost counts duplicates — Eq. 6)
        total_ek = int(sum(ek for _, ek in used))
        cost += query.dim() * total_ek
        num_dist += total_ek
        union = np.unique(np.concatenate(cand))
        scores = concat(query.vid)[union] @ query.concat()
        top = np.argsort(-scores, kind="stable")[:k]
        ids = union[top]
    wall = (time.time() - t0) * 1e3
    rec = len(gt & set(int(i) for i in ids)) / max(len(gt), 1)
    return ExecutionMetrics(query.qid, cost, wall, rec, num_dist, eks, ids=ids)


@dataclass
class WorkloadMetrics:
    per_query: list[ExecutionMetrics]
    weighted_cost: float
    weighted_wall_ms: float
    min_recall: float
    mean_recall: float
    storage: float


def execute_workload(db: MultiVectorDatabase, store: IndexStore,
                     workload: Workload, result: TuningResult,
                     gt_cache: dict[int, np.ndarray] | None = None,
                     batched: bool = True, engine=None) -> WorkloadMetrics:
    """Execute every plan in the workload. The default path compiles the
    batch into plan groups and runs it on the batched serving engine
    (``serve.engine``); ``batched=False`` keeps the per-query numpy
    reference loop for comparison / benchmarking."""
    if batched:
        from repro_torch.serve.engine import BatchEngine  # core<->serve: lazy
        eng = engine or BatchEngine(db, store=store)
        return eng.execute_workload(workload, result, gt_cache=gt_cache)

    from repro_torch.serve.columnstore import ColumnStore
    cstore = ColumnStore(db, device="cpu")  # host concats only
    per_query = []
    wc = 0.0
    ww = 0.0
    for q, p in workload:
        gt = None if gt_cache is None else gt_cache.get(q.qid)
        m = execute_plan(db, store, q, result.plans[q.qid], gt_ids=gt,
                         cstore=cstore)
        per_query.append(m)
        wc += p * m.cost
        ww += p * m.wall_ms
    recalls = [m.recall for m in per_query]
    return WorkloadMetrics(
        per_query=per_query, weighted_cost=wc, weighted_wall_ms=ww,
        min_recall=min(recalls), mean_recall=float(np.mean(recalls)),
        storage=result.storage)


def ground_truth_cache(db: MultiVectorDatabase, workload: Workload) -> dict[int, np.ndarray]:
    out = {}
    for q, _ in workload:
        ids, _ = exact_topk(db.concat(q.vid), q.concat(), q.k)
        out[q.qid] = ids
    return out
