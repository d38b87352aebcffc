"""Configuration Searcher (paper Section 4) — beam search, Algorithm 3.

NP-hard (Theorem 2, Densest-g-Subgraph reduction). The beam search:

  1. Candidates: for each query q, indexes x with x.vid ⊆ q.vid and
     |x.vid| ≥ |q.vid| − di  (di = 2 default).
  2. Seeds: per-query candidate subsets with ≤ se indexes (se = 2).
  3. Keep the b best feasible configurations; then repeatedly try adding one
     candidate index to each beam member, re-planning all queries (what-if
     calls), dropping unused indexes, until improvement < im (5%).

Plan caching (paper Section 4.2): plans are cached keyed by
(qid, frozenset(useful indexes)) so repeated what-if calls are free.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass


from repro_torch.core.estimators import StorageEstimator
from repro_torch.core.planner import QueryPlanner
from repro_torch.core.types import (Constraints, IndexSpec, Query, QueryPlan,
                              TuningResult, Workload, norm_vid)


@dataclass
class BeamSearchParams:
    di: int = 2            # subset difference (candidate index width)
    se: int = 2            # seed configuration size limit
    beam_width: int = 4    # b
    improvement: float = 0.05  # im — stop when relative gain below this
    max_iters: int = 16
    index_kind: str = "hnsw"


class ConfigurationSearcher:
    def __init__(self, planner: QueryPlanner, workload: Workload,
                 constraints: Constraints, params: BeamSearchParams | None = None,
                 extra_seeds: list[frozenset] | None = None):
        self.planner = planner
        self.workload = workload
        self.constraints = constraints
        self.params = params or BeamSearchParams()
        # warm-start seeds (online retune: the currently serving config)
        self.extra_seeds = list(extra_seeds or [])
        self.storage_est = StorageEstimator(
            n_rows=planner.estimators.n_rows, mode=constraints.storage_mode)
        self._plan_cache: dict[tuple[int, frozenset], QueryPlan] = {}
        self.what_if_calls = 0
        self.cache_hits = 0

    # ---- candidate generation (Alg 3 lines 1-3) ----
    def candidates_for(self, query: Query) -> list[IndexSpec]:
        vid = query.vid
        lo = max(1, len(vid) - self.params.di)
        out = []
        for r in range(lo, len(vid) + 1):
            for sub in itertools.combinations(vid, r):
                out.append(IndexSpec(vid=norm_vid(sub), kind=self.params.index_kind))
        return out

    def all_candidates(self) -> list[IndexSpec]:
        seen: dict[IndexSpec, None] = {}
        for q in self.workload.queries:
            for x in self.candidates_for(q):
                seen[x] = None
        return list(seen)

    def seeds(self) -> list[frozenset]:
        out: dict[frozenset, None] = {}
        for seed in self.extra_seeds:
            out[frozenset(seed)] = None
        for q in self.workload.queries:
            cands = self.candidates_for(q)
            for r in range(1, self.params.se + 1):
                for sub in itertools.combinations(cands, r):
                    out[frozenset(sub)] = None
        return list(out)

    # ---- what-if planning with cache (Sec 4.2 optimization) ----
    def plan(self, query: Query, config: frozenset) -> QueryPlan:
        useful = frozenset(x for x in config if x.covers(query.vid))
        key = (query.qid, useful)
        if key in self._plan_cache:
            self.cache_hits += 1
            return self._plan_cache[key]
        self.what_if_calls += 1
        plan = self.planner.plan(query, useful)
        self._plan_cache[key] = plan
        return plan

    def evaluate(self, config: frozenset) -> tuple[float, dict[int, QueryPlan], bool]:
        """Workload cost (Formula 1), plans, and feasibility (2)+(3)."""
        cost = 0.0
        plans: dict[int, QueryPlan] = {}
        feasible = self.storage_est.storage(config) <= self.constraints.theta_storage
        for q, p in self.workload:
            plan = self.plan(q, config)
            plans[q.qid] = plan
            cost += p * plan.est_cost
            if plan.est_recall < self.constraints.theta_recall - 1e-9:
                feasible = False
        return cost, plans, feasible

    @staticmethod
    def prune_unused(config: frozenset, plans: dict[int, QueryPlan]) -> frozenset:
        used = set()
        for plan in plans.values():
            used.update(plan.indexes)
        return frozenset(x for x in config if x in used)

    def search_at_budget(self, theta_storage: float,
                         warm: frozenset | None = None) -> TuningResult:
        """Re-run the beam search under a different storage budget, reusing
        this searcher's what-if plan cache — plans are keyed by (qid, useful
        indexes), which is budget-independent, so walking a budget LADDER
        (the joint cross-tenant tuner's inner loop) pays the planner only
        for configurations no previous rung explored. ``warm`` (typically
        the previous rung's configuration) is added to the seed set."""
        saved = self.constraints
        saved_seeds = list(self.extra_seeds)
        self.constraints = dataclasses.replace(saved,
                                               theta_storage=theta_storage)
        if warm:
            self.extra_seeds.append(frozenset(warm))
        try:
            return self.search()
        finally:  # rung-local: budget AND warm seed must not leak out
            self.constraints = saved
            self.extra_seeds = saved_seeds

    def is_feasible(self, result: TuningResult,
                    theta_storage: float | None = None) -> bool:
        """Recall + storage feasibility of a finished result (the searcher
        returns the best INFEASIBLE configuration when nothing feasible
        exists, so ladder consumers must check). ``theta_storage`` overrides
        the searcher's own budget (ladder rungs differ per call)."""
        budget = (self.constraints.theta_storage if theta_storage is None
                  else theta_storage)
        if result.storage > budget + 1e-9:
            return False
        return all(p.est_recall >= self.constraints.theta_recall - 1e-9
                   for p in result.plans.values())

    # ---- Algorithm 3 main loop ----
    def search(self) -> TuningResult:
        t0 = time.time()
        params = self.params
        candidates = self.all_candidates()
        trace: list[dict] = []

        scored: list[tuple[float, frozenset, dict, bool]] = []
        for seed in self.seeds():
            cost, plans, feasible = self.evaluate(seed)
            seed = self.prune_unused(seed, plans)
            scored.append((cost, seed, plans, feasible))
        scored.sort(key=lambda t: (not t[3], t[0]))
        feasible_seeds = [s for s in scored if s[3]]
        beam = (feasible_seeds or scored)[: params.beam_width]
        best_cost, best_config, best_plans, _ = beam[0]
        trace.append({"iter": 0, "best_cost": best_cost,
                      "beam": [len(b[1]) for b in beam],
                      "elapsed_s": time.time() - t0})

        for it in range(1, params.max_iters + 1):
            expanded: dict[frozenset, tuple[float, dict, bool]] = {}
            for _, config, _, _ in beam:
                for x in candidates:
                    if x in config:
                        continue
                    cfg = frozenset(config | {x})
                    if self.storage_est.storage(cfg) > self.constraints.theta_storage:
                        continue
                    if cfg in expanded:
                        continue
                    cost, plans, feasible = self.evaluate(cfg)
                    cfg2 = self.prune_unused(cfg, plans)
                    expanded[cfg2] = (cost, plans, feasible)
            if not expanded:
                break
            ranked = sorted(expanded.items(), key=lambda kv: (not kv[1][2], kv[1][0]))
            beam = [(cost, cfg, plans, feas)
                    for cfg, (cost, plans, feas) in ranked[: params.beam_width]]
            improved = False
            top_cost, top_cfg, top_plans, top_feas = beam[0]
            if top_feas and top_cost < best_cost * (1 - 1e-12):
                gain = (best_cost - top_cost) / max(best_cost, 1e-9)
                best_cost, best_config, best_plans = top_cost, top_cfg, top_plans
                improved = gain > params.improvement
            trace.append({"iter": it, "best_cost": best_cost,
                          "beam": [len(b[1]) for b in beam],
                          "elapsed_s": time.time() - t0})
            if not improved:
                break

        return TuningResult(
            configuration=best_config,
            plans=best_plans,
            est_workload_cost=best_cost,
            storage=self.storage_est.storage(best_config),
            trace=trace,
        )
