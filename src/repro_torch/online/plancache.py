"""Plan cache: the planner off the serving hot path (DESIGN.md §7, §8).

``QueryPlanner.plan`` builds a ``WhatIfContext`` per query — an exact
full-database ground truth plus per-index rank scans — which is fine at
tuning time but far too slow per request. The cache templates planner
output by *plan key*: (tenant, query vid, k, constraints fingerprint,
generation). Two queries on the same columns at the same k get the same
(X, EK) template; only the first pays the planner.

Tenancy: keys carry a ``TenantId`` namespace and generations are
PER-TENANT — a tenant's re-tune bumps only its own generation and drops
only its own templates, so one tenant's swap never invalidates another's
plans. Each tenant can register its own constraints fingerprint (tenants
tune under different recall/storage targets).

Capacity: high query-vector cardinality (many distinct (vid, k) pairs)
used to grow the template map without limit; ``capacity`` bounds it with
LRU eviction, and evictions are reported alongside the hit rate.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from repro_torch.core.types import (DEFAULT_TENANT, Constraints, IndexSpec, Query,
                              QueryPlan, TenantId, TuningResult, Vid, Workload)


@dataclass(frozen=True)
class PlanKey:
    vid: Vid
    k: int
    constraints: tuple  # constraints_fingerprint(...)
    generation: int
    tenant: TenantId = DEFAULT_TENANT
    # predicate AST node (frozen/hashable) — filtered queries must not
    # share templates with unfiltered ones or with other predicates, since
    # access path and inflated eks depend on the predicate's selectivity
    pred: object = None


@dataclass
class PlanTemplate:
    """A reusable (X, EK) shape: instantiate() stamps it with a qid."""

    indexes: list[IndexSpec]
    eks: list[int]
    est_cost: float
    est_recall: float
    access_path: str | None = None
    selectivity: float | None = None

    @classmethod
    def from_plan(cls, plan: QueryPlan) -> "PlanTemplate":
        return cls(indexes=list(plan.indexes), eks=list(plan.eks),
                   est_cost=plan.est_cost, est_recall=plan.est_recall,
                   access_path=plan.access_path,
                   selectivity=plan.selectivity)

    def instantiate(self, query: Query) -> QueryPlan:
        return QueryPlan(query_qid=query.qid, indexes=list(self.indexes),
                         eks=list(self.eks), est_cost=self.est_cost,
                         est_recall=self.est_recall,
                         access_path=self.access_path,
                         selectivity=self.selectivity)


def constraints_fingerprint(constraints: Constraints) -> tuple:
    return (round(constraints.theta_recall, 6), constraints.theta_storage,
            constraints.storage_mode)


@dataclass
class PlanCache:
    """Tenant-namespaced, generation-keyed template store with hit/miss/
    eviction accounting and an optional LRU capacity bound."""

    constraints: tuple = ()      # default tenant's fingerprint
    capacity: int | None = None  # max templates (None = unbounded)
    generation: int = 0          # default tenant's generation
    hits: int = 0
    misses: int = 0
    swaps: int = 0
    evictions: int = 0
    _entries: OrderedDict = field(default_factory=OrderedDict)
    _tenant_gen: dict = field(default_factory=dict)  # TenantId -> generation
    _tenant_fp: dict = field(default_factory=dict)   # TenantId -> fingerprint

    def __post_init__(self):
        if self.capacity is not None and self.capacity < 1:
            raise ValueError("capacity must be >= 1 (or None for unbounded)")

    # ---- tenancy ----------------------------------------------------------

    def register_tenant(self, tenant: TenantId, constraints: tuple) -> None:
        """Record a tenant's constraints fingerprint (its keys embed it, so
        tenants with different recall targets can never share a template)."""
        self._tenant_fp[tenant] = tuple(constraints)
        self._tenant_gen.setdefault(tenant, 0)

    def generation_of(self, tenant: TenantId = DEFAULT_TENANT) -> int:
        if tenant == DEFAULT_TENANT:
            return self.generation
        return self._tenant_gen.get(tenant, 0)

    def _fingerprint(self, tenant: TenantId) -> tuple:
        if tenant == DEFAULT_TENANT:
            return self.constraints
        return self._tenant_fp.get(tenant, self.constraints)

    # ---- hot path ---------------------------------------------------------

    def key(self, query: Query, tenant: TenantId = DEFAULT_TENANT) -> PlanKey:
        return PlanKey(vid=query.vid, k=query.k,
                       constraints=self._fingerprint(tenant),
                       generation=self.generation_of(tenant), tenant=tenant,
                       pred=getattr(query, "predicate", None))

    def get(self, query: Query,
            tenant: TenantId = DEFAULT_TENANT) -> QueryPlan | None:
        k = self.key(query, tenant)
        tpl = self._entries.get(k)
        if tpl is None:
            self.misses += 1
            return None
        self._entries.move_to_end(k)  # LRU refresh
        self.hits += 1
        return tpl.instantiate(query)

    def peek(self, query: Query,
             tenant: TenantId = DEFAULT_TENANT) -> QueryPlan | None:
        """Like get() but without touching the hit/miss counters or LRU
        order — for introspection (e.g. the re-tuner's stale-cost probe)
        that must not pollute the serving metrics."""
        tpl = self._entries.get(self.key(query, tenant))
        return None if tpl is None else tpl.instantiate(query)

    def put(self, query: Query, plan: QueryPlan,
            tenant: TenantId = DEFAULT_TENANT) -> None:
        self._insert(self.key(query, tenant), PlanTemplate.from_plan(plan))

    def seed(self, workload: Workload, result: TuningResult,
             tenant: TenantId = DEFAULT_TENANT) -> int:
        """Template the tuning result's plans by vid (first writer per key
        wins — later queries of the same vid share one template)."""
        n = 0
        for q in workload.queries:
            plan = result.plans.get(q.qid)
            if plan is None:
                continue
            k = self.key(q, tenant)
            if k not in self._entries:
                self._insert(k, PlanTemplate.from_plan(plan))
                n += 1
        return n

    def _insert(self, key: PlanKey, tpl: PlanTemplate) -> None:
        self._entries[key] = tpl
        self._entries.move_to_end(key)
        if self.capacity is not None:
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)  # coldest template
                self.evictions += 1

    # ---- swap handle ------------------------------------------------------

    def bump_generation(self, tenant: TenantId = DEFAULT_TENANT) -> int:
        """Invalidate ONE tenant's templates (atomic-swap handle): its
        entries belong to older generations, so drop them — other tenants'
        templates, keyed under their own generations, are untouched."""
        if tenant == DEFAULT_TENANT:
            self.generation += 1
            gen = self.generation
        else:
            gen = self._tenant_gen.get(tenant, 0) + 1
            self._tenant_gen[tenant] = gen
        self.swaps += 1
        for k in [k for k in self._entries if k.tenant == tenant]:
            del self._entries[k]
        return gen

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_counters(self) -> None:
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "entries": len(self._entries),
                "capacity": self.capacity, "evictions": self.evictions,
                "generation": self.generation, "swaps": self.swaps,
                "tenant_generations": dict(sorted(self._tenant_gen.items()))}
