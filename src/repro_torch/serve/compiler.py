"""Plan-group compiler (DESIGN.md §Serving).

A batch of (query, plan) pairs compiles into *plan groups*: queries whose
plans have the same signature — same query vid and the same set of
(index spec, ek bucket) pairs — execute together, so each (group, index)
pair costs ONE batched kernel dispatch instead of one per query.

ek bucketing: retrieval depths are padded up to the next power of two
(floor ``MIN_BUCKET``) purely for *dispatch shapes*; every query still
slices its own exact ek from the best-first scan results, so batched
results are identical to the per-query paths. Plans carry only ek > 0
entries by construction, but the compiler filters ek <= 0 defensively —
an unused index must never reach a kernel dispatch (and never enters the
cost accounting).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.types import IndexSpec, Query, QueryPlan, Vid

MIN_BUCKET = 16


def ek_bucket(ek: int) -> int:
    """Next power of two >= ek (>= MIN_BUCKET): the padded dispatch depth."""
    if ek <= 0:
        return 0
    b = MIN_BUCKET
    while b < ek:
        b <<= 1
    return b


@dataclass(frozen=True)
class GroupKey:
    """Plan signature: query vid + sorted ((spec, ek bucket), ...) pairs.
    An empty signature is the flat-scan fallback group for that vid.

    Filtered queries (DESIGN.md §12) additionally group by predicate and
    access path: the keep bitmap is a shared (1, N) kernel operand per
    launch, so a group must be predicate-uniform. Predicate AST nodes are
    frozen/hashable, so they key directly."""

    vid: Vid
    signature: tuple  # tuple[(IndexSpec, int), ...]
    pred: object = None          # query.predicate (None = unfiltered)
    access: str | None = None    # plan.access_path for filtered groups


@dataclass
class GroupItem:
    pos: int            # position in the input batch (output order)
    query: Query
    plan: QueryPlan
    eks: list[int]      # actual per-index depths, aligned with group specs


@dataclass
class PlanGroup:
    key: GroupKey
    items: list[GroupItem] = field(default_factory=list)

    @property
    def specs(self) -> list[IndexSpec]:
        return [spec for spec, _ in self.key.signature]

    @property
    def buckets(self) -> list[int]:
        return [bucket for _, bucket in self.key.signature]

    @property
    def batch(self) -> int:
        return len(self.items)

    @property
    def max_k(self) -> int:
        return max(item.query.k for item in self.items)

    @property
    def single_exact(self) -> bool:
        """One index covering exactly the query vid: its partial score IS the
        full score, so the scan output is final — no rerank (planner fast
        path, ``planner._plan_cost``)."""
        specs = self.specs
        return len(specs) == 1 and specs[0].vid == self.key.vid


def _signature(query: Query, plan: QueryPlan) -> tuple[GroupKey, list[int]]:
    used = [(spec, int(ek)) for spec, ek in zip(plan.indexes, plan.eks) if ek > 0]
    used.sort(key=lambda se: (se[0].vid, se[0].kind))
    pred = getattr(query, "predicate", None)
    access = plan.access_path if pred is not None else None
    key = GroupKey(vid=query.vid,
                   signature=tuple((spec, ek_bucket(ek)) for spec, ek in used),
                   pred=pred, access=access)
    return key, [ek for _, ek in used]


def compile_batch(pairs: list[tuple[Query, QueryPlan]]) -> list[PlanGroup]:
    """Group (query, plan) pairs by plan signature, preserving batch order
    inside each group. len(groups) * |signature| = total scan dispatches."""
    groups: dict[GroupKey, PlanGroup] = {}
    for pos, (query, plan) in enumerate(pairs):
        key, eks = _signature(query, plan)
        if key not in groups:
            groups[key] = PlanGroup(key=key)
        groups[key].items.append(GroupItem(pos=pos, query=query, plan=plan, eks=eks))
    return list(groups.values())


BATCHABLE_KINDS = ("flat", "ivf")  # graph walks execute per query


def dispatch_plan(groups: list[PlanGroup],
                  batchable: tuple[str, ...] | None = BATCHABLE_KINDS) -> dict:
    """Dispatch accounting for a compiled batch (vs the per-query paths).

    A (group, index) pair costs one batched dispatch only for kinds the
    engine can batch; graph kinds (hnsw/diskann) still cost one search per
    query. Pass ``batchable=None`` for a storeless engine, which serves
    every planned index as a batched flat scan. Both sides count only
    ek > 0 indexes (the compiler filters them)."""
    n_queries = sum(g.batch for g in groups)
    batched = 0
    for g in groups:
        if not g.specs:
            batched += 1  # flat-scan fallback group
            continue
        for spec in g.specs:
            if batchable is None or spec.kind in batchable:
                batched += 1
            else:
                batched += g.batch
    per_query = sum(max(len(item.eks), 1)
                    for g in groups for item in g.items)
    return {"queries": n_queries, "groups": len(groups),
            "batched_scan_dispatches": batched,
            "per_query_scan_dispatches": per_query}
