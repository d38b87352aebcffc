"""Core datatypes for MINT: queries, workloads, index specs, configurations, plans.

Terminology follows the paper (MINT, CS.DB 2025):
  - a *database* has m columns; each cell is a d_i-dim vector (one row = one item)
  - a *query* names a column subset ``vid`` and carries one vector per named column
  - an *index spec* is (vid, kind); a *configuration* is a set of index specs
  - a *query plan* is (X, EK): indexes used + per-index retrieval depth ek_i
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

Vid = tuple[int, ...]

# Tenant namespace handle. Every store/cache/scheduler key that used to be
# implicitly global is namespaced by one of these; "" is the default tenant
# (single-tenant deployments never need to mention it).
TenantId = str
DEFAULT_TENANT: TenantId = ""


def norm_vid(vid: Iterable[int]) -> Vid:
    t = tuple(sorted(set(int(v) for v in vid)))
    if not t:
        raise ValueError("vid must name at least one column")
    return t


@dataclass(frozen=True)
class IndexSpec:
    """A (hypothetical or materialized) ANN index over a column subset."""

    vid: Vid
    kind: str = "hnsw"  # "hnsw" | "diskann" | "ivf" | "flat"

    def __post_init__(self):
        object.__setattr__(self, "vid", norm_vid(self.vid))

    @property
    def name(self) -> str:
        return f"x[{','.join(map(str, self.vid))}]:{self.kind}"

    def covers(self, other_vid: Vid) -> bool:
        """True if this index can help answer a query on ``other_vid``
        (paper rule: index columns must be a subset of the query columns)."""
        return set(self.vid).issubset(set(other_vid))


Configuration = frozenset  # frozenset[IndexSpec]


def config_name(config: Iterable[IndexSpec]) -> str:
    return "{" + ", ".join(sorted(s.name for s in config)) + "}"


@dataclass
class Query:
    """A multi-vector search query on columns ``vid``.

    ``vectors[c]`` is the (d_c,) query vector for column c (c in vid).
    """

    qid: int
    vid: Vid
    vectors: dict[int, np.ndarray]
    k: int = 100
    # optional attribute predicate (filter AST node, hashable).
    # None = pure vector query; set -> results are the top-k over the live
    # rows matching the predicate (DESIGN.md §12).
    predicate: object = None

    def __post_init__(self):
        self.vid = norm_vid(self.vid)
        missing = [c for c in self.vid if c not in self.vectors]
        if missing:
            raise ValueError(f"query {self.qid} missing vectors for columns {missing}")

    def concat(self, vid: Vid | None = None) -> np.ndarray:
        cols = self.vid if vid is None else norm_vid(vid)
        return np.concatenate([np.asarray(self.vectors[c], dtype=np.float32) for c in cols])

    def dim(self, vid: Vid | None = None) -> int:
        cols = self.vid if vid is None else norm_vid(vid)
        return int(sum(np.asarray(self.vectors[c]).shape[-1] for c in cols))

    @property
    def name(self) -> str:
        return f"q[{','.join(map(str, self.vid))}]#{self.qid}"


@dataclass
class Workload:
    """Weighted query workload W = {(q_i, p_i)}."""

    queries: list[Query]
    probs: np.ndarray  # (len(queries),), sums to 1

    def __post_init__(self):
        self.probs = np.asarray(self.probs, dtype=np.float64)
        if len(self.probs) != len(self.queries):
            raise ValueError("probs / queries length mismatch")
        s = self.probs.sum()
        if s <= 0:
            raise ValueError("probabilities must be positive")
        self.probs = self.probs / s

    def __iter__(self):
        return iter(zip(self.queries, self.probs))

    def __len__(self):
        return len(self.queries)

    @property
    def all_vids(self) -> set[Vid]:
        return {q.vid for q in self.queries}


@dataclass
class QueryPlan:
    """(X, EK) for one query, with estimated cost/recall attached."""

    query_qid: int
    indexes: list[IndexSpec]
    eks: list[int]
    est_cost: float
    est_recall: float
    # filtered-search fields (DESIGN.md §12): how to apply the query's
    # predicate — "pre" (gather matching rows, brute force), "masked"
    # (keep_mask composed into the fused scan), or "post" (index probe at
    # 1/selectivity-inflated eks, filter candidates). None for unfiltered
    # plans; ``selectivity`` records the estimate the choice was based on.
    access_path: str | None = None
    selectivity: float | None = None

    def __post_init__(self):
        # Drop unused indexes (ek == 0) — they incur no scan and no rerank.
        kept = [(x, ek) for x, ek in zip(self.indexes, self.eks) if ek > 0]
        self.indexes = [x for x, _ in kept]
        self.eks = [int(ek) for _, ek in kept]

    @property
    def used(self) -> frozenset:
        return frozenset(self.indexes)

    def describe(self) -> str:
        parts = [f"{x.name}: ek={ek}" for x, ek in zip(self.indexes, self.eks)]
        acc = ""
        if self.access_path is not None:
            acc = f", access={self.access_path}@{self.selectivity:.3g}"
        return (
            f"plan(q#{self.query_qid}; {'; '.join(parts) or 'EMPTY'}; "
            f"cost={self.est_cost:.1f}, recall={self.est_recall:.3f}{acc})"
        )


@dataclass
class TuningResult:
    configuration: frozenset
    plans: dict[int, QueryPlan]  # qid -> plan
    est_workload_cost: float
    storage: float
    trace: list[dict] = field(default_factory=list)  # searcher iterations

    def describe(self) -> str:
        lines = [
            f"configuration: {config_name(self.configuration)}",
            f"estimated workload cost: {self.est_workload_cost:.1f}",
            f"storage: {self.storage}",
        ]
        for qid in sorted(self.plans):
            lines.append("  " + self.plans[qid].describe())
        return "\n".join(lines)


@dataclass
class Constraints:
    theta_recall: float = 0.9
    theta_storage: float = 8.0  # number of indexes by default (paper metric)
    storage_mode: str = "count"  # "count" | "bytes"
