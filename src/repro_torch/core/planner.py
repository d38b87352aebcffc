"""Query Planner (paper Section 3).

Given a query q and a configuration X, find (X_used, EK) minimizing

    cost_plan = Σ_i dim(x_i)·numDist(q, x_i, ek_i)  +  dim(q)·Σ_i ek_i   (Eq. 4-6)

subject to coverage-recall ≥ θ_recall (Eq. 7). The problem is NP-hard
(Theorem 1, Set-Cover reduction); MINT solves it with

  * Algorithm 1 (Search) — relevant-ek grid enumeration with the
    monotone last-index optimization; used when |X| ≤ 3;
  * Algorithm 2 (DP) — bitmask dynamic programming over a sampled ground
    truth of size k' (default 5), several samples; used when |X| > 3.

What-if machinery: relevant eks come from the *estimator sample* — for each
tuning-time ground-truth item (exact top-k on the sample by full score), its
exact rank in each candidate index's partial-score ordering, inflated by the
fitted ANN recall curve (``EstimatorBundle.inflate_ek``). See DESIGN.md for
the scale-free-rank argument and the exact-match special case the paper's
case study exhibits (single exact-vid index plans skip the rerank term).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.estimators import EstimatorBundle
from repro_torch.core.types import IndexSpec, Query, QueryPlan, Vid
from repro_torch.data.vectors import MultiVectorDatabase


# --------------------------------------------------------------------------
# What-if context: per-query rank structure over the estimator sample
# --------------------------------------------------------------------------


class WhatIfContext:
    """Caches, for one query, the tuning-time ground truth and the required
    ek per (candidate index, gt item). Shared across planner invocations —
    the paper's "cache and pass relevant ek ... for a (q, x) pair".

    Ground truth and per-index exact ranks are computed on the FULL database
    by brute-force partial-score scans (vectorized matmuls — cheap; what
    sampling must avoid is index *construction*, Section 3.3.2). The sampled
    estimators supply the cost curve and the ANN reliability floor.
    """

    def __init__(self, query: Query, database: MultiVectorDatabase,
                 estimators: EstimatorBundle, k: int | None = None,
                 cstore=None):
        if cstore is None:
            from repro_torch.serve.columnstore import ColumnStore
            cstore = ColumnStore(database, device="cpu")  # host concats only
        self.query = query
        self.database = database
        self.cstore = cstore  # shared per-vid concat cache (serve.columnstore)
        self.est = estimators
        self.k = int(k or query.k)
        full = cstore.host(query.vid) @ query.concat()
        order = np.argsort(-full, kind="stable")
        self.gt_ids = order[: self.k]
        self._scores = {}  # vid -> (N,) partial scores
        self._ek_req: dict[IndexSpec, np.ndarray] = {}
        self._rel: dict[IndexSpec, tuple] = {}  # relevant-ek tables (Alg 1)

    def partial_scores(self, vid: Vid) -> np.ndarray:
        if vid not in self._scores:
            self._scores[vid] = self.cstore.host(vid) @ self.query.concat(vid)
        return self._scores[vid]

    def ek_req(self, spec: IndexSpec) -> np.ndarray:
        """(k,) required ek on ``spec`` to cover each gt item (ANN-inflated)."""
        if spec not in self._ek_req:
            ps = self.partial_scores(spec.vid)
            # rank of each gt item in the exact partial ordering (1-based)
            gt_scores = ps[self.gt_ids]
            ranks = (ps[None, :] > gt_scores[:, None]).sum(axis=1).astype(np.float64) + 1
            self._ek_req[spec] = self.est.inflate_ek(spec, ranks)
        return self._ek_req[spec]

    def rel(self, spec: IndexSpec) -> tuple:
        """Cached relevant-ek table for Algorithm 1 (paper: 'we cache and
        pass relevant ek ... for a (q, x) pair')."""
        if spec not in self._rel:
            self._rel[spec] = _relevant_eks(self.ek_req(spec))
        return self._rel[spec]

    def flat_scan_plan(self) -> QueryPlan:
        """Fallback: a full scan answers any query exactly (recall 1.0) at
        cost dim(q)·N — used when a configuration has no useful index."""
        cost = self.query.dim() * float(self.est.n_rows)
        return QueryPlan(query_qid=self.query.qid, indexes=[], eks=[],
                         est_cost=cost, est_recall=1.0)


# --------------------------------------------------------------------------
# Cost assembly
# --------------------------------------------------------------------------


def _plan_cost(ctx: WhatIfContext, specs: list[IndexSpec], eks: list[float],
               selectivity: float = 1.0) -> float:
    """Eq. 4: index-scan + rerank. Single exact-vid index plans skip rerank
    (the index already scores the full query — paper case study, Table 3).

    ``selectivity`` is the filtered-search term (DESIGN.md §12): a
    post-filter plan must over-fetch each index by 1/selectivity so ~ek
    matching candidates survive the predicate, so every ek is inflated
    (capped at the table size) before costing. selectivity=1.0 (the
    default) is the unfiltered cost, bit-identical to the old behavior."""
    if selectivity < 1.0:
        n = float(ctx.est.n_rows)
        floor = 1.0 / max(n, 1.0)
        s = max(float(selectivity), floor)
        eks = [min(float(np.ceil(ek / s)), n) if ek > 0 else 0.0 for ek in eks]
    used = [(x, ek) for x, ek in zip(specs, eks) if ek > 0]
    cost = sum(ctx.est.cost_idx(x, ek) for x, ek in used)
    if len(used) == 1 and used[0][0].vid == ctx.query.vid:
        return float(cost)
    rerank = ctx.query.dim() * sum(ek for _, ek in used)
    return float(cost + rerank)


def _coverage(ek_req: np.ndarray, eks: np.ndarray) -> np.ndarray:
    """(k,) bool — gt item covered by any index at its chosen ek."""
    # ek_req: (|X|, k); eks: (|X|,)
    return (ek_req <= eks[:, None]).any(axis=0)


# --------------------------------------------------------------------------
# Algorithm 1 — Search (|X| <= 3)
# --------------------------------------------------------------------------


def _relevant_eks(req: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique requirement levels for one index.

    Returns (levels (L,), cover_masks (L,) as python ints): choosing
    ek = levels[t] covers exactly the gt items with req <= levels[t].
    levels[0] = 0 covers nothing (index skipped)."""
    uniq = np.unique(req)
    levels = np.concatenate([[0.0], uniq])
    masks = []
    for lv in levels:
        m = 0
        for j, r in enumerate(req):
            if r <= lv and lv > 0:
                m |= 1 << j
        masks.append(m)
    return levels, np.asarray(masks, dtype=object)


def algorithm1_search(ctx: WhatIfContext, specs: list[IndexSpec],
                      theta_recall: float) -> QueryPlan | None:
    """Try every index in the "closer" role (the monotone last-index trick
    only applies to one index per enumeration) and keep the cheapest plan."""
    best: QueryPlan | None = None
    n = len(specs)
    orders = [list(range(n))] if n == 1 else [
        [j for j in range(n) if j != last] + [last] for last in range(n)]
    for order in orders:
        sub = algorithm1_search_fixed_order(ctx, [specs[j] for j in order], theta_recall)
        if sub is not None and (best is None or sub.est_cost < best.est_cost):
            best = sub
    return best


def algorithm1_search_fixed_order(ctx: WhatIfContext, specs: list[IndexSpec],
                                  theta_recall: float) -> QueryPlan | None:
    """Algorithm 1 with the given index order (last index gets the monotone
    treatment). All costs are pre-tabulated per relevant level so the inner
    enumeration is pure scalar arithmetic (branch-and-bound pruned)."""
    k = ctx.k
    target = int(np.ceil(theta_recall * k))
    req = np.stack([ctx.ek_req(x) for x in specs])
    n = len(specs)
    rel = [ctx.rel(x) for x in specs]
    qdim = ctx.query.dim()
    # per-level scan cost and scan+rerank cost
    scan = [np.where(rel[i][0] > 0,
                     np.asarray(ctx.est.cost_idx(specs[i], rel[i][0])), 0.0)
            for i in range(n)]
    full = [scan[i] + qdim * rel[i][0] for i in range(n)]
    exact_single = [specs[i].vid == ctx.query.vid for i in range(n)]

    best_cost, best_eks = np.inf, None
    levels_last, masks_last = rel[n - 1]
    pop_last = np.asarray([bin(m).count("1") for m in masks_last])

    def last_min_t(covered_mask: int):
        if bin(covered_mask | masks_last[-1]).count("1") < target:
            return None
        lo, hi = 0, len(levels_last) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if bin(covered_mask | masks_last[mid]).count("1") >= target:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def recurse(i: int, covered: int, eks_prefix: tuple, cost_prefix: float, used: int):
        nonlocal best_cost, best_eks
        if cost_prefix >= best_cost:
            return
        if i == n - 1:
            t = last_min_t(covered)
            if t is None:
                return
            ek_last = levels_last[t]
            if ek_last > 0:
                if used == 0 and exact_single[i]:
                    cost = cost_prefix + scan[i][t]  # no rerank (exact vid)
                else:
                    cost = cost_prefix + full[i][t]
            else:
                # last index unused: prefix must be a plan on its own
                if used == 1:
                    # single used index: if exact vid, remove its rerank
                    j, tj = _single_used(eks_prefix, rel)
                    if j is not None and exact_single[j]:
                        cost = scan[j][tj]
                    else:
                        cost = cost_prefix
                else:
                    cost = cost_prefix
            if cost < best_cost:
                best_cost = cost
                best_eks = np.asarray(eks_prefix + (ek_last,))
            return
        levels, masks = rel[i]
        for t in range(len(levels)):
            recurse(i + 1, covered | masks[t], eks_prefix + (levels[t],),
                    cost_prefix + full[i][t], used + (1 if levels[t] > 0 else 0))

    def _single_used(eks_prefix: tuple, rel_tabs):
        for j, ek in enumerate(eks_prefix):
            if ek > 0:
                levels = rel_tabs[j][0]
                tj = int(np.searchsorted(levels, ek))
                return j, tj
        return None, None

    recurse(0, 0, tuple(), 0.0, 0)
    if best_eks is None:
        return None
    rec = _coverage(req, best_eks).sum() / k
    return QueryPlan(ctx.query.qid, list(specs), [int(e) for e in best_eks],
                     float(best_cost), float(rec))


# --------------------------------------------------------------------------
# Algorithm 2 — Dynamic Programming (|X| > 3)
# --------------------------------------------------------------------------


def algorithm2_dp(ctx: WhatIfContext, specs: list[IndexSpec], theta_recall: float,
                  k_prime: int = 5, n_samples: int = 3, seed: int = 0) -> QueryPlan | None:
    """Bitmask DP over sampled ground truths (paper Algorithm 2).

    DP(i, cover) = min over cvr ⊆ cover of DP(i-1, cover−cvr) +
    cost_cover(cvr, x_i), where cost_cover = cost_idx at the max required ek
    of cvr's items + that index's rerank contribution.
    """
    k = ctx.k
    rng = np.random.default_rng(seed + 101 * ctx.query.qid)
    req_full = np.stack([ctx.ek_req(x) for x in specs])  # (n, k)
    n = len(specs)
    target_full = int(np.ceil(theta_recall * k))
    qdim = ctx.query.dim()

    best_plan: QueryPlan | None = None
    for s in range(n_samples):
        kp = min(k_prime, k)
        sel = np.sort(rng.choice(k, size=kp, replace=False))
        req = req_full[:, sel]  # (n, kp)
        size = 1 << kp
        target_kp = int(np.ceil(theta_recall * kp))

        # cost_cover(cvr, i): cost at max ek over cvr + rerank share
        cover_ek = np.zeros((n, size))
        for i in range(n):
            for cover in range(1, size):
                mx = 0.0
                for j in range(kp):
                    if cover >> j & 1:
                        mx = max(mx, req[i, j])
                cover_ek[i, cover] = mx
        cover_cost = np.zeros((n, size))
        for i in range(n):
            eks = cover_ek[i]
            cover_cost[i] = np.where(
                eks > 0, np.asarray(ctx.est.cost_idx(specs[i], eks)) + qdim * eks, 0.0)

        INF = np.inf
        dp = cover_cost[0].copy()
        choice = [np.arange(size)]  # choice[i][cover] = cvr taken by index i
        for i in range(1, n):
            ndp = np.full(size, INF)
            nch = np.zeros(size, dtype=np.int64)
            for cover in range(size):
                # iterate submasks of cover (classic (c-1)&cover walk)
                best, bc = dp[cover] + 0.0, 0  # cvr = 0 for index i
                cvr = cover
                while cvr:
                    v = dp[cover ^ cvr] + cover_cost[i, cvr]
                    if v < best:
                        best, bc = v, cvr
                    cvr = (cvr - 1) & cover
                ndp[cover] = best
                nch[cover] = bc
            dp = ndp
            choice.append(nch)

        # best cover meeting the sampled target
        feas = [c for c in range(size) if bin(c).count("1") >= target_kp]
        if not feas:
            continue
        cbest = min(feas, key=lambda c: dp[c])
        if not np.isfinite(dp[cbest]):
            continue
        # traceback -> eks per index
        eks = np.zeros(n)
        cover = cbest
        for i in range(n - 1, 0, -1):
            cvr = int(choice[i][cover])
            eks[i] = cover_ek[i, cvr]
            cover ^= cvr
        eks[0] = cover_ek[0, cover]

        # validate on the FULL gt; inflate proportionally if short (the sample
        # can under-cover the full k items)
        for _ in range(12):
            covered = _coverage(req_full, eks).sum()
            if covered >= target_full:
                break
            eks = np.where(eks > 0, np.ceil(eks * 1.25), 0.0)
            eks = np.minimum(eks, float(ctx.est.n_rows))
            if (eks >= ctx.est.n_rows).all():
                break
        covered = _coverage(req_full, eks).sum()
        if covered < target_full:
            continue
        cost = _plan_cost(ctx, specs, list(eks))
        if best_plan is None or cost < best_plan.est_cost:
            best_plan = QueryPlan(ctx.query.qid, list(specs), [int(e) for e in eks],
                                  float(cost), float(covered / k))
    return best_plan


# --------------------------------------------------------------------------
# Planner facade
# --------------------------------------------------------------------------


@dataclass
class QueryPlanner:
    """MINT's planner: Algorithm 1 for |X| ≤ 3, Algorithm 2 beyond
    (paper Section 3.3.1 closing paragraph)."""

    estimators: EstimatorBundle
    database: MultiVectorDatabase
    theta_recall: float = 0.9
    dp_k_prime: int = 5
    dp_samples: int = 3
    seed: int = 0
    use_jax_dp: bool = False  # vectorized Algorithm 2 (planner_jax, a torch DP)
    # where the vectorized DP runs: None means the CUDA card, "cpu" the host
    dp_device: object = None
    # filtered search (DESIGN.md §12): the attribute store and a sampled
    # SelectivityEstimator; both None keeps the planner purely vector
    attributes: object = None
    selectivity: object = None
    _contexts: dict[int, WhatIfContext] = field(default_factory=dict)
    _cstore: object = None  # shared ColumnStore across contexts

    def context(self, query: Query) -> WhatIfContext:
        if self._cstore is None:
            from repro_torch.serve.columnstore import ColumnStore
            # host concats only: the planner scans with numpy
            self._cstore = ColumnStore(self.database, device="cpu")
        if query.qid not in self._contexts:
            self._contexts[query.qid] = WhatIfContext(
                query, self.database, self.estimators, cstore=self._cstore)
        return self._contexts[query.qid]

    def useful_indexes(self, query: Query, config) -> list[IndexSpec]:
        return sorted((x for x in config if x.covers(query.vid)),
                      key=lambda x: (len(x.vid), x.vid, x.kind))

    @property
    def theta_plan(self) -> float:
        """Coverage target. Items at covered ranks are retrieved w.p.
        ≈ theta_hit (the inflation reliability), so expected recall is
        coverage × theta_hit — plan coverage to theta_recall / theta_hit."""
        return min(1.0, self.theta_recall / self.estimators.theta_hit)

    def plan(self, query: Query, config,
             force_access: str | None = None) -> QueryPlan:
        ctx = self.context(query)
        specs = self.useful_indexes(query, config)
        pred = getattr(query, "predicate", None)
        if pred is not None:
            return self._plan_filtered(query, ctx, specs, pred, force_access)
        p = self._index_plan(ctx, specs) if specs else None
        if p is None:
            return ctx.flat_scan_plan()
        flat = ctx.flat_scan_plan()
        return p if p.est_cost <= flat.est_cost else flat

    def _index_plan(self, ctx: WhatIfContext, specs) -> QueryPlan | None:
        """Best unfiltered index plan (Alg 1 / Alg 2), no flat comparison."""
        if len(specs) <= 3:
            return algorithm1_search(ctx, specs, self.theta_plan)
        if self.use_jax_dp:
            from repro_torch.core.planner_jax import plan_dp_jax
            return plan_dp_jax(ctx, specs, self.theta_plan,
                               k_prime=self.dp_k_prime,
                               n_samples=self.dp_samples, seed=self.seed,
                               device=self.dp_device)
        p = algorithm2_dp(ctx, specs, self.theta_plan,
                          k_prime=self.dp_k_prime, n_samples=self.dp_samples,
                          seed=self.seed)
        # DP is approximate — for safety also try the best ≤3-subset built
        # from the lowest-ek closers when DP fails
        if p is None:
            for sub in ([specs[0]], specs[:2], specs[:3]):
                q = algorithm1_search(ctx, sub, self.theta_plan)
                if q is not None and (p is None or q.est_cost < p.est_cost):
                    p = q
        return p

    # ---- filtered search (DESIGN.md §12) ---------------------------------

    def _selectivity_of(self, pred) -> float:
        if self.selectivity is not None:
            return float(self.selectivity.estimate(pred))
        if self.attributes is not None:
            # lazily build a default estimator over the base rows
            from repro_torch.filter.selectivity import SelectivityEstimator
            self.selectivity = SelectivityEstimator(
                self.attributes, np.arange(self.database.n_rows),
                seed=self.seed)
            return float(self.selectivity.estimate(pred))
        # no attribute info: assume the predicate passes everything, so
        # the masked path (≈ the unfiltered scan) is chosen
        return 1.0

    def _plan_filtered(self, query: Query, ctx: WhatIfContext, specs, pred,
                       force_access: str | None = None) -> QueryPlan:
        """Access-path choice per (query, predicate): cost out pre-filter
        gather, keep-masked scan, and 1/selectivity-inflated post-filter
        probe, and take the cheapest (``force_access`` pins one — bench /
        test hook). Candidates are ordered masked, post, pre so exact cost
        ties at the crossover resolve to the scan-shaped paths."""
        from repro_torch.filter.selectivity import (inflate_eks, masked_scan_cost,
                                                    prefilter_cost)
        n = float(self.estimators.n_rows)
        sel = self._selectivity_of(pred)
        qdim = query.dim()
        if sel <= 0.0:
            # known-empty predicate: only the bitmap is ever evaluated
            return QueryPlan(query.qid, [], [],
                             est_cost=prefilter_cost(qdim, n, 0.0),
                             est_recall=1.0, access_path="pre",
                             selectivity=0.0)
        cands = [QueryPlan(query.qid, [], [], masked_scan_cost(qdim, n), 1.0,
                           access_path="masked", selectivity=sel)]
        if specs:
            p = self._index_plan(ctx, specs)
            if p is not None and p.indexes:
                cost = _plan_cost(ctx, p.indexes, p.eks, selectivity=sel)
                # execution needs no estimator: the inflated eks are
                # stored in the plan itself
                inflated = inflate_eks(p.eks, sel, int(n))
                cands.append(QueryPlan(query.qid, list(p.indexes), inflated,
                                       cost, p.est_recall,
                                       access_path="post", selectivity=sel))
        cands.append(QueryPlan(query.qid, [], [],
                               prefilter_cost(qdim, n, sel), 1.0,
                               access_path="pre", selectivity=sel))
        if force_access is not None:
            forced = [c for c in cands if c.access_path == force_access]
            if not forced:
                raise ValueError(
                    f"no {force_access!r} plan available for q#{query.qid}")
            return forced[0]
        return min(cands, key=lambda c: c.est_cost)
