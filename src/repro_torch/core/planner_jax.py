"""Vectorized Algorithm 2 (bitmask DP) as a torch DP — beyond-paper tuner
throughput. The file keeps its counterpart's name so that a reader finds
it; nothing here uses JAX.

The Python DP in ``planner.py`` walks 3^k' submask pairs per index per
sample. Here the whole table is one vectorized recurrence: precompute the
(cover, submask) pair lists once (k'=5 → 243 pairs), then each DP layer is a
segment-min (``scatter_reduce(..., "amin")``) over a (n_pairs,) gather, and
every ground-truth sample is one row of the same batched solve, so a
what-if call prices all samples in one pass on the planner's device.

Used by ``QueryPlanner`` when ``use_jax_dp=True``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

INF = 3e38          # float32 "no plan" sentinel, as in the reference DP
_NO_PAIR = 1 << 30  # pair rank of a cover with no minimizing pair


@functools.lru_cache(maxsize=8)
def _pair_lists(k_prime: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    covers, subs = [], []
    for cover in range(1 << k_prime):
        cvr = cover
        while True:
            covers.append(cover)
            subs.append(cvr)
            if cvr == 0:
                break
            cvr = (cvr - 1) & cover
    item_masks = np.asarray(
        [[(c >> j) & 1 for j in range(k_prime)] for c in range(1 << k_prime)],
        np.float32)
    return (np.asarray(covers, np.int32), np.asarray(subs, np.int32), item_masks)


def submask_tables(k_prime: int, device="cpu"):
    """Static (pair_cover, pair_sub) enumeration of all cvr ⊆ cover, and the
    (2^k', k') item bitmask of each cover, as tensors on ``device``."""
    covers, subs, masks = _pair_lists(k_prime)
    return (torch.as_tensor(covers, device=device),
            torch.as_tensor(subs, device=device),
            torch.as_tensor(masks, device=device))


def dp_solve(ek_req: torch.Tensor, idx_dims: torch.Tensor, slopes: torch.Tensor,
             intercepts: torch.Tensor, q_dim: float, n_rows: float,
             target: float, k_prime: int):
    """ek_req: (S, n_idx, k') required eks, one row per sample (or one
    (n_idx, k') sample). Returns (best_cost (S,), eks (S, n_idx)) in
    float32, or unbatched for an unbatched ``ek_req``.

    cost_cover(cvr, i) = dim_i·min(slope_i·ek + b_i, N) + q_dim·ek with
    ek = max over cvr of ek_req[i] — exactly the Python DP's pricing.
    """
    single = ek_req.dim() == 2
    if single:
        ek_req = ek_req[None]
    dev = ek_req.device
    f32 = dict(dtype=torch.float32, device=dev)
    covers, subs, item_masks = (t.long() if t.dtype == torch.int32 else t
                                for t in submask_tables(k_prime, dev))
    S, n_idx, _ = ek_req.shape
    size = 1 << k_prime
    n_pairs = covers.shape[0]
    ek_req = ek_req.to(torch.float32)
    idx_dims, slopes, intercepts = (torch.as_tensor(x, **f32)
                                    for x in (idx_dims, slopes, intercepts))
    q_dim, n_rows, target = (torch.as_tensor(float(x), **f32)
                             for x in (q_dim, n_rows, target))

    # ek needed per (sample, index, cover) = max over covered items
    ek_cover = (item_masks[None, None, :, :] * ek_req[:, :, None, :]).amax(dim=3)
    nd = torch.clamp(slopes[None, :, None] * ek_cover + intercepts[None, :, None],
                     min=0.0).minimum(n_rows)
    cost_cover = torch.where(ek_cover > 0,
                             idx_dims[None, :, None] * nd + q_dim * ek_cover,
                             torch.zeros((), **f32))

    seg = covers.expand(S, n_pairs)
    ranks = torch.arange(n_pairs, device=dev).expand(S, n_pairs)
    dp = cost_cover[:, 0]
    choices = []
    for i in range(1, n_idx):
        # candidate: dp[cover - sub] + cost_cover[i, sub] over all pairs
        cand = dp[:, covers ^ subs] + cost_cover[:, i, subs]
        # segment-min over pairs grouped by cover
        best = torch.full((S, size), INF, **f32).scatter_reduce(
            1, seg, cand, "amin")
        # recover which submask achieved the min (first match)
        is_best = cand <= best[:, covers] + 1e-6
        pair_rank = torch.where(is_best, ranks, _NO_PAIR)
        first = torch.full((S, size), _NO_PAIR, dtype=torch.int64,
                           device=dev).scatter_reduce(1, seg, pair_rank, "amin")
        chosen = torch.where(first < _NO_PAIR,
                             subs[torch.clamp(first, 0, n_pairs - 1)], 0)
        dp = best
        choices.append(chosen)

    # best feasible cover
    feasible = item_masks.sum(dim=1) >= target
    masked = torch.where(feasible[None, :], dp, torch.full((), INF, **f32))
    best_cover = torch.argmin(masked, dim=1)
    rows = torch.arange(S, device=dev)
    best_cost = masked[rows, best_cover]

    # traceback: walk layers in reverse
    cover = best_cover
    eks = torch.zeros((S, n_idx), **f32)
    for li in range(n_idx - 2, -1, -1):
        sub = choices[li][rows, cover]
        eks[:, li + 1] = ek_cover[rows, li + 1, sub]
        cover = cover ^ sub
    eks[:, 0] = ek_cover[rows, 0, cover]
    if single:
        return best_cost[0], eks[0]
    return best_cost, eks


def plan_dp_jax(ctx, specs, theta_recall: float, k_prime: int = 5,
                n_samples: int = 3, seed: int = 0, device=None):
    """Drop-in for algorithm2_dp using the vectorized solver: the samples
    are solved in one batched ``dp_solve`` on ``device`` (None: the card)."""
    from repro_torch.core.planner import _coverage, _plan_cost
    from repro_torch.core.types import QueryPlan

    device = resolve_device(device)
    k = ctx.k
    rng = np.random.default_rng(seed + 101 * ctx.query.qid)
    req_full = np.stack([ctx.ek_req(x) for x in specs])
    target_full = int(np.ceil(theta_recall * k))

    idx_dims = [ctx.est.index_dim(x) for x in specs]
    slopes, intercepts = [], []
    for x in specs:
        fits = [ctx.est.stats[(c, x.kind)].cost for c in x.vid]
        slopes.append(float(np.mean([f.slope for f in fits])))
        intercepts.append(float(np.mean([f.intercept for f in fits])))

    best_plan = None
    kp = min(k_prime, k)
    target_kp = int(np.ceil(theta_recall * kp))
    sels = np.stack([np.sort(rng.choice(k, size=kp, replace=False))
                     for _ in range(n_samples)])
    reqs = torch.as_tensor(req_full[:, sels.T].transpose(2, 0, 1),
                           dtype=torch.float32, device=device)  # (S, n, kp)
    costs, eks_all = dp_solve(reqs, idx_dims, slopes, intercepts,
                              float(ctx.query.dim()), float(ctx.est.n_rows),
                              float(target_kp), kp)
    costs = costs.cpu().numpy()
    eks_all = eks_all.cpu().numpy()

    for s in np.argsort(costs):
        if not np.isfinite(costs[s]) or costs[s] >= 3e38:
            continue
        eks = eks_all[s].astype(np.float64)
        for _ in range(12):
            if _coverage(req_full, eks).sum() >= target_full:
                break
            eks = np.minimum(np.where(eks > 0, np.ceil(eks * 1.25), 0.0),
                             float(ctx.est.n_rows))
            if (eks >= ctx.est.n_rows).all():
                break
        covered = _coverage(req_full, eks).sum()
        if covered < target_full:
            continue
        cost = _plan_cost(ctx, specs, list(eks))
        if best_plan is None or cost < best_plan.est_cost:
            best_plan = QueryPlan(ctx.query.qid, list(specs),
                                  [int(e) for e in eks], float(cost),
                                  float(covered / k))
    return best_plan
