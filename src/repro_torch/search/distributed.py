"""Distributed vector-search serving over a row-sharded mesh.

The database rows are sharded over one mesh axis (``distributed.sharding.
row_sharding``); every shard is scanned by the streaming fused scan (its
hand-written kernel on the card, its plain version on the CPU) and only the
per-shard top-k (k values + global ids) crosses devices: a tournament merge,
never raw rows or scores.

The merge keeps the reference's order: ``jax.lax.top_k`` is stable, so over
the shard-major (S * k) candidate list an equal score goes to the lower
position, which is the lower global id. ``torch.topk`` promises no tie order,
so the merge is a stable descending sort.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_gather, psum
from repro_torch.distributed.sharding import row_sharding
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.streaming.ops import streaming_fused_scan


def _local_scan(db_shard, qvecs, k, shard_offset, valid_n=None, bad=None):
    """One shard's top-``k`` -> (values, GLOBAL ids). Rows at global index
    >= ``valid_n`` (column-store padding) and rows set in ``bad``
    (tombstones or rows outside a predicate) are masked; masked slots come
    back as (NEG_INF, 0) — id 0, as the fused kernels report them, not the
    shard's offset."""
    n_local = db_shard.shape[0]
    vn = n_local if valid_n is None else min(max(valid_n - shard_offset, 0), n_local)
    if bad is not None and bad.dtype != torch.bool:
        bad = bad != 0
    vals, ids = streaming_fused_scan(qvecs, db_shard, k=k, valid_n=vn, dead_mask=bad)
    ids = ids + shard_offset
    return vals, torch.where(vals <= NEG_INF / 2, torch.zeros_like(ids), ids)


def make_search_step(mesh, k: int, axis: str = "data",
                     valid_n: int | None = None, masked: bool = False):
    """Returns ``search_step(db_shards, qvecs[, bad]) -> (vals (Q, k), ids
    (Q, k))`` on the queries' device.

    ``db_shards`` is the per-rank row blocks of an (N, d) matrix in the
    layout of ``row_sharding(mesh, axis)`` (rank r's block on its device);
    the queries are replicated. Each shard scans at ``min(k, n_local)`` and
    the merge all-gathers only the (Q, k) candidates of each shard.
    ``valid_n`` marks trailing rows as padding. ``masked=True`` adds the
    third operand ``bad``, an (N,) row bitmap (True / nonzero = tombstoned
    or filtered out) sharded exactly like the rows; bad rows come back at
    NEG_INF with id 0."""
    layout = row_sharding(mesh, axis)

    def step(db_shards, qvecs, bad=None):
        if masked != (bad is not None):
            raise ValueError(f"step built with masked={masked}, called with"
                             f"{'' if bad is not None else 'out'} a bad mask")
        S = layout.n_shards
        if len(db_shards) != S:
            raise ValueError(f"{len(db_shards)} row blocks for {S} shards of {axis!r}")
        bads = layout.shard(bad) if masked else [None] * S
        home = qvecs.device
        vals, ids = [], []
        for r, x in enumerate(db_shards):
            n_local = x.shape[0]
            v, i = _local_scan(x, qvecs.to(x.device), min(k, n_local), r * n_local,
                               valid_n=valid_n, bad=bads[r])
            vals.append(v)
            ids.append(i)
        # tournament merge: gather candidates only
        all_vals = all_gather(vals, mesh, axis, home)   # (S, Q, k)
        all_ids = all_gather(ids, mesh, axis, home)
        S, Q, kk = all_vals.shape
        flat_v = all_vals.transpose(0, 1).reshape(Q, S * kk)
        flat_i = all_ids.transpose(0, 1).reshape(Q, S * kk)
        best = torch.sort(flat_v, dim=1, descending=True, stable=True)
        pos = best.indices[:, :k]
        return best.values[:, :k], torch.take_along_dim(flat_i, pos, dim=1)

    return step


def distributed_rerank(mesh, db, cand_ids, qvec, k: int, axis: str = "data"):
    """Full-score rerank of candidate ids against a row-sharded database
    (``db``: the per-rank row blocks): each shard scores the candidates it
    owns with the distance kernel, the others contribute 0.0, and a psum
    merges them (exactly one shard owns each id, so the sum is exact).
    Returns the best ``k`` (scores, ids), ties to the earlier candidate."""
    layout = row_sharding(mesh, axis)
    if len(db) != layout.n_shards:
        raise ValueError(f"{len(db)} row blocks for {layout.n_shards} shards of {axis!r}")
    home = qvec.device
    per_rank = []
    for r, x in enumerate(db):
        n_local = x.shape[0]
        local = cand_ids.to(x.device) - r * n_local
        mine = (local >= 0) & (local < n_local)
        scores = torch.zeros(cand_ids.shape[0], dtype=torch.float32, device=x.device)
        owned = local[mine]
        if owned.numel():
            scores[mine] = batched_scores(qvec.to(x.device)[None, :], x[owned])[0]
        per_rank.append(scores)
    scores = psum(per_rank, mesh, axis, home)
    best = torch.sort(scores, descending=True, stable=True)
    pos = best.indices[:k]
    return best.values[:k], cand_ids.to(home)[pos]
