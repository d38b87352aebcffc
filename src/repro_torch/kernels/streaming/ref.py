"""Plain PyTorch version of the streaming fused scan: the two-pass
computation it replaces (full score matrix, masks, top-k), with the same
combined id space (delta row r -> padded base rows + r)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF, pad_to
from repro_torch.kernels.distance.ops import fit_mask
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.topk.ref import topk_ref


def _masked_scores(q, db, metric, valid_n, dead_mask, keep_mask):
    scores = batched_scores_ref(q, db, metric)
    n = db.shape[0]
    bad = torch.arange(n, device=db.device) >= (n if valid_n is None else valid_n)
    if dead_mask is not None:
        bad = bad | fit_mask(dead_mask, n)
    if keep_mask is not None:
        bad = bad | ~fit_mask(keep_mask, n)
    return torch.where(bad[None, :], NEG_INF, scores)


def streaming_fused_scan_ref(q, db, k, metric="dot", valid_n=None,
                             dead_mask=None, delta=None, delta_valid_n=None,
                             delta_dead_mask=None, keep_mask=None,
                             delta_keep_mask=None, bn: int = 128):
    """(values, ids) with the streaming op's output contract. ``bn`` only
    sets the combined-id offset of delta rows (the base rows padded to a
    multiple of ``bn``)."""
    scores = _masked_scores(q, db, metric, valid_n, dead_mask, keep_mask)
    total = db.shape[0]
    if delta is not None:
        dscores = _masked_scores(q, delta, metric, delta_valid_n,
                                 delta_dead_mask, delta_keep_mask)
        # pad the base score block so column positions equal combined ids
        scores = torch.cat([pad_to(scores, 1, bn, value=NEG_INF), dscores], dim=1)
        total += delta.shape[0]
    return topk_ref(scores, min(k, total))
