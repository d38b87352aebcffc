"""The two-pass fused scan: scores, a row mask, then top-k.

This is the REFERENCE path: it writes the full (B, N) score matrix between
the distance and top-k kernels. The serving default is the one-pass
``kernels/streaming`` kernel (same results, no score matrix);
``BatchEngine(streaming=False)`` or ``REPRO_TWOPASS_SCAN=1`` selects this
path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.topk.kernel import topk_scores


def fit_mask(mask: torch.Tensor, n: int) -> torch.Tensor:
    """A row bitmap cut or padded with False to ``n`` rows."""
    mask = mask.to(torch.bool)
    if mask.shape[0] >= n:
        return mask[:n]
    pad = torch.zeros(n - mask.shape[0], dtype=torch.bool, device=mask.device)
    return torch.cat([mask, pad])


def _mask_rows(scores: torch.Tensor, valid_n: int, dead=None,
               keep=None) -> torch.Tensor:
    """One elementwise pass: rows at or past ``valid_n`` (padding),
    tombstoned rows and rows outside the predicate ``keep`` go to NEG_INF."""
    bad = torch.arange(scores.shape[1], device=scores.device) >= valid_n
    if dead is not None:
        bad = bad | dead
    if keep is not None:
        bad = bad | ~keep
    return torch.where(bad[None, :], NEG_INF, scores)


def fused_scan(q: torch.Tensor, db: torch.Tensor, k: int, metric: str = "dot",
               valid_n: int | None = None,
               dead_mask: torch.Tensor | None = None,
               keep_mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) queries over (N, d) rows -> top-k (values, ids): the distance
    kernel, the mask pass, then the top-k kernel. Rows at or past
    ``valid_n`` are padding, and k is clamped to ``valid_n``; ``dead_mask``
    (tombstones) and ``keep_mask`` (predicate) mask rows in the same pass."""
    scores = batched_scores(q, db, metric=metric)
    has_pad = valid_n is not None and valid_n < db.shape[0]
    if has_pad:
        k = min(k, int(valid_n))
    if has_pad or dead_mask is not None or keep_mask is not None:
        n = db.shape[0]
        vn = n if valid_n is None else valid_n
        keep = None if keep_mask is None else fit_mask(keep_mask, n)
        scores = _mask_rows(scores, vn, dead_mask, keep)
    return topk_scores(scores, k)


__all__ = ["batched_scores", "fused_scan"]
