"""Plain PyTorch version of the top-k kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def topk_ref(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) -> (values (B, k) f32, ids (B, k) int32), best first, equal
    scores by ascending id (a stable descending sort). Only scores strictly
    above NEG_INF can fill a slot; empty slots are (NEG_INF, 0), as in the
    reference's buffer, which starts at NEG_INF and admits strict
    improvements only."""
    s = scores.float()
    k = min(k, s.shape[1])
    order = torch.sort(s, dim=1, descending=True, stable=True)
    vals = order.values[:, :k]
    ids = order.indices[:, :k].to(torch.int32)
    empty = ~(vals > NEG_INF)
    return vals.masked_fill(empty, NEG_INF), ids.masked_fill(empty, 0)
