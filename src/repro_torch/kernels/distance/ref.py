"""Plain PyTorch version of the batched distance kernel: the same function,
step by step, as the CPU path and the card's oracle."""
from __future__ import annotations

import torch


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n,) f32 sums of squares (the epilogue's norm operand)."""
    x32 = x.float()
    return (x32 * x32).sum(dim=-1)


def batched_scores_ref(q: torch.Tensor, db: torch.Tensor,
                       metric: str = "dot") -> torch.Tensor:
    """q: (B, d); db: (N, d) -> (B, N) f32 scores (higher = more similar):
    dot, cosine with norms clamped at 1e-24 under the square root, or
    -L2^2 = -(|q|^2 - 2 q.x + |x|^2). Callers on the card turn TF32 off
    (``kernels.common.strict_fp32``)."""
    acc = q.float() @ db.float().T
    if metric == "dot":
        return acc
    qsq = squared_norms(q)[:, None]
    dsq = squared_norms(db)[None, :]
    if metric == "cosine":
        return acc / (torch.sqrt(torch.clamp(qsq, min=1e-24))
                      * torch.sqrt(torch.clamp(dsq, min=1e-24)))
    if metric == "l2":
        return -(qsq - 2.0 * acc + dsq)
    raise ValueError(f"unknown metric {metric!r}")
