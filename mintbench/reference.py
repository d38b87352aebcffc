"""The plain reference: exact multi-vector top-k over the generated columns.

Columns hold unit rows, so a row's score for a query on columns ``vid`` is
the sum of the per-column dot products (the paper's score aggregation).
Plain PyTorch in float32 with TF32 off; it takes the raw generated columns
and query vectors, and nothing the program derived from them. Imports
nothing of the program.
"""
from __future__ import annotations

import torch


def strict_fp32() -> None:
    """TF32 keeps about three decimal digits: off for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def split(qvecs: torch.Tensor, dims: list[int], vid) -> list[torch.Tensor]:
    """The (b, d_c) blocks of the columns in ``vid`` from full-width query
    vectors (b, sum of dims)."""
    offs = [0]
    for d in dims:
        offs.append(offs[-1] + d)
    return [qvecs[:, offs[c]:offs[c + 1]] for c in vid]


def scores(cols: list[torch.Tensor], vid, qparts: list[torch.Tensor],
           dtype=torch.float32) -> torch.Tensor:
    """(b, rows) scores of every row, summed over the columns of ``vid``,
    computed in ``dtype``."""
    out = None
    for c, q in zip(vid, qparts):
        s = q.to(dtype) @ cols[c].to(dtype).T
        out = s if out is None else out + s
    return out


def topk(cols: list[torch.Tensor], vid, qparts: list[torch.Tensor], k: int,
         dtype=torch.float32) -> torch.Tensor:
    """(b, k) ids of the best rows, best first."""
    return torch.topk(scores(cols, vid, qparts, dtype), k, dim=1).indices


def scores_of(cols: list[torch.Tensor], vid, qparts: list[torch.Tensor],
              ids: torch.Tensor) -> torch.Tensor:
    """(b, m) float32 scores of rows ``ids`` (b, m)."""
    out = None
    for c, q in zip(vid, qparts):
        s = torch.einsum("bmd,bd->bm", cols[c][ids], q)
        out = s if out is None else out + s
    return out
