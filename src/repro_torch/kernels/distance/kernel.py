"""Batched distance kernel wrapper: (B, d) x (N, d) -> (B, N) f32 scores.

On a CUDA tensor it launches ``csrc/distance.cu`` (the port of
``repro/kernels/distance/kernel.py:_distance_kernel``); on a CPU tensor it
computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPE_CODES, METRIC_CODES, check_cuda_operand,
                                        check_launch, load_library, ptr, stream_ptr)
from repro_torch.kernels.distance.ref import batched_scores_ref, squared_norms


def batched_scores(q: torch.Tensor, db: torch.Tensor,
                   metric: str = "dot") -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) f32 scores; dot, cosine or -L2^2."""
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    B, d = q.shape
    N, d2 = db.shape
    if d != d2:
        raise ValueError(f"query width {d} != row width {d2}")
    if q.device.type == "cpu":
        return batched_scores_ref(q, db, metric)
    check_cuda_operand("q", q, q.device)
    check_cuda_operand("db", db, q.device, dtypes=(q.dtype,))
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    qsq = dbsq = None
    if metric != "dot":
        qsq, dbsq = squared_norms(q), squared_norms(db)
    lib = load_library()
    err = lib.mint_batched_scores(ptr(q), ptr(db), ptr(qsq), ptr(dbsq), ptr(out),
                                  B, N, d, METRIC_CODES[metric],
                                  DTYPE_CODES[q.dtype], stream_ptr(q.device))
    check_launch(lib, err, "batched_scores")
    batched_scores.launches += 1
    return out


batched_scores.launches = 0
