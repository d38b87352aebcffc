"""Public op for the streaming fused scan (one pass, no score matrix)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import METRIC_CODES
from repro_torch.kernels.streaming.kernel import streaming_scan_cuda
from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref

# delta rows are numbered after the base rows rounded up to this block
DELTA_ID_BLOCK = 128


def delta_id_offset(n_base: int, bn: int = DELTA_ID_BLOCK) -> int:
    """The combined id of delta row 0 over ``n_base`` base rows."""
    return -(-n_base // bn) * bn


def streaming_fused_scan(q: torch.Tensor, db: torch.Tensor, k: int,
                         metric: str = "dot",
                         valid_n: int | None = None,
                         dead_mask: torch.Tensor | None = None,
                         delta: torch.Tensor | None = None,
                         delta_valid_n: int | None = None,
                         delta_dead_mask: torch.Tensor | None = None,
                         keep_mask: torch.Tensor | None = None,
                         delta_keep_mask: torch.Tensor | None = None,
                         bn: int = DELTA_ID_BLOCK
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) queries over (N, d) base rows — plus an optional (Nd, d)
    delta source — -> top-k (values, ids) without a (B, N) score matrix.

    Rows at or past ``valid_n`` / ``delta_valid_n`` are masked, as are rows
    set in ``dead_mask`` / ``delta_dead_mask`` (tombstones) and rows unset in
    ``keep_mask`` / ``delta_keep_mask`` (predicate bitmaps). Ids are
    combined-physical: base row i is id i; delta row r is id
    ``delta_id_offset(Nb, bn) + r`` (the padded base row count). Results are best
    first, equal scores by ascending id; when fewer than k live rows exist
    the tail slots are (NEG_INF, 0). k is clamped to Nb + Nd only; callers
    that need the two-pass ``min(k, valid_n)`` narrowing clamp first.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    B, d = q.shape
    Nb, d2 = db.shape
    if d != d2 or (delta is not None and delta.shape[1] != d):
        raise ValueError(f"row widths {db.shape}, "
                         f"{None if delta is None else delta.shape} != {d}")
    Nd = 0 if delta is None else delta.shape[0]
    k_eff = min(k, Nb + Nd)
    if q.device.type == "cpu":
        return streaming_fused_scan_ref(
            q, db, k_eff, metric=metric, valid_n=valid_n, dead_mask=dead_mask,
            delta=delta, delta_valid_n=delta_valid_n,
            delta_dead_mask=delta_dead_mask, keep_mask=keep_mask,
            delta_keep_mask=delta_keep_mask, bn=bn)
    if B == 0 or k_eff <= 0:
        return (torch.empty((B, max(k_eff, 0)), dtype=torch.float32, device=q.device),
                torch.empty((B, max(k_eff, 0)), dtype=torch.int32, device=q.device))
    out = streaming_scan_cuda(
        q, db, k_eff, metric,
        Nb if valid_n is None else valid_n, dead_mask, keep_mask,
        delta, Nd if delta_valid_n is None else delta_valid_n,
        delta_dead_mask, delta_keep_mask, delta_id_offset=delta_id_offset(Nb, bn))
    streaming_fused_scan.launches += 1
    return out


streaming_fused_scan.launches = 0

__all__ = ["DELTA_ID_BLOCK", "delta_id_offset", "streaming_fused_scan"]
