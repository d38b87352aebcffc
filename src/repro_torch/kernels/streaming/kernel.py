"""Launch of the streaming fused-scan kernel (``csrc/streaming.cu``, the
port of ``repro/kernels/streaming/kernel.py:streaming_kernel``).

The kernel splits the row axis across blocks: each block scores
``CHUNK`` rows for 8 queries, masks them, sorts their (score, id) keys and
writes its best min(k, CHUNK); a merge pass folds those partial lists into
the final best-first top-k. See the note at the top of the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (CHUNK, DTYPE_CODES, METRIC_CODES, cdiv,
                                        check_cuda_operand, check_launch, load_library,
                                        merge_scratch_elems, ptr, stream_ptr)
from repro_torch.kernels.distance.ops import fit_mask
from repro_torch.kernels.distance.ref import squared_norms


def _row_mask(mask: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """(n,) uint8 row bitmap for the kernel (cut or padded with 0)."""
    if mask is None:
        return None
    return fit_mask(mask, n).to(torch.uint8).contiguous()


def streaming_scan_cuda(q: torch.Tensor, db: torch.Tensor, k: int, metric: str,
                        valid_n: int, dead_mask, keep_mask,
                        delta: torch.Tensor | None, delta_valid_n: int,
                        delta_dead_mask, delta_keep_mask, delta_id_offset: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel call over base (+ delta) rows -> (B, k) f32 values and
    int32 ids, best first. ``k`` is already clamped to the combined rows."""
    dev = q.device
    check_cuda_operand("q", q, dev)
    check_cuda_operand("db", db, dev, dtypes=(q.dtype,))
    B, d = q.shape
    Nb = db.shape[0]
    Nd = 0 if delta is None else delta.shape[0]
    if delta is not None:
        check_cuda_operand("delta", delta, dev, dtypes=(q.dtype,))
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    qsq = bsq = dsq = None
    if metric != "dot":
        qsq, bsq = squared_norms(q), squared_norms(db)
        dsq = None if delta is None else squared_norms(delta)
    P = cdiv(Nb, CHUNK) + cdiv(Nd, CHUNK)
    Lc = min(k, CHUNK)
    n = merge_scratch_elems(B, P, Lc, k)
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    sb = torch.empty(n, dtype=torch.int64, device=dev)
    masks = [_row_mask(dead_mask, Nb), _row_mask(keep_mask, Nb),
             _row_mask(delta_dead_mask, Nd), _row_mask(delta_keep_mask, Nd)]
    lib = load_library()
    err = lib.mint_streaming_scan(
        ptr(q), ptr(db), ptr(delta), ptr(qsq), ptr(bsq), ptr(dsq),
        *[ptr(m) for m in masks],
        B, d, Nb, int(valid_n), Nd, int(delta_valid_n), int(delta_id_offset), k, P,
        Lc, METRIC_CODES[metric], DTYPE_CODES[q.dtype],
        ptr(sa), ptr(sb), ptr(vals), ptr(ids), stream_ptr(dev))
    check_launch(lib, err, "streaming_fused_scan")
    return vals, ids
