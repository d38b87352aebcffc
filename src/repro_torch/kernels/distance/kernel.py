"""Batched distance kernel wrapper: (B, d) x (N, d) -> (B, N) f32 scores.

On a CUDA tensor it launches ``csrc/distance.cu`` (the port of
``repro/kernels/distance/kernel.py:_distance_kernel``); on a CPU tensor it
computes the plain version in ``ref.py``. ``distance_tiles`` is the one place
the kernel's grid is computed. See the note at the top of the CUDA source.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (DTYPE_CODES, H100_SMS, METRIC_CODES, cdiv,
                                        check_cuda_operand, check_launch, copy_bytes,
                                        load_library, ptr, stream_ptr)
from repro_torch.kernels.distance.ref import batched_scores_ref, squared_norms

# (queries, rows, thread tile) the kernel is built for (csrc/distance.cu:
# launch_tile): 8 warps of 8 x 8 thread tiles, or one warp of 4 x 4
WIDE_TILE = (64, 256, 8)
NARROW_TILE = (16, 32, 4)


@dataclass(frozen=True)
class DistanceTiles:
    """Block tile ``bm`` queries x ``bn`` rows, each thread a ``tm`` x
    ``tm`` register tile; ``grid`` = (row tiles, query tiles)."""
    bm: int
    bn: int
    tm: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def distance_tiles(B: int, N: int, d: int, sm_count: int = H100_SMS) -> DistanceTiles:
    """The kernel's tiles for B queries against N rows of width d.

    The wide tile (64 x 256 of 8 x 8 thread tiles, two 8-warp blocks an SM)
    where it still gives two blocks for every SM, so at B <= 64 each row is
    read once and B = 65-128 takes two query tiles; else the narrow one-warp
    tile (16 x 32 of 4 x 4), so a small call (IVF centroids: B <= 64 against
    ~1e3 rows) spreads over the SMs and each thread's FMA chain (tm * tm * d
    long, what a small call waits for) is a quarter of the wide tile's. The
    width d never splits the tiles: each score is one FMA chain over d (the
    two-pass = one-pass contract)."""
    if B < 1 or N < 1 or d < 1:
        raise ValueError(f"empty distance call: B={B}, N={N}, d={d}")
    bm, bn, tm = WIDE_TILE
    if cdiv(B, bm) * cdiv(N, bn) < 2 * sm_count:
        bm, bn, tm = NARROW_TILE
    return DistanceTiles(bm=bm, bn=bn, tm=tm, grid=(cdiv(N, bn), cdiv(B, bm)))


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
    t = distance_tiles(B, N, d, torch.cuda.get_device_properties(q.device)
                       .multi_processor_count)
    lib = load_library()
    err = lib.mint_batched_scores(ptr(q), ptr(db), ptr(qsq), ptr(dbsq), ptr(out),
                                  B, N, d, METRIC_CODES[metric], DTYPE_CODES[q.dtype],
                                  t.bm, t.bn, t.tm, copy_bytes(q, db),
                                  stream_ptr(q.device))
    check_launch(lib, err, "batched_scores")
    batched_scores.launches += 1
    return out


batched_scores.launches = 0
