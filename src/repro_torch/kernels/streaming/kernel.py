"""Launch of the streaming fused-scan kernel (``csrc/streaming.cu``, the
port of ``repro/kernels/streaming/kernel.py:streaming_kernel``).

Each block walks a contiguous range of rows once for a tile of up to 64
queries, keeps each query's best keys sorted in shared memory behind a
threshold, and writes its best min(k, rows); a merge pass folds those
partial lists into the final best-first top-k. ``scan_grid`` is the one
place the grid is computed. See the note at the top of the CUDA source.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (DTYPE_CODES, H100_SMS, METRIC_CODES, cdiv,
                                        check_cuda_operand, check_launch, copy_bytes,
                                        load_library, merge_fan_in, merge_scratch_elems,
                                        pow2_at_least, ptr, stream_ptr)
from repro_torch.kernels.distance.ops import fit_mask
from repro_torch.kernels.distance.ref import squared_norms

# query tiles the kernel is built for (csrc/streaming.cu: launch_qt)
QUERY_TILES = (64, 16, 4, 1)
ROW_TILE = 256             # rows per staged tile; a block's range is a multiple
LIST_BYTES = 96 * 1024     # shared memory for a query tile's lists and buffers
MAX_LIST = 8192            # longest per-query list a block keeps


@dataclass(frozen=True)
class ScanGrid:
    """How one scan call is cut: ``qt`` queries per tile (``n_qtiles``
    tiles), ``rows_per_block`` contiguous rows per block, ``base_blocks`` of
    the ``P`` row blocks on the base source, each writing its best ``lc``
    keys from a sorted list of ``lpad`` (a power of two) fed through a
    candidate buffer of ``cap``."""
    qt: int
    n_qtiles: int
    rows_per_block: int
    base_blocks: int
    P: int
    lc: int
    lpad: int
    cap: int


def scan_grid(B: int, Nb: int, Nd: int, k: int, sm_count: int = H100_SMS) -> ScanGrid:
    """The scan's grid for B queries over Nb base + Nd delta rows at top-k.

    The query tile is the smallest built tile that holds B (64 beyond), so
    each row is read once per 64 queries. Rows are cut into about one block
    per SM per query tile (on an H100, one block an SM beat two at 1-16
    queries once a single query streams 256-byte row pieces). A block keeps
    min(k, its rows) keys per query; where k exceeds ``MAX_LIST`` the blocks
    shrink to ``MAX_LIST`` rows. The query tile then shrinks until its lists
    and candidate buffers fit ``LIST_BYTES`` of shared memory."""
    if B < 1 or k < 1 or Nb + Nd < 1:
        raise ValueError(f"empty scan: B={B}, rows={Nb}+{Nd}, k={k}")
    qt = next(t for t in reversed(QUERY_TILES) if t >= min(B, QUERY_TILES[0]))
    per_tile = max(1, cdiv(sm_count, cdiv(B, qt)))
    rb = max(ROW_TILE, cdiv(cdiv(Nb + Nd, per_tile), ROW_TILE) * ROW_TILE)
    if k > MAX_LIST:
        rb = min(rb, MAX_LIST)
    lc = min(k, rb)
    lpad = pow2_at_least(lc)
    cap = min(lpad, max(64, lpad // 8))
    while qt > 1 and qt * (lpad + cap) * 8 > LIST_BYTES:
        qt = QUERY_TILES[QUERY_TILES.index(qt) + 1]
    base_blocks = cdiv(Nb, rb)
    return ScanGrid(qt=qt, n_qtiles=cdiv(B, qt), rows_per_block=rb,
                    base_blocks=base_blocks, P=base_blocks + cdiv(Nd, rb), lc=lc,
                    lpad=lpad, cap=cap)


def _row_mask(mask: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """(n,) row bitmap of one byte a row for the kernel (cut or padded with
    0). A bool or uint8 mask of exactly n rows goes as it is (a bool is one
    byte of 0 or 1), so a cached mask costs no copy a launch."""
    if mask is None:
        return None
    if (mask.dtype in (torch.bool, torch.uint8) and mask.shape[0] == n
            and mask.is_contiguous()):
        return mask
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
    g = scan_grid(B, Nb, Nd, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the queries transposed to (d, columns) in f32 (exact), zero past B
    qtw = cdiv(g.n_qtiles * g.qt, 4) * 4
    qt = torch.nn.functional.pad(q.float().T, (0, qtw - B)).contiguous()
    fan_in = merge_fan_in(B, g.P, g.lc)
    n = merge_scratch_elems(B, g.P, g.lc, k, fan_in)
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    sb = torch.empty(n, dtype=torch.int64, device=dev)
    masks = [_row_mask(dead_mask, Nb), _row_mask(keep_mask, Nb),
             _row_mask(delta_dead_mask, Nd), _row_mask(delta_keep_mask, Nd)]
    vb = copy_bytes(db, *([] if delta is None else [delta]))
    lib = load_library()
    err = lib.mint_streaming_scan(
        ptr(qt), ptr(db), ptr(delta), ptr(qsq), ptr(bsq), ptr(dsq),
        *[ptr(m) for m in masks],
        B, d, qtw, Nb, int(valid_n), Nd, int(delta_valid_n), int(delta_id_offset), k,
        g.qt, g.n_qtiles, g.rows_per_block, g.base_blocks, g.P, g.lc, g.lpad, g.cap, vb,
        fan_in, METRIC_CODES[metric], DTYPE_CODES[q.dtype],
        ptr(sa), ptr(sb), ptr(vals), ptr(ids), stream_ptr(dev))
    check_launch(lib, err, "streaming_fused_scan")
    return vals, ids
