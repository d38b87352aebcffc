"""Top-k kernel wrapper: (B, N) scores -> (B, k) values and ids, best first.

On a CUDA tensor it launches ``csrc/topk.cu`` (the port of
``repro/kernels/topk/kernel.py:_topk_kernel``); on a CPU tensor it computes
the plain version in ``ref.py``. ``topk_grid`` is the one place the kernel's
grid is computed. See the note at the top of the CUDA source.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (DTYPE_CODES, H100_SMS, NEG_INF, cdiv,
                                        check_cuda_operand, check_launch, copy_bytes,
                                        load_library, merge_fan_in, merge_scratch_elems,
                                        neg_inf_for, pow2_at_least, ptr, stream_ptr)
from repro_torch.kernels.topk.ref import topk_ref

__all__ = ["NEG_INF", "TopkGrid", "neg_inf_for", "topk_grid", "topk_scores"]

COL_TILE = 1024       # a block's columns are a multiple (the last block ends at N)
MAX_LIST = 8192       # longest list a block keeps
MIN_CAP = 256         # smallest candidate buffer
SMEM_BYTES = 96 * 1024  # shared memory budget of a block's list and buffer


@dataclass(frozen=True)
class TopkGrid:
    """How one top-k call is cut: each row into ``blocks_per_row`` blocks
    of ``cols_per_block`` contiguous columns, each keeping its best ``lc``
    keys in a sorted list of ``lpad`` (a power of two) fed through a
    candidate buffer of ``cap``."""
    cols_per_block: int
    blocks_per_row: int
    lc: int
    lpad: int
    cap: int

    @property
    def smem_bytes(self) -> int:
        return 8 * (self.lpad + self.cap) + 16


def topk_grid(B: int, N: int, k: int, sm_count: int = H100_SMS) -> TopkGrid:
    """The kernel's grid for top-k of B rows of N scores.

    About two blocks per SM over the call: each row is cut into
    2 * sm_count // B column ranges (at least one), rounded up to
    ``COL_TILE`` columns. A block keeps min(k, its columns) keys; where k
    exceeds ``MAX_LIST`` the ranges shrink to ``MAX_LIST`` columns."""
    if B < 1 or N < 1 or k < 1:
        raise ValueError(f"empty top-k: B={B}, N={N}, k={k}")
    per_row = max(1, 2 * sm_count // B)
    cols = cdiv(cdiv(N, per_row), COL_TILE) * COL_TILE
    if k > MAX_LIST:
        cols = min(cols, MAX_LIST)
    lc = min(k, cols)
    lpad = pow2_at_least(max(lc, MIN_CAP))
    cap = min(lpad, max(MIN_CAP, lpad // 8))
    return TopkGrid(cols_per_block=cols, blocks_per_row=cdiv(N, cols), lc=lc, lpad=lpad,
                    cap=cap)


def topk_scores(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) f32/bf16/f16 -> per-row (values f32, ids int32) of the
    min(k, N) best, ties by ascending id; empty slots are (NEG_INF, 0)."""
    B, N = scores.shape
    k_eff = min(k, N)
    if scores.device.type == "cpu":
        return topk_ref(scores, k_eff)
    check_cuda_operand("scores", scores, scores.device)
    dev = scores.device
    vals = torch.empty((B, max(k_eff, 0)), dtype=torch.float32, device=dev)
    ids = torch.empty((B, max(k_eff, 0)), dtype=torch.int32, device=dev)
    if B == 0 or k_eff <= 0:
        return vals, ids
    g = topk_grid(B, N, k_eff, torch.cuda.get_device_properties(dev).multi_processor_count)
    P = g.blocks_per_row
    fan_in = merge_fan_in(B, P, g.lc)
    n = merge_scratch_elems(B, P, g.lc, k_eff, fan_in)
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    sb = torch.empty(n, dtype=torch.int64, device=dev)
    lib = load_library()
    err = lib.mint_topk_scores(ptr(scores), B, N, k_eff, g.cols_per_block, P, g.lc, g.lpad,
                               g.cap, copy_bytes(scores), fan_in,
                               DTYPE_CODES[scores.dtype], ptr(sa), ptr(sb), ptr(vals),
                               ptr(ids), stream_ptr(dev))
    check_launch(lib, err, "topk_scores")
    topk_scores.launches += 1
    return vals, ids


topk_scores.launches = 0
