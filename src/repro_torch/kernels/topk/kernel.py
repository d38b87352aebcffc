"""Top-k kernel wrapper: (B, N) scores -> (B, k) values and ids, best first.

On a CUDA tensor it launches ``csrc/topk.cu`` (the port of
``repro/kernels/topk/kernel.py:_topk_kernel``); on a CPU tensor it computes
the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (CHUNK, DTYPE_CODES, NEG_INF, cdiv,
                                        check_cuda_operand, check_launch, load_library,
                                        merge_fan_in, merge_scratch_elems, neg_inf_for,
                                        ptr, stream_ptr)
from repro_torch.kernels.topk.ref import topk_ref

__all__ = ["NEG_INF", "neg_inf_for", "topk_scores"]


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
    P, Lc = cdiv(N, CHUNK), min(k_eff, CHUNK)
    fan_in = merge_fan_in(B, P, Lc)
    n = merge_scratch_elems(B, P, Lc, k_eff, fan_in)
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    sb = torch.empty(n, dtype=torch.int64, device=dev)
    lib = load_library()
    err = lib.mint_topk_scores(ptr(scores), B, N, k_eff, P, Lc, fan_in,
                               DTYPE_CODES[scores.dtype], ptr(sa), ptr(sb),
                               ptr(vals), ptr(ids), stream_ptr(dev))
    check_launch(lib, err, "topk_scores")
    topk_scores.launches += 1
    return vals, ids


topk_scores.launches = 0
