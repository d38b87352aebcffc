"""Exact (flat) search: one streaming-scan kernel call on the card, a
blocked matmul + top-k on the CPU.

Used for ground truth, re-ranking, and as the 'flat' index kind.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.base import SearchResult, VectorIndex
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.streaming.ops import streaming_fused_scan
from repro_torch.kernels.topk.ref import topk_ref


def batch_exact_topk(data: np.ndarray, qvecs: np.ndarray, k: int,
                     block_rows: int = 8192, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by dot product for a batch of queries over ``data``
    (N, d) -> (ids (Q, k) int64, scores (Q, k)), best first.

    On the card the whole scan is ONE streaming fused scan (distance +
    top-k, no score matrix). On the CPU it scans blocks of ``block_rows``
    rows with a running merge, so memory stays at block_rows x Q scores.
    """
    device = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    qvecs = np.atleast_2d(np.asarray(qvecs, dtype=np.float32))
    n = data.shape[0]
    k = min(k, n)
    if device.type == "cuda":
        vals, idx = streaming_fused_scan(
            torch.as_tensor(qvecs, device=device),
            torch.as_tensor(data, device=device), k=k)
        return idx.cpu().numpy().astype(np.int64), vals.cpu().numpy()
    q = torch.as_tensor(qvecs)
    best_scores = None
    best_ids = None
    for start in range(0, n, block_rows):
        block = torch.as_tensor(data[start:start + block_rows])
        vals, idx = topk_ref(q @ block.T, min(k, block.shape[0]))
        vals = vals.numpy()
        ids = idx.numpy().astype(np.int64) + start
        if best_scores is None:
            best_scores, best_ids = vals, ids
        else:
            cat_s = np.concatenate([best_scores, vals], axis=1)
            cat_i = np.concatenate([best_ids, ids], axis=1)
            sel = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
            best_scores = np.take_along_axis(cat_s, sel, axis=1)
            best_ids = np.take_along_axis(cat_i, sel, axis=1)
    return best_ids, best_scores


class FlatIndex(VectorIndex):
    """Exact scan; numDist = N (every row scored)."""

    kind = "flat"
    max_degree = 0

    def __init__(self, data: np.ndarray, device=None):
        super().__init__(data)
        self.device = resolve_device(device)

    def search(self, qvec: np.ndarray, ek: int) -> SearchResult:
        ids, scores = batch_exact_topk(self.data, qvec[None, :], ek,
                                       device=self.device)
        return SearchResult(ids=ids[0], scores=scores[0], num_dist=self.n)

    def storage_bytes(self, edge_bytes: int = 4) -> int:
        return 0  # no index structure beyond the vectors themselves
