"""IVF-Flat — the accelerator-native index kind.

Cosine k-means partitions (Lloyd in PyTorch on the index's device); a
search probes the nprobe nearest partitions and scores every row in them.
numDist = n_partitions (centroid pass) + rows scanned, exactly MINT's proxy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.index.base import SearchResult, VectorIndex
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.streaming.ops import streaming_fused_scan


def _scan_gathered(sub: np.ndarray, qvec: np.ndarray, ek: int,
                   device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Score a gathered probe union (m, d) against one query and return the
    local (positions, scores) of the ek best, best first. On the card this
    is ONE streaming fused scan; on the CPU it is the reference's numpy
    argpartition path."""
    ek = min(ek, sub.shape[0])
    if device.type == "cuda":
        vals, idx = streaming_fused_scan(
            torch.as_tensor(qvec[None, :], device=device),
            torch.as_tensor(sub, device=device), k=ek)
        return idx[0].cpu().numpy().astype(np.int64), vals[0].cpu().numpy()
    scores = sub @ qvec
    part = np.argpartition(-scores, ek - 1)[:ek]
    order = np.argsort(-scores[part], kind="stable")
    sel = part[order]
    return sel.astype(np.int64), scores[sel]


def _lloyd(data: torch.Tensor, init: torch.Tensor, n_iters: int = 8
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine k-means: assign each row to its most similar centroid (first
    maximum wins), move centroids to the re-normalized means. The update is
    a one-hot matmul rather than ``index_add_``, whose float atomics on the
    card would make builds differ run to run."""
    centroids = init
    n_lists = init.shape[0]
    for _ in range(n_iters):
        assign = torch.argmax(data @ centroids.T, dim=1)
        onehot = torch.nn.functional.one_hot(assign, n_lists).to(data.dtype)
        sums = onehot.T @ data
        counts = onehot.sum(dim=0)[:, None]
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1), centroids)
        del onehot, sums
        norm = torch.linalg.norm(new, dim=1, keepdim=True)
        centroids = new / torch.clamp(norm, min=1e-12)
    return centroids, torch.argmax(data @ centroids.T, dim=1)


class IVFFlatIndex(VectorIndex):
    kind = "ivf"
    max_degree = 0

    def __init__(self, data: np.ndarray, n_lists: int | None = None,
                 n_iters: int = 8, seed: int = 0, device=None):
        super().__init__(data)
        self.device = resolve_device(device)
        if n_lists is None:
            n_lists = max(4, int(np.sqrt(self.n)))
        n_lists = min(n_lists, self.n)
        rng = np.random.default_rng(seed)
        init = self.data[rng.choice(self.n, size=n_lists, replace=False)]
        centroids, assign = _lloyd(torch.as_tensor(self.data, device=self.device),
                                   torch.as_tensor(init, device=self.device),
                                   n_iters)
        self.centroids = centroids.cpu().numpy()
        assign = assign.cpu().numpy()
        order = np.argsort(assign, kind="stable")
        self.row_ids = order.astype(np.int64)
        self.offsets = np.searchsorted(assign[order], np.arange(n_lists + 1))
        self.n_lists = n_lists

    def _nprobe_for(self, ek: int, overscan: float = 4.0) -> int:
        avg = max(self.n / self.n_lists, 1.0)
        return int(np.clip(np.ceil(overscan * ek / avg), 1, self.n_lists))

    def search(self, qvec: np.ndarray, ek: int, nprobe: int | None = None) -> SearchResult:
        qvec = np.asarray(qvec, dtype=np.float32)
        csims = self.centroids @ qvec
        num_dist = self.n_lists
        nprobe = nprobe if nprobe is not None else self._nprobe_for(ek)
        probe = np.argsort(-csims, kind="stable")[:nprobe]
        rows = np.concatenate([
            self.row_ids[self.offsets[p]:self.offsets[p + 1]] for p in probe
        ]) if nprobe else np.empty(0, dtype=np.int64)
        if rows.shape[0] == 0:
            return SearchResult(np.empty(0, np.int64), np.empty(0, np.float32), num_dist)
        num_dist += int(rows.shape[0])
        sel, scores = _scan_gathered(self.data[rows], qvec, ek, self.device)
        return SearchResult(ids=rows[sel], scores=scores, num_dist=num_dist)

    def storage_bytes(self, edge_bytes: int = 4) -> int:
        # centroid table + inverted-list row ids
        return int(self.centroids.size * 4 + self.row_ids.size * edge_bytes)
