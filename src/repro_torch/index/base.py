"""Vector index protocol with distance-computation accounting.

MINT's cost model is ``cost_idx = dim * numDist`` (paper Eq. 5): every index
here counts score-function invocations exactly, so measured cost is the
paper's proxy with no instrumentation gap.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np


@dataclass
class SearchResult:
    ids: np.ndarray        # (ek,) item ids, best first
    scores: np.ndarray     # (ek,) partial scores
    num_dist: int          # score-function invocations for this search


class VectorIndex(abc.ABC):
    """An ANN index over a single (possibly concatenated) vector matrix."""

    def __init__(self, data: np.ndarray):
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.n, self.dim = self.data.shape

    @abc.abstractmethod
    def search(self, qvec: np.ndarray, ek: int) -> SearchResult:
        """Retrieve top-ek item ids by dot-product score, counting numDist."""

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def storage_bytes(self, edge_bytes: int = 4) -> int:
        """Paper Section 2.2: items × degree × edge size (graph indexes);
        overridden where the layout differs."""
        degree = getattr(self, "max_degree", 16)
        return int(self.n * degree * edge_bytes)


def exact_topk(data: np.ndarray, qvec: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by dot product (numpy; used for ground truth on samples)."""
    scores = data @ np.asarray(qvec, dtype=np.float32)
    k = min(k, scores.shape[0])
    part = np.argpartition(-scores, k - 1)[:k]
    order = np.argsort(-scores[part], kind="stable")
    ids = part[order]
    return ids, scores[ids]
