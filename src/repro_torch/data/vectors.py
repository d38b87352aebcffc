"""Synthetic multi-vector databases and workloads.

Mirrors the paper's evaluation setup (Section 5.1):
  - semi-synthetic columns mimicking GloVe25/50/100/200, SIFT1M (128d),
    Deep1M (96d), Music (100d), Yandex T2I (200d): clustered unit vectors
    with per-column cluster structure so ANN indexes behave realistically;
  - workloads Naive (3 cols / 4 queries), BiSimple (8 cols, p=0.3),
    BiComplex (8 cols, p=0.5), News-like (4 cols, p=0.5, 6 queries);
  - query column subsets ~ binomial(p); probabilities uniform, normalized.

All vectors are L2-normalized per column so cosine similarity == dot product
and a concatenated multi-column index scores exactly the sum of per-column
cosine scores (the paper's score aggregation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.types import Query, Vid, Workload, norm_vid

# (name, dim) per paper Table 1 (semi-synthetic pool)
PAPER_COLUMNS = [
    ("glove25", 25),
    ("glove50", 50),
    ("glove100", 100),
    ("glove200", 200),
    ("sift1m", 128),
    ("deep1m", 96),
    ("music", 100),
    ("yandex_t2i", 200),
]

NEWS_COLUMNS = [
    ("news_image", 512),
    ("news_title", 512),
    ("news_description", 768),
    ("news_content", 768),
]


def _normalize(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / np.maximum(n, 1e-12)).astype(np.float32)


def _unit_noise(rng: np.random.Generator, shape, scale: float) -> np.ndarray:
    """Noise with norm == scale regardless of dimension (per-coordinate noise
    has norm scale·√d, which swamps unit centroids at embedding dims and
    erases all cluster structure after normalization)."""
    g = rng.standard_normal(shape).astype(np.float32)
    return _normalize(g) * scale


def _clustered_vectors(rng: np.random.Generator, n: int, dim: int, n_clusters: int,
                       spread: float) -> np.ndarray:
    """Unit vectors drawn around ``n_clusters`` random centroids.

    Cluster structure makes graph/IVF indexes behave like they do on real
    embedding data (hubs, locally navigable neighborhoods). ``spread`` is the
    noise NORM relative to the unit centroid (cos(row, centroid) ≈
    1/√(1+spread²)), dimension-independent.
    """
    centroids = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centroids = _normalize(centroids)
    assign = rng.integers(0, n_clusters, size=n)
    return _normalize(centroids[assign] + _unit_noise(rng, (n, dim), spread))


@dataclass
class MultiVectorDatabase:
    """Row-aligned multi-column vector store. columns[c] has shape (N, d_c)."""

    columns: list[np.ndarray]
    names: list[str]

    def __post_init__(self):
        ns = {c.shape[0] for c in self.columns}
        if len(ns) != 1:
            raise ValueError(f"ragged column row counts: {ns}")

    @property
    def n_rows(self) -> int:
        return int(self.columns[0].shape[0])

    @property
    def n_cols(self) -> int:
        return len(self.columns)

    @property
    def dims(self) -> list[int]:
        return [int(c.shape[1]) for c in self.columns]

    def dim(self, vid: Vid) -> int:
        return int(sum(self.columns[c].shape[1] for c in norm_vid(vid)))

    def concat(self, vid: Vid) -> np.ndarray:
        cols = norm_vid(vid)
        if len(cols) == 1:
            return self.columns[cols[0]]
        return np.concatenate([self.columns[c] for c in cols], axis=1)

    def sample(self, rate: float, seed: int = 0) -> tuple["MultiVectorDatabase", np.ndarray]:
        """Uniform row sample (the paper's 1%-sample used by the estimators)."""
        rng = np.random.default_rng(seed)
        n_keep = max(32, int(round(self.n_rows * rate)))
        n_keep = min(n_keep, self.n_rows)
        ids = np.sort(rng.choice(self.n_rows, size=n_keep, replace=False))
        return MultiVectorDatabase([c[ids] for c in self.columns], list(self.names)), ids


def make_database(n_rows: int, columns: list[tuple[str, int]] | None = None,
                  seed: int = 0, n_clusters: int | None = None,
                  spread: float = 0.8, correlation: float = 0.7) -> MultiVectorDatabase:
    """Multi-column database with a shared latent item identity.

    Each row has a latent cluster id; with probability ``correlation`` a
    column's vector is drawn around that shared cluster's (column-specific)
    centroid, else around an independent cluster — modeling multi-modal data
    where an item's features correlate across modalities (e.g. a product's
    image and text), as in the paper's real News workload. correlation=0
    reproduces fully independent columns (the paper's semi-synthetic
    combination of unrelated datasets).
    """
    columns = columns if columns is not None else PAPER_COLUMNS
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, int(np.sqrt(n_rows)))
    shared_assign = rng.integers(0, n_clusters, size=n_rows)
    cols = []
    for i, (_, dim) in enumerate(columns):
        sub = np.random.default_rng(seed * 1000 + i)
        centroids = _normalize(sub.standard_normal((n_clusters, dim)).astype(np.float32))
        own = sub.integers(0, n_clusters, size=n_rows)
        use_shared = sub.random(n_rows) < correlation
        assign = np.where(use_shared, shared_assign, own)
        cols.append(_normalize(centroids[assign] + _unit_noise(sub, (n_rows, dim), spread)))
    return MultiVectorDatabase(cols, [name for name, _ in columns])


def make_queries(db: MultiVectorDatabase, vids: list[Vid], k: int = 100,
                 seed: int = 0, noise: float = 0.5) -> list[Query]:
    """Queries near the data manifold: a random row + per-column noise."""
    rng = np.random.default_rng(seed)
    queries = []
    for qid, vid in enumerate(vids):
        vid = norm_vid(vid)
        row = int(rng.integers(0, db.n_rows))
        vecs = {}
        for c in vid:
            base = db.columns[c][row]
            vecs[c] = _normalize(base + _unit_noise(rng, base.shape, noise))
        queries.append(Query(qid=qid, vid=vid, vectors=vecs, k=k))
    return queries


def binomial_vids(n_cols: int, n_queries: int, p: float, seed: int = 0) -> list[Vid]:
    """Paper workload generator: each column joins a query w.p. p (≥1 column)."""
    rng = np.random.default_rng(seed)
    vids: list[Vid] = []
    while len(vids) < n_queries:
        mask = rng.random(n_cols) < p
        if not mask.any():
            mask[rng.integers(0, n_cols)] = True
        vids.append(tuple(int(i) for i in np.nonzero(mask)[0]))
    return vids


def make_workload(db: MultiVectorDatabase, name: str = "bisimple", n_queries: int | None = None,
                  k: int = 100, seed: int = 0) -> Workload:
    """Named workloads following paper Table 2."""
    name = name.lower()
    rng = np.random.default_rng(seed + 17)
    if name == "naive":
        # paper: 3 columns (glove100, sift1m, yandex) and 4 manually crafted queries
        vids: list[Vid] = [(0,), (0, 1), (1, 2), (0, 1, 2)]
    elif name == "bisimple":
        vids = binomial_vids(db.n_cols, n_queries or 12, p=0.3, seed=seed)
    elif name == "bicomplex":
        vids = binomial_vids(db.n_cols, n_queries or 12, p=0.5, seed=seed)
    elif name == "news":
        vids = binomial_vids(db.n_cols, n_queries or 6, p=0.5, seed=seed)
    else:
        raise ValueError(f"unknown workload {name!r}")
    queries = make_queries(db, vids, k=k, seed=seed)
    probs = rng.uniform(0.5, 1.5, size=len(queries))
    return Workload(queries=queries, probs=probs)


def naive_database(n_rows: int, seed: int = 0) -> MultiVectorDatabase:
    """The paper's Naive 3-column database: GloVe100, SIFT1M, Yandex T2I."""
    cols = [("glove100", 100), ("sift1m", 128), ("yandex_t2i", 200)]
    return make_database(n_rows, cols, seed=seed)


def news_database(n_rows: int, seed: int = 0) -> MultiVectorDatabase:
    return make_database(n_rows, NEWS_COLUMNS, seed=seed)
