"""Graph ANN indexes: HNSW-style hierarchical navigable graph and
DiskANN/Vamana-style alpha-pruned graph.

Construction uses exact kNN neighbor lists (``bruteforce.batch_exact_topk``:
the streaming-scan kernel on the card, a blocked matmul on the CPU; k-means
pools from ``ivf._lloyd`` on the index's device) instead of incremental
insertion — an equivalent
navigable graph that is orders of magnitude faster to build in Python while
preserving the *search-time* behaviour MINT models: numDist ≈ linear in ek
(paper Fig. 5) and recall ≈ logarithmic in ek (paper Fig. 6). Every search
counts score invocations exactly.
"""
from __future__ import annotations

import heapq

import numpy as np

import torch

from repro_torch.index.base import SearchResult, VectorIndex
from repro_torch.index.bruteforce import batch_exact_topk
from repro_torch.kernels.common import resolve_device


def build_knn_graph(data: np.ndarray, k: int, query_block: int = 2048,
                    ids: np.ndarray | None = None, device=None) -> np.ndarray:
    """Exact kNN ids (N, k) excluding self. ``ids`` restricts to a row subset.
    Each block of ``query_block`` rows is one exact top-k on ``device``."""
    device = resolve_device(device)
    rows = data if ids is None else data[ids]
    n = rows.shape[0]
    k_eff = min(k + 1, n)
    out = np.empty((n, min(k, n - 1)), dtype=np.int32)
    for start in range(0, n, query_block):
        q = rows[start:start + query_block]
        nbr_ids, _ = batch_exact_topk(rows, q, k_eff, device=device)
        for r in range(q.shape[0]):
            row = nbr_ids[r]
            row = row[row != (start + r)][: out.shape[1]]
            out[start + r, : row.shape[0]] = row
            if row.shape[0] < out.shape[1]:  # tiny-graph padding
                out[start + r, row.shape[0]:] = row[-1] if row.shape[0] else 0
    return out


def _kmeans(data: np.ndarray, init: np.ndarray, device: torch.device
            ) -> tuple[np.ndarray, np.ndarray]:
    """Six Lloyd rounds of ``ivf._lloyd`` on ``device`` -> host (centroids,
    assignment)."""
    from repro_torch.index.ivf import _lloyd  # local import to avoid cycle
    centroids, assign = _lloyd(torch.as_tensor(data, device=device),
                               torch.as_tensor(init, device=device), 6)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def build_knn_graph_fast(data: np.ndarray, k: int, seed: int = 0,
                         rows_per_cluster: int = 256, n_probe_clusters: int = 3,
                         device=None) -> np.ndarray:
    """Cluster-assisted approximate kNN graph — O(N · pool · d) instead of
    O(N² · d). k-means partitions the rows; each row's kNN candidates are the
    members of its own + the ``n_probe_clusters`` nearest partitions.

    Used for N above ~20k where the exact build would dominate benchmark
    time; graph quality is equivalent for MINT's purposes (search cost /
    recall curves keep their linear / logarithmic shapes).
    """
    device = resolve_device(device)
    n = data.shape[0]
    if n <= 10000:
        return build_knn_graph(data, k, device=device)
    n_lists = max(8, n // rows_per_cluster)
    n_probe_clusters = max(n_probe_clusters, min(7, n // 10000))
    rng = np.random.default_rng(seed)
    init = data[rng.choice(n, size=n_lists, replace=False)]
    centroids, assign = _kmeans(data, init, device)

    # nearest clusters per cluster (include self first)
    csims = centroids @ centroids.T
    order = np.argsort(-csims, axis=1)[:, : 1 + n_probe_clusters]

    members: list[np.ndarray] = [np.nonzero(assign == c)[0] for c in range(n_lists)]
    out = np.zeros((n, k), dtype=np.int32)
    for c in range(n_lists):
        mine = members[c]
        if mine.shape[0] == 0:
            continue
        pool = np.concatenate([members[cc] for cc in order[c]])
        sims = data[mine] @ data[pool].T  # (m, P)
        # mask self matches
        self_pos = {int(r): i for i, r in enumerate(pool)}
        for i, r in enumerate(mine):
            j = self_pos.get(int(r))
            if j is not None:
                sims[i, j] = -np.inf
        kk = min(k, pool.shape[0] - 1)
        part = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
        srt = np.take_along_axis(sims, part, axis=1)
        ordr = np.argsort(-srt, axis=1, kind="stable")
        top = np.take_along_axis(part, ordr, axis=1)
        sel = pool[top]
        out[mine, :kk] = sel
        if kk < k:
            out[mine, kk:] = sel[:, -1:]
    return nn_descent_rounds(data, out, k, rounds=2, seed=seed)


def nn_descent_rounds(data: np.ndarray, adj: np.ndarray, k: int, rounds: int = 2,
                      nbr_sample: int = 12, seed: int = 0, block: int = 1024) -> np.ndarray:
    """NN-descent refinement: neighbors-of-neighbors are likely neighbors.

    Each round rescans (current ∪ sampled 2-hop) candidates in the full
    space; 1-2 rounds repair most of the recall a cluster-pool seed graph
    leaves behind. Fully vectorized (blocked gathers + einsum)."""
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    adj = adj.copy()
    for r in range(rounds):
        s = min(nbr_sample, adj.shape[1])
        cols1 = rng.choice(adj.shape[1], size=s, replace=False)
        cols2 = rng.choice(adj.shape[1], size=min(8, adj.shape[1]), replace=False)
        hop1 = adj[:, cols1]                                  # (N, s)
        hop2 = adj[hop1.reshape(-1)][:, cols2].reshape(n, -1)  # (N, s*8)
        cand = np.concatenate([adj, hop2], axis=1)
        out = np.zeros((n, k), dtype=np.int32)
        for start in range(0, n, block):
            rows = slice(start, min(start + block, n))
            cb = cand[rows]
            scores = np.einsum("bcd,bd->bc", data[cb], data[rows])
            scores[cb == np.arange(start, start + cb.shape[0])[:, None]] = -np.inf
            # dedupe: first occurrence wins (ties by -inf on repeats)
            srt_idx = np.argsort(cb, axis=1, kind="stable")
            cb_sorted = np.take_along_axis(cb, srt_idx, axis=1)
            dup = np.zeros_like(cb_sorted, dtype=bool)
            dup[:, 1:] = cb_sorted[:, 1:] == cb_sorted[:, :-1]
            dup_unsorted = np.zeros_like(dup)
            np.put_along_axis(dup_unsorted, srt_idx, dup, axis=1)
            scores[dup_unsorted] = -np.inf
            kk = min(k, cb.shape[1])
            part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
            srt = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-srt, axis=1, kind="stable")
            top = np.take_along_axis(part, order, axis=1)
            out[rows] = np.take_along_axis(cb, top, axis=1)
        adj = out
    return adj


def build_knn_graph_multicol(data: np.ndarray, col_dims: list[int], k: int,
                             seed: int = 0, block: int = 1024,
                             device=None) -> np.ndarray:
    """kNN graph for a multi-column concatenation.

    k-means candidate pools degrade in concatenated spaces (the sum of m
    independent cluster structures has no global clusters), so we generate
    candidates per column — where structure exists — and re-score the union
    in the concat space. A sum-score neighbor is w.h.p. a good neighbor in at
    least one column, so the union candidate pool has high true-kNN recall.
    """
    device = resolve_device(device)
    n = data.shape[0]
    m = len(col_dims)
    if m <= 1 or n <= 10000:
        return build_knn_graph_fast(data, k, seed=seed, device=device)
    offs = np.concatenate([[0], np.cumsum(col_dims)])
    kc = max(8, int(np.ceil(1.5 * k / m)))
    cands = []
    for i in range(m):
        sub = np.ascontiguousarray(data[:, offs[i]:offs[i + 1]])
        cands.append(build_knn_graph_fast(sub, kc, seed=seed + 7 * i,
                                          device=device))
    cand = np.concatenate(cands, axis=1)  # (N, m*kc)
    out = np.zeros((n, k), dtype=np.int32)
    for start in range(0, n, block):
        rows = slice(start, min(start + block, n))
        cb = cand[rows]                       # (B, C)
        vecs = data[cb]                       # (B, C, D)
        scores = np.einsum("bcd,bd->bc", vecs, data[rows])
        scores[cb == np.arange(start, start + cb.shape[0])[:, None]] = -np.inf
        kk = min(k, cb.shape[1])
        part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        srt = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-srt, axis=1, kind="stable")
        top = np.take_along_axis(part, order, axis=1)
        sel = np.take_along_axis(cb, top, axis=1)
        out[rows, :kk] = sel
        if kk < k:
            out[rows, kk:] = sel[:, -1:]
    return nn_descent_rounds(data, out, k, rounds=2, seed=seed)


def add_reverse_edges(adj: np.ndarray, cap: int) -> np.ndarray:
    """Append up to ``cap`` reverse edges per node (vectorized).

    Directed kNN lists orphan anti-hub nodes (they appear in nobody's list),
    which silently caps recall; HNSW links bidirectionally. -1 entries pad.
    """
    n, k = adj.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = adj.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    # position of each edge within its destination group
    starts = np.searchsorted(dst_s, np.arange(n))
    pos = np.arange(dst_s.shape[0]) - starts[dst_s]
    keep = pos < cap
    rev = -np.ones((n, cap), dtype=np.int32)
    rev[dst_s[keep], pos[keep]] = src_s[keep]
    return np.concatenate([adj, rev], axis=1)


def cluster_seeds(data: np.ndarray, seed: int = 0, rows_per_cluster: int = 256,
                  device=None) -> tuple[np.ndarray, np.ndarray]:
    """k-means centroids + per-cluster exemplar row ids, used to seed graph
    beams (fixes cross-cluster reachability for out-of-manifold queries —
    the IVF+graph hybrid used by industrial systems). Centroid scoring is
    charged to numDist at search time."""
    device = resolve_device(device)
    n = data.shape[0]
    n_lists = int(np.clip(n // rows_per_cluster, 8, 4096))
    n_lists = min(n_lists, n)
    rng = np.random.default_rng(seed)
    init = data[rng.choice(n, size=n_lists, replace=False)]
    centroids, assign = _kmeans(data, init, device)
    # exemplar = member most similar to its centroid
    sims = np.einsum("nd,nd->n", data, centroids[assign])
    exemplars = np.full(n_lists, -1, dtype=np.int64)
    best = np.full(n_lists, -np.inf)
    for i in range(n):
        c = assign[i]
        if sims[i] > best[c]:
            best[c] = sims[i]
            exemplars[c] = i
    ok = exemplars >= 0
    return centroids[ok], exemplars[ok]


class _BeamSearcher:
    """Best-first beam search over an adjacency list, with numDist accounting."""

    def __init__(self, data: np.ndarray, neighbors: np.ndarray):
        self.data = data
        self.neighbors = neighbors  # (N, R) int32, -1 padded

    def search(self, qvec: np.ndarray, entries: np.ndarray, ef: int,
               visited: np.ndarray | None = None) -> tuple[list[tuple[float, int]], int]:
        data, neighbors = self.data, self.neighbors
        if visited is None:
            visited = np.zeros(data.shape[0], dtype=bool)
        qvec = np.asarray(qvec, dtype=np.float32)
        entries = np.unique(np.asarray(entries, dtype=np.int64))
        visited[entries] = True
        scores = data[entries] @ qvec
        num_dist = int(entries.shape[0])

        # candidates: max-heap (by -score); results: min-heap of size <= ef
        candidates = [(-float(s), int(i)) for s, i in zip(scores, entries)]
        heapq.heapify(candidates)
        results = [(float(s), int(i)) for s, i in zip(scores, entries)]
        heapq.heapify(results)
        while len(results) > ef:
            heapq.heappop(results)

        while candidates:
            neg_s, node = heapq.heappop(candidates)
            if len(results) >= ef and -neg_s < results[0][0]:
                break  # best frontier candidate can't improve top-ef
            nbrs = neighbors[node]
            nbrs = nbrs[nbrs >= 0]
            fresh = np.unique(nbrs[~visited[nbrs]])
            if fresh.shape[0] == 0:
                continue
            visited[fresh] = True
            s = data[fresh] @ qvec
            num_dist += int(fresh.shape[0])
            thresh = results[0][0] if len(results) >= ef else -np.inf
            for sc, nid in zip(s, fresh):
                sc = float(sc)
                if len(results) < ef:
                    heapq.heappush(results, (sc, int(nid)))
                    heapq.heappush(candidates, (-sc, int(nid)))
                    thresh = results[0][0]
                elif sc > thresh:
                    heapq.heapreplace(results, (sc, int(nid)))
                    heapq.heappush(candidates, (-sc, int(nid)))
                    thresh = results[0][0]
        return sorted(results, key=lambda t: -t[0]), num_dist


class HNSWIndex(VectorIndex):
    """Hierarchical navigable graph (HNSW-style).

    Layer 0: exact-kNN edges (degree 2M) + 2 random long edges per node for
    connectivity. Upper layers: exponentially-thinned subsets (P[level>=l] =
    M^-l) with exact-kNN edges among layer members. Search descends the
    hierarchy greedily, then runs an ef-beam at layer 0 (standard HNSW).
    The build runs on ``device`` (None: the card); walks run on the host.
    """

    kind = "hnsw"

    def __init__(self, data: np.ndarray, m: int = 16, seed: int = 0,
                 ef_extra: int = 100, col_dims: list[int] | None = None,
                 device=None):
        super().__init__(data)
        self.device = resolve_device(device)
        self.max_degree = m
        self.ef_extra = ef_extra
        self.col_dims = col_dims
        rng = np.random.default_rng(seed)
        ml = 1.0 / np.log(max(m, 2))
        levels = np.floor(-np.log(rng.uniform(1e-12, 1.0, self.n)) * ml).astype(np.int32)
        self.max_level = int(levels.max()) if self.n else 0

        # layer 0: degree M kNN edges + M/2 reverse edges + random long edges
        # (fat graphs multiply per-hop scoring cost — numDist slope — while
        # NN-descent-refined kNN edges keep recall at HNSW's classic M=16)
        deg0 = min(m, max(self.n - 1, 1))
        if col_dims is not None and len(col_dims) > 1:
            knn0 = build_knn_graph_multicol(self.data, col_dims, deg0, seed=seed,
                                            device=self.device)
        else:
            knn0 = build_knn_graph_fast(self.data, deg0, seed=seed,
                                        device=self.device)
        knn0 = add_reverse_edges(knn0, cap=max(m // 2, 4))
        longe = rng.integers(0, self.n, size=(self.n, 2)).astype(np.int32)
        self._layers = [np.concatenate([knn0, longe], axis=1)]
        self._layer_ids = [np.arange(self.n, dtype=np.int64)]

        for lvl in range(1, self.max_level + 1):
            ids = np.nonzero(levels >= lvl)[0]
            if ids.shape[0] <= 1:
                self.max_level = lvl - 1
                break
            local = build_knn_graph(self.data, min(m, ids.shape[0] - 1), ids=ids,
                                    device=self.device)
            self._layers.append(ids[local].astype(np.int32))  # global ids, dense local rows
            self._layer_ids.append(ids)
        # entry = a node on the top layer, plus centroid-seeded entries for
        # layer-0 beams (cross-cluster reachability; numDist-accounted)
        self.entry = int(self._layer_ids[self.max_level][0]) if self.n else 0
        self.seed_centroids, self.seed_exemplars = cluster_seeds(
            self.data, seed=seed, device=self.device)
        self.n_seed_entries = 8
        self._make_searchers()

    def _make_searchers(self) -> None:
        """Beam searchers over ``_layers`` (layer 0 on global ids, upper
        layers on local ids)."""
        self._searchers = []
        for lvl, adj in enumerate(self._layers):
            if lvl == 0:
                self._searchers.append(_BeamSearcher(self.data, adj))
            else:
                # upper layers are searched via a local-id searcher
                ids = self._layer_ids[lvl]
                remap = -np.ones(self.n, dtype=np.int64)
                remap[ids] = np.arange(ids.shape[0])
                local_adj = remap[adj].astype(np.int32)
                self._searchers.append(
                    (_BeamSearcher(self.data[ids], local_adj), ids, remap))

    def search(self, qvec: np.ndarray, ek: int) -> SearchResult:
        qvec = np.asarray(qvec, dtype=np.float32)
        num_dist = 0
        entry = self.entry
        for lvl in range(self.max_level, 0, -1):
            searcher, ids, remap = self._searchers[lvl]
            local_entry = remap[entry]
            res, nd = searcher.search(qvec, np.asarray([local_entry]), ef=1)
            num_dist += nd
            entry = int(ids[res[0][1]])
        # efSearch = ek + slack: the standard production policy — beams at
        # exactly ek are myopic (recall ~0.6 at ek=k); the slack buys recall
        # far more cheaply than inflating ek itself.
        ef = ek + self.ef_extra
        csims = self.seed_centroids @ qvec
        num_dist += int(self.seed_centroids.shape[0])
        top_c = np.argsort(-csims, kind="stable")[: self.n_seed_entries]
        entries = np.concatenate([[entry], self.seed_exemplars[top_c]])
        res, nd = self._searchers[0].search(qvec, entries, ef=ef)
        num_dist += nd
        res = res[:ek]
        return SearchResult(
            ids=np.asarray([i for _, i in res], dtype=np.int64),
            scores=np.asarray([s for s, _ in res], dtype=np.float32),
            num_dist=num_dist,
        )


class VamanaIndex(VectorIndex):
    """DiskANN/Vamana-style single-layer alpha-pruned graph, medoid entry.
    The build runs on ``device`` (None: the card); walks run on the host."""

    kind = "diskann"

    def __init__(self, data: np.ndarray, r: int = 20, alpha: float = 1.2,
                 pool: int = 48, seed: int = 0, ef_extra: int = 100,
                 col_dims: list[int] | None = None, device=None):
        super().__init__(data)
        self.device = resolve_device(device)
        self.max_degree = r
        self.ef_extra = ef_extra
        self.col_dims = col_dims
        pool = min(pool, max(self.n - 1, 1))
        if self.n <= 10000:
            knn = build_knn_graph(self.data, pool, device=self.device)
            adj = self._alpha_prune(knn, r, alpha)
        elif col_dims is not None and len(col_dims) > 1:
            adj = build_knn_graph_multicol(self.data, col_dims, r, seed=seed,
                                           device=self.device)
        else:
            # at scale: approximate kNN edges (alpha-prune is O(N·pool²·d) in
            # Python — documented simplification; search behaviour preserved)
            adj = build_knn_graph_fast(self.data, r, seed=seed, device=self.device)
        adj = add_reverse_edges(adj, cap=max(r // 2, 4))
        rng = np.random.default_rng(seed)
        longe = rng.integers(0, self.n, size=(self.n, 2)).astype(np.int32)
        self.adj = np.concatenate([adj, longe], axis=1)
        mean = self.data.mean(axis=0)
        self.entry = int(np.argmax(self.data @ mean))  # medoid by similarity
        self.seed_centroids, self.seed_exemplars = cluster_seeds(
            self.data, seed=seed, device=self.device)
        self.n_seed_entries = 8
        self._searcher = _BeamSearcher(self.data, self.adj)

    def _alpha_prune(self, knn: np.ndarray, r: int, alpha: float) -> np.ndarray:
        """RobustPrune over the exact-kNN candidate pool (similarity form):
        keep candidate c unless an already-kept neighbor b is much closer to c
        than the node is (sim(b, c) > alpha_sim * sim(node, c))."""
        n = self.n
        out = -np.ones((n, r), dtype=np.int32)
        for v in range(n):
            cands = knn[v]
            kept: list[int] = []
            cand_vecs = self.data[cands]
            node_sims = cand_vecs @ self.data[v]
            order = np.argsort(-node_sims, kind="stable")
            for idx in order:
                if len(kept) >= r:
                    break
                c = int(cands[idx])
                if c == v or c in kept:
                    continue
                ok = True
                if kept:
                    sims_kb = self.data[kept] @ self.data[c]
                    if np.any(sims_kb > alpha * node_sims[idx]):
                        ok = False
                if ok:
                    kept.append(c)
            out[v, :len(kept)] = kept
        return out

    def search(self, qvec: np.ndarray, ek: int) -> SearchResult:
        ef = ek + self.ef_extra
        qvec = np.asarray(qvec, np.float32)
        csims = self.seed_centroids @ qvec
        top_c = np.argsort(-csims, kind="stable")[: self.n_seed_entries]
        entries = np.concatenate([[self.entry], self.seed_exemplars[top_c]])
        res, nd = self._searcher.search(qvec, entries, ef=ef)
        nd += int(self.seed_centroids.shape[0])
        res = res[:ek]
        return SearchResult(
            ids=np.asarray([i for _, i in res], dtype=np.int64),
            scores=np.asarray([s for s, _ in res], dtype=np.float32),
            num_dist=nd,
        )
