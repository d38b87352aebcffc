"""Port parity of the graph indexes (HNSW and Vamana/DiskANN), their builds,
the engine's graph plan groups and the torch quickstart against the JAX
package.

Tolerances: with the reference's adjacency, levels, entry points and
centroid seeds carried over (``repro_torch.convert``), search ids, scores
and numDist are held exactly equal. Builds of up to 10,000 rows take exact
kNN lists and are held exactly equal; above that, k-means (``ivf._lloyd``)
seeds the candidate pools and flips assignments on last-bit differences,
so the kNN lists are held by agreement: at least 97% of the reference's
neighbor entries appear in the port's list of the same row. The quickstart
at 2,000 rows is held to the same configuration, plans, ids and costs.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.tuner import Mint as JaxMint
from repro.core.tuner import execute_workload as jax_execute_workload
from repro.core.tuner import ground_truth_cache as jax_ground_truth_cache
from repro.core.types import Constraints as JaxConstraints
from repro.core.types import IndexSpec as JSpec
from repro.core.types import QueryPlan as JPlan
from repro.data.vectors import make_database as jax_make_database
from repro.data.vectors import make_queries as jax_make_queries
from repro.data.vectors import make_workload as jax_make_workload
from repro.index import graph as jg
from repro.index.registry import IndexStore as JaxIndexStore
from repro.serve.engine import BatchEngine as JaxEngine
from repro_torch import convert
from repro_torch.core.tuner import execute_plan
from repro_torch.core.types import IndexSpec, QueryPlan
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.index import graph as tg
from repro_torch.index.registry import BUILDERS, IndexStore
from repro_torch.serve.engine import BatchEngine

ROOT = Path(__file__).resolve().parents[1]
COLS = [("a", 32), ("b", 48)]
N_ROWS = 2500
AGREEMENT = 0.97


@pytest.fixture(scope="module")
def dbs():
    return make_database(N_ROWS, COLS, seed=0), jax_make_database(N_ROWS, COLS, seed=0)


@pytest.fixture(scope="module")
def jax_graphs(dbs):
    data = dbs[1].concat((0, 1))
    return {"hnsw": jg.HNSWIndex(data, seed=0), "diskann": jg.VamanaIndex(data, seed=0)}


def carried(kind, data, j):
    if kind == "hnsw":
        return convert.hnsw_from_arrays(data, j._layers, j._layer_ids, j.entry,
                                        j.seed_centroids, j.seed_exemplars,
                                        m=j.max_degree, ef_extra=j.ef_extra,
                                        device="cpu")
    return convert.vamana_from_arrays(data, j.adj, j.entry, j.seed_centroids,
                                      j.seed_exemplars, r=j.max_degree,
                                      ef_extra=j.ef_extra, device="cpu")


def _queries(n, d, seed):
    q = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _agreement(adj, jadj):
    """Share of the reference's neighbor entries found in the port's list
    of the same row."""
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(adj, jadj))
    return hits / jadj.size


# ---- search over carried adjacency ------------------------------------------


@pytest.mark.parametrize("ek", [1, 10, 50, 200, 1000])
@pytest.mark.parametrize("kind", ["hnsw", "diskann"])
def test_search_exact_with_carried_adjacency(dbs, jax_graphs, kind, ek):
    data = dbs[0].concat((0, 1))
    j = jax_graphs[kind]
    idx = carried(kind, data, j)
    for qv in _queries(6, data.shape[1], seed=ek):
        ref, got = j.search(qv, ek), idx.search(qv, ek)
        np.testing.assert_array_equal(got.ids, ref.ids)
        np.testing.assert_array_equal(got.scores, ref.scores)
        assert got.num_dist == ref.num_dist


# ---- builds -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["hnsw", "diskann"])
def test_exact_builds_equal_jax(dbs, jax_graphs, kind):
    """Up to 10,000 rows the builds use exact kNN lists: identical graphs."""
    idx = BUILDERS[kind](dbs[0].concat((0, 1)), seed=0, device="cpu")
    j = jax_graphs[kind]
    if kind == "hnsw":
        assert idx.max_level == j.max_level and idx.entry == j.entry
        for a, b in zip(idx._layers, j._layers):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(idx.adj, j.adj)
        assert idx.entry == j.entry
    np.testing.assert_array_equal(idx.seed_exemplars, j.seed_exemplars)
    assert np.abs(idx.seed_centroids - j.seed_centroids).max() <= 1e-4
    assert idx.storage_bytes() == j.storage_bytes()


def test_knn_graph_and_edges_equal_jax(dbs):
    data = dbs[0].concat((0,))
    ids = np.arange(0, N_ROWS, 3)
    np.testing.assert_array_equal(tg.build_knn_graph(data, 12, ids=ids, device="cpu"),
                                  jg.build_knn_graph(data, 12, ids=ids))
    adj = tg.build_knn_graph(data, 10, query_block=512, device="cpu")
    np.testing.assert_array_equal(adj, jg.build_knn_graph(data, 10))
    np.testing.assert_array_equal(tg.add_reverse_edges(adj, 6), jg.add_reverse_edges(adj, 6))
    np.testing.assert_array_equal(tg.nn_descent_rounds(data, adj, 10, seed=3),
                                  jg.nn_descent_rounds(data, adj, 10, seed=3))


@pytest.fixture(scope="module")
def big():
    """12,000 rows: above the exact-kNN cut, so k-means seeds the pools."""
    cols = [("p", 16), ("q", 24)]
    return make_database(12_000, cols, seed=5), cols


def test_cluster_pool_build_agrees_with_jax(big):
    db, _ = big
    data = db.concat((0,))
    adj = tg.build_knn_graph_fast(data, 10, seed=0, device="cpu")
    jadj = jg.build_knn_graph_fast(data, 10, seed=0)
    assert adj.shape == jadj.shape == (12_000, 10)
    assert _agreement(adj, jadj) >= AGREEMENT
    cent, ex = tg.cluster_seeds(data, seed=0, device="cpu")
    jcent, jex = jg.cluster_seeds(data, seed=0)
    assert cent.shape == jcent.shape and np.mean(ex == jex) >= AGREEMENT


def test_multicolumn_build_agrees_with_jax(big):
    db, cols = big
    data = db.concat((0, 1))
    dims = [d for _, d in cols]
    adj = tg.build_knn_graph_multicol(data, dims, 12, seed=0, device="cpu")
    jadj = jg.build_knn_graph_multicol(data, dims, 12, seed=0)
    assert _agreement(adj, jadj) >= AGREEMENT


# ---- the engine's graph groups --------------------------------------------------------


@pytest.mark.parametrize("kind", ["hnsw", "diskann"])
def test_engine_graph_groups_equal_jax(dbs, kind):
    jstore = JaxIndexStore(dbs[1], seed=0)
    store = IndexStore(dbs[0], seed=0, device="cpu")
    for vid in ((0,), (1,), (0, 1)):
        store._cache[IndexSpec(vid, kind)] = carried(kind, dbs[0].concat(vid),
                                                     jstore.get(JSpec(vid, kind)))
    eng, jeng = BatchEngine(dbs[0], store=store), JaxEngine(dbs[1], store=jstore)
    vids = [(0, 1), (0,), (1,), (0, 1)]
    qs, jqs = make_queries(dbs[0], vids, k=10, seed=3), jax_make_queries(dbs[1], vids,
                                                                          k=10, seed=3)

    def plans(q, QP, Spec):
        out = [QP(q.qid, [Spec(q.vid, kind)], [40], 1.0, 1.0)]
        if len(q.vid) > 1:
            out.append(QP(q.qid, [Spec((c,), kind) for c in q.vid], [25, 60], 1.0, 1.0))
        return out

    pairs = [(q, p) for q in qs for p in plans(q, QueryPlan, IndexSpec)]
    jpairs = [(q, p) for q in jqs for p in plans(q, JPlan, JSpec)]
    got, want = eng.execute_batch(pairs), jeng.execute_batch(jpairs)
    for (q, p), m, jm in zip(pairs, got, want):
        np.testing.assert_array_equal(m.ids, jm.ids)
        assert (m.cost, m.num_dist, m.recall, m.eks) == (jm.cost, jm.num_dist,
                                                         jm.recall, jm.eks)
        # the per-query reference path agrees with the batched engine
        ref = execute_plan(dbs[0], store, q, p)
        np.testing.assert_array_equal(ref.ids, m.ids)
        assert (ref.cost, ref.num_dist) == (m.cost, m.num_dist)
    assert eng.counters.as_dict() == jeng.counters.as_dict()
    assert eng.counters.fallback == sum(len(p.indexes) for _, p in pairs)


def test_index_store_builds_graph_kinds_on_its_device():
    db = make_database(900, [("a", 16), ("b", 8)], seed=1)
    store = IndexStore(db, seed=0, device="cpu")
    idx = store.get(IndexSpec((0, 1), "hnsw"))
    assert isinstance(idx, tg.HNSWIndex) and idx.device.type == "cpu"
    assert idx.col_dims == [16, 8]
    jidx = JaxIndexStore(jax_make_database(900, [("a", 16), ("b", 8)], seed=1),
                         seed=0).get(JSpec((0, 1), "hnsw"))
    for a, b in zip(idx._layers, jidx._layers):
        np.testing.assert_array_equal(a, b)
    assert isinstance(store.get(IndexSpec((1,), "diskann")), tg.VamanaIndex)


# ---- the torch quickstart --------------------------------------------------------------


def test_torch_quickstart_matches_the_jax_quickstart():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_quickstart
    finally:
        sys.path.remove(str(ROOT / "examples"))
    r = torch_quickstart.run(2000, device="cpu")
    jdb = jax_make_database(2000, torch_quickstart.COLUMNS, seed=0)
    jwl = jax_make_workload(jdb, "news", n_queries=6, k=50, seed=0)
    cons = JaxConstraints(theta_recall=0.9, theta_storage=4)
    jmint = JaxMint(jdb, index_kind="hnsw", seed=0)
    jres, jpc = jmint.tune(jwl, cons), jmint.per_column(jwl, cons)
    jstore, jgt = JaxIndexStore(jdb, seed=0), jax_ground_truth_cache(jdb, jwl)
    for res, jr, key in ((r["result"], jres, "mint"), (r["pc"], jpc, "per_column")):
        assert sorted(s.name for s in res.configuration) == sorted(
            s.name for s in jr.configuration)
        assert {q: p.describe() for q, p in res.plans.items()} == {
            q: p.describe() for q, p in jr.plans.items()}
        jm = jax_execute_workload(jdb, jstore, jwl, jr, jgt)
        m = r[key]
        for a, b in zip(m.per_query, jm.per_query):
            np.testing.assert_array_equal(a.ids, b.ids)
            assert (a.cost, a.num_dist) == (b.cost, b.num_dist)
        assert (m.weighted_cost, m.mean_recall) == (jm.weighted_cost, jm.mean_recall)
    assert r["mint"].mean_recall >= 0.9
    # the same plans over diskann indexes
    dk = torch_quickstart.with_kind(r["result"], "diskann")
    assert {s.kind for s in dk.configuration} == {"diskann"}
    assert [p.eks for p in dk.plans.values()] == [p.eks for p in r["result"].plans.values()]
