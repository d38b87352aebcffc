"""Port parity of the semantic result cache (``online/semcache.py``) against
the JAX package, on the fixture of tests/test_semcache.py (400 rows, 2
columns, k = 8).

The same scenario (probes, admissions, generation and epoch bumps, LRU and
ring pressure) runs through both packages' ``SemanticCache`` and must give
equal served ids and equal stats. Inside the port: an ε=0 hit is
bit-identical to the uncached engine for every index kind, the namespace's
matrix is a resident tensor on the cache's device that the probe scans in
place, and ``cache_probe_scan`` takes a tensor or numpy alike. Every
comparison is exact (ids, counters, stats); no tolerance applies.
"""
import importlib
from dataclasses import replace as dc_replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.distance.ref import squared_norms
from repro_torch.serve.engine import cache_probe_scan

K = 8
COLS = [("a", 24), ("b", 32)]


def _pkg(name):
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("core.tuner", "core.types", "data.vectors", "filter",
                      "index.registry", "ingest", "online", "online.trace")}
    kw = {"device": "cpu"} if name == "repro_torch" else {}
    return SimpleNamespace(
        name=name, kw=kw, Mint=mods["core.tuner"].Mint,
        Constraints=mods["core.types"].Constraints,
        IndexSpec=mods["core.types"].IndexSpec,
        QueryPlan=mods["core.types"].QueryPlan,
        Workload=mods["core.types"].Workload,
        make_database=mods["data.vectors"].make_database,
        make_queries=mods["data.vectors"].make_queries,
        Range=mods["filter"].Range, IndexStore=mods["index.registry"].IndexStore,
        CompactionPolicy=mods["ingest"].CompactionPolicy,
        IngestConfig=mods["ingest"].IngestConfig,
        IngestRuntime=mods["ingest"].IngestRuntime,
        OnlineRuntime=mods["online"].OnlineRuntime,
        RuntimeConfig=mods["online"].RuntimeConfig,
        SemanticCache=mods["online"].SemanticCache,
        SemCacheConfig=mods["online"].SemCacheConfig,
        row_batch=mods["online.trace"].row_batch)


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}


def _cache(P, **cfg):
    gen = cfg.pop("gen", None)
    return P.SemanticCache(P.SemCacheConfig(**cfg),
                           generation=None if gen is None else (lambda: gen["v"]),
                           **P.kw)


def _qp(P, db, seed, qid, vid=(0, 1)):
    q = P.make_queries(db, [vid], k=K, seed=seed)[0]
    q.qid = qid
    plan = P.QueryPlan(q.qid, [P.IndexSpec(vid, "flat")], [K], 1.0, 1.0)
    return q, plan


def _ids(got):
    return None if got is None else np.asarray(got).tolist()


# ---- unit scenarios: each returns a log of served ids and the stats --------


def _miss_admit_hit_near_miss(P, db):
    cache = _cache(P, epsilon=0.0, capacity=4)
    q, plan = _qp(P, db, 1, 100)
    log = []
    got, token = cache.probe(q, plan)
    log.append(_ids(got))
    token.admit(np.arange(K, dtype=np.int64))
    got, _ = cache.probe(q, plan)
    log.append(_ids(got))
    got[0] = -1  # a copy: the store is untouched
    log.append(_ids(cache.probe(q, plan)[0]))
    near = dc_replace(q, qid=101)
    near.vectors = {v: a + 1e-3 for v, a in q.vectors.items()}
    log.append(_ids(cache.probe(near, plan)[0]))
    return log, cache.stats()


def _epsilon_radius(P, db):
    cache = _cache(P, epsilon=0.5, capacity=4)
    q, plan = _qp(P, db, 2, 200)
    cache.probe(q, plan)[1].admit(np.arange(K, dtype=np.int64))
    log = []
    for i, shift in enumerate((1e-3, 1.0)):
        other = dc_replace(q, qid=201 + i)
        other.vectors = {v: a + shift for v, a in q.vectors.items()}
        log.append(_ids(cache.probe(other, plan)[0]))
    return log, cache.stats()


def _fifo_ring(P, db):
    cache = _cache(P, epsilon=0.0, capacity=2)
    qps = [_qp(P, db, 10 + i, 300 + i) for i in range(3)]
    for i, (q, plan) in enumerate(qps):
        cache.probe(q, plan)[1].admit(np.full(K, i, dtype=np.int64))
    return [_ids(cache.probe(*qp)[0]) for qp in qps], cache.stats()


def _signature_isolation(P, db):
    cache = _cache(P, epsilon=0.0, capacity=4)
    q, plan = _qp(P, db, 3, 400)
    cache.probe(q, plan)[1].admit(np.arange(K, dtype=np.int64))
    other = P.QueryPlan(q.qid, [P.IndexSpec((0, 1), "flat")], [K + 16], 1.0, 1.0)
    log = [_ids(cache.probe(q, plan)[0]),
           _ids(cache.probe(dc_replace(q, k=K + 4), plan)[0]),
           _ids(cache.probe(q, other)[0]),
           _ids(cache.probe(dc_replace(q, predicate=P.Range("score", lo=0.0, hi=0.5)),
                            plan)[0])]
    return log, cache.stats()


def _generation_and_epoch(P, db):
    gen = {"v": 0}
    cache = _cache(P, epsilon=0.0, capacity=4, gen=gen)
    q, plan = _qp(P, db, 4, 500)
    log = []
    cache.probe(q, plan)[1].admit(np.arange(K, dtype=np.int64))
    log.append(_ids(cache.probe(q, plan)[0]))
    gen["v"] += 1  # retune swap / compaction rebase
    got, token = cache.probe(q, plan)
    log.append(_ids(got))
    token.admit(np.arange(K, dtype=np.int64))
    log.append(_ids(cache.probe(q, plan)[0]))
    cache.bump()  # mutation flush
    log.append(_ids(cache.probe(q, plan)[0]))
    return log, cache.stats()


def _stale_admission(P, db):
    cache = _cache(P, epsilon=0.0, capacity=4)
    q, plan = _qp(P, db, 5, 600)
    _, token = cache.probe(q, plan)
    cache.bump()
    token.admit(np.arange(K, dtype=np.int64))
    return [_ids(cache.probe(q, plan)[0])], cache.stats()


def _namespace_lru(P, db):
    cache = _cache(P, epsilon=0.0, capacity=2, max_namespaces=2)
    log = []
    for i in range(3):
        q, plan = _qp(P, db, 6, 700 + i)
        q = dc_replace(q, k=K + i)
        cache.probe(q, plan)[1].admit(np.arange(q.k, dtype=np.int64))
    for i in range(3):
        q, plan = _qp(P, db, 6, 710 + i)
        log.append(_ids(cache.probe(dc_replace(q, k=K + i), plan)[0]))
    return log, cache.stats()


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _miss_admit_hit_near_miss, _epsilon_radius, _fifo_ring, _signature_isolation,
    _generation_and_epoch, _stale_admission, _namespace_lru)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cache_state_machine_matches_reference(name):
    """Equal served ids and equal stats (hits, misses, near misses,
    admissions, invalidations, namespaces, drops, entries, device bytes)."""
    out = {}
    for pkg, P in PKGS.items():
        db = P.make_database(400, COLS, seed=0)
        out[pkg] = SCENARIOS[name](P, db)
    assert out["repro_torch"] == out["repro"]


def test_governor_is_refused_until_tenancy():
    """The tenancy slice has landed: a governed cache charges its namespace
    under the reference's key and padded bytes, and releases it when the
    namespace dies."""
    out = {}
    for pkg, P in PKGS.items():
        gov = importlib.import_module(f"{pkg}.tenancy").MemoryGovernor(10**9)
        db = P.make_database(400, COLS, seed=0)
        cache = P.SemanticCache(governor=gov, tenant="t", **P.kw)
        q, plan = _qp(P, db, 0, 900)
        cache.probe(q, plan)[1].admit(np.arange(K))
        hit = cache.probe(q, plan)[0]
        out[pkg] = (hit.tolist(), gov.resident())
        cache.bump()
        assert gov.resident() == [] and gov.stats()["total_bytes"] == 0
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"] == (list(range(K)), [("t", ("semcache", 0), 256 * 128 * 4)])


# ---- the resident matrix and the repaired probe ------------------------------


def test_namespace_matrix_stays_resident_and_probe_scans_it_in_place():
    """The namespace's matrix and its squared norms are built once per
    admission version; probes without admissions hand the scan the SAME
    tensor (no copy, no host round trip), an admission rebuilds it."""
    P = PKGS["repro_torch"]
    db = P.make_database(400, COLS, seed=0)
    seen = []

    def spy(qmat, mat, valid_n, mat_sq):
        seen.append((mat.data_ptr(), mat_sq.data_ptr(), mat.device, valid_n))
        torch.testing.assert_close(mat_sq, squared_norms(mat), rtol=0, atol=0)
        return cache_probe_scan(qmat, mat, valid_n, device="cpu", mat_sq=mat_sq)

    cache = P.SemanticCache(P.SemCacheConfig(epsilon=0.0, capacity=4), scan=spy,
                            device="cpu")
    q, plan = _qp(P, db, 1, 100)
    cache.probe(q, plan)[1].admit(np.arange(K, dtype=np.int64))
    for _ in range(3):
        assert cache.probe(q, plan)[0] is not None
    assert len(seen) == 3 and len(set(seen)) == 1
    (ns,) = cache._ns.values()
    assert isinstance(ns.dev, torch.Tensor) and ns.dev.dtype == torch.float32
    assert seen[0][0] == ns.dev.data_ptr()
    q2, _ = _qp(P, db, 2, 101)
    cache.probe(q2, plan)[1].admit(np.arange(K, dtype=np.int64))
    assert cache.probe(q2, plan)[0] is not None
    assert seen[-1][3] == 2 and ns.dev_version == ns.version == 2
    assert seen[-1][0] == ns.dev.data_ptr()
    np.testing.assert_array_equal(ns.dev.numpy(), ns.queries)


def test_cache_probe_takes_a_tensor_or_numpy_alike():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 40)).astype(np.float32)
    mat = rng.standard_normal((16, 40)).astype(np.float32)
    mat[7] = q[2]
    a = cache_probe_scan(q, mat, 12, device="cpu")
    mt = torch.from_numpy(mat)
    b = cache_probe_scan(torch.from_numpy(q), mt, 12, device="cpu",
                         mat_sq=squared_norms(mt))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1][2, 0] == 7
    with pytest.raises(ValueError, match="float32"):
        cache_probe_scan(q, mt.double(), 12, device="cpu")


# ---- integration: ε=0 parity with the uncached engine ------------------------


def _two_rounds(rt, qs, qid0=9000):
    tks = []
    i = 0
    for _ in range(2):
        for q in qs:
            tks.append(rt.submit(dc_replace(q, qid=qid0 + i), now=i * 1e-3))
            i += 1
        rt.drain()
    return tks


def _eps0_run(P, kind):
    db = P.make_database(400, COLS, seed=0)
    qs = P.make_queries(db, [(0,), (0, 1), (1,)], k=K, seed=7)
    wl = P.Workload(queries=qs, probs=np.ones(len(qs)))
    cons = P.Constraints(theta_recall=0.85, theta_storage=3)
    mint = P.Mint(db, index_kind=kind, seed=0, min_sample_rows=300, **P.kw)
    tuned = mint.tune(wl, cons)
    asks = P.make_queries(db, [(0,), (0, 1), (1,)] * 2, k=K, seed=21)
    out = {}
    for on in (False, True):
        rt = P.OnlineRuntime(db, mint, wl, cons, result=tuned,
                             store=P.IndexStore(db, seed=0, **P.kw),
                             config=P.RuntimeConfig(max_batch=4, cooldown_s=1e9,
                                                    drift_threshold=2.0, semcache=on,
                                                    semcache_epsilon=0.0))
        tks = _two_rounds(rt, asks)
        out[on] = dict(ids=[np.asarray(t.ids).tolist() for t in tks],
                       hits=[bool(t.cache_hit) for t in tks],
                       batches=rt.batcher.stats.batches,
                       semcache=rt.stats()["semcache"])
    return out


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw", "diskann"])
def test_eps0_hits_bit_identical_and_match_reference(kind):
    """ε=0 hits equal the uncached engine inside the port, every repeat
    hits, and ids, hits and cache stats equal the reference's."""
    ref = _eps0_run(PKGS["repro"], kind)
    got = _eps0_run(PKGS["repro_torch"], kind)
    assert got[True]["ids"] == got[False]["ids"]
    assert sum(got[True]["hits"]) == len(got[True]["hits"]) // 2
    assert got[True]["batches"] < got[False]["batches"]
    for on in (False, True):
        assert got[on]["ids"] == ref[on]["ids"]
        assert got[on]["hits"] == ref[on]["hits"]
    assert got[True]["semcache"] == ref[True]["semcache"]


def _mutation_invalidation(P):
    db = P.make_database(400, COLS, seed=0)
    qs = P.make_queries(db, [(0,), (0, 1), (1,)], k=K, seed=7)
    wl = P.Workload(queries=qs, probs=np.ones(len(qs)))
    cons = P.Constraints(theta_recall=0.85, theta_storage=3)
    mint = P.Mint(db, index_kind="flat", seed=0, min_sample_rows=300, **P.kw)
    rt = P.IngestRuntime(
        db, mint, wl, cons, result=mint.tune(wl, cons), **P.kw,
        config=P.RuntimeConfig(max_batch=2, cooldown_s=1e9, drift_threshold=2.0,
                               semcache=True, semcache_epsilon=0.0),
        ingest=P.IngestConfig(policy=P.CompactionPolicy(max_delta_fraction=None,
                                                        max_dead_fraction=None),
                              min_mutated_rows=10**9))
    rng = np.random.default_rng(8)
    q, plan = _qp(P, db, 23, 0)
    log = []

    def ask(qid, now):
        tk = rt.batcher.submit(dc_replace(q, qid=qid), now, plan=plan)
        rt.drain(now)
        np.testing.assert_array_equal(np.asarray(tk.ids), rt.view.ground_truth(q))
        log.append((bool(tk.cache_hit), np.asarray(tk.ids).tolist()))

    ask(9100, 0.1)
    ask(9101, 0.2)
    rt.insert(P.row_batch(db, rng, 20))
    ask(9102, 0.3)
    ask(9103, 0.4)
    rt.delete(rng.choice(rt.table.live_ids(), 15, replace=False))
    rt.compact(reason="test", now=0.5)
    ask(9104, 0.6)
    ask(9105, 0.7)
    rt.close()
    return log, rt.stats()["semcache"]


def test_mutation_and_compaction_invalidate_then_reprime_as_reference():
    """An insert (epoch bump) and a compaction (generation bump) each kill
    the cached entry; the next ask re-flushes against the live oracle and
    re-primes. Hits, ids and stats equal the reference's."""
    got = _mutation_invalidation(PKGS["repro_torch"])
    assert [h for h, _ in got[0]] == [False, True, False, True, False, True]
    assert got == _mutation_invalidation(PKGS["repro"])
