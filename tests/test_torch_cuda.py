"""The port's hand-written kernels against their plain PyTorch versions on
the card, over the grid and tolerance rule of ``repro_torch.kernels.parity``
(the same grid ``chip_smoke.py`` runs). Every test here needs a CUDA device
and skips without one; the file imports neither JAX nor the reference
package, so it runs on the GPU machine:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.parity import (CARD_CASES, FLASH_CASES, FLASH_DTYPES, TOPK_CASES,
                                        check_case, check_flash_case, check_scores,
                                        check_topk_case)
from repro_torch.kernels.topk.kernel import topk_scores
from repro_torch.kernels.topk.ref import topk_ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    common.strict_fp32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda_device, name, metric, dtype):
    check_case(name, metric, DTYPES[dtype], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_cases_equal_plain_on_card(cuda_device, name):
    """Rising scores, ties, NEG_INF tails, k beyond the live columns, 1e6
    columns, k = 2048 and odd N in each dtype: equal to ``topk_ref``."""
    check_topk_case(name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
def test_distance_and_topk_kernels_match_plain_on_card(cuda_device, metric):
    """A serving-width case: 64 queries at a padded width of 384, k = 2048."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(64, 384, generator=g).to(cuda_device)
    db = torch.randn(5000, 384, generator=g).to(cuda_device)
    rs = batched_scores_ref(q, db, metric=metric)
    check_scores(batched_scores(q, db, metric=metric), rs, 384, f"distance/{metric}")
    vals, ids = topk_scores(rs, 2048)
    rvals, rids = topk_ref(rs, 2048)
    assert torch.equal(ids, rids) and torch.equal(vals, rvals)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_matches_plain_on_card(cuda_device, name, dtype):
    check_flash_case(name, FLASH_DTYPES[dtype], cuda_device)


# ---- the engine's filtered, mutated, cache-probe, graph and DP paths on the card ----
#
# Each is held against the same path on the CPU (the plain versions) and the
# host oracle: ids exactly equal (seeded random scores leave no ties).


def _engine_fixture(dev):
    import numpy as np
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.filter import Range, synth_attributes
    db = make_database(3000, [("a", 48), ("b", 64)], seed=0)
    qs = make_queries(db, [(0, 1), (0,), (1,)], k=10, seed=7)
    attrs = {d: synth_attributes(db.n_rows, seed=3, device=d) for d in ("cpu", dev)}
    vals = np.sort(attrs["cpu"].take("score", np.arange(db.n_rows)))
    preds = [Range("score", lo=float(np.quantile(vals, 0.2)),
                   hi=float(np.quantile(vals, 0.2 + sel))) for sel in (0.01, 0.1, 0.5)]
    return db, qs, attrs, preds


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("access", ["pre", "masked", "post"])
def test_filtered_engine_on_card_equals_cpu(cuda_device, access, streaming):
    from dataclasses import replace

    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BatchEngine
    db, qs, attrs, preds = _engine_fixture(cuda_device)
    engs = {}
    for d in ("cpu", cuda_device):
        engs[d] = BatchEngine(db, device=d, streaming=streaming)
        engs[d].attach_filters(attrs[d])
    reset_launch_counts()
    for pred in preds:
        pairs = []
        for q in qs:
            fq = replace(q, predicate=pred)
            specs = [IndexSpec(fq.vid, "flat")] if access == "post" else []
            pairs.append((fq, QueryPlan(fq.qid, specs, [40] * len(specs), 1.0, 1.0,
                                        access_path=access, selectivity=0.1)))
        card, cpu = (engs[d].search_batch(pairs) for d in (cuda_device, "cpu"))
        for (fq, _), a, b in zip(pairs, card, cpu):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, engs["cpu"].ground_truth(fq))
    counts = launch_counts()
    assert counts["batched_scores"] > 0 if access == "pre" or not streaming else \
        counts["streaming_fused_scan"] > 0
    assert engs[cuda_device].counters.as_dict() == engs["cpu"].counters.as_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [True, False])
def test_mutated_engine_on_card_equals_cpu(cuda_device, streaming):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database
    from repro_torch.ingest import DeleteBatch, InsertBatch, MutableTable, MutationView
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BatchEngine
    db, qs, _, _ = _engine_fixture(cuda_device)
    table = MutableTable(db)
    table.apply(InsertBatch(make_database(200, [("a", 48), ("b", 64)], seed=77).columns))
    table.apply(DeleteBatch(np.random.default_rng(1).choice(table.live_ids(), 150,
                                                            replace=False)))
    engs = {}
    for d in ("cpu", cuda_device):
        engs[d] = BatchEngine(db, device=d, streaming=streaming)
        engs[d].attach_mutations(MutationView(table, device=d))
    pairs = []
    for q in qs:
        pairs.append((q, QueryPlan(q.qid, [], [], 1.0, 1.0)))
        pairs.append((q, QueryPlan(q.qid, [IndexSpec(q.vid, "flat")], [40], 1.0, 1.0)))
        if len(q.vid) > 1:
            pairs.append((q, QueryPlan(q.qid, [IndexSpec((c,), "flat") for c in q.vid],
                                       [30, 50], 1.0, 1.0)))
    reset_launch_counts()
    card, cpu = (engs[d].search_batch(pairs) for d in (cuda_device, "cpu"))
    for (q, p), a, b in zip(pairs, card, cpu):
        np.testing.assert_array_equal(a, b)
        if not p.indexes:
            np.testing.assert_array_equal(a, engs["cpu"].ground_truth(q))
    c = engs[cuda_device].counters.as_dict()
    assert c == engs["cpu"].counters.as_dict()
    assert (c["delta"] == 0) == streaming
    if streaming:  # one merged base + delta launch per flat (group, index)
        assert launch_counts()["streaming_fused_scan"] == c["scan"]


@pytest.mark.cuda
def test_cache_probe_on_card_equals_cpu(cuda_device):
    import numpy as np
    from repro_torch.serve.engine import cache_probe_scan
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((256, 384)).astype(np.float32)
    q = rng.standard_normal((64, 384)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)  # the cache holds unit
    q /= np.linalg.norm(q, axis=1, keepdims=True)      # query vectors
    q[:8] = mat[[3, 9, 27, 81, 100, 150, 190, 199]]
    vals, ids = cache_probe_scan(q, mat, 200, device=cuda_device)
    cvals, cids = cache_probe_scan(q, mat, 200, device="cpu")
    np.testing.assert_array_equal(ids, cids)
    np.testing.assert_array_equal(ids[:8, 0], [3, 9, 27, 81, 100, 150, 190, 199])
    assert (np.abs(vals - cvals) <= 1e-5 * np.sqrt(384) * np.maximum(np.abs(cvals), 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hnsw", "diskann"])
def test_graph_build_on_card_agrees_with_cpu(cuda_device, kind):
    import numpy as np
    from repro_torch.data.vectors import make_database
    from repro_torch.index.registry import BUILDERS
    data = make_database(3000, [("a", 48), ("b", 64)], seed=0).concat((0, 1))
    card = BUILDERS[kind](data, seed=0, device=cuda_device)
    cpu = BUILDERS[kind](data, seed=0, device="cpu")
    a, b = (card._layers[0], cpu._layers[0]) if kind == "hnsw" else (card.adj, cpu.adj)
    assert np.mean(a == b) >= 0.99
    qv = data[:5] + 0.01
    for v in qv:
        assert len(set(card.search(v, 20).ids) & set(cpu.search(v, 20).ids)) >= 18


@pytest.mark.cuda
def test_vectorized_dp_on_card_equals_cpu(cuda_device):
    import numpy as np
    from repro_torch.core.planner_jax import dp_solve
    rng = np.random.default_rng(0)
    req = torch.as_tensor(rng.integers(0, 400, size=(8, 6, 5)).astype(np.float32))
    args = (rng.integers(16, 160, 6).astype(np.float32),
            rng.uniform(1, 30, 6).astype(np.float32),
            rng.uniform(0, 300, 6).astype(np.float32), 144.0, 2500.0, 4.0, 5)
    cost, eks = dp_solve(req.to(cuda_device), *args)
    ccost, ceks = dp_solve(req, *args)
    assert torch.allclose(cost.cpu(), ccost, rtol=1e-6)
    assert torch.equal(eks.cpu(), ceks)


@pytest.mark.cuda
def test_cache_probe_scans_a_resident_matrix_in_place(cuda_device, monkeypatch):
    """The probe takes the cache's resident float32 matrix as it is: the
    scan receives that very tensor (no host round trip, no copy), and the
    result equals the numpy call's, with or without the kept norms."""
    import numpy as np
    from repro_torch.kernels.distance.ref import squared_norms
    from repro_torch.serve import engine
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((256, 384)).astype(np.float32)
    q = rng.standard_normal((16, 384)).astype(np.float32)
    q[:4] = mat[[5, 50, 150, 199]]
    ref = engine.cache_probe_scan(q, mat, 200, device=cuda_device)
    dev = torch.as_tensor(mat, device=cuda_device)
    seen = []
    scan = engine.streaming_fused_scan

    def spy(qt, db, **kw):
        seen.append((db.data_ptr(), kw.get("db_sq")))
        return scan(qt, db, **kw)
    monkeypatch.setattr(engine, "streaming_fused_scan", spy)
    for mat_sq in (None, squared_norms(dev)):
        got = engine.cache_probe_scan(q, dev, 200, device=cuda_device, mat_sq=mat_sq)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])
    assert [p for p, _ in seen] == [dev.data_ptr()] * 2 and seen[1][1] is not None
    np.testing.assert_array_equal(ref[1][:4, 0], [5, 50, 150, 199])


def _staging_fixture(dev):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.index.registry import IndexStore
    from repro_torch.serve.engine import BatchEngine
    db = make_database(3000, [("a", 48), ("b", 64)], seed=0)
    engine = BatchEngine(db, store=IndexStore(db, seed=0, device=dev))
    rng = np.random.default_rng(2)
    pairs = []
    for i, q in enumerate(make_queries(db, [(0, 1), (0,), (1,), (0, 1)] * 4, k=10,
                                       seed=3)):
        q.qid = 100 + i
        kind = ("ivf", "flat")[i % 2]
        if i % 3 == 2:
            plan = QueryPlan(q.qid, [], [], 1.0, 1.0)
        elif len(q.vid) > 1 and i % 3 == 1:
            plan = QueryPlan(q.qid, [IndexSpec((c,), kind) for c in q.vid],
                             [int(rng.integers(20, 60)) for _ in q.vid], 1.0, 1.0)
        else:
            plan = QueryPlan(q.qid, [IndexSpec(q.vid, kind)], [40], 1.0, 1.0)
        pairs.append((q, plan))
    return engine, pairs


@pytest.mark.cuda
def test_staged_batch_on_card_equals_unstaged(cuda_device):
    """Staging on the card: pinned host buffers, copies on the engine's
    side stream behind an event, the executing thread's stream waits on
    it; the ids equal the unstaged call's, also when a worker thread
    executes."""
    import threading

    import numpy as np
    engine, pairs = _staging_fixture(cuda_device)
    ref = engine.search_batch(pairs)
    staged = engine.stage_batch(pairs)
    assert isinstance(staged.ready, torch.cuda.Event)
    assert staged.pinned and all(t.is_pinned() for t in staged.pinned)
    assert all(t.device.type == "cuda" for t in staged.qmats.values())
    assert engine._stage_stream != torch.cuda.current_stream(cuda_device)
    for r, a in zip(ref, engine.search_batch(pairs, staged=staged)):
        np.testing.assert_array_equal(r, a)
    out = []
    staged = engine.stage_batch(pairs)
    worker = threading.Thread(
        target=lambda: out.append(engine.search_batch(pairs, staged=staged)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and out
    for r, a in zip(ref, out[0]):
        np.testing.assert_array_equal(r, a)


@pytest.mark.cuda
def test_async_flush_on_a_real_pool_equals_sync_on_card(cuda_device):
    import numpy as np
    from repro_torch.async_ import WorkerPool
    from repro_torch.online.scheduler import MicroBatcher
    engine, pairs = _staging_fixture(cuda_device)

    def run(executor=None, stage=False):
        mb = MicroBatcher(
            lambda tks, staged=None: engine.search_batch(
                [(t.query, t.plan) for t in tks], staged=staged),
            plan_for=None, max_batch=4, executor=executor,
            stage=(lambda tks: engine.stage_batch([(t.query, t.plan) for t in tks]))
            if stage else None)
        tks = [mb.submit(q, now=i * 1e-4, plan=p) for i, (q, p) in enumerate(pairs)]
        mb.drain(1.0)
        return [np.asarray(t.result(timeout=60)) for t in tks]
    ref = run()
    with WorkerPool(workers=2, name="card") as pool:
        for stage in (True, False):
            for r, a in zip(ref, run(pool, stage)):
                np.testing.assert_array_equal(r, a)


@pytest.mark.cuda
def test_semcache_namespace_tensor_stays_on_card(cuda_device):
    """Probes without admissions scan the same resident CUDA tensor; an
    admission rebuilds it (and its norms) once."""
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.online import SemanticCache, SemCacheConfig
    db = make_database(500, [("a", 48), ("b", 64)], seed=0)
    qs = make_queries(db, [(0, 1)] * 3, k=10, seed=4)
    plan = QueryPlan(0, [IndexSpec((0, 1), "flat")], [10], 1.0, 1.0)
    cache = SemanticCache(SemCacheConfig(epsilon=0.0, capacity=8), device=cuda_device)
    for i, q in enumerate(qs[:2]):
        cache.probe(q, plan)[1].admit(np.arange(10) + i)
    (ns,) = cache._ns.values()
    cache.probe(qs[0], plan)
    ptr = ns.dev.data_ptr()
    assert ns.dev.device.type == "cuda" and ns.dev_sq.device.type == "cuda"
    for i, q in enumerate(qs[:2]):
        np.testing.assert_array_equal(cache.probe(q, plan)[0], np.arange(10) + i)
        assert ns.dev.data_ptr() == ptr
    cache.probe(qs[2], plan)[1].admit(np.arange(10) + 2)
    np.testing.assert_array_equal(cache.probe(qs[2], plan)[0], np.arange(10) + 2)
    assert ns.dev_version == ns.version == 3


@pytest.mark.cuda
def test_governed_spill_frees_card_memory_and_comes_back_bit_identical(cuda_device):
    """A budget eviction drops the store's tensor: ``memory_allocated`` (not
    ``memory_reserved``: the caching allocator keeps the block) falls by the
    column's padded bytes, and the column comes back equal."""
    from repro_torch.data.vectors import make_database
    from repro_torch.serve.columnstore import ColumnStore
    from repro_torch.tenancy import MemoryGovernor, TenantColumnStores
    db = make_database(10_000, [("a", 200), ("b", 130)], seed=0)
    col = ColumnStore(db, device="cpu").device_bytes
    gov = MemoryGovernor(col((0,)) + col((1,)))
    stores = TenantColumnStores(gov)
    sa = stores.register("a", db, device=cuda_device)
    sb = stores.register("b", db, device=cuda_device)
    before = sa.device((0,)).data.clone()
    sb.device((1,))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    sb.device((0,))  # over the budget: a's (0,) is the LRU victim, freed first
    torch.cuda.synchronize()
    assert sa.resident() == [] and gov.evictions == 1
    assert torch.cuda.memory_allocated() - held < col((0,))
    held = torch.cuda.memory_allocated()
    assert sb.evict_device((0,))
    torch.cuda.synchronize()
    assert held - torch.cuda.memory_allocated() >= col((0,))
    assert gov.tenant_bytes("b") == col((1,))
    assert torch.equal(sa.device((0,)).data, before)


@pytest.mark.cuda
def test_spilled_semcache_namespace_frees_matrix_and_norms_on_card(cuda_device):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.online import SemanticCache, SemCacheConfig
    from repro_torch.tenancy import MemoryGovernor
    db = make_database(500, [("a", 300), ("b", 200)], seed=0)
    qs = make_queries(db, [(0, 1)] * 2, k=10, seed=4)
    plan = QueryPlan(0, [IndexSpec((0, 1), "flat")], [10], 1.0, 1.0)
    gov = MemoryGovernor(10**9)
    cache = SemanticCache(SemCacheConfig(capacity=4096), governor=gov, tenant="t",
                          device=cuda_device)
    gov.register_semcache("t", cache)
    for i, q in enumerate(qs):
        cache.probe(q, plan)[1].admit(np.arange(10) + i)
    np.testing.assert_array_equal(cache.probe(qs[0], plan)[0], np.arange(10))
    (ns,) = cache._ns.values()
    assert gov.resident() == [("t", ns.gvid, ns.device_bytes)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gov._evict("t", ns.gvid)
    torch.cuda.synchronize()
    assert ns.dev is None and ns.dev_sq is None and gov.resident() == []
    assert held - torch.cuda.memory_allocated() >= 4096 * 500 * 4 + 4096 * 4
    for i, q in enumerate(qs):  # re-uploads both, and hits
        np.testing.assert_array_equal(cache.probe(q, plan)[0], np.arange(10) + i)
    assert ns.dev.device.type == "cuda" and ns.dev_sq.device.type == "cuda"
    assert gov.resident() == [("t", ns.gvid, ns.device_bytes)]


@pytest.mark.cuda
def test_governed_delta_segment_is_charged_and_released_on_card(cuda_device):
    import numpy as np
    from repro_torch.data.vectors import make_database
    from repro_torch.ingest import DeltaSegments, InsertBatch, MutableTable
    from repro_torch.online import row_batch
    from repro_torch.tenancy import MemoryGovernor
    db = make_database(1000, [("a", 200), ("b", 100)], seed=0)
    table = MutableTable(db)
    gov = MemoryGovernor(10**9)
    seg = DeltaSegments(table, governor=gov, tenant="t", device=cuda_device)
    gov.register_delta("t", seg)
    table.apply(InsertBatch(row_batch(db, np.random.default_rng(0), 5000)))
    d = seg.column((0, 1))
    assert d.col.data.device.type == "cuda"
    assert gov.resident() == [("t", ("delta", 0, 1), d.col.device_bytes)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del d
    seg.drop_all()
    torch.cuda.synchronize()
    assert gov.resident() == [] and gov.stats()["total_bytes"] == 0
    assert held - torch.cuda.memory_allocated() >= 5120 * 384 * 4
