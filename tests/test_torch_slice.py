"""Port parity of MINT's tune -> batched-serve path (the port's first slice)
against the JAX package, on the serving fixture of tests/test_serve.py
(2,500 rows, 3 columns, the naive workload, k = 10, ivf indexes).

With the reference's fitted estimators carried across, tuning is held to
the identical configuration and plans; with its IVF lists carried across,
execution is held to identical ids, numDist, costs, dispatch counters and
recall. From scratch, the configuration is the same and the MINT/PerColumn
cost ratio within 1%. The guards keep the port free of JAX and of the
reference package, and keep its entry points on the card unless the caller
asks for the CPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.tuner import Mint as JaxMint
from repro.core.tuner import execute_workload as jax_execute_workload
from repro.core.tuner import ground_truth_cache as jax_ground_truth_cache
from repro.core.types import Constraints as JaxConstraints
from repro.core.types import IndexSpec as JSpec
from repro.core.types import QueryPlan as JPlan
from repro.data.vectors import make_database as jax_make_database
from repro.data.vectors import make_queries as jax_make_queries
from repro.data.vectors import make_workload as jax_make_workload
from repro.index.registry import IndexStore as JaxIndexStore
from repro.launch.roofline import modeled_scan_bytes as jax_modeled_scan_bytes
from repro.serve.columnstore import padded_device_bytes as jax_padded_bytes
from repro.serve.compiler import compile_batch as jax_compile_batch
from repro.serve.engine import BatchEngine as JaxEngine
from repro_torch import convert
from repro_torch.core.tuner import Mint, execute_workload, ground_truth_cache
from repro_torch.core.types import Constraints, IndexSpec, QueryPlan, Workload
from repro_torch.data.vectors import make_database, make_queries, make_workload
from repro_torch.filter import Eq, synth_attributes
from repro_torch.index.bruteforce import batch_exact_topk
from repro_torch.index.graph import HNSWIndex, VamanaIndex, build_knn_graph
from repro_torch.index.ivf import IVFFlatIndex
from repro_torch.ingest import (Compactor, DeltaSegments, IngestRuntime, MutableTable,
                                MutationView)
from repro_torch.index.registry import IndexStore
from repro_torch.launch.roofline import modeled_scan_bytes
from repro_torch.autotune import AutoTuner, ReplayScenario, replay, serving_space
from repro_torch.online import OnlineRuntime, SemanticCache
from repro_torch.search.engine import execute_plan_fused
from repro_torch.serve.columnstore import ColumnStore, padded_device_bytes
from repro_torch.serve.compiler import compile_batch
from repro_torch.serve.engine import BatchEngine, cache_probe_scan
from repro_torch.tenancy import MemoryGovernor, MultiTenantRuntime, Tenant, TenantColumnStores

ROOT = Path(__file__).resolve().parents[1]
COLS = [("a", 32), ("b", 48), ("c", 24)]
N_ROWS, K = 2500, 10
THETA = dict(theta_recall=0.85, theta_storage=3)


@pytest.fixture(scope="module")
def dbs():
    return make_database(N_ROWS, COLS, seed=0), jax_make_database(N_ROWS, COLS, seed=0)


@pytest.fixture(scope="module")
def workloads(dbs):
    return (make_workload(dbs[0], "naive", k=K, seed=0),
            jax_make_workload(dbs[1], "naive", k=K, seed=0))


@pytest.fixture(scope="module")
def jax_tuned(dbs, workloads):
    mint = JaxMint(dbs[1], index_kind="ivf", seed=0, min_sample_rows=600)
    return mint, mint.tune(workloads[1], JaxConstraints(**THETA))


@pytest.fixture(scope="module")
def jax_store(dbs):
    return JaxIndexStore(dbs[1], seed=0)


@pytest.fixture(scope="module")
def jax_gt(dbs, workloads):
    return jax_ground_truth_cache(dbs[1], workloads[1])


def _carried_estimators(est):
    stats = {key: dict(cost=(st.cost.slope, st.cost.intercept),
                       recall=(st.recall.alpha, st.recall.beta, st.recall.lo,
                               st.recall.hi),
                       rec_eks=st.rec_eks, rec_vals=st.rec_vals)
             for key, st in est.stats.items()}
    return convert.estimators_from_arrays(stats, est.dims, est.n_rows,
                                          est.sample_rate, est.train_seconds,
                                          est.theta_hit)


def _carried_store(db, jstore, configs):
    states = {}
    for config in configs:
        for spec in config:
            idx = jstore.get(spec)
            states[spec.vid] = dict(centroids=idx.centroids, row_ids=idx.row_ids,
                                    offsets=idx.offsets, n_lists=idx.n_lists)
    return convert.index_store_from_arrays(db, states, seed=0, device="cpu")


def _names(config):
    return sorted(s.name for s in config)


def _plans(result):
    return {qid: ([s.name for s in p.indexes], list(p.eks))
            for qid, p in result.plans.items()}


@pytest.fixture(scope="module")
def carried_tuned(dbs, workloads, jax_tuned):
    mint = Mint(dbs[0], index_kind="ivf", seed=0, min_sample_rows=600,
                estimators=_carried_estimators(jax_tuned[0].estimators),
                device="cpu")
    return mint, mint.tune(workloads[0], Constraints(**THETA))


@pytest.mark.parametrize("name,cols", [("naive", COLS),
                                       ("bisimple", [("x", 8)] * 8),
                                       ("news", [("n", 12)] * 4)])
def test_data_copies_are_identical(name, cols):
    db, jdb = make_database(700, cols, seed=4), jax_make_database(700, cols, seed=4)
    for a, b in zip(db.columns, jdb.columns):
        np.testing.assert_array_equal(a, b)
    w, jw = make_workload(db, name, k=7, seed=4), jax_make_workload(jdb, name, k=7, seed=4)
    np.testing.assert_array_equal(w.probs, jw.probs)
    for q, jq in zip(w.queries, jw.queries):
        assert q.vid == jq.vid
        np.testing.assert_array_equal(q.concat(), jq.concat())


def test_tune_with_carried_estimators_gives_identical_plans(jax_tuned, carried_tuned):
    _, jres = jax_tuned
    _, res = carried_tuned
    assert _names(res.configuration) == _names(jres.configuration)
    assert _plans(res) == _plans(jres)
    assert res.est_workload_cost == jres.est_workload_cost


def test_per_column_with_carried_estimators_identical(dbs, workloads, jax_tuned,
                                                      carried_tuned):
    jres = jax_tuned[0].per_column(workloads[1], JaxConstraints(**THETA))
    res = carried_tuned[0].per_column(workloads[0], Constraints(**THETA))
    assert _names(res.configuration) == _names(jres.configuration)
    assert _plans(res) == _plans(jres)


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("which", ["mint", "per_column"])
def test_execute_workload_identical_with_carried_indexes(
        dbs, workloads, jax_tuned, carried_tuned, jax_store, jax_gt,
        streaming, which):
    jmint, jres = jax_tuned
    mint, res = carried_tuned
    if which == "per_column":
        jres = jmint.per_column(workloads[1], JaxConstraints(**THETA))
        res = mint.per_column(workloads[0], Constraints(**THETA))
    store = _carried_store(dbs[0], jax_store, [jres.configuration])
    jeng = JaxEngine(dbs[1], store=jax_store, streaming=streaming)
    eng = BatchEngine(dbs[0], store=store, streaming=streaming)
    jm = jax_execute_workload(dbs[1], jax_store, workloads[1], jres, jax_gt,
                              engine=jeng)
    m = execute_workload(dbs[0], store, workloads[0], res,
                         ground_truth_cache(dbs[0], workloads[0]), engine=eng)
    for a, b in zip(m.per_query, jm.per_query):
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        assert (a.cost, a.num_dist, a.recall, a.eks) == (b.cost, b.num_dist,
                                                         b.recall, b.eks)
    assert eng.counters.as_dict() == jeng.counters.as_dict()
    assert (m.weighted_cost, m.min_recall, m.mean_recall) == (
        jm.weighted_cost, jm.min_recall, jm.mean_recall)


def test_per_query_reference_path_matches_batched(dbs, workloads, carried_tuned,
                                                  jax_store, jax_tuned):
    _, res = carried_tuned
    store = _carried_store(dbs[0], jax_store, [jax_tuned[1].configuration])
    gt = ground_truth_cache(dbs[0], workloads[0])
    batched = execute_workload(dbs[0], store, workloads[0], res, gt)
    per_query = execute_workload(dbs[0], store, workloads[0], res, gt, batched=False)
    for a, b in zip(batched.per_query, per_query.per_query):
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        assert a.cost == b.cost and a.num_dist == b.num_dist


def test_from_scratch_same_configuration_and_cost_ratio(dbs, workloads, jax_tuned,
                                                        jax_store, jax_gt):
    jmint, jres = jax_tuned
    mint = Mint(dbs[0], index_kind="ivf", seed=0, min_sample_rows=600, device="cpu")
    res = mint.tune(workloads[0], Constraints(**THETA))
    assert _names(res.configuration) == _names(jres.configuration)
    store = IndexStore(dbs[0], seed=0, device="cpu")
    gt = ground_truth_cache(dbs[0], workloads[0])
    pc = mint.per_column(workloads[0], Constraints(**THETA))
    ratio = (execute_workload(dbs[0], store, workloads[0], res, gt).weighted_cost
             / execute_workload(dbs[0], store, workloads[0], pc, gt).weighted_cost)
    jpc = jmint.per_column(workloads[1], JaxConstraints(**THETA))
    jratio = (jax_execute_workload(dbs[1], jax_store, workloads[1], jres,
                                   jax_gt).weighted_cost
              / jax_execute_workload(dbs[1], jax_store, workloads[1], jpc,
                                     jax_gt).weighted_cost)
    assert ratio == pytest.approx(jratio, rel=0.01)


def test_burst_takes_one_scan_per_group_index(dbs, workloads, carried_tuned,
                                              jax_store, jax_tuned):
    _, res = carried_tuned
    store = _carried_store(dbs[0], jax_store, [jax_tuned[1].configuration])
    q = workloads[0].queries[1]
    plan = res.plans[q.qid]
    burst = make_queries(dbs[0], [q.vid] * 8, k=q.k, seed=7)
    pairs = [(bq, plan) for bq in burst]
    eng = BatchEngine(dbs[0], store=store)
    ids = eng.search_batch(pairs)
    assert eng.counters.scan == max(len(plan.indexes), 1)
    for pair, got in zip(pairs, ids):
        [ref] = eng.search_batch([pair])
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("streaming", [True, False])
def test_flat_fallback_and_flat_specs_match_jax(dbs, streaming):
    """Flat scans (the planner's fallback plan and flat specs) exercise the
    scan kernels' plain versions inside the engine."""
    qs = make_queries(dbs[0], [(0, 1), (0, 1), (2,)], k=K, seed=9)
    jqs = jax_make_queries(dbs[1], [(0, 1), (0, 1), (2,)], k=K, seed=9)
    plans = [QueryPlan(0, [], [], 0.0, 1.0),
             QueryPlan(1, [IndexSpec((0,), "flat"), IndexSpec((1,), "flat")],
                       [40, 30], 0.0, 1.0),
             QueryPlan(2, [IndexSpec((2,), "flat")], [20], 0.0, 1.0)]
    jplans = [JPlan(0, [], [], 0.0, 1.0),
              JPlan(1, [JSpec((0,), "flat"), JSpec((1,), "flat")], [40, 30], 0.0, 1.0),
              JPlan(2, [JSpec((2,), "flat")], [20], 0.0, 1.0)]
    eng = BatchEngine(dbs[0], streaming=streaming, device="cpu")
    jeng = JaxEngine(dbs[1], streaming=streaming)
    got = eng.execute_batch(list(zip(qs, plans)))
    ref = jeng.execute_batch(list(zip(jqs, jplans)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        assert (a.cost, a.num_dist, a.recall) == (b.cost, b.num_dist, b.recall)
    assert eng.counters.as_dict() == jeng.counters.as_dict()


def test_compiler_and_byte_models_match_jax(dbs, workloads, jax_tuned, carried_tuned):
    pairs = [(q, carried_tuned[1].plans[q.qid]) for q in workloads[0].queries]
    jpairs = [(q, jax_tuned[1].plans[q.qid]) for q in workloads[1].queries]
    sig = [(g.key.vid, [(s.name, b) for s, b in g.key.signature],
            [it.pos for it in g.items]) for g in compile_batch(pairs)]
    jsig = [(g.key.vid, [(s.name, b) for s, b in g.key.signature],
             [it.pos for it in g.items]) for g in jax_compile_batch(jpairs)]
    assert sig == jsig
    for args in [(1, 1000, 128, 100), (64, 1_000_000, 899, 128)]:
        assert modeled_scan_bytes(*args) == jax_modeled_scan_bytes(*args)
        assert padded_device_bytes(args[1], args[2]) == jax_padded_bytes(args[1], args[2])


def test_column_store_padding_and_bytes(dbs):
    cs = ColumnStore(dbs[0], device="cpu")
    col = cs.device((0, 1))
    assert col.n_rows == N_ROWS and col.dim == 80
    assert tuple(col.data.shape) == (2560, 128)
    assert col.device_bytes == cs.device_bytes((0, 1)) == cs.total_device_bytes()
    np.testing.assert_array_equal(col.data[:N_ROWS, :80].numpy(), cs.host((0, 1)))
    assert not col.data[N_ROWS:].any() and not col.data[:, 80:].any()


# ---- guards ---------------------------------------------------------------


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


ENTRY_POINTS = {
    "Mint": lambda db: Mint(db, index_kind="ivf"),
    "IndexStore": lambda db: IndexStore(db),
    "ColumnStore": lambda db: ColumnStore(db),
    "BatchEngine": lambda db: BatchEngine(db),
    "IVFFlatIndex": lambda db: IVFFlatIndex(db.columns[0]),
    "batch_exact_topk": lambda db: batch_exact_topk(db.columns[0],
                                                    db.columns[0][:2], 3),
    "HNSWIndex": lambda db: HNSWIndex(db.columns[0]),
    "VamanaIndex": lambda db: VamanaIndex(db.columns[0]),
    "build_knn_graph": lambda db: build_knn_graph(db.columns[0], 4),
    "MutationView": lambda db: MutationView(MutableTable(db)),
    "DeltaSegments": lambda db: DeltaSegments(MutableTable(db)),
    "Compactor": lambda db: Compactor(MutableTable(db)),
    "AttributeStore.device_bitmap": lambda db: synth_attributes(db.n_rows).device_bitmap(
        Eq("category", "cat0"), np.arange(db.n_rows)),
    "cache_probe_scan": lambda db: cache_probe_scan(db.columns[0][:2], db.columns[0], 10),
    "torch_quickstart.run": lambda db: _torch_quickstart().run(64),
    "OnlineRuntime": lambda db: OnlineRuntime(db, Mint(db, device="cpu"),
                                              *_one_query_workload(db)),
    "IngestRuntime": lambda db: IngestRuntime(db, Mint(db, device="cpu"),
                                              *_one_query_workload(db)),
    "SemanticCache": lambda db: SemanticCache(),
    "execute_plan_fused": lambda db: execute_plan_fused(
        db, *_one_query_workload(db)[0].queries, QueryPlan(0, [], [], 1.0, 1.0)),
    "MultiTenantRuntime": lambda db: MultiTenantRuntime(
        [Tenant("t", db, Mint(db, device="cpu"), *_one_query_workload(db))], 10**9),
    "TenantColumnStores.register": lambda db: TenantColumnStores(
        MemoryGovernor(10**9)).register("t", db),
    "replay": lambda db: replay(ReplayScenario(), serving_space().defaults()),
    "AutoTuner": lambda db: AutoTuner(ReplayScenario()),
}


def _one_query_workload(db):
    q = make_queries(db, [(0,)], k=3, seed=0)[0]
    return Workload(queries=[q], probs=np.ones(1)), Constraints(**THETA)


def _torch_quickstart():
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_quickstart
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return torch_quickstart


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_the_card_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    db = make_database(64, [("a", 8)], seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](db)


def test_unported_paths_raise(dbs):
    for call in (lambda: BatchEngine(dbs[0], mesh=object(), device="cpu"),
                 lambda: ColumnStore(dbs[0], mesh=object(), device="cpu")):
        with pytest.raises(NotImplementedError):
            call()
