"""Port parity of filtered search (attribute store, predicates, selectivity
estimation, filtered planning and the engine's pre / masked / post access
paths) against the JAX package, on the fixture of tests/test_filter.py
(240 rows, 2 columns, k = 8, ``synth_attributes(seed=3)``).

Tolerances: none. Bitmaps, selectivity estimates, costs, plans, ids,
numDist, costs and dispatch counters are held exactly equal; the engine's
results are also held equal to the brute-force filtered oracle. IVF lists
and graph adjacency are carried over from the reference's built indexes
(``repro_torch.convert``), so every index kind is compared on the same
index.
"""
import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.filter as jf
from repro.core.tuner import Mint as JaxMint
from repro.core.types import Constraints as JaxConstraints
from repro.core.types import IndexSpec as JSpec
from repro.core.types import QueryPlan as JPlan
from repro.core.types import Workload as JaxWorkload
from repro.data.vectors import make_database as jax_make_database
from repro.data.vectors import make_queries as jax_make_queries
from repro.filter.attributes import synth_attributes as jax_synth_attributes
from repro.index.registry import IndexStore as JaxIndexStore
from repro.ingest import DeleteBatch as JDelete
from repro.ingest import InsertBatch as JInsert
from repro.ingest import MutableTable as JaxTable
from repro.ingest import MutationView as JaxView
from repro.ingest import UpsertBatch as JUpsert
from repro.online.trace import row_batch
from repro.serve.engine import BatchEngine as JaxEngine
from repro_torch import convert
from repro_torch import filter as tf
from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, IndexSpec, QueryPlan, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.filter.attributes import synth_attributes
from repro_torch.index.registry import IndexStore
from repro_torch.ingest import DeleteBatch, InsertBatch, MutableTable, MutationView, UpsertBatch
from repro_torch.serve.engine import BatchEngine

K = 8
COLS = [("a", 16), ("b", 24)]
N_ROWS = 240
VIDS = [(0, 1), (0,), (1,)]


@pytest.fixture(scope="module")
def dbs():
    return make_database(N_ROWS, COLS, seed=0), jax_make_database(N_ROWS, COLS, seed=0)


@pytest.fixture(scope="module")
def queries(dbs):
    return (make_queries(dbs[0], VIDS, k=K, seed=7),
            jax_make_queries(dbs[1], VIDS, k=K, seed=7))


def _attrs():
    return synth_attributes(N_ROWS, seed=3, device="cpu"), jax_synth_attributes(N_ROWS, seed=3)


def to_jax(pred):
    """The reference's predicate tree with the same shape and values."""
    if pred is None:
        return None
    if isinstance(pred, (tf.And, tf.Or)):
        return getattr(jf, type(pred).__name__)(*map(to_jax, pred.children))
    if isinstance(pred, tf.Not):
        return jf.Not(to_jax(pred.child))
    if isinstance(pred, tf.Eq):
        return jf.Eq(pred.field, pred.value)
    if isinstance(pred, tf.In):
        return jf.In(pred.field, pred.values)
    return jf.Range(pred.field, lo=pred.lo, hi=pred.hi)


def quantile_pred(attrs, sel, lo_q=0.25):
    """Range over the uniform ``score`` field hitting ~``sel`` of the rows
    (tests/test_filter.py's rule)."""
    vals = np.sort(attrs.take("score", np.arange(N_ROWS)))
    if sel <= 0.0:
        return tf.Range("score", lo=float(vals[-1]) + 1.0, hi=float(vals[-1]) + 2.0)
    if sel >= 1.0:
        return tf.Range("score", lo=float(vals[0]) - 1.0, hi=float(vals[-1]) + 1.0)
    lo_q = min(lo_q, 1.0 - sel)
    return tf.Range("score", lo=float(np.quantile(vals, lo_q)),
                    hi=float(np.quantile(vals, lo_q + sel)))


def _random_pred(rng, depth=0):
    r = rng.random()
    if depth >= 3 or r < 0.45:
        f = ("category", "score", "source")[int(rng.integers(3))]
        if f == "score":
            lo, hi = sorted(rng.random(2))
            return tf.Range("score", lo=float(lo), hi=float(hi))
        vals = [f"cat{int(rng.integers(10))}" if f == "category"
                else f"src{int(rng.integers(6))}"
                for _ in range(int(rng.integers(1, 4)))]
        return tf.Eq(f, vals[0]) if len(vals) == 1 else tf.In(f, vals)
    if r < 0.65:
        return tf.Not(_random_pred(rng, depth + 1))
    op = tf.And if r < 0.85 else tf.Or
    return op(_random_pred(rng, depth + 1), _random_pred(rng, depth + 1))


PREDS = {
    "eq_tag": tf.Eq("category", "cat0"),
    "eq_unknown_tag": tf.Eq("category", "zzz"),
    "in_texthash": tf.In("source", ["src1", "src3"]),
    "range_open_hi": tf.Range("score", lo=0.4),
    "range_closed": tf.Range("score", lo=0.1, hi=0.3),
    "not_eq": tf.Not(tf.Eq("source", "src0")),
    "and_or_not": tf.And(tf.Range("score", lo=0.1, hi=0.9),
                         tf.Or(tf.Eq("category", "cat1"),
                               tf.Not(tf.In("source", ["src0"])))),
}


# ---- predicates, bitmaps, selectivity ---------------------------------------


@pytest.mark.parametrize("name", sorted(PREDS))
def test_predicate_copy_describes_and_hashes_like_jax(name):
    p = PREDS[name]
    assert tf.describe(p) == jf.describe(to_jax(p))
    assert p.fields() == to_jax(p).fields()
    twin = copy.deepcopy(p)
    assert twin == p and hash(twin) == hash(p) and {p: 1}[twin] == 1


@pytest.mark.parametrize("name", sorted(PREDS))
def test_host_and_device_bitmaps_equal_jax(name):
    attrs, jattrs = _attrs()
    p = PREDS[name]
    ids = np.arange(-3, N_ROWS + 20)  # out-of-range ids read as missing
    want = jattrs.bitmap(to_jax(p), ids)
    np.testing.assert_array_equal(attrs.bitmap(p, ids), want)
    dev = attrs.device_bitmap(p, ids)
    assert dev.dtype == torch.bool and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jattrs.device_bitmap(to_jax(p), ids)))
    np.testing.assert_array_equal(dev.numpy(), want)


def test_random_predicate_trees_equal_jax():
    attrs, jattrs = _attrs()
    rng = np.random.default_rng(42)
    ids = np.arange(N_ROWS)
    for _ in range(40):
        p = _random_pred(rng)
        want = jattrs.bitmap(to_jax(p), ids)
        np.testing.assert_array_equal(attrs.bitmap(p, ids), want, err_msg=tf.describe(p))
        np.testing.assert_array_equal(attrs.device_bitmap(p, ids).numpy(), want)


def test_put_take_and_missing_semantics_equal_jax():
    fields = [("tag", "tag"), ("num", "numeric"), ("txt", "texthash")]
    store = tf.AttributeStore([tf.FieldSpec(*f) for f in fields], device="cpu")
    jstore = jf.AttributeStore([jf.FieldSpec(*f) for f in fields])
    vals = {"tag": ["a", "b", "a"], "num": [0.1, 0.7, 0.3], "txt": ["x", "y", "x"]}
    for s in (store, jstore):
        s.put(np.array([0, 2, 5]), vals)
        s.put(np.array([70]), {"tag": ["c"]})  # grows past the capacity
    ids = np.arange(-1, 80)
    for f, _ in fields:
        np.testing.assert_array_equal(store.take(f, ids), jstore.take(f, ids))
    assert store.version == jstore.version and store.capacity == jstore.capacity
    for p in (tf.Eq("tag", "a"), tf.Not(tf.Eq("tag", "a")), tf.Eq("txt", "x"),
              tf.Range("num", lo=0.0, hi=1.0), tf.Eq("tag", "zzz")):
        np.testing.assert_array_equal(store.bitmap(p, ids), jstore.bitmap(to_jax(p), ids))
        np.testing.assert_array_equal(store.device_bitmap(p, ids).numpy(),
                                      jstore.bitmap(to_jax(p), ids))
    assert tf.text_hash("hello") == jf.text_hash("hello")
    with pytest.raises(TypeError):
        store.bitmap(tf.Range("tag", lo=0, hi=1), ids)


@pytest.mark.parametrize("sel", [0.0, 0.01, 0.1, 0.5, 1.0])
def test_selectivity_estimates_equal_jax(sel):
    attrs, jattrs = _attrs()
    est = tf.SelectivityEstimator(attrs, np.arange(N_ROWS), sample_size=200, seed=0)
    jest = jf.SelectivityEstimator(jattrs, np.arange(N_ROWS), sample_size=200, seed=0)
    p = quantile_pred(attrs, sel)
    assert est.estimate(p) == jest.estimate(to_jax(p))
    est.refresh(np.arange(0, N_ROWS, 2))
    jest.refresh(np.arange(0, N_ROWS, 2))
    assert est.estimate(p) == jest.estimate(to_jax(p))
    assert est.estimate(None) == jest.estimate(None) == 1.0


def test_access_cost_model_equal_jax():
    for sel in (0.0, 0.003, 0.1, 0.5, 1.0):
        assert tf.prefilter_cost(40, N_ROWS, sel) == jf.prefilter_cost(40, N_ROWS, sel)
        assert tf.inflate_eks([0, 5, 40, 300], sel, N_ROWS) == jf.inflate_eks(
            [0, 5, 40, 300], sel, N_ROWS)
    assert tf.masked_scan_cost(40, N_ROWS) == jf.masked_scan_cost(40, N_ROWS)


# ---- filtered planning ---------------------------------------------------------

SELS = (0.0, 0.01, 0.1, 0.5, 0.9, 1.0)


def _carried_estimators(est):
    stats = {key: dict(cost=(st.cost.slope, st.cost.intercept),
                       recall=(st.recall.alpha, st.recall.beta, st.recall.lo,
                               st.recall.hi),
                       rec_eks=st.rec_eks, rec_vals=st.rec_vals)
             for key, st in est.stats.items()}
    return convert.estimators_from_arrays(stats, est.dims, est.n_rows,
                                          est.sample_rate, est.train_seconds,
                                          est.theta_hit)


def _plan_key(p):
    return ([s.name for s in p.indexes], list(p.eks), p.est_cost, p.est_recall,
            p.access_path, p.selectivity)


@pytest.fixture(scope="module")
def tuned(dbs, queries):
    """Both packages tuned on a filtered workload (each query at each
    selectivity); the port carries the reference's fitted estimators."""
    attrs, jattrs = _attrs()
    fq, jfq = [], []
    for sel in SELS:
        p = quantile_pred(attrs, sel)
        fq += [replace(q, predicate=p) for q in queries[0]]
        jfq += [replace(q, predicate=to_jax(p)) for q in queries[1]]
    for i, (q, jq) in enumerate(zip(fq, jfq)):
        fq[i], jfq[i] = replace(q, qid=i), replace(jq, qid=i)
    jmint = JaxMint(dbs[1], index_kind="hnsw", seed=0, attributes=jattrs)
    jres = jmint.tune(JaxWorkload(queries=jfq, probs=np.ones(len(jfq))),
                      JaxConstraints(theta_recall=0.9, theta_storage=3))
    mint = Mint(dbs[0], index_kind="hnsw", seed=0, attributes=attrs, device="cpu",
                estimators=_carried_estimators(jmint.estimators))
    res = mint.tune(Workload(queries=fq, probs=np.ones(len(fq))),
                    Constraints(theta_recall=0.9, theta_storage=3))
    return dict(mint=mint, res=res, jmint=jmint, jres=jres, fq=fq, jfq=jfq)


def test_filtered_tuning_equal_jax(tuned):
    res, jres = tuned["res"], tuned["jres"]
    assert sorted(s.name for s in res.configuration) == sorted(
        s.name for s in jres.configuration)
    assert {q: _plan_key(p) for q, p in res.plans.items()} == {
        q: _plan_key(p) for q, p in jres.plans.items()}
    assert res.est_workload_cost == jres.est_workload_cost
    assert {p.access_path for p in res.plans.values()} >= {"pre"}


@pytest.mark.parametrize("force", [None, "pre", "masked", "post"])
def test_filtered_plans_and_access_choice_equal_jax(tuned, force):
    planner = tuned["mint"].planner(Constraints(theta_recall=0.9, theta_storage=3))
    jplanner = tuned["jmint"].planner(JaxConstraints(theta_recall=0.9, theta_storage=3))
    config = tuned["res"].configuration
    jconfig = tuned["jres"].configuration
    for q, jq in zip(tuned["fq"], tuned["jfq"]):
        try:
            want = jplanner.plan(jq, jconfig, force_access=force)
        except ValueError:
            with pytest.raises(ValueError):
                planner.plan(q, config, force_access=force)
            continue
        assert _plan_key(planner.plan(q, config, force_access=force)) == _plan_key(want)
    with pytest.raises(ValueError):
        planner.plan(tuned["fq"][5], [], force_access="post")


# ---- the engine's access paths -----------------------------------------------------


def _churn(dbs, attrs, jattrs, seed=1, n_insert=30, n_delete=40, n_upsert=6):
    """The same churn on a port table and a reference table; inserted rows
    carry attributes in both stores."""
    t, jt = MutableTable(dbs[0]), JaxTable(dbs[1])
    rng = np.random.default_rng(seed)
    blocks = row_batch(dbs[1], rng, n_insert)
    _, ids = t.apply(InsertBatch(blocks))
    jt.apply(JInsert(blocks))
    vals = {"score": rng.random(n_insert).astype(np.float32),
            "category": [f"cat{i % 5}" for i in range(n_insert)]}
    attrs.put(ids, vals)
    jattrs.put(ids, vals)
    dead = rng.choice(t.live_ids(), size=n_delete, replace=False)
    t.apply(DeleteBatch(dead))
    jt.apply(JDelete(dead))
    up = rng.choice(t.live_ids(), size=n_upsert, replace=False)
    ublocks = row_batch(dbs[1], rng, n_upsert)
    t.apply(UpsertBatch(up, ublocks))
    jt.apply(JUpsert(up, ublocks))
    return t, jt


def _carried_store(db, jstore, specs):
    """A port IndexStore holding the reference's built indexes as arrays."""
    store = IndexStore(db, seed=0, device="cpu")
    for spec in specs:
        j = jstore.get(JSpec(spec.vid, spec.kind))
        data = db.concat(spec.vid)
        if spec.kind == "ivf":
            idx = convert.ivf_from_arrays(data, j.centroids, j.row_ids, j.offsets,
                                          j.n_lists, device="cpu")
        elif spec.kind == "hnsw":
            idx = convert.hnsw_from_arrays(data, j._layers, j._layer_ids, j.entry,
                                           j.seed_centroids, j.seed_exemplars,
                                           device="cpu")
        elif spec.kind == "diskann":
            idx = convert.vamana_from_arrays(data, j.adj, j.entry, j.seed_centroids,
                                             j.seed_exemplars, device="cpu")
        else:
            continue
        store._cache[spec] = idx
    return store


def filtered_oracle(attrs, pred, q, db, table=None):
    """Independent numpy oracle: exact filtered top-k over live rows."""
    qvec = q.concat()
    if table is None:
        rows = np.nonzero(attrs.bitmap(pred, np.arange(db.n_rows)))[0]
        s, ids = db.concat(q.vid)[rows] @ qvec, rows.astype(np.int64)
    else:
        t = table
        bp = np.nonzero(attrs.bitmap(pred, t.base_ids) & t.base_alive)[0]
        parts_s, parts_i = [t.base.concat(q.vid)[bp] @ qvec], [t.base_ids[bp]]
        if t.n_delta:
            dp = np.nonzero(attrs.bitmap(pred, t.delta_ids_arr()) & t.delta_alive_arr())[0]
            parts_s.append(t.delta_concat(q.vid)[dp] @ qvec)
            parts_i.append(t.delta_ids_arr()[dp])
        s, ids = np.concatenate(parts_s), np.concatenate(parts_i)
    order = np.lexsort((ids, -s))
    return ids[order][: min(q.k, ids.size)].astype(np.int64)


def _grid_plans(q, kind, sel, n_live, mk):
    """One plan per access path; ANN post probes run exhaustively."""
    QP, Spec = mk
    ek = 40 if kind == "flat" else n_live
    plans = {"pre": QP(q.qid, [], [], 1.0, 1.0, access_path="pre", selectivity=sel),
             "masked": QP(q.qid, [], [], 1.0, 1.0, access_path="masked",
                          selectivity=sel),
             "post": QP(q.qid, [Spec(q.vid, kind)], [ek], 1.0, 1.0, access_path="post",
                        selectivity=sel)}
    if len(q.vid) > 1:  # per-column probes + the union rerank
        plans["post_rerank"] = QP(q.qid, [Spec((c,), kind) for c in q.vid],
                                  [ek] * len(q.vid), 1.0, 1.0, access_path="post",
                                  selectivity=sel)
    return plans


def _run_grid(dbs, queries, kind, churned, sels, streaming=True):
    attrs, jattrs = _attrs()
    table = jtable = None
    if churned:
        table, jtable = _churn(dbs, attrs, jattrs)
    specs = {IndexSpec(v, kind) for v in VIDS}
    jstore = JaxIndexStore(dbs[1], seed=0)
    jeng = JaxEngine(dbs[1], store=jstore, streaming=streaming)
    eng = BatchEngine(dbs[0], store=_carried_store(dbs[0], jstore, specs),
                      streaming=streaming)
    eng.attach_filters(attrs)
    jeng.attach_filters(jattrs)
    if churned:
        eng.attach_mutations(MutationView(table, device="cpu"))
        jeng.attach_mutations(JaxView(jtable))
    n_live = N_ROWS if table is None else table.n_live
    for sel in sels:
        pred = quantile_pred(attrs, sel)
        for q, jq in zip(*queries):
            fq, jfq = replace(q, predicate=pred), replace(jq, predicate=to_jax(pred))
            gt = filtered_oracle(attrs, pred, fq, dbs[0], table)
            np.testing.assert_array_equal(eng.ground_truth(fq), gt)
            plans = _grid_plans(fq, kind, sel, n_live, (QueryPlan, IndexSpec))
            jplans = _grid_plans(jfq, kind, sel, n_live, (JPlan, JSpec))
            for access in plans:
                what = f"kind={kind} access={access} sel={sel} vid={q.vid}"
                m = eng.execute_batch([(fq, plans[access])])[0]
                jm = jeng.execute_batch([(jfq, jplans[access])])[0]
                np.testing.assert_array_equal(m.ids, jm.ids, err_msg=what)
                assert (m.cost, m.num_dist, m.recall, m.eks) == (
                    jm.cost, jm.num_dist, jm.recall, jm.eks), what
                if kind == "flat" or access in ("pre", "masked"):
                    np.testing.assert_array_equal(m.ids, gt, err_msg=what)
    assert eng.counters.as_dict() == jeng.counters.as_dict()
    return eng


@pytest.mark.parametrize("churned", [False, True])
@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw", "diskann"])
def test_engine_access_paths_equal_jax(dbs, queries, kind, churned):
    _run_grid(dbs, queries, kind, churned, (0.01, 0.1, 0.5, 1.0))


@pytest.mark.parametrize("churned", [False, True])
def test_engine_two_pass_equals_jax_and_streaming(dbs, queries, churned):
    eng = _run_grid(dbs, queries, "flat", churned, (0.1, 0.5), streaming=False)
    assert eng.counters.delta > 0 if churned else eng.counters.delta == 0


@pytest.mark.parametrize("churned", [False, True])
def test_streaming_and_two_pass_bit_identical_in_port(dbs, queries, churned):
    attrs, jattrs = _attrs()
    engs = [BatchEngine(dbs[0], streaming=s, device="cpu") for s in (True, False)]
    if churned:
        table, _ = _churn(dbs, attrs, jattrs, seed=5)
    for eng in engs:
        eng.attach_filters(attrs)
        if churned:
            eng.attach_mutations(MutationView(table, device="cpu"))
    for sel in (0.01, 0.1, 0.5, 1.0):
        pred = quantile_pred(attrs, sel)
        pairs = []
        for q in queries[0]:
            fq = replace(q, predicate=pred)
            pairs += [(fq, p) for p in _grid_plans(fq, "flat", sel, N_ROWS,
                                                   (QueryPlan, IndexSpec)).values()]
        a, b = (e.search_batch(pairs) for e in engs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_zero_match_launches_nothing_and_equals_jax(dbs, queries):
    attrs, jattrs = _attrs()
    jstore = JaxIndexStore(dbs[1], seed=0)
    specs = {IndexSpec(queries[0][0].vid, k) for k in ("ivf", "hnsw")}
    eng = BatchEngine(dbs[0], store=_carried_store(dbs[0], jstore, specs))
    jeng = JaxEngine(dbs[1], store=jstore)
    eng.attach_filters(attrs)
    jeng.attach_filters(jattrs)
    pred = quantile_pred(attrs, 0.0)
    q = replace(queries[0][0], predicate=pred)
    jq = replace(queries[1][0], predicate=to_jax(pred))
    for access, kinds in (("pre", []), ("post", ["ivf"]), ("post", ["hnsw"]),
                          ("masked", [])):
        plan = QueryPlan(q.qid, [IndexSpec(q.vid, k) for k in kinds], [40] * len(kinds),
                         1.0, 1.0, access_path=access, selectivity=0.0)
        jplan = JPlan(q.qid, [JSpec(q.vid, k) for k in kinds], [40] * len(kinds),
                      1.0, 1.0, access_path=access, selectivity=0.0)
        before = eng.counters.as_dict()
        got = eng.search_batch([(q, plan)])[0]
        assert got.shape == (0,) and eng.counters.as_dict() == before
        m, jm = eng.execute_batch([(q, plan)])[0], jeng.execute_batch([(jq, jplan)])[0]
        assert (m.recall, m.num_dist, m.cost) == (jm.recall, jm.num_dist, jm.cost) == (
            1.0, 0, 0.0)
    assert eng.counters.as_dict() == jeng.counters.as_dict()


def test_filtered_query_without_attrs_raises(dbs, queries):
    eng = BatchEngine(dbs[0], device="cpu")
    q = replace(queries[0][0], predicate=tf.Eq("category", "cat0"))
    plan = QueryPlan(q.qid, [], [], 1.0, 1.0, access_path="masked", selectivity=0.5)
    with pytest.raises(ValueError, match="AttributeStore"):
        eng.search_batch([(q, plan)])
    eng.attach_filters(synth_attributes(N_ROWS, seed=3, device="cpu"))
    assert len(eng.search_batch([(q, plan)])[0]) == K
    eng.detach_filters()
    with pytest.raises(ValueError, match="AttributeStore"):
        eng.search_batch([(q, plan)])


def test_filter_cache_invalidates_on_attribute_version(dbs, queries):
    attrs, _ = _attrs()
    eng = BatchEngine(dbs[0], device="cpu")
    eng.attach_filters(attrs)
    pred = tf.Range("score", lo=2.0, hi=3.0)  # matches nothing ...
    q = replace(queries[0][0], predicate=pred)
    plan = QueryPlan(q.qid, [], [], 1.0, 1.0, access_path="masked", selectivity=0.5)
    assert eng.search_batch([(q, plan)])[0].shape == (0,)
    attrs.put(np.arange(20), {"score": np.full(20, 2.5, np.float32)})  # ... until now
    got = eng.search_batch([(q, plan)])[0]
    assert len(got) == K and set(got.tolist()) <= set(range(20))
    np.testing.assert_array_equal(got, filtered_oracle(attrs, pred, q, dbs[0]))
