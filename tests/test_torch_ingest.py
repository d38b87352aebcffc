"""Port parity of the mutation subsystem (table, log replay, delta segments,
the mutation view, the engine's mutated serving, compaction and data drift)
and of the semantic-cache probe against the JAX package, on the fixture of
tests/test_ingest.py (500 rows, 2 columns, k = 10).

Tolerances: ids, numDist, costs, plans, counters, bitmaps and table state
are held exactly equal. The cache probe's values are held within the
kernels' score tolerance (``kernels.parity.tolerance(d)`` relative to
max(|value|, 1)): the reference's CPU probe is an XLA formula, the port's
is the streaming scan's plain version; its ids are held equal.
"""
import numpy as np
import pytest
import torch

from repro.core.types import IndexSpec as JSpec
from repro.core.types import QueryPlan as JPlan
from repro.data.vectors import make_database as jax_make_database
from repro.data.vectors import make_queries as jax_make_queries
from repro.index.registry import IndexStore as JaxIndexStore
from repro.ingest import CompactionPolicy as JaxPolicy
from repro.ingest import Compactor as JaxCompactor
from repro.ingest import DataDriftDetector as JaxDrift
from repro.ingest import DeleteBatch as JDelete
from repro.ingest import InsertBatch as JInsert
from repro.ingest import MutableTable as JaxTable
from repro.ingest import MutationView as JaxView
from repro.ingest import DeltaSegments as JaxSegments
from repro.ingest import UpsertBatch as JUpsert
from repro.online.trace import row_batch
from repro.serve.engine import BatchEngine as JaxEngine
from repro.serve.engine import cache_probe_scan as jax_cache_probe_scan
from repro.tenancy import MemoryGovernor as JaxGovernor
from repro_torch import convert
from repro_torch.core.types import IndexSpec, QueryPlan
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.index.registry import IndexStore
from repro_torch.ingest import (CompactionPolicy, Compactor, DataDriftDetector,
                                DeleteBatch, DeltaSegments, InsertBatch, MutableTable,
                                MutationView, UpsertBatch)
from repro_torch.kernels.parity import tolerance
from repro_torch.serve.columnstore import ColumnStore
from repro_torch.serve.engine import BatchEngine, cache_probe_scan
from repro_torch.tenancy import MemoryGovernor

K = 10
COLS = [("a", 24), ("b", 32)]
N_ROWS = 500


@pytest.fixture(scope="module")
def dbs():
    return make_database(N_ROWS, COLS, seed=0), jax_make_database(N_ROWS, COLS, seed=0)


def _twin_churn(dbs, seed=1, n_insert=40, n_delete=60, n_upsert=0, tables=None):
    """The same seeded churn applied to a port and a reference table."""
    t, jt = tables or (MutableTable(dbs[0]), JaxTable(dbs[1]))
    rng = np.random.default_rng(seed)
    blocks = row_batch(dbs[1], rng, n_insert)
    a, b = t.apply(InsertBatch(blocks)), jt.apply(JInsert(blocks))
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    dead = rng.choice(t.live_ids(), size=n_delete, replace=False)
    t.apply(DeleteBatch(dead))
    jt.apply(JDelete(dead))
    if n_upsert:
        up = rng.choice(t.live_ids(), size=n_upsert, replace=False)
        ublocks = row_batch(dbs[1], rng, n_upsert)
        t.apply(UpsertBatch(up, ublocks))
        jt.apply(JUpsert(up, ublocks))
    return t, jt


def _assert_tables_equal(t, jt):
    assert t.stats() == jt.stats()
    np.testing.assert_array_equal(t.base_ids, jt.base_ids)
    np.testing.assert_array_equal(t.base_alive, jt.base_alive)
    np.testing.assert_array_equal(t.delta_ids_arr(), jt.delta_ids_arr())
    np.testing.assert_array_equal(t.delta_alive_arr(), jt.delta_alive_arr())
    np.testing.assert_array_equal(t.live_ids(), jt.live_ids())
    for vid in ((0,), (1,), (0, 1)):
        np.testing.assert_array_equal(t.delta_concat(vid), jt.delta_concat(vid))
    for c in range(2):
        np.testing.assert_array_equal(t.live_mean(c), jt.live_mean(c))
    assert t._loc == jt._loc


# ---- table, log, replay -----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_table_and_log_equal_jax(dbs, seed):
    t, jt = _twin_churn(dbs, seed=seed, n_upsert=7)
    _assert_tables_equal(t, jt)
    for r, jr in zip(t.log.records, jt.log.records):
        assert (r.lsn, r.kind, r.n, r.applied) == (jr.lsn, jr.kind, jr.n, jr.applied)
        np.testing.assert_array_equal(r.ids, jr.ids)
    assert t.contains(int(t.live_ids()[0])) and not t.contains(10 ** 6)
    db, ids = t.materialize()
    jdb, jids = jt.materialize()
    np.testing.assert_array_equal(ids, jids)
    for a, b in zip(db.columns, jdb.columns):
        np.testing.assert_array_equal(a, b)


def test_rebase_with_replay_equals_jax(dbs):
    t, jt = _twin_churn(dbs, seed=4, n_upsert=3)
    db, ids, cut = t.snapshot()
    jdb, jids, jcut = jt.snapshot()
    assert cut == jcut
    _twin_churn(dbs, seed=5, n_insert=12, n_delete=9, n_upsert=2, tables=(t, jt))
    t.rebase(db, ids, cut, replay=t.log.since(cut))
    jt.rebase(jdb, jids, jcut, replay=jt.log.since(jcut))
    _assert_tables_equal(t, jt)
    assert t.log.stats() == jt.log.stats()


# ---- the mutation view --------------------------------------------------------


def test_mutation_view_translate_masks_and_oracle_equal_jax(dbs):
    t, jt = _twin_churn(dbs, seed=2, n_upsert=5)
    mdb, mids = t.materialize()
    jmdb, jmids = jt.materialize()
    t.rebase(mdb, mids)
    jt.rebase(jmdb, jmids)
    _twin_churn((mdb, jmdb), seed=3, n_insert=25, n_delete=30, n_upsert=4,
                tables=(t, jt))
    mv, jmv = MutationView(t, device="cpu"), JaxView(jt)
    assert mv.mutated() == jmv.mutated() and mv.identity_base() == jmv.identity_base()
    phys = np.arange(t.n_base)
    np.testing.assert_array_equal(mv.translate(phys), jmv.translate(phys))
    np.testing.assert_array_equal(mv.base_dead_mask(512).numpy(),
                                  np.asarray(jmv.base_dead_mask(512)))
    assert mv.base_dead_mask(512) is mv.base_dead_mask(512)  # cached per version
    for vid in ((0,), (0, 1)):
        d, jd = mv.delta(vid), jmv.delta(vid)
        np.testing.assert_array_equal(d.col.data.numpy(), np.asarray(jd.col.data))
        np.testing.assert_array_equal(d.ids, jd.ids)
        assert (d.dead_mask is None) == (jd.dead_mask is None)
        if d.dead_mask is not None:
            np.testing.assert_array_equal(d.dead_mask.numpy(), np.asarray(jd.dead_mask))
        assert (d.n_rows, d.n_alive) == (jd.n_rows, jd.n_alive)
    live = t.live_ids()
    for a, b in zip(mv.locate(live), jmv.locate(live)):
        np.testing.assert_array_equal(a, b)
    for q, jq in zip(make_queries(mdb, [(0,), (0, 1)], k=K, seed=3),
                     jax_make_queries(jmdb, [(0,), (0, 1)], k=K, seed=3)):
        np.testing.assert_array_equal(mv.ground_truth(q), jmv.ground_truth(jq))


def test_delta_segments_versioning(dbs):
    t = MutableTable(dbs[0])
    seg = DeltaSegments(t, device="cpu")
    assert seg.column((0,)) is None
    rng = np.random.default_rng(6)
    t.apply(InsertBatch(row_batch(dbs[1], rng, 10)))
    d1 = seg.column((0,))
    assert d1.n_rows == 10 and seg.column((0,)) is d1
    assert tuple(d1.col.data.shape) == (128, 128) and d1.dead_mask is None
    t.apply(InsertBatch(row_batch(dbs[1], rng, 200)))  # new version: re-upload
    d2 = seg.column((0,))
    assert d2.n_rows == 210 and tuple(d2.col.data.shape) == (256, 128)
    assert seg.total_device_bytes() == 256 * 128 * 4
    seg.drop_all()
    assert seg.total_device_bytes() == 0
    # governed, a segment charges the reference's key and padded bytes
    govs, tables = (MemoryGovernor(10**9), JaxGovernor(10**9)), (MutableTable(dbs[0]),
                                                                   JaxTable(dbs[1]))
    block = row_batch(dbs[1], np.random.default_rng(7), 130)
    segs = (DeltaSegments(tables[0], governor=govs[0], tenant="t", device="cpu"),
            JaxSegments(tables[1], governor=govs[1], tenant="t"))
    tables[0].apply(InsertBatch(block))
    tables[1].apply(JInsert(block))
    for seg, gov in zip(segs, govs):
        seg.column((0,))
        seg.column((0, 1))
    assert govs[0].resident() == govs[1].resident() == [
        ("t", ("delta", 0), 256 * 128 * 4), ("t", ("delta", 0, 1), 256 * 128 * 4)]
    segs[0].drop_all()
    assert govs[0].resident() == [] and govs[0].stats()["total_bytes"] == 0


# ---- the engine over a mutated table ------------------------------------------


def _carried_store(db, jstore, specs):
    store = IndexStore(db, seed=0, device="cpu")
    for spec in specs:
        j = jstore.get(JSpec(spec.vid, spec.kind))
        data = db.concat(spec.vid)
        if spec.kind == "ivf":
            store._cache[spec] = convert.ivf_from_arrays(
                data, j.centroids, j.row_ids, j.offsets, j.n_lists, device="cpu")
        elif spec.kind == "hnsw":
            store._cache[spec] = convert.hnsw_from_arrays(
                data, j._layers, j._layer_ids, j.entry, j.seed_centroids,
                j.seed_exemplars, device="cpu")
        elif spec.kind == "diskann":
            store._cache[spec] = convert.vamana_from_arrays(
                data, j.adj, j.entry, j.seed_centroids, j.seed_exemplars,
                device="cpu")
    return store


def _plans(q, kind, ek, mk):
    QP, Spec = mk
    out = [QP(q.qid, [], [], 1.0, 1.0),                      # flat fallback
           QP(q.qid, [Spec(q.vid, kind)], [ek], 1.0, 1.0)]   # single exact
    if len(q.vid) > 1:                                        # rerank union
        out.append(QP(q.qid, [Spec((c,), kind) for c in q.vid], [ek] * len(q.vid),
                      1.0, 1.0))
    return out


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw", "diskann"])
def test_mutated_serving_equals_jax(dbs, kind, streaming):
    t, jt = _twin_churn(dbs, seed=11, n_insert=30, n_delete=45, n_upsert=5)
    jstore = JaxIndexStore(dbs[1], seed=0)
    store = _carried_store(dbs[0], jstore, {IndexSpec(v, kind)
                                            for v in ((0,), (1,), (0, 1))})
    eng = BatchEngine(dbs[0], store=store, streaming=streaming)
    jeng = JaxEngine(dbs[1], store=jstore, streaming=streaming)
    eng.attach_mutations(MutationView(t, device="cpu"))
    jeng.attach_mutations(JaxView(jt))
    ek = 40 if kind == "flat" else t.n_live
    vids = [(0, 1), (0,), (1,), (0, 1)]
    qs, jqs = make_queries(dbs[0], vids, k=K, seed=13), jax_make_queries(dbs[1], vids,
                                                                          k=K, seed=13)
    pairs = [(q, p) for q in qs for p in _plans(q, kind, ek, (QueryPlan, IndexSpec))]
    jpairs = [(q, p) for q in jqs for p in _plans(q, kind, ek, (JPlan, JSpec))]
    got, want = eng.execute_batch(pairs), jeng.execute_batch(jpairs)
    for (q, p), m, jm in zip(pairs, got, want):
        np.testing.assert_array_equal(m.ids, jm.ids, err_msg=p.describe())
        assert (m.cost, m.num_dist, m.recall, m.eks) == (jm.cost, jm.num_dist,
                                                         jm.recall, jm.eks)
        np.testing.assert_array_equal(eng.ground_truth(q), jeng.ground_truth(
            jqs[qs.index(q)]))
        if kind == "flat":
            assert m.recall == 1.0
    assert eng.counters.as_dict() == jeng.counters.as_dict()
    if kind == "flat":  # streaming: every flat group ONE merged launch
        assert (eng.counters.delta == 0) == streaming


def test_streaming_and_two_pass_bit_identical_in_port(dbs):
    t, _ = _twin_churn(dbs, seed=21, n_insert=33, n_delete=70, n_upsert=4)
    qs = make_queries(dbs[0], [(0, 1), (0,), (1,), (0, 1)], k=K, seed=23)
    pairs = [(q, p) for q in qs for p in _plans(q, "flat", 37, (QueryPlan, IndexSpec))]
    outs = []
    for streaming in (True, False):
        eng = BatchEngine(dbs[0], streaming=streaming, device="cpu")
        eng.attach_mutations(MutationView(t, device="cpu"))
        outs.append(eng.search_batch(pairs))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_merged_scan_refuses_a_base_off_the_id_block(dbs):
    t, _ = _twin_churn(dbs, seed=1)
    cs = ColumnStore(dbs[0], block_rows=100, device="cpu")  # 500 rows: 500, not 512
    eng = BatchEngine(dbs[0], cstore=cs)
    eng.attach_mutations(MutationView(t, device="cpu"))
    q = make_queries(dbs[0], [(0,)], k=K, seed=1)[0]
    with pytest.raises(RuntimeError, match="delta id block"):
        eng.search_batch([(q, QueryPlan(q.qid, [], [], 1.0, 1.0))])


def test_attach_mutations_checks_the_device(dbs):
    eng = BatchEngine(dbs[0], device="cpu")
    view = MutationView(MutableTable(dbs[0]), device="cpu")
    view.device = torch.device("meta")
    with pytest.raises(ValueError, match="mutation view"):
        eng.attach_mutations(view)


# ---- compaction and drift ---------------------------------------------------------


def test_compaction_with_swap_store_equals_jax(dbs):
    t, jt = _twin_churn(dbs, seed=27, n_upsert=6)
    config = frozenset({IndexSpec((0,), "ivf"), IndexSpec((0, 1), "ivf")})
    jconfig = frozenset({JSpec((0,), "ivf"), JSpec((0, 1), "ivf")})
    eng = BatchEngine(dbs[0], device="cpu")
    jeng = JaxEngine(dbs[1])
    eng.attach_mutations(MutationView(t, device="cpu"))
    jeng.attach_mutations(JaxView(jt))
    qs = make_queries(dbs[0], [(0, 1), (0,)], k=K, seed=29)
    jqs = jax_make_queries(dbs[1], [(0, 1), (0,)], k=K, seed=29)
    pairs = [(q, QueryPlan(q.qid, [IndexSpec(q.vid, "flat")], [30], 1.0, 1.0)) for q in qs]
    jpairs = [(q, JPlan(q.qid, [JSpec(q.vid, "flat")], [30], 1.0, 1.0)) for q in jqs]
    before = eng.search_batch(pairs)
    np.testing.assert_array_equal(before, jeng.search_batch(jpairs))

    comp, jcomp = Compactor(t, seed=0, device="cpu"), JaxCompactor(jt, seed=0)
    assert comp.should_compact() == jcomp.should_compact()
    state, jstate = comp.build(config, reason="test"), jcomp.build(jconfig, reason="test")
    assert state.db.n_rows == jstate.db.n_rows == t.n_live
    np.testing.assert_array_equal(state.ids, jstate.ids)
    assert set(state.store.built_specs()) == config
    assert state.store.device == state.cstore.torch_device == torch.device("cpu")
    for f in ("upto_lsn", "rows_before", "rows_after", "delta_folded",
              "dead_reclaimed", "specs_rebuilt", "build_cost"):
        assert getattr(state.stats, f) == getattr(jstate.stats, f)
    assert t.n_delta > 0  # pure construction: the live table is untouched

    eng.swap_store(state.store, state.cstore, state.db)
    jeng.swap_store(jstate.store, jstate.cstore, jstate.db)
    t.rebase(state.db, state.ids, state.stats.upto_lsn)
    jt.rebase(jstate.db, jstate.ids, jstate.stats.upto_lsn)
    _assert_tables_equal(t, jt)
    after = eng.search_batch(pairs)
    for a, b, c in zip(before, after, jeng.search_batch(jpairs)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert eng.counters.as_dict() == jeng.counters.as_dict()


def test_compaction_policy_triggers_equal_jax(dbs):
    pol = CompactionPolicy(max_delta_fraction=0.05, max_dead_fraction=0.08,
                           max_log_records=3)
    jpol = JaxPolicy(max_delta_fraction=0.05, max_dead_fraction=0.08, max_log_records=3)
    t, jt = MutableTable(dbs[0]), JaxTable(dbs[1])
    rng = np.random.default_rng(7)
    reasons = []
    for step in range(4):
        if step % 2:
            dead = rng.choice(t.live_ids(), size=25, replace=False)
            t.apply(DeleteBatch(dead))
            jt.apply(JDelete(dead))
        else:
            blocks = row_batch(dbs[1], rng, 15)
            t.apply(InsertBatch(blocks))
            jt.apply(JInsert(blocks))
        reasons.append(pol.should_compact(t))
        assert reasons[-1] == jpol.should_compact(jt)
    assert reasons[0] is None and reasons[-1] is not None


@pytest.mark.parametrize("shift", [False, True])
def test_drift_reports_equal_jax(dbs, shift):
    kw = dict(delta_threshold=0.1, churn_threshold=0.2, shift_threshold=0.02,
              min_mutated_rows=10)
    t, jt = MutableTable(dbs[0]), JaxTable(dbs[1])
    det, jdet = DataDriftDetector(t, **kw), JaxDrift(jt, **kw)
    rng = np.random.default_rng(8)
    source = jax_make_database(N_ROWS, COLS, seed=77) if shift else None
    for n in (5, 30, 60):
        blocks = row_batch(dbs[1], rng, n, source=source)
        t.apply(InsertBatch(blocks))
        jt.apply(JInsert(blocks))
        rep, jrep = det.check(), jdet.check()
        assert rep.__dict__ == jrep.__dict__
    mdb, mids = t.materialize()
    t.rebase(mdb, mids)
    jmdb, jmids = jt.materialize()
    jt.rebase(jmdb, jmids)
    assert det.check().__dict__ == jdet.check().__dict__
    det.rearm()
    jdet.rearm()
    assert det.check().__dict__ == jdet.check().__dict__


# ---- the semantic-cache probe ----------------------------------------------------


@pytest.mark.parametrize("B,C,d,valid_n", [(1, 8, 16, 8), (64, 256, 96, 200),
                                           (7, 40, 33, 1), (16, 256, 384, 256)])
def test_cache_probe_equals_jax(B, C, d, valid_n):
    rng = np.random.default_rng(B * C + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    mat = rng.standard_normal((C, d)).astype(np.float32)
    mat[rng.choice(valid_n, size=min(3, valid_n), replace=False)] = q[0]  # exact hits
    vals, ids = cache_probe_scan(q, mat, valid_n, device="cpu")
    jvals, jids = jax_cache_probe_scan(q, mat, valid_n, interpret=True)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert vals.shape == (B, 1) and ids.dtype == np.int32
    jvals = np.asarray(jvals)
    assert (np.abs(vals - jvals) <= tolerance(d) * np.maximum(np.abs(jvals), 1.0)).all()
    assert (ids < valid_n).all()
    eng = BatchEngine(make_database(64, [("a", 8)], seed=0), device="cpu")
    v2, i2 = eng.cache_probe(q, mat, valid_n)
    np.testing.assert_array_equal(v2, vals)
    np.testing.assert_array_equal(i2, ids)
