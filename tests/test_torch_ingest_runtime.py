"""Port parity of the ingest runtime (``ingest/runtime.py``: the online
runtime plus mutations, sync and async compaction with replay-rebase, and
data-drift retunes) against the JAX package, on the fixture of
tests/test_ingest.py (500 rows, 2 columns, k = 10).

The same churn trace through the reference's ``IngestRuntime`` and the
port's gives equal ticket ids, recalls, costs, compaction and data-retune
events (times left out) and an equal final table. Inside the port: a
rebase with replay equals a from-scratch materialization, queries served
while an async compaction builds observe one (store, generation, table)
triple and equal the live oracle, a stale build is dropped, a failing build
lands in ``failures``, and seeded interleavings converge to the serial
schedule. Every comparison is exact.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

K = 10
COLS = [("a", 24), ("b", 32)]


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, kw={"device": "cpu"} if name == "repro_torch" else {},
        a=mod("async_"), Mint=mod("core.tuner").Mint, types=mod("core.types"),
        vectors=mod("data.vectors"), IndexStore=mod("index.registry").IndexStore,
        ingest=mod("ingest"), online=mod("online"), trace=mod("online.trace"),
        BatchEngine=mod("serve.engine").BatchEngine)


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}
T = PKGS["repro_torch"]


def _setup(P, kind="ivf"):
    db = P.vectors.make_database(500, COLS, seed=0)
    qs = P.vectors.make_queries(db, [(0,), (0, 1), (1,)], k=K, seed=7)
    wl = P.types.Workload(queries=qs, probs=np.ones(len(qs)))
    cons = P.types.Constraints(theta_recall=0.85, theta_storage=3)
    mint = P.Mint(db, index_kind=kind, seed=0, min_sample_rows=300, **P.kw)
    return SimpleNamespace(db=db, wl=wl, cons=cons, mint=mint,
                           tuned=mint.tune(wl, cons))


@pytest.fixture(scope="module")
def twins():
    return {name: _setup(P) for name, P in PKGS.items()}


@pytest.fixture(scope="module")
def flat():
    return _setup(T, "flat")


def _runtime(P, s, executor=None, async_flush=False, **ingest_kw):
    kw = dict(policy=P.ingest.CompactionPolicy(max_delta_fraction=0.1,
                                               max_dead_fraction=0.12),
              min_mutated_rows=10_000, data_cooldown_s=0.0)
    kw.update(ingest_kw)
    return P.ingest.IngestRuntime(
        s.db, s.mint, s.wl, s.cons, result=s.tuned, executor=executor, **P.kw,
        config=P.online.RuntimeConfig(max_batch=4, max_delay_ms=5.0, window=32,
                                      min_window=16, drift_threshold=2.0,
                                      cooldown_s=1e9, measure=True,
                                      async_flush=async_flush),
        ingest=P.ingest.IngestConfig(**kw))


def _mixed_run(P, s, scenario):
    if scenario == "compaction":
        rt = _runtime(P, s)
        trace = P.trace.churn_trace(s.db, s.wl, n=30, qps=1000.0, mutation_rate=0.6,
                                    batch=8, mix=(0.6, 0.4, 0.0), seed=14)
    elif scenario == "async_compaction":
        rt = _runtime(P, s, executor=P.a.StepExecutor(seed=2), async_flush=True,
                      async_compaction=True)
        trace = P.trace.churn_trace(s.db, s.wl, n=30, qps=1000.0, mutation_rate=0.6,
                                    batch=8, mix=(0.6, 0.3, 0.1), seed=14)
    else:  # data drift: compact + retrain + retune
        drift_db = P.vectors.make_database(500, COLS, seed=88)
        rt = _runtime(P, s, min_mutated_rows=120, churn_threshold=0.25,
                      shift_threshold=0.03,
                      policy=P.ingest.CompactionPolicy(max_delta_fraction=0.5,
                                                       max_dead_fraction=0.5))
        trace = P.trace.churn_trace(s.db, s.wl, n=36, qps=1000.0, mutation_rate=1.0,
                                    batch=8, mix=(0.75, 0.25, 0.0),
                                    insert_source=drift_db, seed=15)
    tickets = rt.run_mixed_trace(trace)
    mdb, mids = rt.table.materialize()
    out = dict(
        ids=[np.asarray(t.result(timeout=30)).tolist() for t in tickets],
        metrics=[(t.metrics.recall, t.metrics.cost, t.metrics.num_dist)
                 for t in tickets],
        compactions=[(e.reason, e.generation, e.rows_before, e.rows_after,
                      e.dead_reclaimed, e.delta_folded, e.build_cost, e.mode,
                      e.replayed) for e in rt.compaction_events],
        retunes=[(e.reason, e.churn_fraction, e.max_shift, e.generation,
                  e.config_before, e.config_after, e.est_cost_after)
                 for e in rt.data_retune_events],
        generation=rt.generation, table=rt.table.stats(),
        config=sorted(x.name for x in rt.result.configuration),
        live=mids.tolist(), rows=[c.tobytes() for c in mdb.columns])
    if rt.builds is not None:
        out["builds"] = rt.builds.stats()
        assert not rt.builds.failures
    rt.close()
    return out


@pytest.mark.parametrize("scenario", ["compaction", "async_compaction", "data_drift"])
def test_ingest_runtime_equals_reference(twins, scenario):
    ref = _mixed_run(PKGS["repro"], twins["repro"], scenario)
    got = _mixed_run(T, twins["repro_torch"], scenario)
    assert got["compactions"] and got["generation"] >= 1
    if scenario == "data_drift":
        assert got["retunes"]
    assert np.mean([m[0] for m in got["metrics"][-10:]]) >= 0.85
    assert got == ref


def test_rebase_with_replay_equals_from_scratch(twins):
    """Cut a snapshot, keep mutating, rebase onto it with the post-cut log:
    the table equals a from-scratch materialization of its final state."""
    db = twins["repro_torch"].db
    rng = np.random.default_rng(43)
    t = T.ingest.MutableTable(db)
    t.apply(T.ingest.InsertBatch(T.trace.row_batch(db, rng, 25)))
    t.apply(T.ingest.DeleteBatch(rng.choice(t.live_ids(), 30, replace=False)))
    snap_db, snap_ids, cut = t.snapshot()
    _, fresh = t.apply(T.ingest.InsertBatch(T.trace.row_batch(db, rng, 10)))
    t.apply(T.ingest.DeleteBatch(np.concatenate([fresh[:3], np.array([888_888])])))
    targets = np.sort(rng.choice(t.live_ids(), 5, replace=False))
    t.apply(T.ingest.UpsertBatch(targets, T.trace.row_batch(db, rng, 5)))
    ref_db, ref_ids = t.materialize()
    t.rebase(snap_db, snap_ids, cut, replay=t.log.since(cut))
    got_db, got_ids = t.materialize()
    np.testing.assert_array_equal(got_ids, ref_ids)
    for a, b in zip(got_db.columns, ref_db.columns):
        np.testing.assert_array_equal(a, b)


def test_mid_compaction_queries_see_one_triple(twins):
    """While an async compaction builds, mutations and queries land on the
    OLD (store, generation) pair with results equal to the live oracle;
    the finalize at the next tick replays the post-cut log, and a query
    after it equals a from-scratch rebuild of the final table."""
    s = twins["repro_torch"]
    step = T.a.StepExecutor(seed=3)
    rt = _runtime(T, s, executor=step, async_compaction=True,
                  policy=T.ingest.CompactionPolicy(max_delta_fraction=None,
                                                   max_dead_fraction=None))
    rng = np.random.default_rng(2)
    rt.insert(T.trace.row_batch(s.db, rng, 40))
    rt.delete(rng.choice(rt.table.live_ids(), 30, replace=False))
    gen0, store0 = rt.generation, rt.store
    assert rt.compact_async(reason="test", now=1.0) is not None
    assert rt.compact_async(reason="dup", now=1.0) is None
    rt.insert(T.trace.row_batch(s.db, rng, 12))
    rt.delete(rng.choice(rt.table.live_ids(), 9, replace=False))
    seen = []
    orig = rt.batcher.execute

    def execute(tickets, staged=None):
        seen.append((rt.engine.store, rt.generation, rt.table.version))
        return orig(tickets, staged)
    rt.batcher.execute = execute
    qs = T.vectors.make_queries(s.db, [(0, 1), (0,), (1,)], k=K, seed=9)
    for i, q in enumerate(qs):
        q.qid = 777 + i
        plan = T.types.QueryPlan(q.qid, [T.types.IndexSpec(q.vid, "flat")], [K], 1.0, 1.0)
        tk = rt.batcher.submit(q, 1.5, plan=plan)
        rt.drain(1.6)
        np.testing.assert_array_equal(np.asarray(tk.ids), rt.view.ground_truth(q))
    assert len(set(seen)) == 1 and seen[0][:2] == (store0, gen0)
    ref_db, ref_ids = rt.table.materialize()
    step.run_all()
    assert rt.generation == gen0
    rt.tick(2.0)
    assert rt.generation == gen0 + 1 and not rt.builds.failures
    ev = rt.compaction_events[-1]
    assert ev.mode == "async" and ev.replayed == 2
    got_db, got_ids = rt.table.materialize()
    np.testing.assert_array_equal(got_ids, ref_ids)
    q2 = T.vectors.make_queries(s.db, [(0, 1)], k=K, seed=11)[0]
    q2.qid = 778
    plan2 = T.types.QueryPlan(q2.qid, [T.types.IndexSpec((0, 1), "flat")], [K], 1.0, 1.0)
    tk2 = rt.batcher.submit(q2, 3.0, plan=plan2)
    rt.drain(3.1)
    reng = T.BatchEngine(ref_db, store=T.IndexStore(ref_db, seed=0, device="cpu"))
    [ref] = reng.search_batch([(q2, plan2)])
    np.testing.assert_array_equal(np.asarray(tk2.ids), ref_ids[np.asarray(ref)])
    rt.close()


def test_stale_async_build_is_dropped(twins):
    s = twins["repro_torch"]
    step = T.a.StepExecutor(seed=0)
    rt = _runtime(T, s, executor=step, async_compaction=True,
                  policy=T.ingest.CompactionPolicy(max_delta_fraction=None,
                                                   max_dead_fraction=None))
    rng = np.random.default_rng(4)
    rt.insert(T.trace.row_batch(s.db, rng, 25))
    rt.compact_async(reason="slow", now=1.0)
    rt.insert(T.trace.row_batch(s.db, rng, 10))
    rt.compact(reason="fast", now=1.1)
    gen = rt.generation
    ref_db, ref_ids = rt.table.materialize()
    step.run_all()
    rt.tick(2.0)
    assert rt.stale_async_builds == 1 and rt.generation == gen
    got_db, got_ids = rt.table.materialize()
    np.testing.assert_array_equal(got_ids, ref_ids)
    np.testing.assert_array_equal(got_db.columns[0], ref_db.columns[0])


def test_failing_build_lands_in_failures_and_serving_continues(twins):
    s = twins["repro_torch"]
    step = T.a.StepExecutor(seed=0)
    rt = _runtime(T, s, executor=step, async_compaction=True,
                  policy=T.ingest.CompactionPolicy(max_delta_fraction=None,
                                                   max_dead_fraction=None))
    rng = np.random.default_rng(5)
    rt.insert(T.trace.row_batch(s.db, rng, 20))

    def broken(cut, configuration, reason="manual", **kw):
        raise RuntimeError("shadow build failed")
    rt.compactor.build_from = broken
    gen = rt.generation
    rt.compact_async(reason="doomed", now=1.0)
    step.run_all()
    rt.tick(2.0)
    assert [f.label for f in rt.builds.failures] == ["compact:doomed"]
    assert isinstance(rt.builds.failures[0].error, RuntimeError)
    assert rt.generation == gen and not rt.compaction_events
    q = T.vectors.make_queries(s.db, [(0, 1)], k=K, seed=12)[0]
    q.qid = 4242
    plan = T.types.QueryPlan(q.qid, [T.types.IndexSpec((0, 1), "flat")], [K], 1.0, 1.0)
    tk = rt.batcher.submit(q, 2.5, plan=plan)
    rt.drain(2.6)
    np.testing.assert_array_equal(np.asarray(tk.ids), rt.view.ground_truth(q))
    rt.close()


def test_async_compaction_fires_from_maintain(twins):
    s = twins["repro_torch"]
    step = T.a.StepExecutor(seed=1)
    rt = _runtime(T, s, executor=step, async_compaction=True, min_mutated_rows=1,
                  policy=T.ingest.CompactionPolicy(max_delta_fraction=0.05,
                                                   max_dead_fraction=None))
    rng = np.random.default_rng(6)
    rt.insert(T.trace.row_batch(s.db, rng, 60))
    rt.tick(0.1)
    assert rt.builds.inflight("compact")
    rt.insert(T.trace.row_batch(s.db, rng, 5))
    step.run_all()
    rt.tick(0.2)
    assert [e.mode for e in rt.compaction_events] == ["async"]
    assert rt.compaction_events[0].replayed == 1 and rt.table.n_delta == 5


def _churn_schedule(s, rt):
    gts = {}
    orig = rt.batcher.execute

    def execute(tickets, staged=None):
        for t in tickets:
            gts[t.query.qid] = rt.view.ground_truth(t.query)
        return orig(tickets, staged)
    rt.batcher.execute = execute
    rng = np.random.default_rng(21)
    out = []
    rt.insert(T.trace.row_batch(s.db, rng, 30))
    for i, q in enumerate(T.vectors.make_queries(s.db, [(0,), (0, 1), (1,)] * 4, k=K,
                                                 seed=17)):
        q.qid = 5000 + i
        plan = T.types.QueryPlan(q.qid, [T.types.IndexSpec(q.vid, "flat")], [K], 1.0, 1.0)
        out.append(rt.batcher.submit(q, i * 1e-3, plan=plan))
        if i == 3:
            rt.delete(rng.choice(rt.table.live_ids(), 20, replace=False))
        if i == 5:
            if rt.ingest.async_compaction:
                rt.compact_async(reason="mid", now=i * 1e-3)
            else:
                rt.compact(reason="mid", now=i * 1e-3)
        if i == 8:
            rt.insert(T.trace.row_batch(s.db, rng, 15))
        rt.tick(i * 1e-3)
    rt.drain(1.0)
    rt.wait_maintenance(now=1.0)
    return out, gts


@pytest.mark.parametrize("seed", range(2))
def test_churn_under_seeded_interleavings_converges_to_serial(flat, seed):
    """Async flush + async compaction under seeded interleavings: every
    flushed batch equals its flush-time oracle, and the final table equals
    the serial schedule's."""
    policy = dict(policy=T.ingest.CompactionPolicy(max_delta_fraction=None,
                                                   max_dead_fraction=None))
    rt_ref = _runtime(T, flat, async_compaction=False, **policy)
    ref, ref_gts = _churn_schedule(flat, rt_ref)
    for t in ref:
        np.testing.assert_array_equal(np.asarray(t.ids), ref_gts[t.query.qid])
    rt = _runtime(T, flat, executor=T.a.StepExecutor(seed=seed), async_flush=True,
                  async_compaction=True, **policy)
    got, gts = _churn_schedule(flat, rt)
    for t in got:
        np.testing.assert_array_equal(np.asarray(t.result(timeout=30)),
                                      gts[t.query.qid])
    ref_db, ref_ids = rt_ref.table.materialize()
    got_db, got_ids = rt.table.materialize()
    np.testing.assert_array_equal(got_ids, ref_ids)
    for a, b in zip(got_db.columns, ref_db.columns):
        np.testing.assert_array_equal(a, b)
    assert rt.compaction_events[-1].mode == "async" and not rt.builds.failures
