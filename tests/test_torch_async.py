"""Port parity of the async serving pipeline (``async_/``, the engine's
staged batches, async flush) against the JAX package, on the fixture of
tests/test_async.py (400 rows, 2 columns, k = 8).

- The executor substrate behaves as the reference's: ``StepExecutor(seed)``
  picks the same task order, a crashed worker fails only its task and is
  replaced, shutdown cancels pending work with ``PoolShutdown``, the build
  coordinator runs cut → build → finalize, and ``drive_until`` returns on
  every executor.
- Async flush equals sync flush bit for bit for flat, IVF, HNSW and
  DiskANN plans, on a real ``WorkerPool`` with staging and under three
  seeded ``StepExecutor`` interleavings; the sync ids equal the reference's.
- ``stage_batch`` then ``search_batch(staged=...)`` equals the unstaged
  call (plain, filtered and mutated tables), stages the bytes the unstaged
  path uploads, moves no counter, and a store swap between the two makes
  execution recompute its queries.

Every comparison is exact (ids, counters); no tolerance applies.
"""
import importlib
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

K = 8
COLS = [("a", 24), ("b", 32)]


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    a = mod("async_")
    return SimpleNamespace(
        name=name, kw={"device": "cpu"} if name == "repro_torch" else {},
        a=a, Mint=mod("core.tuner").Mint, types=mod("core.types"),
        vectors=mod("data.vectors"), IndexStore=mod("index.registry").IndexStore,
        online=mod("online"), MicroBatcher=mod("online.scheduler").MicroBatcher,
        BatchEngine=mod("serve.engine").BatchEngine,
        ColumnStore=mod("serve.columnstore").ColumnStore,
        filt=mod("filter"), attributes=mod("filter.attributes"),
        ingest=mod("ingest"), row_batch=mod("online.trace").row_batch)


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}
T = PKGS["repro_torch"]


@pytest.fixture(scope="module")
def db():
    return T.vectors.make_database(400, COLS, seed=0)


# ---- executor substrate -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_step_executor_schedule_equals_reference(seed):
    """The seeded pick order, a crash on a picked task, and what shutdown
    cancels are the reference's."""
    out = {}
    for name, P in PKGS.items():
        ex = P.a.StepExecutor(seed=seed)
        futs = [ex.submit(lambda i=i: i * i, label=f"t{i}") for i in range(9)]
        ex.run_next()
        crashed = ex.crash_next()
        ex.run_next()
        ex.run_next()
        ex.shutdown(cancel_pending=True)
        out[name] = (list(ex.ran), crashed.label,
                     [(f.state, type(f.exception()).__name__) for f in futs])
    assert out["repro_torch"] == out["repro"]
    assert len(set(out["repro_torch"][0])) == 4  # three runs and the crash


def _pool_faults(P):
    states = []
    inj = P.a.FaultInjector(crash_on=(2,))
    pool = P.a.WorkerPool(workers=1, name="t", hooks=inj)
    try:
        futs = [pool.submit(lambda i=i: 1 / (i - 3), label=f"x{i}") for i in range(6)]
        for f in futs:
            f.wait(timeout=10)
            states.append((f.state, type(f.exception()).__name__))
        states.append(pool.crashed_workers)
    finally:
        pool.shutdown()
    with pytest.raises(P.a.PoolShutdown):
        pool.submit(lambda: None)
    return states


def test_worker_crash_and_task_errors_are_isolated_as_reference():
    got = _pool_faults(T)
    assert got[-1] == 1 and ("done", "NoneType") in got
    assert got == _pool_faults(PKGS["repro"])


def test_shutdown_cancels_pending_with_pool_shutdown():
    gate, started = threading.Event(), threading.Event()
    pool = T.a.WorkerPool(workers=1, name="t")

    def blocker():
        started.set()
        assert gate.wait(timeout=30)
        return "ran"
    first = pool.submit(blocker, label="run")
    queued = [pool.submit(lambda: 1, label=f"q{i}") for i in range(3)]
    assert started.wait(timeout=10)
    pool.shutdown(wait=False, cancel_pending=True)
    gate.set()
    assert pool.join(timeout=30), "pool did not quiesce"
    assert first.result(timeout=10) == "ran"
    for f in queued:
        with pytest.raises(T.a.PoolShutdown):
            f.result(timeout=10)


def test_drive_until_returns_on_every_executor():
    from repro_torch.async_.executor import drive_until
    ex = T.a.StepExecutor(seed=0)
    inner = []
    outer = ex.submit(lambda: inner.append(ex.submit(lambda: 7, label="in")),
                      label="out")
    assert drive_until(ex, outer, timeout=5)
    assert drive_until(ex, inner[0], timeout=5) and inner[0].result() == 7
    gate = threading.Event()
    with T.a.WorkerPool(workers=1, name="t") as pool:
        slow = pool.submit(lambda: gate.wait(timeout=30), label="slow")
        assert not drive_until(pool, slow, timeout=0.05)  # times out, no hang
        gate.set()
        assert drive_until(pool, slow, timeout=10)
    serial = T.a.SerialExecutor()
    assert drive_until(serial, serial.submit(lambda: 1, label="s"), timeout=1)


def _coordinator(P):
    ex = P.a.StepExecutor(seed=0)
    coord = P.a.BuildCoordinator(ex)
    finalized = []
    b = coord.submit("k", lambda: 10,
                     finalize=lambda res, now: finalized.append((res, now)) or res,
                     label="build")
    log = [coord.inflight("k"),
           coord.submit("k", lambda: 11, finalize=lambda r, n: r) is None,
           len(coord.poll(1.0))]
    ex.run_all()
    log += [b.built, list(finalized), [x.event for x in coord.poll(2.0)],
            list(finalized), coord.inflight()]
    coord.submit("k", lambda: 1 / 0, finalize=lambda r, n: r, label="bad")
    ex.run_all()
    log += [coord.poll(), [(f.label, type(f.error).__name__) for f in coord.failures],
            coord.stats()]
    return log


def test_build_coordinator_protocol_equals_reference():
    got = _coordinator(T)
    assert got[-2] == [("bad", "ZeroDivisionError")]
    assert got == _coordinator(PKGS["repro"])


# ---- async flush == sync flush ----------------------------------------------


def _batcher_run(engine, pairs, executor=None, stage=False, max_batch=4):
    def execute(tickets, staged=None):
        return engine.search_batch([(t.query, t.plan) for t in tickets],
                                   staged=staged)
    stage_fn = None
    if stage:
        stage_fn = lambda tickets: engine.stage_batch(  # noqa: E731
            [(t.query, t.plan) for t in tickets])
    mb = T.MicroBatcher(execute, plan_for=None, max_batch=max_batch,
                        executor=executor, stage=stage_fn)
    tickets = [mb.submit(q, now=i * 1e-4, plan=p) for i, (q, p) in enumerate(pairs)]
    mb.drain(1.0)
    return [np.asarray(t.result(timeout=30)) for t in tickets]


def _kind_pairs(P, db, kind, seed=5):
    """Single-exact, rerank and flat-fallback groups for one index kind."""
    rng = np.random.default_rng(seed)
    qs = P.vectors.make_queries(db, [(0,), (0, 1), (1,), (0, 1)] * 3, k=K,
                                seed=int(rng.integers(1000)))
    pairs = []
    for i, q in enumerate(qs):
        q.qid = 10_000 + i
        if i % 3 == 2:
            plan = P.types.QueryPlan(q.qid, [], [], 1.0, 1.0)
        elif len(q.vid) > 1 and i % 3 == 1:
            plan = P.types.QueryPlan(q.qid, [P.types.IndexSpec((c,), kind) for c in q.vid],
                                     [int(rng.integers(8, 40)) for _ in q.vid], 1.0, 1.0)
        else:
            plan = P.types.QueryPlan(q.qid, [P.types.IndexSpec(q.vid, kind)],
                                     [int(rng.integers(8, 40))], 1.0, 1.0)
        pairs.append((q, plan))
    return pairs


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw", "diskann"])
def test_async_flush_bit_identical_to_sync_per_kind(db, kind):
    """Async == sync on a real WorkerPool with staging and under three
    seeded interleavings; the sync ids equal the reference engine's."""
    engine = T.BatchEngine(db, store=T.IndexStore(db, seed=0, device="cpu"))
    pairs = _kind_pairs(T, db, kind)
    ref = _batcher_run(engine, pairs)
    with T.a.WorkerPool(workers=2, name="flush") as pool:
        got_pool = _batcher_run(engine, pairs, executor=pool, stage=True)
    runs = [got_pool] + [_batcher_run(engine, pairs, executor=T.a.StepExecutor(seed=s),
                                      stage=s == 1) for s in range(3)]
    for got in runs:
        for r, a in zip(ref, got):
            np.testing.assert_array_equal(r, a)
    J = PKGS["repro"]
    jdb = J.vectors.make_database(400, COLS, seed=0)
    jeng = J.BatchEngine(jdb, store=J.IndexStore(jdb, seed=0))
    jref = jeng.search_batch(_kind_pairs(J, jdb, kind))
    for r, j in zip(ref, jref):
        np.testing.assert_array_equal(r, np.asarray(j))


def test_async_stress_more_workers_than_cores_matches_sync(db):
    """Eight workers, a short switch interval, staging on: the engine is
    shared between the submitting thread (staging) and the workers, and
    every ticket still equals the sync run."""
    engine = T.BatchEngine(db, store=T.IndexStore(db, seed=0, device="cpu"))
    pairs = _kind_pairs(T, db, "ivf", seed=9) * 3
    ref = _batcher_run(engine, pairs, max_batch=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with T.a.WorkerPool(workers=8, name="stress") as pool:
            got = _batcher_run(engine, pairs, executor=pool, stage=True, max_batch=2)
    finally:
        sys.setswitchinterval(old)
    for r, a in zip(ref, got):
        np.testing.assert_array_equal(r, a)


def _runtime_async(P, async_flush, executor=None):
    db = P.vectors.make_database(400, COLS, seed=0)
    qs = P.vectors.make_queries(db, [(0,), (0, 1), (1,)], k=K, seed=7)
    wl = P.types.Workload(queries=qs, probs=np.ones(len(qs)))
    cons = P.types.Constraints(theta_recall=0.85, theta_storage=3)
    mint = P.Mint(db, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw)
    rt = P.online.OnlineRuntime(db, mint, wl, cons, result=mint.tune(wl, cons),
                                executor=executor, **P.kw,
                                config=P.online.RuntimeConfig(
                                    max_batch=8, cooldown_s=1e9, drift_threshold=2.0,
                                    async_flush=async_flush, workers=2))
    tks = rt.run_trace(P.online.steady_trace(db, wl, n=48, qps=1000.0, seed=3))
    out = ([np.asarray(t.result(timeout=30)).tolist() for t in tks],
           [t.batch_size for t in tks], rt.stats()["batcher"])
    rt.close()
    return out


def test_runtime_async_flush_matches_sync_and_reference():
    ref = _runtime_async(PKGS["repro"], False)
    assert _runtime_async(T, False) == ref
    assert _runtime_async(T, True) == ref
    assert _runtime_async(T, True, T.a.StepExecutor(seed=2)) == \
        _runtime_async(PKGS["repro"], True, PKGS["repro"].a.StepExecutor(seed=2))


def test_ticket_future_and_worker_crash(db):
    engine = T.BatchEngine(db, store=None, device="cpu")
    ex = T.a.StepExecutor(seed=0)
    mb = T.MicroBatcher(lambda tks, staged=None: engine.search_batch(
        [(t.query, t.plan) for t in tks]), plan_for=None, max_batch=1, executor=ex)
    qs = T.vectors.make_queries(db, [(0,), (0,)], k=K, seed=11)
    qs[1].qid = qs[0].qid + 1
    plans = [T.types.QueryPlan(q.qid, [T.types.IndexSpec((0,), "flat")], [16], 1.0, 1.0)
             for q in qs]
    t1 = mb.submit(qs[0], now=0.0, plan=plans[0])
    t2 = mb.submit(qs[1], now=0.0, plan=plans[1])
    with pytest.raises(TimeoutError):
        t1.result(timeout=0.01)
    ex.crash_next(index=0)
    ex.run_all()
    with pytest.raises(T.a.WorkerCrashed):
        t1.result(timeout=1)
    np.testing.assert_array_equal(np.asarray(t2.result(timeout=1)),
                                  engine.search_batch([(qs[1], plans[1])])[0])
    done = mb.drain(1.0)
    assert t1 in done and not t1.done and t2.done


# ---- staged batches ---------------------------------------------------------------


def _filtered_engine(db):
    attrs = T.attributes.synth_attributes(db.n_rows, seed=3, device="cpu")
    engine = T.BatchEngine(db, store=T.IndexStore(db, seed=0, device="cpu"))
    engine.attach_filters(attrs)
    return engine


def _mutated_engine(db):
    table = T.ingest.MutableTable(db)
    rng = np.random.default_rng(4)
    table.apply(T.ingest.InsertBatch(T.row_batch(db, rng, 30)))
    table.apply(T.ingest.DeleteBatch(rng.choice(table.live_ids(), 25, replace=False)))
    engine = T.BatchEngine(db, store=T.IndexStore(db, seed=0, device="cpu"))
    engine.attach_mutations(T.ingest.MutationView(table, device="cpu"))
    return engine


def _staged_pairs(db, table):
    if table == "filtered":
        pairs = []
        for access in ("pre", "masked", "post"):
            for q, plan in _kind_pairs(T, db, "ivf", seed=7)[:6]:
                q.predicate = T.filt.Range("score", lo=0.2, hi=0.7)
                plan.access_path = access
                q.qid += {"pre": 0, "masked": 100, "post": 200}[access]
                plan.query_qid = q.qid
                pairs.append((q, plan))
        return pairs
    return _kind_pairs(T, db, "ivf", seed=7) + _kind_pairs(T, db, "flat", seed=8)


@pytest.mark.parametrize("table", ["plain", "filtered", "mutated"])
def test_staged_batch_equals_unstaged(db, table):
    """``stage_batch`` then ``search_batch`` / ``execute_batch`` with it
    give the unstaged ids, costs and counters; staging itself moves no
    counter and stages exactly the bytes ``pad_queries`` uploads."""
    engine = {"plain": lambda: T.BatchEngine(db, store=T.IndexStore(db, seed=0,
                                                                    device="cpu")),
              "filtered": lambda: _filtered_engine(db),
              "mutated": lambda: _mutated_engine(db)}[table]()
    pairs = _staged_pairs(db, table)
    ref = engine.search_batch(pairs)
    ref_m = engine.execute_batch(pairs)
    ref_counts = engine.counters.as_dict()
    engine.counters.reset()
    staged = engine.stage_batch(pairs)
    assert engine.counters.as_dict() == {"scan": 0, "delta": 0, "rerank": 0,
                                         "fallback": 0}
    assert staged.n == len(pairs) and staged.qmats and staged.ready is None
    for (gi, slot), qmat in staged.qmats.items():
        g = staged.groups[gi]
        vid = g.key.vid if slot in (-1, "rerank") else g.specs[slot].vid
        col = engine.cstore.device(vid)
        want = col.pad_queries(np.stack([it.query.concat(None if slot in (-1, "rerank")
                                                         else vid) for it in g.items]))
        assert qmat.dtype == want.dtype and np.array_equal(qmat.numpy(), want.numpy())
    got = engine.search_batch(pairs, staged=staged)
    got_m = engine.execute_batch(pairs, staged=engine.stage_batch(pairs))
    for r, a in zip(ref, got):
        np.testing.assert_array_equal(r, a)
    for r, a in zip(ref_m, got_m):
        np.testing.assert_array_equal(r.ids, a.ids)
        assert (r.cost, r.num_dist, r.recall) == (a.cost, a.num_dist, a.recall)
    assert engine.counters.as_dict() == ref_counts
    # a staged batch for another batch size is ignored: fresh compile
    for r, a in zip(ref[:3], engine.search_batch(pairs[:3], staged=staged)):
        np.testing.assert_array_equal(r, a)


def test_store_swap_between_stage_and_execute_recomputes(db):
    """A column store of another padded width swapped in after staging:
    execution drops the stale staged queries and pads them afresh, and the
    results equal an unstaged run on the new store."""
    store = T.IndexStore(db, seed=0, device="cpu")
    engine = T.BatchEngine(db, store=store)
    pairs = _kind_pairs(T, db, "ivf", seed=3)
    staged = engine.stage_batch(pairs)
    wide = T.ColumnStore(db, block_dim=256, device="cpu")
    engine.swap_store(store, wide)
    used = []
    orig = engine._staged_qmat

    def spy(sq, slot, col):
        out = orig(sq, slot, col)
        used.append(out is not None)
        return out
    engine._staged_qmat = spy
    got = engine.search_batch(pairs, staged=staged)
    assert used and not any(used)
    ref = T.BatchEngine(db, store=store, cstore=wide).search_batch(pairs)
    for r, a in zip(ref, got):
        np.testing.assert_array_equal(r, a)
