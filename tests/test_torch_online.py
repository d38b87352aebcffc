"""Port parity of the online runtime (``online/``: traces, monitor, plan
cache, micro-batcher, retuner, ``OnlineRuntime``) against the JAX package,
on the fixture of tests/test_online.py (1,500 rows, 4 columns, k = 10).

The same seeded trace goes through the reference's ``OnlineRuntime`` and the
port's, in ``sync`` mode and in ``pool`` mode with async flush, both driven
by a ``StepExecutor`` of the same seed. Ticket ids, batcher stats, plan-cache
stats and retune events (generation, configuration, built / dropped) must be
equal. IVF builds agree on the CPU at this size (both packages' Lloyd
iterations give the same lists), so no index state is carried over. Traces
drawn from the same seed must be equal event for event. Every comparison is
exact; times (wall clocks, tune seconds) are left out.
"""
import importlib
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

K = 10
COLS = [("a", 24), ("b", 32), ("c", 28), ("d", 20)]
DAY_VIDS = [(0,), (0, 1), (1,)]
NIGHT_VIDS = [(2,), (2, 3), (3,)]


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    online = mod("online")
    return SimpleNamespace(
        name=name, kw={"device": "cpu"} if name == "repro_torch" else {},
        Mint=mod("core.tuner").Mint, execute_plan=mod("core.tuner").execute_plan,
        types=mod("core.types"), vectors=mod("data.vectors"),
        synth_attributes=mod("filter.attributes").synth_attributes,
        IndexStore=mod("index.registry").IndexStore, online=online,
        trace=mod("online.trace"), scheduler=mod("online.scheduler"),
        StepExecutor=mod("async_").StepExecutor,
        dryrun=mod("launch.online_dryrun"), shim=mod("search.engine"))


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}


def _setup(P, kind="ivf"):
    db = P.vectors.make_database(1500, COLS, seed=0)

    def wl(vids, seed):
        qs = P.vectors.make_queries(db, vids, k=K, seed=seed)
        return P.types.Workload(queries=qs, probs=np.ones(len(qs)))
    mint = P.Mint(db, index_kind=kind, seed=0, min_sample_rows=400, **P.kw)
    cons = P.types.Constraints(theta_recall=0.85, theta_storage=3)
    day = wl(DAY_VIDS, 0)
    return SimpleNamespace(db=db, mint=mint, cons=cons, day=day,
                           night=wl(NIGHT_VIDS, 1), tuned=mint.tune(day, cons))


@pytest.fixture(scope="module")
def twins():
    return {name: _setup(P) for name, P in PKGS.items()}


# ---- traces -----------------------------------------------------------------


def _events(trace):
    out = []
    for ev in trace:
        if hasattr(ev, "query"):
            q = ev.query
            out.append(("q", ev.t, str(ev.tenant), q.qid, q.vid, q.k,
                        repr(q.predicate), q.concat().tobytes()))
        else:
            out.append(("m", ev.t, ev.kind, ev.count, ev.seed, str(ev.tenant),
                        None if ev.vectors is None
                        else [np.asarray(v).tobytes() for v in ev.vectors]))
    return out


TRACES = {
    "steady": lambda P, s: P.trace.steady_trace(s.db, s.day, n=40, qps=500.0, seed=3),
    "diurnal": lambda P, s: P.trace.diurnal_trace(s.db, s.day, s.night, n=40, seed=4,
                                                  t0=1.0, qid_start=10_000),
    "burst": lambda P, s: P.trace.burst_trace(s.db, s.day, (2, 3), n=40, seed=5),
    "hot_item": lambda P, s: P.trace.hot_item_trace(s.db, (0, 1), n=40, n_hot=3,
                                                    k=K, seed=6, noise=0.1),
    "tenant_skew": lambda P, s: P.trace.tenant_skew_trace(
        s.db, {"A": s.day, "B": s.night}, n=40, noisy="A", seed=7),
    "churn": lambda P, s: P.trace.churn_trace(s.db, s.day, n=30, mutation_rate=0.3,
                                              batch=4, mix=(0.5, 0.3, 0.2),
                                              query_drift=0.5, insert_source=s.db,
                                              seed=8),
    "filtered": lambda P, s: P.trace.filtered_trace(
        s.db, s.day, P.synth_attributes(s.db.n_rows, seed=3), n=40, seed=9),
    "make_trace": lambda P, s: P.trace.make_trace(s.db, "steady", workload=s.night,
                                                  n=20, seed=10),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_equal_reference(twins, name):
    ref = _events(TRACES[name](PKGS["repro"], twins["repro"]))
    got = _events(TRACES[name](PKGS["repro_torch"], twins["repro_torch"]))
    assert len(got) == len(ref) > 0
    assert got == ref


# ---- monitor, drift, plan cache, batcher ---------------------------------


def _monitor_run(P, s):
    mon = P.online.WorkloadMonitor(window=16)
    det = P.online.DriftDetector(P.online.reference_histogram(s.day),
                                 threshold=0.35, min_window=8)
    reports = []
    for tq in P.trace.diurnal_trace(s.db, s.day, s.night, n=48, seed=2):
        mon.observe(tq.query)
        r = det.check(mon)
        reports.append((r.drifted, r.drift))
    observed = mon.observed_workload(reps_per_vid=2)
    return (reports, sorted(mon.histogram().items()), mon.column_usage(),
            [(q.vid, p, q.concat().tobytes()) for q, p in observed])


def test_monitor_and_drift_detector_equal_reference(twins):
    ref = _monitor_run(PKGS["repro"], twins["repro"])
    got = _monitor_run(PKGS["repro_torch"], twins["repro_torch"])
    assert any(d for d, _ in got[0]) and got == ref


def _plan_cache_run(P, s):
    cache = P.online.PlanCache(capacity=3)
    cache.seed(s.day, s.tuned)
    log = []
    for i, q in enumerate(P.vectors.make_queries(s.db, DAY_VIDS + NIGHT_VIDS, k=K,
                                                 seed=9)):
        hit = cache.get(q)
        log.append(None if hit is None else ([x.name for x in hit.indexes], hit.eks))
        if hit is None:
            cache.put(q, P.types.QueryPlan(q.qid, [], [], 1.0, 1.0))
        if i == 3:
            cache.bump_generation()
    return log, cache.stats()


def test_plan_cache_equal_reference(twins):
    ref = _plan_cache_run(PKGS["repro"], twins["repro"])
    assert _plan_cache_run(PKGS["repro_torch"], twins["repro_torch"]) == ref


def _drr_run(P, s):
    order = []

    def execute(tickets):
        order.append([(str(t.tenant), t.query.qid) for t in tickets])
        return [np.zeros(1, np.int64)] * len(tickets)
    mb = P.scheduler.MicroBatcher(execute, plan_for=lambda q: None, max_batch=4,
                                  max_delay_ms=1.0, quantum=1, auto_flush=False)
    qs = P.vectors.make_queries(s.db, [(0,)] * 12, k=K, seed=11)
    for i, q in enumerate(qs):
        q.qid = i
        mb.submit(q, now=i * 1e-4, tenant="noisy" if i < 9 else "light")
    for step in range(4):
        mb.poll(now=0.01 + step * 0.01)
    mb.drain(1.0)
    return order, mb.stats.as_dict()


def test_micro_batcher_drr_flush_order_equal_reference(twins):
    ref = _drr_run(PKGS["repro"], twins["repro"])
    got = _drr_run(PKGS["repro_torch"], twins["repro_torch"])
    assert any(tn == "light" for tn, _ in got[0][0] + got[0][1])
    assert got == ref


def test_online_dryrun_schedule_equal_reference():
    out = {}
    for name, P in PKGS.items():
        stream = P.dryrun.synthetic_stream(96, 2000.0, seed=1)
        out[name] = [P.dryrun.run_schedule(stream, 16, d) for d in (0.5, 5.0)]
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][1]["dispatch_reduction"] > 1.0


def test_search_engine_shim_equals_reference(twins):
    res = {}
    for name, P in PKGS.items():
        s = twins[name]
        q = s.day.queries[1]
        plan = P.types.QueryPlan(q.qid, [P.types.IndexSpec((0,), "flat"),
                                         P.types.IndexSpec((1,), "flat")],
                                 [40, 40], 1.0, 1.0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ids, cost = P.shim.execute_plan_fused(s.db, q, plan, **P.kw)
        assert any(issubclass(w.category, DeprecationWarning) for w in caught)
        res[name] = (np.asarray(ids).tolist(), cost)
    assert res["repro_torch"] == res["repro"]


# ---- the runtime, sync and pool -------------------------------------------


def _runtime_run(P, s, mode, seed=None):
    """Day traffic, then a drift to night traffic: equal tickets, stats and
    retune events are the parity contract."""
    kw = dict(max_batch=4, max_delay_ms=5.0, window=32, min_window=16,
              drift_threshold=0.35, cooldown_s=0.01, retune_mode=mode)
    executor = None
    if mode == "pool":
        kw.update(async_flush=True)
        executor = P.StepExecutor(seed=seed)
    rt = P.online.OnlineRuntime(s.db, s.mint, s.day, s.cons, result=s.tuned,
                                store=P.IndexStore(s.db, seed=0, **P.kw),
                                config=P.online.RuntimeConfig(**kw),
                                executor=executor, **P.kw)
    tickets = rt.run_trace(P.trace.steady_trace(s.db, s.day, n=12, qps=1000.0, seed=3))
    tickets += rt.run_trace(P.trace.steady_trace(s.db, s.night, n=48, qps=1000.0,
                                                 seed=4, t0=1.0, qid_start=10_000))
    st = rt.stats()
    events = [(e.t, e.drift, e.generation, e.window, e.est_cost_before,
               e.est_cost_after, e.config_before, e.config_after, e.built, e.dropped)
              for e in rt.retune_events]
    out = dict(ids=[np.asarray(t.result(timeout=30)).tolist() for t in tickets],
               batch_sizes=[t.batch_size for t in tickets],
               batcher=st["batcher"], plan_cache=st["plan_cache"],
               dispatches=st["dispatches"], generation=st["generation"],
               events=events,
               config=sorted(x.name for x in rt.result.configuration),
               store=sorted(x.name for x in rt.store.built_specs()))
    rt.close()
    return out


@pytest.mark.parametrize("mode,seed", [("sync", None), ("pool", 0), ("pool", 1)])
def test_runtime_equals_reference(twins, mode, seed):
    ref = _runtime_run(PKGS["repro"], twins["repro"], mode, seed)
    got = _runtime_run(PKGS["repro_torch"], twins["repro_torch"], mode, seed)
    assert got["events"] and got["generation"] >= 1
    assert got == ref


def test_pool_retune_runs_while_serving_and_matches_sync(twins):
    """On a real WorkerPool the retune's tune + shadow build run on a worker
    thread while the submitting thread serves; every ticket equals the
    per-query execution of its own plan, and one generation swap lands."""
    P, s = PKGS["repro_torch"], twins["repro_torch"]
    rt = P.online.OnlineRuntime(
        s.db, s.mint, s.day, s.cons, result=s.tuned, device="cpu",
        store=P.IndexStore(s.db, seed=0, device="cpu"),
        config=P.online.RuntimeConfig(max_batch=4, window=32, min_window=16,
                                      drift_threshold=0.35, cooldown_s=1e9,
                                      retune_mode="pool", async_flush=True,
                                      workers=2))
    tickets = rt.run_trace(P.trace.steady_trace(s.db, s.night, n=48, qps=1000.0,
                                                seed=4, qid_start=10_000))
    assert len(rt.retune_events) == 1 and not rt.retuner.builds.failures
    for t in tickets[-8:]:
        ref = P.execute_plan(s.db, rt.store, t.query, t.plan)
        np.testing.assert_array_equal(np.asarray(t.result(timeout=30)), ref.ids)
    rt.close()


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_batches_bit_identical_to_execute_plan(twins, seed):
    """Randomized streams (vid mixes, lengths, batch caps) through the
    port's scheduler equal per-query ``execute_plan``."""
    P, s = PKGS["repro_torch"], twins["repro_torch"]
    rt = P.online.OnlineRuntime(s.db, s.mint, s.day, s.cons, result=s.tuned,
                                device="cpu",
                                store=P.IndexStore(s.db, seed=0, device="cpu"),
                                config=P.online.RuntimeConfig(drift_threshold=2.0))
    all_vids = DAY_VIDS + NIGHT_VIDS + [(0, 2), (1, 3), (0, 1, 2, 3)]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 13))
    rt.batcher.max_batch = int(rng.integers(1, 6))
    vids = [all_vids[i] for i in rng.integers(0, len(all_vids), size=n)]
    tickets = []
    for i, q in enumerate(P.vectors.make_queries(s.db, vids, k=K, seed=seed)):
        q.qid = 100_000 + seed * 100 + i
        tickets.append(rt.submit(q, now=i * 1e-4))
        rt.tick(now=i * 1e-4)
    rt.drain(now=1.0)
    for t in tickets:
        ref = P.execute_plan(s.db, rt.store, t.query, t.plan)
        np.testing.assert_array_equal(np.asarray(t.ids), np.asarray(ref.ids))
