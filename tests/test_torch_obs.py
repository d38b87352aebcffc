"""Port parity of the observability layer (``obs/``, ``launch/obs_report``,
``launch/obs_overhead``) against the JAX package, on the fixture of
tests/test_obs.py (400 rows, 2 columns, k = 8).

The same calls on both packages' metrics registry, histograms, spans and
timeline give equal counters, buckets, quantiles and JSON (times are left
out: span and event stamps come from the clock). Through the serving stack
the same trace gives equal ids, equal per-ticket stage sets and equal
non-time counters; with the observer off the port's results are
bit-identical to a run with it on and the NULL seam holds no state.
Every comparison is exact.
"""
import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

K = 8
COLS = [("a", 24), ("b", 32)]
STAGES = {"enqueue", "semcache_probe", "flush_wait", "dispatch", "merge"}


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, kw={"device": "cpu"} if name == "repro_torch" else {},
        obs=mod("obs"), a=mod("async_"), Mint=mod("core.tuner").Mint,
        types=mod("core.types"), vectors=mod("data.vectors"),
        IndexStore=mod("index.registry").IndexStore, online=mod("online"),
        BatchEngine=mod("serve.engine").BatchEngine, report=mod("launch.obs_report"))


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}
T = PKGS["repro_torch"]


# ---- primitives: the same calls give the same state ----------------------------


def _hist(P):
    h = P.obs.Histogram(lo=1.0, growth=2.0, n_buckets=8)
    for v in h.bounds + [0.01, 1e9]:
        h.observe(v)
    a, b = P.obs.Histogram(), P.obs.Histogram()
    vals = np.linspace(0.5, 400.0, 200)
    for v in vals[:100]:
        a.observe(float(v))
    for v in vals[100:]:
        b.observe(float(v))
    a.merge(b)
    d = json.loads(json.dumps(a.data()))
    return (h.bounds, h.counts, h.overflow, [h.quantile(q) for q in (0.125, 0.5, 1.0)],
            a.counts, [a.quantile(q) for q in (0.5, 0.95, 0.99)], a.mean,
            P.obs.hist_quantile(d, 0.99), P.obs.hist_summary(d))


def _registry(P):
    reg = P.obs.MetricsRegistry()
    reg.counter("hits", tenant="a")
    reg.counter("hits", value=2, tenant="a")
    reg.counter("hits", tenant="b")
    reg.gauge("depth", 3.5)
    reg.observe("wait_ms", 12.0, tenant="a")
    reg.observe("wait_ms", 3.0, tenant="a")
    snap = reg.snapshot()
    return snap.to_jsonl(), snap.to_prometheus(), snap.as_dict()


def _overflow(P):
    reg = P.obs.MetricsRegistry(max_series_per_name=3)
    for i in range(10):
        reg.counter("q", qid=i)
    reg.counter("ok", tenant="t")
    snap = reg.snapshot()
    return snap.as_dict(), snap.dropped_labelsets


def _diff_merge(P):
    reg = P.obs.MetricsRegistry()
    reg.counter("c", tenant="a")
    reg.observe("h", 1.0)
    s0 = reg.snapshot()
    reg.counter("c", value=4, tenant="a")
    reg.gauge("g", 9.0)
    for v in (2.0, 8.0):
        reg.observe("h", v)
    s1 = reg.snapshot()
    reg.reset()
    reg.counter("c", value=3, tenant="a")
    s2 = reg.snapshot()
    return (s1.diff(s0).as_dict(), s0.merge(s1.diff(s0)).as_dict(),
            sorted(s1.diff(s1).series), s2.diff(s1).as_dict())


def _timeline(P):
    tl = P.obs.Timeline(capacity=4)
    for i in range(6):
        tl.record("swap" if i % 2 else "evict", t=float(i), gen=i)
    obs = P.obs.Observer()
    obs.event("retune_swap", generation=3)
    obs.event("retune_swap", generation=4)
    return ([e.as_dict() for e in tl.window()], [e.t for e in tl.window(t0=3.0, t1=4.5)],
            tl.kinds(), obs.timeline.kinds(), obs.metrics.snapshot().as_dict())


def _spans(P):
    obs = P.obs.Observer()
    tr = obs.begin_trace("ticket", t0=0.0, qid=1)
    with obs.span("outer", parent=tr.root) as outer:
        with obs.span("inner", depth=2):
            pass
        obs.span_at("retro", 1.0, 2.0, parent=obs.current(), batch=4)
    obs.span_at("merge", 2.0, 3.0, parent=tr.root)
    obs.end_trace(tr, t=3.0)

    def shape(sp):
        return (sp.name, sorted(sp.attrs.items()), [shape(c) for c in sp.children])
    null = P.obs.NULL_OBSERVER
    with null.span("x") as sp:
        sp.annotate(a=1).end()
    null.counter("c")
    return (shape(tr.root), sorted(tr.stage_names()), outer.t1 is not None,
            null.enabled, null.traces, null.span_at("y", 0.0, 1.0).duration_ms,
            [(s.name, s.duration_ms) for s in tr.stages() if s.name == "merge"])


SCENARIOS = {f.__name__.strip("_"): f for f in
             (_hist, _registry, _overflow, _diff_merge, _timeline, _spans)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_obs_primitives_equal_reference(name):
    got = SCENARIOS[name](T)
    assert got == SCENARIOS[name](PKGS["repro"])


def test_registry_has_no_lost_updates_under_the_ports_pool():
    reg = T.obs.MetricsRegistry()
    n_tasks, per_task = 16, 300

    def work(i):
        for j in range(per_task):
            reg.counter("c", tenant="shared")
            reg.observe("h", float(j % 7), tenant="shared")
    with T.a.WorkerPool(workers=4, name="obs-t") as pool:
        for f in [pool.submit(work, i, label=f"w:{i}") for i in range(n_tasks)]:
            f.result(timeout=30)
    snap = reg.snapshot()
    assert snap.get("c", tenant="shared")["value"] == n_tasks * per_task
    assert snap.get("h", tenant="shared")["data"]["count"] == n_tasks * per_task


def test_span_stacks_are_per_thread():
    obs = T.obs.Observer()
    seen = []
    with obs.span("main-only"):
        t = threading.Thread(target=lambda: seen.append(obs.current()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None]


# ---- through the serving stack ---------------------------------------------------


def _setup(P):
    db = P.vectors.make_database(400, COLS, seed=0)
    qs = P.vectors.make_queries(db, [(0,), (0, 1), (1,)], k=K, seed=7)
    wl = P.types.Workload(queries=qs, probs=np.ones(len(qs)))
    cons = P.types.Constraints(theta_recall=0.85, theta_storage=3)
    mint = P.Mint(db, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw)
    trace = P.online.hot_item_trace(db, vid=(0,), n=48, qps=2000.0, n_hot=3,
                                    p_hot=0.8, k=K, seed=7, noise=0.1,
                                    qid_start=90_000)
    return SimpleNamespace(db=db, wl=wl, cons=cons, mint=mint,
                           tuned=mint.tune(wl, cons), trace=trace)


@pytest.fixture(scope="module")
def twins():
    return {name: _setup(P) for name, P in PKGS.items()}


def _served(P, s, observe, seed=None):
    executor = None if seed is None else P.a.StepExecutor(seed=seed)
    rt = P.online.OnlineRuntime(
        s.db, s.mint, s.wl, s.cons, result=s.tuned, executor=executor,
        store=P.IndexStore(s.db, seed=0, **P.kw), **P.kw,
        config=P.online.RuntimeConfig(max_batch=4, max_delay_ms=5.0, cooldown_s=1e9,
                                      drift_threshold=2.0, semcache=True,
                                      semcache_epsilon=0.1, observe=observe,
                                      async_flush=seed is not None))
    tickets = rt.run_trace(s.trace)
    ids = [np.asarray(t.result(timeout=30)).tolist() for t in tickets]
    obs = rt.observer
    out = dict(ids=ids, obs=obs)
    if observe:
        snap = obs.metrics.snapshot()
        out["shapes"] = [(sorted(tr.stage_names()),
                          tr.find("dispatch").attrs.get("batch")
                          if tr.find("dispatch") else None) for tr in obs.traces]
        out["counters"] = {k: v["value"] for k, v in snap.series.items()
                           if v["kind"] == T.obs.COUNTER}
        out["hcounts"] = {k: v["data"]["count"] for k, v in snap.series.items()
                          if v["kind"] == T.obs.HISTOGRAM}
        rep = P.report.report(obs)
        out["report"] = (rep["n_traces"], sorted(rep["breakdown"]["stages"]),
                         {k: v["count"] for k, v in rep["breakdown"]["stages"].items()},
                         rep["hbm"], rep["timeline_kinds"])
        out["coverage"] = [tr.coverage() for tr in obs.traces
                           if STAGES <= tr.stage_names()]
    rt.close()
    return out


@pytest.mark.parametrize("seed", [None, 3])
def test_observed_serving_equals_reference(twins, seed):
    """Sync and StepExecutor-driven async flush with the observer on: equal
    ids, per-ticket stage sets and batch sizes, counters, histogram counts,
    modeled HBM bytes and report rows; complete ticket trees cover their
    end-to-end time."""
    ref = _served(PKGS["repro"], twins["repro"], True, seed)
    got = _served(T, twins["repro_torch"], True, seed)
    for key in ("ids", "shapes", "counters", "hcounts", "report"):
        assert got[key] == ref[key], key
    assert got["coverage"] and all(0.9 <= c <= 1.1 for c in got["coverage"])
    assert set(got["report"][1]) == STAGES


def test_observer_off_is_bit_identical_and_inert(twins):
    s = twins["repro_torch"]
    off = _served(T, s, False)
    on = _served(T, s, True)
    assert off["ids"] == on["ids"]
    obs = off["obs"]
    assert obs is T.obs.NULL_OBSERVER and not obs.traces
    assert obs.metrics is None and obs.timeline is None
    assert on["obs"].traces


def test_engine_with_observer_is_bit_identical(twins):
    """A ``BatchEngine`` with an enabled observer returns the ids of one
    without; its plan-group spans carry modeled bytes."""
    s = twins["repro_torch"]
    pairs = [(q, s.tuned.plans[q.qid]) for q, _ in s.wl]
    store = T.IndexStore(s.db, seed=0, device="cpu")
    plain = T.BatchEngine(s.db, store=store)
    obs = T.obs.Observer()
    watched = T.BatchEngine(s.db, store=store, observer=obs)
    with obs.span("dispatch") as dsp:
        got = watched.search_batch(pairs)
    for a, b in zip(plain.search_batch(pairs), got):
        np.testing.assert_array_equal(a, b)
    groups = [c for c in dsp.children if c.name == "plan_group"]
    assert groups and all(g.attrs["hbm_bytes_modeled"] > 0 for g in groups)
    assert dsp.attrs["hbm_bytes_modeled"] == pytest.approx(
        sum(g.attrs["hbm_bytes_modeled"] for g in groups))


def test_obs_overhead_run_is_bit_identical_off_and_on():
    """The gate script's scenario on the CPU: observer off and on give the
    same ids, and the off run leaves no observer state (its latency gate
    is for the card, where the script runs whole)."""
    from repro_torch.launch import obs_overhead
    args = obs_overhead.build("cpu")
    off = obs_overhead.run_once(*args, False, "cpu")
    on = obs_overhead.run_once(*args, True, "cpu")
    for a, b in zip(off[0], on[0]):
        np.testing.assert_array_equal(a, b)
    assert off[3] is T.obs.NULL_OBSERVER and on[3].traces
