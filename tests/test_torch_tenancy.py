"""Port parity of multi-tenant serving (``tenancy/``: the device-memory
governor, governed and namespaced stores, ``MultiTenantRuntime``) against
the JAX package, on the fixtures of tests/test_tenancy.py (1,100 and 900
rows, k = 10).

The same seeded inputs go through both packages. The governor's ``stats()``
and ``resident()`` (keys, bytes, LRU order) must be equal after the same
sequence of calls; multi-tenant tickets (ids, per-ticket cost, numDist and
recall), each tenant's ``DispatchCounters`` and the governor's counters must
equal the reference's, and each tenant's ids must equal its isolated
single-tenant run in the port. Governed delta segments and semantic caches
charge the same keys and bytes as the reference's. IVF builds agree
between the packages on the CPU at these sizes, so nothing is carried.
"""
import importlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

K = 10


def _pkg(name):
    def mod(m):
        return importlib.import_module(f"{name}.{m}")
    return SimpleNamespace(
        name=name, kw={"device": "cpu"} if name == "repro_torch" else {},
        tuner=mod("core.tuner"), types=mod("core.types"), vectors=mod("data.vectors"),
        online=mod("online"), plancache=mod("online.plancache"),
        scheduler=mod("online.scheduler"), semcache=mod("online.semcache"),
        cs=mod("serve.columnstore"), tenancy=mod("tenancy"), ingest=mod("ingest"),
        trace=mod("online.trace"))


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}


def _both(fn, *args):
    return {name: fn(P, *args) for name, P in PKGS.items()}


def _wl(P, db, vids, seed):
    qs = P.vectors.make_queries(db, vids, k=K, seed=seed)
    return P.types.Workload(queries=qs, probs=np.ones(len(qs)))


def _setup(P):
    mk = P.vectors.make_database
    db_a = mk(1100, [("a", 24), ("b", 32), ("c", 28)], seed=0)
    db_b = mk(900, [("x", 16), ("y", 24)], seed=7)
    wl_a, wl_b = _wl(P, db_a, [(0,), (1,), (0, 2)], 0), _wl(P, db_b, [(0, 1)], 1)
    mint_a = P.tuner.Mint(db_a, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw)
    mint_b = P.tuner.Mint(db_b, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw)
    cons_a = P.types.Constraints(theta_recall=0.85, theta_storage=4)
    cons_b = P.types.Constraints(theta_recall=0.85, theta_storage=2)
    return SimpleNamespace(db_a=db_a, db_b=db_b, wl_a=wl_a, wl_b=wl_b, mint_a=mint_a,
                           mint_b=mint_b, cons_a=cons_a, cons_b=cons_b,
                           tuned_a=mint_a.tune(wl_a, cons_a),
                           tuned_b=mint_b.tune(wl_b, cons_b))


@pytest.fixture(scope="module")
def twins():
    return {name: _setup(P) for name, P in PKGS.items()}


def _tenants(P, s, **quota):
    Tenant = P.tenancy.Tenant
    return [Tenant("a", s.db_a, s.mint_a, s.wl_a, s.cons_a, result=s.tuned_a,
                   quota_bytes=quota.get("a")),
            Tenant("b", s.db_b, s.mint_b, s.wl_b, s.cons_b, result=s.tuned_b,
                   quota_bytes=quota.get("b"))]


def _plans(result):
    return (sorted(x.name for x in result.configuration),
            {qid: p.describe() for qid, p in sorted(result.plans.items())})


def test_tenants_tune_to_the_reference_configurations(twins):
    for key in ("tuned_a", "tuned_b"):
        assert _plans(getattr(twins["repro_torch"], key)) == \
            _plans(getattr(twins["repro"], key))


# ---- column-store device-byte accounting ---------------------------------------


@pytest.mark.parametrize("vid", [(0,), (1, 2), (0, 1, 2)])
def test_padded_device_bytes_equal_materialized_and_reference(twins, vid):
    out = {}
    for name, P in PKGS.items():
        cs = P.cs.ColumnStore(twins[name].db_a, **P.kw)
        pre = cs.device_bytes(vid)
        col = cs.device(vid)
        assert col.device_bytes == pre >= col.n_rows * col.dim * 4
        out[name] = (pre, np.asarray(col.data.cpu() if name == "repro_torch" else col.data))
    assert out["repro_torch"][0] == out["repro"][0]
    np.testing.assert_array_equal(out["repro_torch"][1], out["repro"][1])
    P = PKGS["repro_torch"]
    assert P.cs.padded_device_bytes(100, 10) == 128 * 128 * 4
    assert P.cs.padded_device_bytes(129, 10) == 256 * 128 * 4


def test_evicted_column_comes_back_bit_identical(twins):
    P = PKGS["repro_torch"]
    cs = P.cs.ColumnStore(twins["repro_torch"].db_a, block_rows=64, block_dim=32,
                          device="cpu")
    before = cs.device((0, 1)).data.clone()
    assert cs.resident() == [(0, 1)]
    assert cs.evict_device((0, 1)) and not cs.evict_device((0, 1))
    assert cs.resident() == [] and cs.total_device_bytes() == 0
    assert torch.equal(cs.device((0, 1)).data, before)


# ---- the governor: the same call sequence, the same state ----------------------


class _Recorder:
    """A delta-segment / semantic-cache stand-in: records the governor's
    eviction callbacks."""

    def __init__(self):
        self.evicted = []

    def evict_device(self, vid):
        self.evicted.append(tuple(vid))
        return True


def _tiny_stores(P, budget, quotas=(None, None)):
    gov = P.tenancy.MemoryGovernor(budget)
    stores = P.tenancy.TenantColumnStores(gov)
    for name, quota, seed in zip(("a", "b"), quotas, (1, 2)):
        db = P.vectors.make_database(20, [("u", 4), ("v", 6)], seed=seed)
        stores.register(name, db, quota_bytes=quota, block_rows=8, block_dim=8, **P.kw)
    return gov, stores


def _governor_script(P, name):
    col = P.cs.padded_device_bytes(20, 4, block_rows=8, block_dim=8)
    log = []

    def snap(gov, stores):
        log.append((gov.stats(), gov.resident(),
                    {t: stores.get(t).resident() for t in stores.tenants()}))
    if name == "lru_budget":
        gov, st = _tiny_stores(P, 2 * col)
        for t, vid in (("a", (0,)), ("b", (0,)), ("a", (0,)), ("b", (1,)), ("a", (0, 1)),
                       ("b", (0,))):
            st.get(t).device(vid)
            snap(gov, st)
    elif name == "quota_own_first":
        gov, st = _tiny_stores(P, 10 * col, quotas=(col, None))
        for t, vid in (("b", (0,)), ("a", (0,)), ("a", (1,)), ("b", (1,)), ("a", (0,))):
            st.get(t).device(vid)
            snap(gov, st)
    elif name == "overcommit":
        gov = P.tenancy.MemoryGovernor(budget_bytes=100)
        st = P.tenancy.TenantColumnStores(gov)
        db = P.vectors.make_database(40, [("u", 4)], seed=3)
        st.register("a", db, block_rows=8, block_dim=8, **P.kw).device((0,))
        snap(gov, st)
    else:  # mixed keys: columns, ("delta",) + vid and ("semcache", ns), a rebind
        gov, st = _tiny_stores(P, 6 * col, quotas=(3 * col, None))
        recs = {t: (_Recorder(), _Recorder()) for t in ("a", "b")}
        for t, (delta, sem) in recs.items():
            gov.register_delta(t, delta)
            gov.register_semcache(t, sem)
        st.get("a").device((0,))
        gov.acquire("a", ("delta", 0), col)
        gov.acquire("a", ("semcache", 0), 2 * col)
        snap(gov, st)
        st.get("b").device((0, 1))
        gov.touch("a", ("delta", 0))
        gov.acquire("b", ("semcache", 1), col)
        snap(gov, st)
        gov.acquire("a", ("delta", 1), col)  # over a's quota: a's LRU goes first
        snap(gov, st)
        gov.acquire("b", ("delta", 0), 2 * col)  # over the budget: anyone's LRU
        snap(gov, st)
        gov.release("b", ("semcache", 1))
        st.get("a").evict_device((0,))
        snap(gov, st)
        db = P.vectors.make_database(20, [("u", 4), ("v", 6)], seed=5)
        st.replace("b", db, block_rows=8, block_dim=8, **P.kw)
        st.get("b").device((1,))
        snap(gov, st)
        log.append({t: (r[0].evicted, r[1].evicted) for t, r in recs.items()})
    return log


@pytest.mark.parametrize("name", ["lru_budget", "quota_own_first", "overcommit",
                                  "mixed_keys"])
def test_governor_state_equals_reference_after_the_same_calls(name):
    out = _both(_governor_script, name)
    assert out["repro_torch"] == out["repro"]
    final = out["repro_torch"][-2 if name == "mixed_keys" else -1][0]
    if name == "overcommit":
        assert final["overcommits"] >= 1 and final["total_bytes"] > final["budget_bytes"]
    else:
        assert final["evictions"] >= 1 and final["peak_bytes"] <= final["budget_bytes"]


def test_governed_spill_frees_the_store_and_comes_back_bit_identical():
    P = PKGS["repro_torch"]
    col = P.cs.padded_device_bytes(20, 4, block_rows=8, block_dim=8)
    gov, st = _tiny_stores(P, 2 * col)
    sa, sb = st.get("a"), st.get("b")
    before = sa.device((0,)).data.clone()
    sb.device((0,))
    sb.device((1,))  # the budget evicts a's (0,): the store drops its tensor
    assert sa.resident() == [] and sa.total_device_bytes() == 0
    assert gov.tenant_bytes("a") == 0 and gov.evictions == 1
    assert torch.equal(sa.device((0,)).data, before)
    assert gov.tenant_bytes("a") == col


# ---- scheduler fairness -------------------------------------------------------


def _mkq(P, db, qid):
    q = P.vectors.make_queries(db, [(0,)], k=K, seed=qid)[0]
    q.qid = qid
    return q


def _drr_run(P, db, name, fair):
    orders = []

    def execute(tickets):
        orders.append([(t.tenant, t.query.qid) for t in tickets])
        return [np.asarray([0])] * len(tickets)
    mb = P.scheduler.MicroBatcher(
        execute, lambda q: P.types.QueryPlan(q.qid, [], [], 0.0, 1.0), max_batch=4,
        max_delay_ms=1e9, fair=fair, auto_flush=False)
    if name == "backlog":
        for i in range(12):
            mb.submit(_mkq(P, db, i), now=0.0, tenant="noisy")
        for qid in (100, 101):
            mb.submit(_mkq(P, db, qid), now=0.001, tenant="victim")
    elif name == "large_quantum":
        mb.quantum = mb.max_batch
        for i in range(16):
            mb.submit(_mkq(P, db, i), now=0.0, tenant="a" if i < 8 else "b")
    else:
        for i in range(8):
            mb.submit(_mkq(P, db, i), now=0.0, tenant="only")
    for step in range(4):
        mb.poll(now=0.001 * (step + 2))
    mb.drain(now=0.01)
    return orders, mb.stats.as_dict()


@pytest.mark.parametrize("name,fair", [("backlog", True), ("backlog", False),
                                       ("large_quantum", True), ("single_tenant", True)])
def test_drr_and_fifo_flush_orders_equal_reference(twins, name, fair):
    out = {n: _drr_run(P, twins[n].db_a, name, fair) for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    first = out["repro_torch"][0][0]
    if name == "backlog":  # DRR serves the victims in the first batch; FIFO does not
        assert (("victim", 100) in first) == fair
    if name == "large_quantum":
        assert [o[0][0] for o in out["repro_torch"][0][:4]] == ["a", "b", "a", "b"]


def _skew_events(P, s):
    trace = P.trace.tenant_skew_trace(s.db_a, {"a": s.wl_a, "b": s.wl_b}, n=48,
                                      qps=400.0, noisy="b", noisy_mult=5.0, seed=9,
                                      dbs={"b": s.db_b})
    return [(tq.t, tq.tenant, tq.query.qid, tq.query.vid, tq.query.concat().tobytes())
            for tq in trace]


def test_tenant_skew_trace_equals_reference(twins):
    out = {n: _skew_events(P, twins[n]) for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    tenants = [e[1] for e in out["repro_torch"]]
    assert tenants.count("b") > tenants.count("a") > 0


# ---- the runtime: tickets, counters, governor ---------------------------------


def _trace(P, s):
    return P.trace.tenant_skew_trace(s.db_a, {"a": s.wl_a, "b": s.wl_b}, n=48, qps=400.0,
                                     noisy="b", noisy_mult=5.0, seed=9, dbs={"b": s.db_b})


def _tickets_out(tickets):
    return dict(ids=[np.asarray(t.ids).tolist() for t in tickets],
                tenants=[t.tenant for t in tickets],
                batch_sizes=[t.batch_size for t in tickets],
                hits=[t.cache_hit for t in tickets],
                metrics=[None if t.metrics is None else
                         (t.metrics.cost, t.metrics.num_dist, t.metrics.recall)
                         for t in tickets])


def _multitenant_run(P, s, budget, measure):
    if budget == "tight":  # below both tenants' working set: evictions mid-trace
        budget = P.cs.ColumnStore(s.db_a, **P.kw).device_bytes((0, 1, 2))
    else:
        budget = 50_000_000
    mt = P.tenancy.MultiTenantRuntime(
        _tenants(P, s), budget_bytes=budget,
        config=P.online.RuntimeConfig(max_batch=6, max_delay_ms=5.0, measure=measure),
        **P.kw)
    tickets = mt.run_trace(_trace(P, s))
    st = mt.stats()
    out = _tickets_out(tickets)
    out.update(governor=st["governor"], resident=mt.governor.resident(),
               batcher=st["batcher"], plan_cache=st["plan_cache"],
               tenants={t: {k: v[k] for k in ("generation", "dispatches", "resident_vids",
                                               "device_bytes", "store")}
                        for t, v in st["tenants"].items()})
    mt.close()
    return out


def _isolated_ids(P, s):
    ids = {}
    for name, db, mint, wl, cons, tuned in (
            ("a", s.db_a, s.mint_a, s.wl_a, s.cons_a, s.tuned_a),
            ("b", s.db_b, s.mint_b, s.wl_b, s.cons_b, s.tuned_b)):
        sub = [P.online.TimedQuery(t=tq.t, query=tq.query)
               for tq in _trace(P, s) if tq.tenant == name]
        iso = P.online.OnlineRuntime(db, mint, wl, cons, result=tuned,
                                     config=P.online.RuntimeConfig(
                                         max_batch=6, max_delay_ms=5.0,
                                         drift_threshold=2.0), **P.kw)
        for t in iso.run_trace(sub):
            ids[t.query.qid] = np.asarray(t.ids).tolist()
    return ids


@pytest.mark.parametrize("budget,measure", [("tight", False), ("tight", True),
                                            ("ample", False)])
def test_multitenant_tickets_equal_reference_and_isolated_runs(twins, budget, measure):
    out = {n: _multitenant_run(P, twins[n], budget, measure) for n, P in PKGS.items()}
    got, ref = out["repro_torch"], out["repro"]
    for key in ("ids", "tenants", "batch_sizes", "hits", "governor", "resident",
                "batcher", "plan_cache", "tenants"):
        assert got[key] == ref[key], key
    for g, r in zip(got["metrics"], ref["metrics"]):
        if r is not None:
            assert g[1] == r[1] and g[2] == r[2]
            assert g[0] == pytest.approx(r[0], rel=1e-6)
    gov = got["governor"]
    if budget == "tight":
        assert gov["evictions"] >= 1 and gov["overcommits"] == 0
        assert gov["peak_bytes"] <= gov["budget_bytes"]
    iso = _isolated_ids(PKGS["repro_torch"], twins["repro_torch"])
    trace = _trace(PKGS["repro_torch"], twins["repro_torch"])
    assert [iso[tq.query.qid] for tq in trace] == got["ids"]


def _churned_run(P, s):
    """A governed run with the semantic cache on and a mutation stream on
    tenant b: column, ("delta",) + vid and ("semcache", ns) keys all land in
    the governor; b's re-arrivals hit the cache after a spill."""
    col = P.cs.ColumnStore(s.db_a, **P.kw).device_bytes((0, 1, 2))
    mt = P.tenancy.MultiTenantRuntime(
        _tenants(P, s), budget_bytes=col,
        config=P.online.RuntimeConfig(max_batch=6, max_delay_ms=5.0, semcache=True),
        **P.kw)
    kinds, acquire = [], mt.governor.acquire

    def spy(tenant, vid, nbytes):
        kinds.append((tenant, vid[0] if vid[0] in ("delta", "semcache") else "column"))
        return acquire(tenant, vid, nbytes)
    mt.governor.acquire = spy
    table = mt.enable_ingest("b")
    rng = np.random.default_rng(3)
    mt.mutate("b", P.ingest.InsertBatch(P.trace.row_batch(s.db_b, rng, 40)))
    mt.mutate("b", P.ingest.DeleteBatch(np.arange(0, 60, 3)))
    trace = _trace(P, s)
    tickets = mt.run_trace(trace)
    t_end = trace[-1].t + 0.05
    again = [P.online.TimedQuery(t=t_end + i * 1e-3, query=tq.query, tenant=tq.tenant)
             for i, tq in enumerate(trace[:12])]
    tickets += mt.run_trace(again)
    st = mt.stats()
    out = _tickets_out(tickets)
    out.update(governor=st["governor"], resident=mt.governor.resident(),
               table=table.stats(), semcache={t: v["semcache"]
                                              for t, v in st["tenants"].items()},
               dispatches={t: v["dispatches"] for t, v in st["tenants"].items()},
               delta_bytes=mt.state("b").view.segments.total_device_bytes(),
               acquired=sorted(set(kinds)))
    mt.close()
    return out


def test_governed_semcache_and_delta_charge_the_reference_keys(twins):
    out = {n: _churned_run(P, twins[n]) for n, P in PKGS.items()}
    got, ref = out["repro_torch"], out["repro"]
    assert got == ref
    assert got["acquired"] == [("a", "column"), ("a", "semcache"), ("b", "column"),
                               ("b", "delta"), ("b", "semcache")]
    assert got["governor"]["evictions"] >= 1
    assert all(got["hits"][-12:]), "every exact re-arrival hits the cache"


def _swap_run(P, s):
    mt = P.tenancy.MultiTenantRuntime(_tenants(P, s), budget_bytes=50_000_000, **P.kw)
    qb = P.vectors.make_queries(s.db_b, [(0, 1)], k=K, seed=11)[0]
    mt.submit("b", qb, now=0.0)
    mt.drain(now=0.1)
    hits_before = mt.cache.stats()["hits"]
    new_a = s.mint_a.retune(s.wl_a, s.cons_a, warm_start=s.tuned_a)
    dropped = mt.swap_tenant("a", new_a, s.wl_a, now=0.2)
    qb2 = P.vectors.make_queries(s.db_b, [(0, 1)], k=K, seed=12)[0]
    t = mt.submit("b", qb2, now=0.3)
    mt.drain(now=0.4)
    out = dict(gens=(mt.generation_of("a"), mt.generation_of("b")), dropped=dropped,
               hits=mt.cache.stats()["hits"] - hits_before, ids=np.asarray(t.ids).tolist(),
               built={x: sorted(sp.name for sp in mt.istores.get(x).built_specs())
                      for x in "ab"},
               config=_plans(new_a))
    mt.close()
    return out


def test_swap_is_tenant_local_as_in_the_reference(twins):
    out = {n: _swap_run(P, twins[n]) for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"]["gens"] == (1, 0) and out["repro_torch"]["hits"] == 1


def _compact_run(P, s):
    mt = P.tenancy.MultiTenantRuntime(_tenants(P, s), budget_bytes=50_000_000, **P.kw)
    mt.enable_ingest("b", policy=P.ingest.CompactionPolicy(max_delta_fraction=0.01))
    rng = np.random.default_rng(4)
    mt.mutate("b", P.ingest.InsertBatch(P.trace.row_batch(s.db_b, rng, 30)))
    mt.mutate("b", P.ingest.DeleteBatch(np.arange(5, 50, 5)))
    qs = P.vectors.make_queries(s.db_b, [(0, 1)] * 3, k=K, seed=21)
    before = [mt.submit("b", q, now=0.01 * i) for i, q in enumerate(qs)]
    mt.drain(now=0.1)
    what = mt.maintain_tenant("b", now=0.2)
    after = [mt.submit("b", q, now=0.3 + 0.01 * i) for i, q in enumerate(qs)]
    mt.drain(now=0.5)
    out = dict(what=what, gens=(mt.generation_of("a"), mt.generation_of("b")),
               before=[np.asarray(t.ids).tolist() for t in before],
               after=[np.asarray(t.ids).tolist() for t in after],
               resident=mt.governor.resident(), governor=mt.governor.stats(),
               rows=mt.state("b").spec.db.n_rows)
    mt.close()
    return out


def test_compact_tenant_equals_reference(twins):
    out = {n: _compact_run(P, twins[n]) for n, P in PKGS.items()}
    got = out["repro_torch"]
    assert got == out["repro"]
    assert got["what"] == "compacted" and got["gens"] == (0, 1)
    assert got["before"] == got["after"]


# ---- joint cross-tenant tuning -------------------------------------------------


def _joint_tasks(P):
    mk = P.vectors.make_database
    db_a = mk(1000, [("a16", 16), ("a64", 64), ("b16", 16), ("b64", 64), ("c16", 16),
                     ("c64", 64)], seed=0)
    db_b = mk(800, [("x16", 16), ("x64", 64)], seed=7)
    Task, Mint, Cons = P.tuner.TenantTask, P.tuner.Mint, P.types.Constraints
    return {
        "a": Task(Mint(db_a, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw),
                  _wl(P, db_a, [(0, 1), (2, 3), (4, 5)], 0),
                  Cons(theta_recall=0.85, theta_storage=4)),
        "b": Task(Mint(db_b, index_kind="ivf", seed=0, min_sample_rows=300, **P.kw),
                  _wl(P, db_b, [(0, 1)], 1), Cons(theta_recall=0.85, theta_storage=2)),
    }


def _joint_out(joint):
    return dict(allocations=joint.allocations, total_cost=joint.total_cost,
                total_storage=joint.total_storage, feasible=joint.feasible,
                curves=joint.curves,
                results={t: _plans(r) for t, r in sorted(joint.results.items())})


@pytest.mark.parametrize("equal_split", [False, True])
def test_tune_tenants_allocations_equal_reference(equal_split):
    out = {n: _joint_out(P.tuner.tune_tenants(_joint_tasks(P), 4, equal_split=equal_split))
           for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    if not equal_split:
        assert out["repro_torch"]["allocations"] == {"a": 3, "b": 1}


def _tune_all_run(P, s):
    mt = P.tenancy.MultiTenantRuntime(_tenants(P, s), budget_bytes=50_000_000, **P.kw)
    joint = mt.tune_all(global_storage=4)
    q = P.vectors.make_queries(s.db_a, [(0,)], k=K, seed=13)[0]
    t = mt.submit("a", q, now=0.0)
    mt.drain(now=0.1)
    out = dict(joint=_joint_out(joint), gens=[mt.generation_of(x) for x in "ab"],
               installed={x: _plans(mt.state(x).result) for x in "ab"},
               ids=np.asarray(t.ids).tolist())
    mt.close()
    return out


def test_tune_all_installs_the_reference_allocations_and_plans(twins):
    out = {n: _tune_all_run(P, twins[n]) for n, P in PKGS.items()}
    got = out["repro_torch"]
    assert got == out["repro"]
    assert got["gens"] == [1, 1]
    assert got["installed"] == got["joint"]["results"]


# ---- namespaced index registry ---------------------------------------------------


def _index_stores_run(P, s):
    reg = P.tenancy.TenantIndexStores()
    sa = reg.register("a", s.db_a, seed=0, **P.kw)
    sb = reg.register("b", s.db_b, seed=0, **P.kw)
    spec = P.types.IndexSpec(vid=(0,), kind="ivf")
    ia, ib = reg.index("a", spec), reg.index("b", spec)
    assert ia is not ib and reg.get("a") is sa
    with pytest.raises(ValueError):
        reg.register("a", s.db_a, **P.kw)
    out = dict(ns=(sa.namespace, sb.namespace), tenants=reg.tenants(),
               lists=(ia.n_lists, ib.n_lists), stats=reg.stats(),
               dropped=(reg.drop("a", spec), reg.drop("a", spec)),
               b_built=[x.name for x in sb.built_specs()], after=reg.stats())
    return out


def test_tenant_index_stores_namespacing_equals_reference(twins):
    out = {n: _index_stores_run(P, twins[n]) for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"]["dropped"] == (True, False)
    assert out["repro_torch"]["after"]["b"]["built"] == 1


# ---- governed delta segments and semantic caches, alone ------------------------


def _delta_run(P, s):
    gov = P.tenancy.MemoryGovernor(10**9)
    table = P.ingest.MutableTable(s.db_b)
    seg = P.ingest.DeltaSegments(table, governor=gov, tenant="b", **P.kw)
    gov.register_delta("b", seg)
    log = []
    rng = np.random.default_rng(6)
    table.apply(P.ingest.InsertBatch(P.trace.row_batch(s.db_b, rng, 10)))
    seg.column((0,))
    seg.column((0, 1))
    log.append((gov.resident(), seg.total_device_bytes()))
    table.apply(P.ingest.InsertBatch(P.trace.row_batch(s.db_b, rng, 200)))
    seg.column((0,))  # new version: the old charge released, the new one taken
    log.append((gov.resident(), seg.total_device_bytes()))
    gov._evict("b", ("delta", 0))
    log.append((gov.resident(), seg.total_device_bytes(), gov.stats()))
    seg.drop_all()
    log.append((gov.resident(), seg.total_device_bytes(), gov.stats()))
    return log


def test_governed_delta_segments_charge_the_reference_keys_and_bytes(twins):
    out = {n: _delta_run(P, twins[n]) for n, P in PKGS.items()}
    assert out["repro_torch"] == out["repro"]
    first = out["repro_torch"][0][0]
    assert [k for _, k, _ in first] == [("delta", 0), ("delta", 0, 1)]
    assert out["repro_torch"][-1][0] == [] and out["repro_torch"][-1][1] == 0


def _semcache_run(P, s):
    gov = P.tenancy.MemoryGovernor(10**9)
    cache = P.semcache.SemanticCache(P.semcache.SemCacheConfig(capacity=8),
                                     governor=gov, tenant="a", **P.kw)
    gov.register_semcache("a", cache)
    qs = P.vectors.make_queries(s.db_a, [(0,), (0,), (1,)], k=K, seed=31)
    plan = P.types.QueryPlan(0, [], [], 0.0, 1.0)
    ids = [np.arange(K) + 10 * i for i in range(3)]
    log = []
    for q, r in zip(qs, ids):
        hit, token = cache.probe(q, plan)
        token.admit(r)
    for q in qs:  # materializes and charges each namespace's matrix
        log.append(cache.probe(q, plan)[0].tolist())
    log.append((gov.resident(), gov.stats(), cache.stats()))
    gov._evict("a", gov.resident()[0][1])  # spill the coldest namespace
    log.append((gov.resident(), cache.stats()["device_bytes"]))
    log.append([cache.probe(q, plan)[0].tolist() for q in qs])  # re-uploads, hits
    log.append((gov.resident(), gov.stats(), cache.stats()))
    cache.bump()  # every namespace dies: its charge is released
    log.append((gov.resident(), gov.stats()["total_bytes"]))
    return log


def test_governed_semcache_spills_and_rehits_as_the_reference(twins):
    out = {n: _semcache_run(P, twins[n]) for n, P in PKGS.items()}
    got = out["repro_torch"]
    assert got == out["repro"]
    assert got[:3] == [list(range(10 * i, 10 * i + K)) for i in range(3)]
    assert got[5] == got[:3]  # the spilled namespace re-uploads and hits
    assert got[-1] == ([], 0)


def test_spilled_namespace_drops_matrix_and_norms_together(twins):
    P = PKGS["repro_torch"]
    gov = P.tenancy.MemoryGovernor(10**9)
    cache = P.semcache.SemanticCache(governor=gov, tenant="a", device="cpu")
    gov.register_semcache("a", cache)
    q = P.vectors.make_queries(twins["repro_torch"].db_a, [(0,)], k=K, seed=32)[0]
    plan = P.types.QueryPlan(0, [], [], 0.0, 1.0)
    cache.probe(q, plan)[1].admit(np.arange(K))
    cache.probe(q, plan)
    (ns,) = cache._ns.values()
    assert ns.dev is not None and ns.dev_sq is not None and ns.charged
    assert gov.resident() == [("a", ("semcache", ns.ns_id), ns.device_bytes)]
    assert cache.evict_device(ns.gvid)
    gov.release("a", ns.gvid)
    assert ns.dev is None and ns.dev_sq is None and not ns.charged
    assert cache.probe(q, plan)[0].tolist() == list(range(K))
    assert ns.dev is not None and ns.dev_sq is not None
    assert gov.tenant_bytes("a") == ns.device_bytes



def test_semcache_probe_and_a_spilling_admission_take_the_locks_in_one_order(twins):
    """A governed probe calls the governor while it holds the cache's lock;
    another store's admission holds the governor's lock while it spills the
    cache's namespace. The probe is held inside the cache's lock until the
    spill has started (at most 0.5 s): taken in two orders, the two locks
    would deadlock here. Both threads finish, the probe hits and the
    namespace ends spilled."""
    P = PKGS["repro_torch"]
    q = P.vectors.make_queries(twins["repro_torch"].db_a, [(0,)], k=K, seed=33)[0]
    plan = P.types.QueryPlan(0, [], [], 0.0, 1.0)
    spilling, held = threading.Event(), []

    def generation():  # read under the cache's lock on every probe
        if threading.current_thread().name == "probe" and not held:
            held.append(True)
            spilling.wait(0.5)
        return 0
    cache = P.semcache.SemanticCache(P.semcache.SemCacheConfig(capacity=4),
                                     generation=generation, tenant="a", device="cpu")
    gov = P.tenancy.MemoryGovernor(P.cs.padded_device_bytes(4, q.concat().shape[0]))
    cache.governor = gov
    gov.register_semcache("a", cache)
    cache.probe(q, plan)[1].admit(np.arange(K))
    cache.probe(q, plan)  # the namespace's matrix is resident and charged
    evict = cache.evict_device

    def spill(vid):
        spilling.set()
        return evict(vid)
    cache.evict_device = spill
    out = {}
    probe = threading.Thread(name="probe", daemon=True,
                             target=lambda: out.update(ids=cache.probe(q, plan)[0]))
    admit = threading.Thread(daemon=True, target=lambda: (
        held or probe.join(0.1), gov.acquire("b", (0,), 1), out.update(admitted=True)))
    probe.start()
    while not held:
        pass
    admit.start()
    probe.join(10.0)
    admit.join(10.0)
    assert not probe.is_alive() and not admit.is_alive(), "the two locks deadlocked"
    assert out["ids"].tolist() == list(range(K)) and out["admitted"]
    (ns,) = cache._ns.values()
    assert ns.dev is None and not ns.charged
    assert gov.resident() == [("b", (0,), 1)]


def test_async_flushes_spilling_semcache_namespaces_finish(twins):
    """Flushes on a 2-worker pool admit columns over a budget that spills
    the semantic cache's namespaces while the serving thread probes the
    cache and uploads them: the traces finish, and every ticket's ids equal
    the synchronous run's."""
    P = PKGS["repro_torch"]
    s = twins["repro_torch"]
    fresh = _trace(P, s)
    t0 = fresh[23].t + 0.05  # once the first half has landed: each of its
    # re-arrivals (a probe that uploads and charges a namespace) beside a
    # fresh arrival (a flush that admits columns and spills namespaces)
    traces = (fresh[:24], [P.online.TimedQuery(t=t0 + i * 2e-3 + d, query=tq.query,
                                               tenant=tq.tenant)
                           for i in range(24) for d, tq in ((0.0, fresh[i]),
                                                            (1e-3, fresh[24 + i]))])
    budget = P.cs.ColumnStore(s.db_a, **P.kw).device_bytes((0, 1, 2))
    out = {}
    for async_flush in (False, True):
        mt = P.tenancy.MultiTenantRuntime(
            _tenants(P, s), budget_bytes=budget,
            config=P.online.RuntimeConfig(max_batch=6, max_delay_ms=5.0, semcache=True,
                                          async_flush=async_flush, workers=2), **P.kw)
        kinds, evict = [], mt.governor._evict

        def noted(tenant, vid, evict=evict, kinds=kinds):
            kinds.append(vid[0] if vid[0] in ("delta", "semcache") else "column")
            return evict(tenant, vid)
        mt.governor._evict = noted
        res = {}
        run = threading.Thread(daemon=True, target=lambda: res.update(
            ids=[np.asarray(t.ids).tolist() for tr in traces for t in mt.run_trace(tr)]))
        run.start()
        run.join(120.0)
        assert not run.is_alive(), f"async_flush={async_flush}: the trace deadlocked"
        assert isinstance(mt.executor, P.online.runtime.WorkerPool) == async_flush
        mt.close()
        out[async_flush] = res["ids"]
        assert {"column", "semcache"} <= set(kinds), kinds
    assert out[True] == out[False]

def test_eviction_under_an_enabled_observer_is_recorded():
    """The reference's governor passes ``kind=`` to ``Observer.event(kind,
    ...)``, so any eviction under an enabled observer raises TypeError there;
    the port names that attribute ``key_kind`` and records the eviction."""
    out = {}
    for name, P in PKGS.items():
        obs = importlib.import_module(f"{name}.obs").Observer()
        gov = P.tenancy.MemoryGovernor(100, observer=obs)
        rec = _Recorder()
        gov.register_semcache("a", rec)
        gov.acquire("a", ("semcache", 0), 80)
        try:
            gov.acquire("a", ("semcache", 1), 80)
        except TypeError:
            out[name] = "TypeError"
            continue
        snap = obs.metrics.snapshot().series
        out[name] = (gov.stats()["evictions"], rec.evicted,
                     [(n, lab, e["value"]) for (n, lab), e in sorted(snap.items())
                      if n in ("events", "governor_evictions")],
                     [(e["kind"], e["attrs"]["key_kind"]) for e in obs.timeline.as_dicts()])
    assert out["repro"] == "TypeError"
    assert out["repro_torch"] == (1, [("semcache", 0)], [
        ("events", (("kind", "governor_evict"),), 1),
        ("governor_evictions", (("kind", "semcache"), ("tenant", "a")), 1)],
        [("governor_evict", "semcache")])


def test_spilling_tenant_skew_replay_is_deterministic():
    """A tenant-skew replay whose budget spills (the reference raises there,
    see above) gives the same fingerprint, objectives and dispatches twice."""
    A = importlib.import_module("repro_torch.autotune")
    sc = A.ReplayScenario(name="tenant_skew", rows=120, n_queries=16, seed=3,
                          min_sample_rows=60, budget_mb=0.2)
    params = A.serving_space().defaults()
    a, b = (A.replay(sc, params, seed=7, device="cpu") for _ in range(2))
    assert a.snapshot["governor_evictions{kind=column,tenant=t0}"] >= 1
    assert (a.fingerprint, a.objectives, a.flush_dispatches) == \
        (b.fingerprint, b.objectives, b.flush_dispatches)
