"""Deterministic trace replay over the serving runtimes (DESIGN.md §15).

One ``(scenario, knobs, seed)`` triple must yield bit-identical results,
or the tuner is chasing noise. Two things make the stack replayable:

  - **virtual time**: traces carry explicit arrival times; the runtimes
    thread ``now`` through submit/tick/drain, so flush deadlines, retune
    cooldowns, and compaction triggers all fire at trace time, never wall
    time;
  - **seeded execution**: a ``StepExecutor(seed)`` runs every async task
    (flushes, shadow builds) on the replay thread in a seeded order —
    the same interleaving every run.

What is NOT replayable is the wall clock itself: ``*_ms`` histograms
(dispatch, executor task, ticket wall) measure the host machine, not the
configuration. The replay objective therefore never reads them — it runs
a **virtual-time single-server queue simulation** over deterministic
quantities only:

  - per-flush modeled service = launch overhead x kernel dispatches
    (engine ``DispatchCounters`` diff) + per-unit cost x the batch's
    dim-weighted distance work (``ExecutionMetrics.cost``);
  - compactions/retunes occupy the server for time modeled from
    ``CompactionStats.build_cost`` (a wall-free work proxy) and replayed
    log records;
  - a ticket's modeled latency = its queue completion time − its
    arrival; semantic-cache hits bypass the server at a constant cost.

The modeled latencies, recalls, throughput, and device bytes are written
into the run's ``obs`` metrics registry as ``replay_*`` series, and the
objectives are read back FROM the registry snapshot — the same read path
a live deployment would use. ``deterministic_snapshot`` strips the
wall-time series; everything left (and hence the result fingerprint) is
bit-identical across replays of the same (scenario, knobs, seed).

A replay runs on one device (``device=None``: the CUDA card; ``"cpu"``:
the kernels' plain versions). ``LatencyModel`` is the reference's, constant
for constant, so objectives agree across devices wherever the work proxies
(dispatch counts, cost units, build cost, device bytes) do; it is not
calibrated to any card's measured times.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.async_.executor import StepExecutor
from repro_torch.autotune.knobs import to_configs
from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.ingest.runtime import IngestRuntime
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import Observer
from repro_torch.online.runtime import OnlineRuntime
from repro_torch.online.trace import (TimedQuery, churn_trace, steady_trace,
                                      tenant_skew_trace)
from repro_torch.tenancy.runtime import MultiTenantRuntime, Tenant

SCENARIOS = ("steady", "churn", "tenant_skew")

# wall-clock metric series: host measurements, excluded from the
# deterministic snapshot (DESIGN.md §15 determinism contract)
WALL_SERIES = frozenset({"executor_task_ms", "dispatch_ms",
                         "ticket_wall_ms", "flush_wait_ms"})


@dataclass(frozen=True)
class ReplayScenario:
    """A captured deployment + trace, fully determined by its fields
    (hashable: deployments are memoized per scenario across trials)."""

    name: str = "steady"            # steady | churn | tenant_skew
    index_kind: str = "flat"
    rows: int = 160
    cols: tuple = (("a", 12), ("b", 16))
    vids: tuple = ((0,), (0, 1))
    n_queries: int = 48
    qps: float = 400.0
    k: int = 10
    seed: int = 0
    theta_recall: float = 0.8
    theta_storage: float = 8.0
    min_sample_rows: int = 64
    # churn
    mutation_rate: float = 0.5
    mutation_batch: int = 8
    mutation_mix: tuple = (0.6, 0.3, 0.1)
    # tenant_skew
    n_tenants: int = 3
    noisy_mult: float = 6.0
    budget_mb: float = 64.0

    def __post_init__(self):
        if self.name not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.name!r} "
                             f"(one of {SCENARIOS})")

    @property
    def churn(self) -> bool:
        return self.name == "churn"

    @property
    def budget_bytes(self) -> int:
        return int(self.budget_mb * (1 << 20))


@dataclass(frozen=True)
class LatencyModel:
    """Knob-independent constants mapping deterministic work proxies to
    modeled milliseconds. Scaled to the interpret-mode reality the wall
    benches measure: per-dispatch launch overhead dominates, so batching
    fewer launches is worth more than shaving per-row work."""

    launch_ms: float = 25.0          # per kernel dispatch (plan group)
    cost_ms_per_unit: float = 2e-6   # per dim-weighted distance (Eq. 4-6)
    flush_overhead_ms: float = 1.0   # select + merge bookkeeping per flush
    build_ms_per_unit: float = 2e-4  # compaction shadow build, per cost unit
    swap_ms: float = 5.0             # drain + atomic swap stall
    replay_ms_per_record: float = 0.5   # post-cut log replay at rebase
    retune_ms: float = 120.0         # sync tune+build occupancy
    hit_ms: float = 0.2              # semcache hit: one probe, no flush


DEFAULT_MODEL = LatencyModel()


@dataclass
class ReplayResult:
    """One deterministic replay: objectives + the registry snapshot they
    were read from. ``fingerprint`` hashes the deterministic snapshot —
    two replays of the same (scenario, knobs, seed, fidelity) must agree
    on it bit-for-bit."""

    scenario: str
    seed: int
    fidelity: float
    params: dict
    objectives: dict
    snapshot: dict
    fingerprint: str
    n_queries: int = 0
    n_flushes: int = 0
    events: dict = field(default_factory=dict)  # compactions/retunes seen
    flush_dispatches: list = field(default_factory=list)  # launches a flush


@dataclass
class _Deployment:
    db: object
    mint: Mint
    workload: Workload
    constraints: Constraints
    result: object
    trace: list
    tenants: list | None = None     # tenant_skew: Tenant spec list


_DEPLOYMENTS: dict[tuple, _Deployment] = {}  # (scenario, device) -> ...


def _uniform_workload(db, vids, k, seed) -> Workload:
    qs = make_queries(db, [tuple(v) for v in vids], k=k, seed=seed)
    return Workload(queries=qs, probs=np.ones(len(qs)))


def deployment(scenario: ReplayScenario, device=None) -> _Deployment:
    """Build (once per device, memoized) the shared immutable half of a
    replay: the database, tuner, tuned result, and the full captured trace.
    Trials share these — per-trial state (stores, tables, caches) is
    fresh. The tuner trains and plans on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    dep = _DEPLOYMENTS.get((scenario, device))
    if dep is not None:
        return dep
    s = scenario
    db = make_database(s.rows, [tuple(c) for c in s.cols], seed=s.seed)
    workload = _uniform_workload(db, s.vids, s.k, s.seed)
    mint = Mint(db, index_kind=s.index_kind, seed=s.seed,
                min_sample_rows=s.min_sample_rows, device=device)
    constraints = Constraints(theta_recall=s.theta_recall,
                              theta_storage=s.theta_storage)
    result = mint.tune(workload, constraints)
    tenants = None
    if s.name == "steady":
        trace = steady_trace(db, workload, s.n_queries, qps=s.qps, k=s.k,
                             seed=s.seed)
    elif s.name == "churn":
        trace = churn_trace(db, workload, s.n_queries, qps=s.qps,
                            mutation_rate=s.mutation_rate,
                            batch=s.mutation_batch,
                            mix=tuple(s.mutation_mix), k=s.k, seed=s.seed)
    else:
        wls = {f"t{i}": _uniform_workload(db, s.vids, s.k, s.seed + 31 * i)
               for i in range(s.n_tenants)}
        tenants = [Tenant(tenant_id=tid, db=db, mint=mint, workload=wl,
                          constraints=constraints, result=result)
                   for tid, wl in sorted(wls.items())]
        trace = tenant_skew_trace(db, wls, s.n_queries, qps=s.qps,
                                  noisy_mult=s.noisy_mult, k=s.k,
                                  seed=s.seed)
    dep = _Deployment(db=db, mint=mint, workload=workload,
                      constraints=constraints, result=result, trace=trace,
                      tenants=tenants)
    _DEPLOYMENTS[(scenario, device)] = dep
    return dep


def clear_deployments() -> None:
    _DEPLOYMENTS.clear()


@dataclass
class _FlushRecord:
    seq: int
    t: float                 # flush virtual time (tickets' t_done)
    cost: float              # Σ ExecutionMetrics.cost over the batch
    dispatches: int          # kernel launches this flush (counter diff)
    tickets: list = field(default_factory=list)


def _counter_total(rt) -> int:
    if isinstance(rt, MultiTenantRuntime):
        return sum(sum(vars(st.engine.counters).values())
                   for st in (rt.state(t) for t in rt.tenants()))
    return sum(vars(rt.engine.counters).values())


def _record_flushes(rt, log: list) -> None:
    """Wrap the batcher's execute callback with a flush recorder. Safe
    because every replay execution path (sync flush, StepExecutor-driven
    async flush) runs on the replay thread — the counter diff brackets
    exactly one flush."""
    batcher = rt.batcher
    orig = batcher.execute

    def wrapped(tickets, staged=None):
        c0 = _counter_total(rt)
        results = orig(tickets, staged)
        cost = float(sum(getattr(m, "cost", 0.0) for m in results))
        log.append(_FlushRecord(seq=len(log), t=0.0, cost=cost,
                                dispatches=_counter_total(rt) - c0,
                                tickets=list(tickets)))
        return results

    batcher.execute = wrapped


def _make_runtime(scenario: ReplayScenario, dep: _Deployment, rc, ic,
                  executor, observer, device):
    if scenario.name == "tenant_skew":
        return MultiTenantRuntime(dep.tenants, scenario.budget_bytes,
                                  config=rc, quantum=rc.quantum,
                                  fair=rc.fair, executor=executor,
                                  observer=observer, device=device)
    if scenario.churn:
        return IngestRuntime(dep.db, dep.mint, dep.workload,
                             dep.constraints, result=dep.result, config=rc,
                             ingest=ic, executor=executor,
                             observer=observer, device=device)
    return OnlineRuntime(dep.db, dep.mint, dep.workload, dep.constraints,
                         result=dep.result, config=rc, executor=executor,
                         observer=observer, device=device)


def _drive(rt, events, executor) -> tuple[list, float]:
    """Run the trace prefix in virtual time, draining the seeded executor
    after every event so async work lands at a deterministic point.
    Returns (tickets, peak device bytes sampled across the trace)."""
    tickets = []
    peak = _device_bytes(rt)
    multi = isinstance(rt, MultiTenantRuntime)
    for ev in events:
        if isinstance(ev, TimedQuery):
            if multi:
                tickets.append(rt.submit(ev.tenant, ev.query, ev.t))
            else:
                tickets.append(rt.submit(ev.query, ev.t))
        else:
            rt.apply_timed(ev)
        rt.tick(ev.t)
        executor.run_all()
        peak = max(peak, _device_bytes(rt))
    last = events[-1].t if events else 0.0
    rt.drain(last)
    executor.run_all()
    if isinstance(rt, IngestRuntime):
        rt.wait_maintenance(now=last)
        executor.run_all()
    if not multi:
        rt.retuner.join()
    return tickets, max(peak, _device_bytes(rt))


def _recall_of(engine, query, ids) -> float:
    gt = engine.ground_truth(query)
    if len(gt) == 0:
        return 1.0
    return float(len(np.intersect1d(np.asarray(ids), np.asarray(gt)))
                 / len(gt))


def _device_bytes(rt) -> float:
    if isinstance(rt, MultiTenantRuntime):
        return float(rt.governor.stats()["peak_bytes"])
    total = float(rt.engine.cstore.total_device_bytes())
    view = getattr(rt, "view", None)
    if view is not None:
        total += float(view.segments.total_device_bytes())
    if rt.semcache is not None:
        total += float(rt.semcache.device_bytes())
    return total


def _simulate(rt, tickets, flush_log, model: LatencyModel):
    """Virtual-time single-server queue over the recorded flush/build
    events. Returns (per-query modeled latency ms, per-query recall,
    makespan seconds, service ms per flush)."""
    events = []
    for fr in flush_log:
        fr.t = fr.tickets[0].t_done  # flush selection time (virtual)
        svc = (model.launch_ms * fr.dispatches
               + model.cost_ms_per_unit * fr.cost
               + model.flush_overhead_ms)
        events.append((fr.t, 0, fr.seq, svc, fr))
    seq = len(flush_log)
    for ce in getattr(rt, "compaction_events", []):
        svc = (model.swap_ms + model.replay_ms_per_record * ce.replayed)
        if ce.mode == "sync":  # in-line build blocks the serving path
            svc += model.build_ms_per_unit * ce.build_cost
        events.append((ce.t, 1, seq, svc, None))
        seq += 1
    for de in getattr(rt, "data_retune_events", []):
        events.append((de.t, 1, seq, model.retune_ms, None))
        seq += 1
    retuners = []
    if isinstance(rt, MultiTenantRuntime):
        retuners = [st.retuner for st in
                    (rt.state(t) for t in rt.tenants())
                    if st.retuner is not None]
    else:
        retuners = [rt.retuner]
    for ret in retuners:
        for re_ in ret.events:
            svc = model.retune_ms if ret.mode == "sync" else model.swap_ms
            events.append((re_.t, 1, seq, svc, None))
            seq += 1
    events.sort(key=lambda e: (e[0], e[1], e[2]))

    latency: dict[int, float] = {}
    services = []
    server_free = 0.0
    for t, _pri, _seq, svc, fr in events:
        start = max(t * 1e3, server_free)
        end = start + svc
        server_free = end
        if fr is not None:
            services.append(svc)
            for tk in fr.tickets:
                latency[id(tk)] = end - tk.t_submit * 1e3
    lats, recalls = [], []
    t_end = 0.0
    for tk in tickets:
        if tk.cache_hit:
            lat = model.hit_ms
            done = tk.t_submit * 1e3 + lat
            eng = (rt.state(tk.tenant).engine
                   if isinstance(rt, MultiTenantRuntime) else rt.engine)
            rec = _recall_of(eng, tk.query, tk.ids)
        else:
            lat = latency[id(tk)]
            done = tk.t_submit * 1e3 + lat
            rec = float(tk.metrics.recall)
        lats.append(lat)
        recalls.append(rec)
        t_end = max(t_end, done)
    t0 = min((tk.t_submit for tk in tickets), default=0.0) * 1e3
    makespan_s = max((t_end - t0) / 1e3, 1e-9)
    return lats, recalls, makespan_s, services


def replay(scenario: ReplayScenario, params: dict, seed: int = 0,
           fidelity: float = 1.0,
           model: LatencyModel = DEFAULT_MODEL, device=None) -> ReplayResult:
    """One deterministic trial: run the trace prefix under ``params`` on
    ``device`` (None: the CUDA card), simulate the queue, publish
    ``replay_*`` series into the obs registry, and read the objectives back
    from its snapshot."""
    if not (0.0 < fidelity <= 1.0):
        raise ValueError("fidelity must be in (0, 1]")
    device = resolve_device(device)
    dep = deployment(scenario, device)
    rc, ic = to_configs(params, churn=scenario.churn, measure=True)
    observer = Observer()
    executor = StepExecutor(seed=seed)
    rt = _make_runtime(scenario, dep, rc, ic, executor, observer, device)
    flush_log: list[_FlushRecord] = []
    _record_flushes(rt, flush_log)
    n_events = max(1, int(round(len(dep.trace) * fidelity)))
    tickets, device_bytes = _drive(rt, dep.trace[:n_events], executor)
    lats, recalls, makespan_s, services = _simulate(rt, tickets, flush_log,
                                                    model)

    reg = observer.metrics
    for v in lats:
        reg.observe("replay_latency_ms", v)
    for v in recalls:
        reg.observe("replay_recall", v)
    for v in services:
        reg.observe("replay_service_ms", v)
    n = len(lats)
    p99 = float(np.percentile(np.asarray(lats), 99)) if n else 0.0
    mean = float(np.mean(np.asarray(lats))) if n else 0.0
    thpt = n / makespan_s
    reg.gauge("replay_p99_ms", p99)
    reg.gauge("replay_mean_ms", mean)
    reg.gauge("replay_throughput_qps", thpt)
    reg.gauge("replay_device_bytes", device_bytes)
    reg.gauge("replay_recall_mean",
              float(np.mean(np.asarray(recalls))) if n else 1.0)
    reg.counter("replay_queries", n)
    reg.counter("replay_flushes", len(flush_log))

    snap = reg.snapshot()
    det = deterministic_snapshot(snap)
    # objectives come FROM the registry (the live read path), not from
    # locals — the determinism gate hashes exactly what they were read from
    objectives = {
        "p99_ms": float(snap.get("replay_p99_ms")["value"]),
        "mean_ms": float(snap.get("replay_mean_ms")["value"]),
        "throughput_qps": float(snap.get("replay_throughput_qps")["value"]),
        "device_bytes": float(snap.get("replay_device_bytes")["value"]),
        "recall_mean": float(snap.get("replay_recall_mean")["value"]),
    }
    events = {
        "compactions": len(getattr(rt, "compaction_events", [])),
        "data_retunes": len(getattr(rt, "data_retune_events", [])),
        "retunes": (len(rt.retuner.events)
                    if not isinstance(rt, MultiTenantRuntime) else 0),
        "cache_hits": rt.batcher.stats.cache_hits,
    }
    rt.close()
    return ReplayResult(scenario=scenario.name, seed=seed,
                        fidelity=fidelity, params=dict(params),
                        objectives=objectives, snapshot=det,
                        fingerprint=fingerprint_of(det), n_queries=n,
                        n_flushes=len(flush_log), events=events,
                        flush_dispatches=[fr.dispatches for fr in flush_log])


def deterministic_snapshot(snap) -> dict:
    """The registry snapshot minus wall-clock series — everything that
    remains is a pure function of (scenario, knobs, seed, fidelity)."""
    out = {}
    for (name, labels), entry in sorted(snap.series.items()):
        if name in WALL_SERIES:
            continue
        tag = name if not labels else \
            name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
        if entry["kind"] == "histogram":
            d = entry["data"]
            out[tag] = {"count": d["count"], "total": round(d["total"], 9),
                        "min": d["min"], "max": d["max"]}
        else:
            out[tag] = entry["value"]
    return out


def fingerprint_of(det: dict) -> str:
    blob = json.dumps(det, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
