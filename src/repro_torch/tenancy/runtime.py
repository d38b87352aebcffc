"""Multi-tenant serving runtime (DESIGN.md §8).

One device, many databases: each tenant brings its own database, workload,
recall target, and storage slice; the runtime shares the machine between
them without letting them observe each other —

  - stores are NAMESPACED (``TenantIndexStores`` / ``TenantColumnStores``):
    per-tenant results are bit-identical to isolated single-tenant runs;
  - device memory is GOVERNED: one ``MemoryGovernor`` arbitrates padded
    device bytes across every tenant's column store (per-tenant quotas,
    global budget, LRU spill back to host);
  - the plan cache is shared but tenant-keyed with PER-TENANT generations:
    one tenant's retune swap never invalidates another's templates;
  - the micro-batcher is shared with DEFICIT-ROUND-ROBIN flush selection:
    a bursty tenant cannot starve a light one out of its batch slots;
  - tuning can be JOINT: ``tune_all`` runs ``core.tuner.tune_tenants``
    (greedy knapsack over per-tenant budget ladders, warm-started from the
    serving configurations) and swaps every tenant's result atomically
    per tenant.

Every tenant's stores, engine, semantic cache and mutation view live on the
runtime's one device (``device=None``: the CUDA card, resolved before any
work; ``device="cpu"`` runs each kernel's plain version).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace as dc_replace

from repro_torch.async_.executor import WorkerPool
from repro_torch.core.tuner import (JointTuningResult, Mint, TenantTask,
                                    tune_tenants)
from repro_torch.core.types import (Constraints, Query, QueryPlan, TenantId,
                                    TuningResult, Workload)
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.ingest.compactor import (CompactionPolicy, CompactionStats,
                                          Compactor)
from repro_torch.ingest.delta import MutationView
from repro_torch.ingest.drift import DataDriftDetector
from repro_torch.ingest.table import MutableTable
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import NULL_OBSERVER, Observer
from repro_torch.online.monitor import (DriftDetector, WorkloadMonitor,
                                        reference_histogram)
from repro_torch.online.plancache import PlanCache, constraints_fingerprint
from repro_torch.online.retuner import BackgroundRetuner, RetuneEvent
from repro_torch.online.runtime import RuntimeConfig
from repro_torch.online.scheduler import MicroBatcher, Ticket
from repro_torch.online.semcache import (SemanticCache, SemCacheConfig,
                                         TenantSemCaches)
from repro_torch.online.trace import TimedMutation, TimedQuery
from repro_torch.serve.engine import BatchEngine
from repro_torch.tenancy.governor import MemoryGovernor
from repro_torch.tenancy.stores import TenantColumnStores, TenantIndexStores


@dataclass
class Tenant:
    """One tenant's deployment description."""

    tenant_id: TenantId
    db: MultiVectorDatabase
    mint: Mint
    workload: Workload
    constraints: Constraints
    result: TuningResult | None = None
    quota_bytes: int | None = None  # None: bounded only by the global budget
    weight: float = 1.0             # traffic share (joint-tuning objective)


class _TenantState:
    """Live serving state for one registered tenant."""

    def __init__(self, runtime: "MultiTenantRuntime", spec: Tenant):
        self.spec = spec
        self.result = (spec.result if spec.result is not None
                       else spec.mint.tune(spec.workload, spec.constraints))
        self.planner = spec.mint.planner(spec.constraints)
        self.cstore = runtime.cstores.register(
            spec.tenant_id, spec.db, quota_bytes=spec.quota_bytes,
            device=runtime.device)
        self.store = runtime.istores.register(
            spec.tenant_id, spec.db, seed=spec.mint.seed,
            device=runtime.device)
        self.engine = BatchEngine(spec.db, store=self.store,
                                  cstore=self.cstore,
                                  observer=runtime.observer)
        # ingest state (enable_ingest): per-tenant mutation stream
        self.table: MutableTable | None = None
        self.view: MutationView | None = None
        self.compactor: Compactor | None = None
        self.detector: DataDriftDetector | None = None
        # query-drift loop (enable_drift_loop): per-tenant monitor +
        # detector + BackgroundRetuner on the shared pool
        self.retune_proxy: "_TenantRetuneProxy | None" = None
        self.retuner: BackgroundRetuner | None = None


def _no_default_plan(query: Query) -> QueryPlan:
    raise RuntimeError("MultiTenantRuntime resolves plans per tenant; "
                       "submit() must pass the tenant id")


class _TenantCacheView:
    """The shared plan cache, scoped to one tenant (the retuner's probe
    surface: ``peek`` + the tenant's own generation)."""

    def __init__(self, cache: PlanCache, tenant: TenantId):
        self._cache = cache
        self._tenant = tenant

    def peek(self, query: Query) -> QueryPlan | None:
        return self._cache.peek(query, tenant=self._tenant)

    @property
    def generation(self) -> int:
        return self._cache.generation_of(self._tenant)


class _TenantRetuneProxy:
    """Adapter exposing ONE tenant of a MultiTenantRuntime through the
    single-tenant surface ``BackgroundRetuner`` drives (DESIGN.md §10):
    reads resolve to the tenant's live state, and the swap lands through
    ``swap_tenant`` — tenant-scoped generation bump + template re-seed +
    store prune, other tenants untouched. Each tenant gets its own monitor
    and drift detector, so tenants re-tune on their OWN drift signals;
    the tune + shadow-build run on the runtime's shared worker pool, so
    one tenant's retune never blocks another tenant's flushes."""

    def __init__(self, runtime: "MultiTenantRuntime", tenant: TenantId,
                 monitor: WorkloadMonitor, detector: DriftDetector):
        self._rt = runtime
        self._tenant = tenant
        self.monitor = monitor
        self.detector = detector
        self.cache = _TenantCacheView(runtime.cache, tenant)

    @property
    def _state(self) -> "_TenantState":
        return self._rt.state(self._tenant)

    @property
    def observer(self):
        return self._rt.observer

    @property
    def db(self):
        return self._state.spec.db

    @property
    def mint(self) -> Mint:
        return self._state.spec.mint

    @property
    def constraints(self) -> Constraints:
        return self._state.spec.constraints

    @property
    def result(self) -> TuningResult:
        return self._state.result

    @property
    def store(self):
        return self._state.store

    def swap(self, result: TuningResult, observed: Workload,
             now: float | None = None) -> int:
        return self._rt.swap_tenant(self._tenant, result, observed, now=now)


class MultiTenantRuntime:
    """Serving facade over N tenants sharing one device budget on
    ``device`` (None: the CUDA card)."""

    def __init__(self, tenants: list[Tenant], budget_bytes: int,
                 config: RuntimeConfig | None = None,
                 plan_cache_capacity: int | None = None,
                 fair: bool = True, auto_flush: bool = True,
                 quantum: int = 1, executor=None, observer=None,
                 device=None):
        if not tenants:
            raise ValueError("need at least one tenant")
        self.device = resolve_device(device)  # before any work: no card raises
        self.config = config or RuntimeConfig()
        # observability seam (DESIGN.md §14): shared across every tenant's
        # engine/semcache and the governor, so cross-tenant interference
        # (spills, DRR waits) lands in ONE timeline with tenant labels
        self.observer = observer if observer is not None else \
            (Observer() if self.config.observe else NULL_OBSERVER)
        # shared pool: async flushes + every tenant's background retunes
        self.executor = executor
        self._own_executor = False
        if self.executor is None and self.config.async_flush:
            self._ensure_executor()
        self.governor = MemoryGovernor(budget_bytes, observer=self.observer)
        self.cstores = TenantColumnStores(self.governor)
        self.istores = TenantIndexStores()
        # explicit capacity wins; otherwise the RuntimeConfig default keeps
        # the shared cache LRU-bounded (None here used to mean unbounded)
        if plan_cache_capacity is None:
            plan_cache_capacity = self.config.plan_cache_capacity
        self.cache = PlanCache(capacity=plan_cache_capacity)
        self._tenants: dict[TenantId, _TenantState] = {}
        self.semcaches: dict[TenantId, SemanticCache] = {}
        for spec in tenants:
            if spec.tenant_id in self._tenants:
                raise ValueError(f"duplicate tenant {spec.tenant_id!r}")
            st = _TenantState(self, spec)
            self._tenants[spec.tenant_id] = st
            self.cache.register_tenant(
                spec.tenant_id, constraints_fingerprint(spec.constraints))
            self.cache.seed(spec.workload, st.result, tenant=spec.tenant_id)
            if self.config.semcache:
                # per-tenant namespaces: each tenant gets its own cache
                # keyed on ITS plan-cache generation, charged to ITS
                # governor quota, probing through ITS engine's kernel route
                cache = SemanticCache(
                    SemCacheConfig(
                        epsilon=self.config.semcache_epsilon,
                        capacity=self.config.semcache_capacity,
                        max_namespaces=self.config.semcache_namespaces),
                    scan=st.engine.cache_probe,
                    generation=(lambda t=spec.tenant_id:
                                self.cache.generation_of(t)),
                    governor=self.governor, tenant=spec.tenant_id,
                    device=st.engine.device, observer=self.observer)
                self.semcaches[spec.tenant_id] = cache
                self.governor.register_semcache(spec.tenant_id, cache)
        flush_exec = self.executor if self.config.async_flush else None
        self.batcher = MicroBatcher(self._execute, _no_default_plan,
                                    max_batch=self.config.max_batch,
                                    max_delay_ms=self.config.max_delay_ms,
                                    quantum=quantum, fair=fair,
                                    auto_flush=auto_flush,
                                    executor=flush_exec,
                                    semcache=(TenantSemCaches(self.semcaches)
                                              if self.semcaches else None),
                                    observer=self.observer)

    def _ensure_executor(self) -> WorkerPool:
        if self.executor is None:
            self.executor = WorkerPool(workers=self.config.workers,
                                       name="tenants",
                                       observer=self.observer)
            self._own_executor = True
        return self.executor

    def tenants(self) -> list[TenantId]:
        return sorted(self._tenants)

    def state(self, tenant: TenantId) -> _TenantState:
        return self._tenants[tenant]

    # ---- request path -----------------------------------------------------

    def plan_for(self, query: Query, tenant: TenantId) -> QueryPlan:
        """Tenant-namespaced plan-cache hot path; a miss pays one planner
        call against the tenant's live configuration."""
        plan = self.cache.get(query, tenant=tenant)
        if plan is None:
            st = self._tenants[tenant]
            plan = st.planner.plan(query, st.result.configuration)
            self.cache.put(query, plan, tenant=tenant)
        return plan

    def submit(self, tenant: TenantId, query: Query,
               now: float | None = None) -> Ticket:
        now = time.time() if now is None else now
        st = self._tenants[tenant]
        if st.retune_proxy is not None:
            st.retune_proxy.monitor.observe(query)
        # plan resolution + enqueue under the batcher lock, so a concurrent
        # swap of THIS tenant can never interleave between them
        with self.batcher.lock:
            plan = self.plan_for(query, tenant)
            return self.batcher.submit(query, now, tenant=tenant, plan=plan)

    def tick(self, now: float | None = None) -> list[Ticket]:
        """Advance the serving loop: flush/harvest due batches, then give
        every tenant's drift loop a chance — finalizing completed pool
        retunes (the swap runs here, on the serving thread) and firing new
        ones on drifted tenants. A tenant mid-retune never blocks another
        tenant's flushes: the tune+build runs on the pool, and this loop
        only pays the per-tenant drain+swap when a result is ready."""
        now = time.time() if now is None else now
        done = self.batcher.poll(now)
        for tid in self.tenants():
            st = self._tenants[tid]
            if st.retuner is not None:
                st.retuner.maybe_retune(now)
        return done

    def drain(self, now: float | None = None) -> list[Ticket]:
        return self.batcher.drain(now)

    def run_trace(self, trace: list[TimedQuery]) -> list[Ticket]:
        """Replay a tenant-tagged trace in virtual time (mutation events
        allowed for ingest-enabled tenants); one completed ticket per
        QUERY, arrival order."""
        tickets = []
        for tq in trace:
            if isinstance(tq, TimedMutation):
                self.apply_timed(tq)
            else:
                tickets.append(self.submit(tq.tenant, tq.query, tq.t))
            self.tick(tq.t)
        last = trace[-1].t if trace else 0.0
        self.drain(last)
        self.join_drift_loops(now=last)
        return tickets

    # ---- per-tenant query-drift loops (DESIGN.md §10) ----------------------

    def enable_drift_loop(self, tenant: TenantId, window: int | None = None,
                          min_window: int | None = None,
                          drift_threshold: float | None = None,
                          cooldown_s: float | None = None,
                          mode: str | None = None,
                          reps_per_vid: int = 3) -> BackgroundRetuner:
        """Give one tenant its own drift → retune → swap lifecycle: a
        private WorkloadMonitor + DriftDetector (referenced on the tenant's
        tuned workload mix) driving a BackgroundRetuner whose tune + shadow
        build run on the runtime's shared worker pool (``mode='pool'``
        whenever an executor exists, else inline). Knobs default to the
        RuntimeConfig values."""
        st = self._tenants[tenant]
        if st.retuner is not None:
            raise ValueError(f"tenant {tenant!r} already has a drift loop")
        cfg = self.config
        proxy = _TenantRetuneProxy(
            self, tenant,
            monitor=WorkloadMonitor(window=window or cfg.window),
            detector=DriftDetector(
                reference_histogram(st.spec.workload),
                threshold=(cfg.drift_threshold if drift_threshold is None
                           else drift_threshold),
                min_window=cfg.min_window if min_window is None else min_window))
        if mode is None:
            mode = "pool" if self.executor is not None else "sync"
        st.retune_proxy = proxy
        st.retuner = BackgroundRetuner(
            proxy, cooldown_s=cfg.cooldown_s if cooldown_s is None else cooldown_s,
            mode=mode, reps_per_vid=reps_per_vid, executor=self.executor)
        return st.retuner

    def join_drift_loops(self, now: float | None = None,
                         timeout: float | None = None) -> None:
        """Wait for (and finalize) every tenant's in-flight retune."""
        for tid in self.tenants():
            st = self._tenants[tid]
            if st.retuner is not None:
                st.retuner.join(timeout=timeout, now=now)

    def retune_events(self, tenant: TenantId) -> list[RetuneEvent]:
        st = self._tenants[tenant]
        return st.retuner.events if st.retuner is not None else []

    def close(self) -> None:
        """Drain in-flight work and shut down an owned worker pool."""
        self.drain()
        self.join_drift_loops()
        if self._own_executor and self.executor is not None:
            self.executor.shutdown(wait=True)

    # ---- mutation path (per-tenant ingest) --------------------------------

    def enable_ingest(self, tenant: TenantId,
                      policy: CompactionPolicy | None = None,
                      drift_kw: dict | None = None) -> MutableTable:
        """Open a mutation stream for one tenant: its engine serves
        (base + delta − tombstones) through a MutationView whose
        delta-segment bytes are charged to this tenant by the shared
        MemoryGovernor — a churning tenant's deltas compete with its own
        resident columns under its quota, not with its neighbors'."""
        st = self._tenants[tenant]
        if st.table is not None:
            raise ValueError(f"tenant {tenant!r} already has ingest enabled")
        st.table = MutableTable(st.spec.db)
        st.view = MutationView(st.table, block_rows=st.cstore.block_rows,
                               block_dim=st.cstore.block_dim,
                               governor=self.governor, tenant=tenant,
                               device=st.engine.device)
        self.governor.register_delta(tenant, st.view.segments)
        st.engine.attach_mutations(st.view)
        st.compactor = Compactor(st.table, policy=policy,
                                 seed=st.spec.mint.seed,
                                 builder_kwargs={"namespace": tenant},
                                 device=st.engine.device)
        st.detector = DataDriftDetector(st.table, **(drift_kw or {}))
        return st.table

    def _ingest_state(self, tenant: TenantId) -> _TenantState:
        st = self._tenants[tenant]
        if st.table is None:
            raise ValueError(f"tenant {tenant!r} has no ingest stream "
                             "(call enable_ingest first)")
        return st

    def mutate(self, tenant: TenantId, mutation):
        """Apply one typed mutation batch to a tenant's table, serialized
        against flushes (same ordering rule as single-tenant ingest:
        in-flight async batches complete before the mutation lands)."""
        st = self._ingest_state(tenant)
        with self.batcher.lock:
            self.batcher.sync_inflight()
            out = st.table.apply(mutation)
            sc = self.semcaches.get(tenant)
            if sc is not None:
                # invalidate ONLY this tenant's cached results (semcache
                # data epoch — mutations never bump plan-cache generations)
                sc.bump()
            return out

    def apply_timed(self, tm: TimedMutation) -> None:
        """Resolve one churn-trace mutation against its tenant's table and
        apply it (``ingest.mutation.resolve_timed``)."""
        from repro_torch.ingest.mutation import resolve_timed
        st = self._ingest_state(tm.tenant)
        mutation = resolve_timed(st.table, tm)
        if mutation is not None:
            self.mutate(tm.tenant, mutation)

    def compact_tenant(self, tenant: TenantId, reason: str = "manual",
                       now: float | None = None) -> CompactionStats:
        """Fold one tenant's delta + tombstones into a new base and swap it
        in atomically: drain in-flight batches, rebase the table, replace
        its governed column store + index store (old residency released by
        the governor), and bump THIS tenant's plan-cache generation — every
        compaction/swap bumps it, not just retunes, so a stale template can
        never reference the pre-compaction snapshot (or its tombstoned
        rows). Other tenants' stores and generations are untouched."""
        st = self._ingest_state(tenant)
        with self.batcher.lock:
            state = st.compactor.build(st.result.configuration,
                                       reason=reason, make_cstore=False)
            self.batcher.drain(now)
            st.table.rebase(state.db, state.ids, state.stats.upto_lsn)
            st.view.segments.drop_all()
            st.cstore = self.cstores.replace(tenant, state.db,
                                             device=self.device)
            st.store = self.istores.replace(tenant, state.store)
            st.engine.swap_store(state.store, st.cstore, db=state.db)
            # future (re)tunes must see the LIVE data: rebind the tenant's
            # tuner to the compacted snapshot (estimators retrain lazily)
            st.spec.mint = dc_replace(st.spec.mint, db=state.db,
                                      estimators=None, _sample=None)
            st.spec.db = state.db
            st.planner = st.spec.mint.planner(st.spec.constraints)
            self.cache.bump_generation(tenant)
        return state.stats

    def maintain_tenant(self, tenant: TenantId,
                        now: float | None = None) -> str | None:
        """One data-side maintenance step for a tenant: data-drift retune
        (compact + retrain + retune + swap) when its detector fires, else
        policy-triggered compaction. Returns what happened (or None)."""
        st = self._ingest_state(tenant)
        report = st.detector.check()
        if report.drifted:
            self.compact_tenant(tenant,
                                reason=f"data_drift ({report.reason})",
                                now=now)
            st = self._tenants[tenant]
            result = st.spec.mint.retune(st.spec.workload,
                                         st.spec.constraints,
                                         warm_start=st.result)
            for spec in result.configuration:  # shadow build before swap
                if spec not in st.store:
                    st.store.get(spec)
            self.swap_tenant(tenant, result, st.spec.workload, now=now)
            st.detector.rearm()
            return "retuned"
        trigger = st.compactor.should_compact()
        if trigger is not None:
            self.compact_tenant(tenant, reason=trigger, now=now)
            return "compacted"
        return None

    # ---- control path -----------------------------------------------------

    def swap_tenant(self, tenant: TenantId, result: TuningResult,
                    observed: Workload, now: float | None = None) -> int:
        """Atomically install one tenant's re-tuned configuration: drain
        in-flight batches (they complete under their admitted plans), bump
        ONLY this tenant's plan-cache generation, re-seed its templates,
        and prune its index store back to the new configuration. Other
        tenants' templates, stores, and generations are untouched."""
        st = self._tenants[tenant]
        with self.batcher.lock:
            self.batcher.drain(now)
            st.result = result
            self.cache.bump_generation(tenant)
            self.cache.seed(observed, result, tenant=tenant)
            dropped = len(st.store.prune(result.configuration))
        self.observer.event("tenant_swap", tenant=str(tenant),
                            generation=self.cache.generation_of(tenant),
                            dropped=dropped)
        return dropped

    def tune_all(self, global_storage: int,
                 equal_split: bool = False) -> JointTuningResult:
        """Joint cross-tenant tuning over the serving workloads: split the
        global storage budget with ``core.tuner.tune_tenants`` (warm-started
        from each tenant's serving configuration) and swap every tenant onto
        its allocated result."""
        tasks = {
            tid: TenantTask(mint=st.spec.mint, workload=st.spec.workload,
                            constraints=st.spec.constraints,
                            weight=st.spec.weight, warm_start=st.result)
            for tid, st in self._tenants.items()
        }
        joint = tune_tenants(tasks, global_storage, equal_split=equal_split)
        for tid, result in joint.results.items():
            self.swap_tenant(tid, result, self._tenants[tid].spec.workload)
        return joint

    # ---- introspection ----------------------------------------------------

    def generation_of(self, tenant: TenantId) -> int:
        return self.cache.generation_of(tenant)

    def stats(self) -> dict:
        out = {
            "governor": self.governor.stats(),
            "plan_cache": self.cache.stats(),
            "batcher": self.batcher.snapshot_stats().as_dict(),
            "tenants": {
                tid: {"generation": self.cache.generation_of(tid),
                      "dispatches": st.engine.counters.as_dict(),
                      "store": st.store.stats(),
                      "resident_vids": st.cstore.resident(),
                      "device_bytes": self.governor.tenant_bytes(tid),
                      "table": st.table.stats() if st.table else None,
                      "semcache": (self.semcaches[tid].stats()
                                   if tid in self.semcaches else None),
                      "retunes": (len(st.retuner.events)
                                  if st.retuner is not None else None)}
                for tid, st in sorted(self._tenants.items())
            },
        }
        if self.observer.enabled:
            out["metrics"] = self.observer.metrics.snapshot().as_dict()
        return out

    # ---- execution --------------------------------------------------------

    def _execute(self, tickets: list[Ticket], staged=None) -> list:
        """Route each flushed ticket to its tenant's engine (mixed batches
        split per tenant — plan-group compilation happens per tenant since
        vids/specs from different databases must never share a dispatch;
        staging is a single-engine optimization, unused here)."""
        out: list = [None] * len(tickets)
        by_tenant: dict[TenantId, list[int]] = {}
        for i, t in enumerate(tickets):
            by_tenant.setdefault(t.tenant, []).append(i)
        for tenant, idxs in by_tenant.items():
            eng = self._tenants[tenant].engine
            pairs = [(tickets[i].query, tickets[i].plan) for i in idxs]
            res = (eng.execute_batch(pairs) if self.config.measure
                   else eng.search_batch(pairs))
            for i, r in zip(idxs, res):
                out[i] = r
        return out
