"""Online serving runtime (DESIGN.md §7): the layer between a request
stream and the batched execution engine.

Request path:  submit(query) → plan cache (miss: planner against the live
configuration) → micro-batcher → flush (size/deadline) → plan-group
compilation → ``BatchEngine`` kernels.

Control path:  every tick the workload monitor's sliding window is checked
for drift; the background re-tuner re-runs ``Mint.retune`` on the observed
window, shadow-builds the winning configuration, and ``swap()`` atomically
installs tuning result + plan-cache generation + pruned index store under
the swap lock. Serving state (result, store, cache generation) is only
ever read or replaced under that lock, so a flush sees either the old
generation or the new one, never a mix.

The runtime serves on one device: ``device=None`` is the CUDA card (and
raises without one), ``device="cpu"`` runs every kernel's plain version.
An injected ``engine`` or ``store`` brings its own device.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.async_.executor import WorkerPool
from repro_torch.core.types import Constraints, Query, QueryPlan, TuningResult, Workload
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import NULL_OBSERVER, Observer
from repro_torch.online.monitor import (DriftDetector, WorkloadMonitor,
                                  reference_histogram)
from repro_torch.online.plancache import PlanCache, constraints_fingerprint
from repro_torch.online.retuner import BackgroundRetuner, RetuneEvent
from repro_torch.online.scheduler import MicroBatcher, Ticket
from repro_torch.online.semcache import SemanticCache, SemCacheConfig
from repro_torch.online.trace import TimedQuery
from repro_torch.serve.engine import BatchEngine


@dataclass
class RuntimeConfig:
    max_batch: int = 32
    max_delay_ms: float = 5.0
    quantum: int = 1           # DRR flush quantum (tenancy fairness)
    fair: bool = True          # deficit-round-robin vs FIFO flush order
    window: int = 256          # workload-monitor sliding window
    min_window: int = 64       # queries required before drift can fire
    drift_threshold: float = 0.35
    cooldown_s: float = 60.0   # min spacing between retunes
    retune_mode: str = "sync"  # "sync" | "thread" | "pool" (DESIGN.md §10)
    measure: bool = False      # True: ExecutionMetrics per ticket (bench)
    # async pipeline (DESIGN.md §10). ``async_flush`` hands flush execution
    # to a worker pool (tickets become futures); sync flush stays the
    # bit-identical baseline. ``workers`` sizes the pool the runtime
    # creates when no executor is passed in; ``stage_transfers`` overlaps
    # the next batch's host→device uploads with the current dispatch.
    async_flush: bool = False
    workers: int = 2
    stage_transfers: bool = True
    # plan cache (DESIGN.md §7): bounded LRU by default — unbounded plan
    # caches grow one template per (vid, k, predicate) forever under
    # filtered / high-cardinality workloads. None = unbounded (opt-in).
    plan_cache_capacity: int | None = 2048
    # semantic result cache (DESIGN.md §13): probe recent (query vector,
    # plan, predicate) results before the batcher; hits within ε bypass
    # the flush entirely. ε=0 serves only bit-exact repeat queries.
    semcache: bool = False
    semcache_epsilon: float = 0.0
    semcache_capacity: int = 256     # entries per namespace ring
    semcache_namespaces: int = 32    # live namespaces per tenant
    # observability (DESIGN.md §14): True builds an obs.Observer and
    # threads it through scheduler/engine/semcache/pool — per-ticket span
    # trees, a metrics registry, and the runtime timeline. False (default)
    # leaves the no-op NULL_OBSERVER in place: zero allocations on the hot
    # path and bit-identical results.
    observe: bool = False


class OnlineRuntime:
    """Serving facade over (Mint, IndexStore, BatchEngine)."""

    def __init__(self, db, mint, workload: Workload, constraints: Constraints,
                 result: TuningResult | None = None,
                 store: IndexStore | None = None,
                 engine: BatchEngine | None = None,
                 config: RuntimeConfig | None = None,
                 executor=None, observer=None, device=None):
        if engine is not None:
            device = engine.device
        elif store is not None:
            device = store.device
        else:
            device = resolve_device(device)  # before any work: no card raises
        self.db = db
        self.mint = mint
        self.constraints = constraints
        self.config = config or RuntimeConfig()
        # observability seam: an injected Observer wins; else config.observe
        # builds one; else the shared no-op. Created before the executor so
        # an owned pool reports task timings through it.
        self.observer = observer if observer is not None else \
            (Observer() if self.config.observe else NULL_OBSERVER)
        # one executor serves BOTH async flushes and background builds
        # (retunes, compactions); tests inject a StepExecutor here
        self.executor = executor
        self._own_executor = False
        if self.config.async_flush or self.config.retune_mode == "pool":
            self._ensure_executor()
        self.result = result if result is not None else mint.tune(workload, constraints)
        self.store = store or IndexStore(db, seed=mint.seed, device=device)
        self.engine = engine or BatchEngine(db, store=self.store,
                                            observer=self.observer,
                                            device=device)
        if self.engine.store is not self.store:
            self.engine.swap_store(self.store)
        if self.observer.enabled:
            self.engine.obs = self.observer  # injected engines report too
        if getattr(mint, "attributes", None) is not None:
            # filtered serving: the engine needs the attribute store for
            # keep bitmaps, and shares the tuner's selectivity estimator
            self.engine.attach_filters(mint.attributes,
                                       mint.selectivity_estimator())
        self.planner = mint.planner(constraints)
        self.cache = PlanCache(constraints=constraints_fingerprint(constraints),
                               capacity=self.config.plan_cache_capacity)
        self.cache.seed(workload, self.result)
        self.monitor = WorkloadMonitor(window=self.config.window)
        self.detector = DriftDetector(reference_histogram(workload),
                                      threshold=self.config.drift_threshold,
                                      min_window=self.config.min_window)
        self.retuner = BackgroundRetuner(self, cooldown_s=self.config.cooldown_s,
                                         mode=self.config.retune_mode,
                                         executor=self.executor)
        flush_exec = self.executor if self.config.async_flush else None
        stage = (self._stage if flush_exec is not None
                 and self.config.stage_transfers else None)
        self.semcache = None
        if self.config.semcache:
            self.semcache = SemanticCache(
                SemCacheConfig(epsilon=self.config.semcache_epsilon,
                               capacity=self.config.semcache_capacity,
                               max_namespaces=self.config.semcache_namespaces),
                scan=self.engine.cache_probe,
                generation=lambda: self.cache.generation,
                device=self.engine.device, observer=self.observer)
        self.batcher = MicroBatcher(self._execute, self.plan_for,
                                    max_batch=self.config.max_batch,
                                    max_delay_ms=self.config.max_delay_ms,
                                    quantum=self.config.quantum,
                                    fair=self.config.fair,
                                    executor=flush_exec, stage=stage,
                                    semcache=self.semcache,
                                    observer=self.observer)
        self._swap_lock = threading.Lock()

    # ---- request path -----------------------------------------------------

    def plan_for(self, query: Query) -> QueryPlan:
        """Plan-cache hot path; a miss pays one planner call against the
        live configuration and templates the result for its (vid, k).
        The (configuration, generation) pair is snapshotted together and
        the template is only installed if no swap happened while planning —
        otherwise a stale plan could be cached under the new generation."""
        plan = self.cache.get(query)
        if plan is None:
            with self._swap_lock:
                config = self.result.configuration
                gen = self.cache.generation
            plan = self.planner.plan(query, config)
            with self._swap_lock:
                if self.cache.generation == gen:
                    self.cache.put(query, plan)
        return plan

    def submit(self, query: Query, now: float | None = None) -> Ticket:
        now = time.time() if now is None else now
        self.monitor.observe(query)
        return self.batcher.submit(query, now)

    def tick(self, now: float | None = None) -> list[Ticket]:
        """Advance the serving loop: flush due micro-batches, then give the
        background re-tuner a chance to react to drift."""
        now = time.time() if now is None else now
        done = self.batcher.poll(now)
        self.retuner.maybe_retune(now)
        return done

    def drain(self, now: float | None = None) -> list[Ticket]:
        return self.batcher.drain(now)

    def run_trace(self, trace: list[TimedQuery]) -> list[Ticket]:
        """Replay a timed trace in virtual time; returns one ticket per
        query in arrival order (all completed)."""
        tickets = [None] * len(trace)
        for i, tq in enumerate(trace):
            tickets[i] = self.submit(tq.query, tq.t)
            self.tick(tq.t)
        last = trace[-1].t if trace else 0.0
        self.drain(last)
        self.retuner.join()
        return tickets  # type: ignore[return-value]

    # ---- control path -----------------------------------------------------

    def swap(self, result: TuningResult, observed: Workload,
             now: float | None = None) -> int:
        """Atomically install a re-tuned configuration: tuning result,
        plan-cache generation (re-seeded from the new plans), drift
        reference, and the index store pruned back to the new configuration
        (the shadow-built indexes stay; stale ones are dropped so the
        storage constraint holds after the swap, not just during it).
        Returns the number of stale indexes dropped.

        The batcher lock is held across drain + install: in-flight
        requests complete under their admitted (old-generation) plans
        BEFORE pruning — otherwise a pending ticket referencing a stale
        index would transparently rebuild it after the drop — and no new
        request can resolve an old-generation plan and enqueue it between
        the drain and the generation bump. Lock order is batcher → swap
        everywhere (submit resolves plans under the batcher lock and
        plan_for takes only the swap lock), so this cannot deadlock."""
        with self.batcher.lock:
            self.batcher.drain(now)
            with self._swap_lock:
                self.result = result
                self.cache.bump_generation()
                self.cache.seed(observed, result)
                self.detector.rearm(observed)
                # prune mutates the engine's store in place (shadow-built
                # indexes stay); engine.swap_store exists for replacing the
                # store/column-store wholesale, e.g. after data mutations
                dropped = len(self.store.prune(result.configuration))
        self.observer.event("swap", generation=self.cache.generation,
                            dropped=dropped)
        return dropped

    @property
    def generation(self) -> int:
        return self.cache.generation

    @property
    def retune_events(self) -> list[RetuneEvent]:
        return self.retuner.events

    def stats(self) -> dict:
        # read-only batcher snapshot (the live object stays untouched);
        # plan-cache LRU pressure rides the snapshot, not the live stats
        batcher = self.batcher.snapshot_stats()
        batcher.plan_evictions = self.cache.evictions
        out = {
            "generation": self.generation,
            "plan_cache": self.cache.stats(),
            "batcher": batcher.as_dict(),
            "semcache": (self.semcache.stats()
                         if self.semcache is not None else None),
            "dispatches": self.engine.counters.as_dict(),
            "monitor": {"window": len(self.monitor),
                        "total_observed": self.monitor.total_observed,
                        "column_usage": self.monitor.column_usage()},
            "drift": self.detector.check(self.monitor).drift,
            "retunes": len(self.retuner.events),
        }
        if self.observer.enabled:
            out["metrics"] = self.observer.metrics.snapshot().as_dict()
        return out

    # ---- execution --------------------------------------------------------

    def _ensure_executor(self, name: str = "runtime"):
        """The runtime's single owned-pool creation point: used at init
        (async flush / pool retunes) and lazily by subclasses that only
        need async BUILDS (e.g. async compaction with sync flush)."""
        if self.executor is None:
            self.executor = WorkerPool(workers=self.config.workers,
                                       name=name, observer=self.observer)
            self._own_executor = True
        elif self.observer.enabled:
            # injected executor (tests: StepExecutor) joins the seam too
            self.executor.obs = self.observer
        return self.executor

    def close(self) -> None:
        """Drain in-flight work and shut down an owned worker pool."""
        self.batcher.drain()
        self.retuner.join()
        if self._own_executor and self.executor is not None:
            self.executor.shutdown(wait=True)

    def _stage(self, tickets: list[Ticket]):
        pairs = [(t.query, t.plan) for t in tickets]
        return self.engine.stage_batch(pairs)

    def _execute(self, tickets: list[Ticket], staged=None) -> list:
        pairs = [(t.query, t.plan) for t in tickets]
        if self.config.measure:
            return self.engine.execute_batch(pairs, staged=staged)
        return self.engine.search_batch(pairs, staged=staged)
