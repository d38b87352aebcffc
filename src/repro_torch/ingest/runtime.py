"""Ingest-aware serving runtime: OnlineRuntime + streaming mutations.

Closes the loop the ROADMAP called "retune under mutation" (DESIGN.md §9):

  request path   : unchanged — plan cache → micro-batcher → BatchEngine;
                   the engine serves (base + delta segments − tombstones)
                   through its attached ``MutationView``, so new rows are
                   visible at the next flush and deleted rows never
                   surface.
  mutation path  : ``mutate()`` applies a typed batch to the MutableTable
                   under the batcher lock, so a mutation is ordered
                   strictly between micro-batch flushes — every flushed
                   batch executes against exactly one table version.
  maintenance    : each ``tick()`` (after the query-drift retuner gets its
                   chance) runs the data side —
                     · ``DataDriftDetector`` fires → compact + retrain
                       ``Mint`` on the materialized live table + retune +
                       atomic swap (``data_retune``);
                     · otherwise the ``Compactor`` policy fires → shadow
                       build + atomic swap (``compact``).
                   EVERY swap — compaction or retune — bumps the
                   plan-cache generation: templates planned against the
                   pre-swap snapshot can never serve the post-swap one.

Delta segments, shadow builds and compacted column stores live on the
engine's device (``device=None``: the CUDA card, as ``OnlineRuntime``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace as dc_replace

import numpy as np

from repro_torch.async_.coordinator import BuildCoordinator
from repro_torch.core.types import Constraints, TuningResult, Workload
from repro_torch.ingest.compactor import CompactionPolicy, Compactor
from repro_torch.ingest.delta import MutationView
from repro_torch.ingest.drift import DataDriftDetector, DataDriftReport
from repro_torch.ingest.mutation import (DeleteBatch, InsertBatch, UpsertBatch,
                                   resolve_timed)
from repro_torch.ingest.table import MutableTable
from repro_torch.online.runtime import OnlineRuntime, RuntimeConfig
from repro_torch.online.trace import TimedMutation, TimedQuery
from repro_torch.serve.columnstore import ColumnStore


@dataclass
class IngestConfig:
    """Maintenance knobs on top of ``RuntimeConfig``."""

    policy: CompactionPolicy | None = None   # None -> CompactionPolicy()
    delta_threshold: float = 0.25            # data drift: live delta share
    churn_threshold: float = 0.3             # cumulative churn since rearm
    shift_threshold: float = 0.15            # per-column centroid shift
    min_mutated_rows: int = 64
    data_cooldown_s: float = 60.0            # min spacing of data retunes
    auto_maintain: bool = True               # tick() runs the data side
    # DESIGN.md §10: policy-triggered compactions cut on-path but build on
    # the worker pool; serving continues on the old (store, generation)
    # pair and the post-cut log is replayed before the atomic rebase
    async_compaction: bool = False


@dataclass
class CompactionEvent:
    t: float
    reason: str
    generation: int            # plan-cache generation AFTER the swap
    rows_before: int
    rows_after: int
    dead_reclaimed: int
    delta_folded: int
    build_seconds: float       # shadow build (async: off the serving path)
    build_cost: float = 0.0    # deterministic work proxy (CompactionStats)
    mode: str = "sync"         # "sync" | "async"
    replayed: int = 0          # post-cut log records replayed at rebase
    stall_s: float = 0.0       # serving-path stall (drain + replay + swap;
                               # sync mode: includes the whole build)


@dataclass
class DataRetuneEvent:
    t: float
    reason: str
    churn_fraction: float
    max_shift: float
    generation: int            # generation AFTER the final swap
    config_before: int
    config_after: int
    est_cost_after: float
    tune_seconds: float


class IngestRuntime(OnlineRuntime):
    """Serving facade over a MUTABLE table."""

    def __init__(self, db, mint, workload: Workload, constraints: Constraints,
                 result: TuningResult | None = None, store=None, engine=None,
                 config: RuntimeConfig | None = None,
                 ingest: IngestConfig | None = None,
                 table: MutableTable | None = None, executor=None,
                 observer=None, device=None):
        super().__init__(db, mint, workload, constraints, result=result,
                         store=store, engine=engine, config=config,
                         executor=executor, observer=observer, device=device)
        self.ingest = ingest or IngestConfig()
        self.table = table if table is not None else MutableTable(db)
        cs = self.engine.cstore
        self.view = MutationView(self.table, block_rows=cs.block_rows,
                                 block_dim=cs.block_dim,
                                 device=self.engine.device)
        self.engine.attach_mutations(self.view)
        self.compactor = Compactor(self.table, policy=self.ingest.policy,
                                   seed=mint.seed, device=self.engine.device)
        self.data_detector = DataDriftDetector(
            self.table, delta_threshold=self.ingest.delta_threshold,
            churn_threshold=self.ingest.churn_threshold,
            shift_threshold=self.ingest.shift_threshold,
            min_mutated_rows=self.ingest.min_mutated_rows)
        self.compaction_events: list[CompactionEvent] = []
        self.data_retune_events: list[DataRetuneEvent] = []
        self._fallback_workload = workload
        self._last_data_fire: float | None = None
        self.builds: BuildCoordinator | None = None
        self.stale_async_builds = 0
        if self.ingest.async_compaction:
            self._build_coordinator()

    def _build_coordinator(self) -> BuildCoordinator:
        if self.builds is None:
            self.builds = BuildCoordinator(self._ensure_executor())
        return self.builds

    # ---- mutation path ----------------------------------------------------

    def mutate(self, mutation) -> tuple[int, np.ndarray]:
        """Apply one typed mutation batch. Serialized against flushes by
        the batcher lock: a queued micro-batch executes either entirely
        before or entirely after this mutation, never across it. Under
        async flush that rule extends to IN-FLIGHT batches: the apply
        waits for outstanding flush jobs first (workers never take the
        batcher lock, so this cannot deadlock) — which is also what keeps
        async flush results bit-identical to the sync baseline under
        churn."""
        return self._mutate(mutation)

    def _mutate(self, mutation, attributes=None) -> tuple[int, np.ndarray]:
        with self.batcher.lock:
            self.batcher.sync_inflight()
            lsn, ids = self.table.apply(mutation)
            if attributes is not None:
                # attributes ride the mutation under the SAME lock hold:
                # a flush sees the rows and their attributes together, or
                # neither — a filtered scan never observes a half-applied
                # (vectors, attributes) pair
                if self.engine.attrs is None:
                    raise ValueError(
                        "mutation carries attributes but the engine has no "
                        "AttributeStore attached")
                self.engine.attrs.put(ids, attributes)
            if self.semcache is not None:
                # mutation flushed: cached results may omit the new rows /
                # contain the deleted ones. Mutations deliberately do NOT
                # bump the plan-cache generation (planner templates stay
                # valid), so the semcache keeps its own data epoch.
                self.semcache.bump()
        return lsn, ids

    def insert(self, vectors, attributes=None) -> np.ndarray:
        return self._mutate(InsertBatch(vectors), attributes)[1]

    def delete(self, ids) -> int:
        lsn, _ = self.mutate(DeleteBatch(np.asarray(ids)))
        return lsn

    def upsert(self, ids, vectors, attributes=None) -> np.ndarray:
        return self._mutate(UpsertBatch(np.asarray(ids), vectors),
                            attributes)[1]

    def apply_timed(self, tm: TimedMutation) -> None:
        """Resolve one trace mutation against the live table and apply it
        (``ingest.mutation.resolve_timed``)."""
        mutation = resolve_timed(self.table, tm)
        if mutation is not None:
            self._mutate(mutation, getattr(tm, "attributes", None))

    # ---- serving loop -----------------------------------------------------

    def tick(self, now: float | None = None):
        now = time.time() if now is None else now
        done = super().tick(now)
        if self.ingest.auto_maintain:
            self.maintain(now)
        return done

    def run_mixed_trace(self, events: list) -> list:
        """Replay a churn trace (TimedQuery | TimedMutation, by arrival
        time). Returns one completed ticket per QUERY in arrival order."""
        tickets = []
        for ev in events:
            if isinstance(ev, TimedQuery):
                tickets.append(self.submit(ev.query, ev.t))
            else:
                self.apply_timed(ev)
            self.tick(ev.t)
        last = events[-1].t if events else 0.0
        self.drain(last)
        self.retuner.join()
        self.wait_maintenance(now=last)  # finalize an in-flight async build
        return tickets

    # ---- maintenance ------------------------------------------------------

    def maintain(self, now: float | None = None) -> None:
        """One maintenance step: finalize a completed background build
        first; while one is in flight nothing else fires (its cut must not
        be invalidated by a competing fold). Otherwise: data-drift retune
        (it compacts as part of its swap — compacting separately would be
        wasted work), else policy-triggered compaction (async when
        configured: cut now, build off-path, finalize at a later tick)."""
        now = time.time() if now is None else now
        if self.builds is not None:
            if self.builds.poll(now):
                return
            if self.builds.inflight():
                return
        report = self.data_detector.check()
        if report.drifted and self._data_cooldown_ok(now):
            self.data_retune(report, now)
            return
        reason = self.compactor.should_compact()
        if reason is not None:
            if self.ingest.async_compaction:
                self.compact_async(reason=reason, now=now)
            else:
                self.compact(reason=reason, now=now)

    def wait_maintenance(self, now: float | None = None,
                         timeout: float | None = None) -> None:
        """Block until any in-flight background build is built AND
        finalized (tests, benches, shutdown)."""
        if self.builds is not None:
            self.builds.wait(timeout=timeout, now=now)

    def close(self) -> None:
        self.wait_maintenance()
        super().close()

    def _data_cooldown_ok(self, now: float) -> bool:
        return (self._last_data_fire is None
                or now - self._last_data_fire >= self.ingest.data_cooldown_s)

    def compact(self, reason: str = "manual",
                now: float | None = None) -> CompactionEvent:
        """Fold delta + tombstones into a new base and atomically swap it
        into serving, IN-LINE: the batcher lock is held across build +
        drain + install, so no mutation or flush can interleave with the
        fold (the stop-the-world baseline ``compact_async`` is measured
        against; nothing lands between cut and rebase, so replay is
        empty)."""
        now = time.time() if now is None else now
        t0 = time.time()
        with self.batcher.lock:
            self.observer.event("compaction_cut", reason=reason, mode="sync")
            state = self.compactor.build(self.result.configuration,
                                         reason=reason)
            self.observer.event("compaction_build", reason=reason,
                                mode="sync",
                                build_seconds=state.stats.build_seconds,
                                rows_after=state.stats.rows_after,
                                specs_rebuilt=state.stats.specs_rebuilt)
            self.batcher.drain(now)
            with self._swap_lock:
                replayed = self._install_compaction(state)
        ev = self._compaction_event(state, reason, now, mode="sync",
                                    replayed=replayed,
                                    stall_s=time.time() - t0)
        self.compaction_events.append(ev)
        self.observer.event("compaction_rebase", reason=reason, mode="sync",
                            generation=ev.generation, replayed=ev.replayed,
                            stall_s=ev.stall_s)
        return ev

    def compact_async(self, reason: str = "manual", now: float | None = None):
        """Cut now; build off the serving path; finalize at a later tick
        (DESIGN.md §10). Serving continues on the old (store, generation)
        pair — post-cut mutations stay visible through the delta path and
        are REPLAYED onto the new base before the atomic rebase, so every
        flush observes exactly one consistent (store, generation, table)
        triple throughout. Returns the ``BackgroundBuild`` handle, or None
        when a build is already in flight."""
        now = time.time() if now is None else now
        builds = self._build_coordinator()
        with self.batcher.lock:  # pin configuration vs a concurrent swap
            cut = self.compactor.cut()
            configuration = self.result.configuration
        self.observer.event("compaction_cut", reason=reason, mode="async",
                            upto_lsn=cut.upto_lsn)
        return builds.submit(
            "compact",
            lambda: self._build_compaction(cut, configuration, reason),
            finalize=lambda state, t: self._finish_compaction(
                state, reason, now if t is None else t),
            label=f"compact:{reason}", now=now)

    def _build_compaction(self, cut, configuration, reason: str):
        """Worker-side shadow build; the build event is recorded on the
        worker thread — the timeline ring is thread-safe, and the event's
        monotonic stamp interleaves correctly with serving-side spans."""
        state = self.compactor.build_from(cut, configuration, reason=reason)
        self.observer.event("compaction_build", reason=reason, mode="async",
                            build_seconds=state.stats.build_seconds,
                            rows_after=state.stats.rows_after,
                            specs_rebuilt=state.stats.specs_rebuilt)
        return state

    def _finish_compaction(self, state, reason: str,
                           now: float) -> CompactionEvent | None:
        """Serving-thread finalize for an async build: drain, replay the
        post-cut log onto the new base, atomic rebase + store swap. A build
        whose cut predates a newer fold (its replay records are gone) is
        STALE and dropped — serving already moved past it. The stale check
        runs under the batcher lock: a concurrent fold (e.g. a data retune
        on another serving thread) can truncate the log while this finalize
        waits for the lock, and rebasing onto the stale cut then would
        silently lose the truncated mutations."""
        t0 = time.time()
        with self.batcher.lock:
            if state.stats.upto_lsn < self.table.log.truncated_upto:
                self.stale_async_builds += 1
                self.observer.event("compaction_stale_drop", reason=reason,
                                    upto_lsn=state.stats.upto_lsn)
                return None
            self.batcher.drain(now)
            with self._swap_lock:
                replayed = self._install_compaction(state)
        ev = self._compaction_event(state, reason, now, mode="async",
                                    replayed=replayed,
                                    stall_s=time.time() - t0)
        self.compaction_events.append(ev)
        self.observer.event("compaction_rebase", reason=reason, mode="async",
                            generation=ev.generation, replayed=ev.replayed,
                            stall_s=ev.stall_s)
        return ev

    def _compaction_event(self, state, reason: str, now: float, mode: str,
                          replayed: int, stall_s: float) -> CompactionEvent:
        return CompactionEvent(
            t=now, reason=reason, generation=self.cache.generation,
            rows_before=state.stats.rows_before,
            rows_after=state.stats.rows_after,
            dead_reclaimed=state.stats.dead_reclaimed,
            delta_folded=state.stats.delta_folded,
            build_seconds=state.stats.build_seconds,
            build_cost=state.stats.build_cost,
            mode=mode, replayed=replayed, stall_s=stall_s)

    def _install_compaction(self, state) -> int:
        """Caller holds batcher lock + swap lock. Order matters: the table
        rebase and the engine store swap must land together — the engine's
        MutationView reads the table, so a half-installed pair would mix
        old physical ids with new stable mapping. Returns the number of
        post-cut log records replayed onto the new base (always 0 for the
        in-line path, which excludes mutations across the fold)."""
        replay = self.table.log.since(state.stats.upto_lsn)
        self.table.rebase(state.db, state.ids, state.stats.upto_lsn,
                          replay=replay)
        self.view.segments.drop_all()   # release stale device deltas
        cstore = state.cstore if state.cstore is not None \
            else ColumnStore(state.db, device=self.engine.device)
        self.engine.swap_store(state.store, cstore, db=state.db)
        self.db = state.db
        self.store = state.store
        # satellite fix: EVERY compaction/swap bumps the generation — plan
        # templates created against the old snapshot (its physical layout,
        # its n_rows cost terms) must not survive into the new one
        self.cache.bump_generation()
        return len(replay)

    def data_retune(self, report: DataDriftReport,
                    now: float | None = None) -> DataRetuneEvent:
        """Data drift: compact, retrain estimators on the live table, and
        retune — the data-side analogue of the query-drift lifecycle."""
        now = time.time() if now is None else now
        self._last_data_fire = now
        self.observer.event("data_drift", reason=report.reason or "",
                            churn=report.churn_fraction,
                            shift=report.max_shift)
        t0 = time.time()
        with self.batcher.lock:
            config_before = len(self.result.configuration)
            self.compact(reason=f"data_drift ({report.reason})", now=now)
            # rebuild the tuner over the compacted snapshot: estimators and
            # the what-if sample must describe the LIVE data distribution
            self.mint = dc_replace(self.mint, db=self.db, estimators=None,
                                   _sample=None, _selest=None)
            self.planner = self.mint.planner(self.constraints)
            if self.mint.attributes is not None:
                # fresh selectivity estimator over the compacted LIVE ids
                # (stable ids are no longer a 0..n range after a fold);
                # also drops the engine's per-version filter bitmap cache
                selest = self.mint.selectivity_estimator(
                    ids=self.table.live_ids())
                self.engine.attach_filters(self.mint.attributes, selest)
            try:
                observed = self.monitor.observed_workload()
            except ValueError:  # nothing served yet: fall back to tuned mix
                observed = self._fallback_workload
            result = self.mint.retune(observed, self.constraints,
                                      warm_start=self.result)
            for spec in result.configuration:   # shadow build before swap
                if spec not in self.store:
                    self.store.get(spec)
            self.swap(result, observed, now=now)
            self.data_detector.rearm()
        ev = DataRetuneEvent(
            t=now, reason=report.reason or "data_drift",
            churn_fraction=report.churn_fraction, max_shift=report.max_shift,
            generation=self.cache.generation, config_before=config_before,
            config_after=len(result.configuration),
            est_cost_after=float(result.est_workload_cost),
            tune_seconds=time.time() - t0)
        self.data_retune_events.append(ev)
        self.observer.event("data_retune_swap", generation=ev.generation,
                            reason=ev.reason, tune_seconds=ev.tune_seconds)
        return ev

    # ---- introspection ----------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        out["table"] = self.table.stats()
        out["compactor"] = self.compactor.stats()
        out["compactions"] = len(self.compaction_events)
        out["data_retunes"] = len(self.data_retune_events)
        out["data_drift"] = vars(self.data_detector.check())
        if self.builds is not None:
            out["async_builds"] = dict(self.builds.stats(),
                                       stale_dropped=self.stale_async_builds)
        return out
