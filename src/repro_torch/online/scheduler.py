"""Request queue + micro-batching scheduler (DESIGN.md §7, §8).

Single queries are admitted one at a time; the batcher holds them until a
flush trigger fires — the pending count reaching ``max_batch``, or the
oldest pending request having waited ``max_delay_ms`` — then executes one
micro-batch through the batched engine, which compiles it into plan groups
(``serve.compiler.compile_batch``) so the scan kernels always see real
batches. Grouping happens per flushed batch; the scheduler's job is to
*create* batches out of a request stream.

Tenancy + fairness: every request is tagged with a ``TenantId`` and queued
per tenant; a flush selects up to ``max_batch`` tickets by DEFICIT ROUND
ROBIN over the active tenants (each tenant earns ``quantum`` credits per
round, spends one per request, keeps leftover deficit while backlogged),
so a bursty tenant saturating the queue cannot starve a light tenant —
the light tenant's requests ride the next batch regardless of how deep
the noisy neighbor's backlog is. DRR is work-conserving: idle tenants
donate their share, and with one tenant it degenerates to FIFO.
``fair=False`` switches selection to global arrival order (the FIFO
baseline the tenant benchmark compares against).

``auto_flush=False`` models a capacity-limited engine: submissions only
queue; ``poll`` flushes at most ONE batch per call (size or deadline
triggered), so the caller's poll cadence is the service rate and backlog
can exceed ``max_batch`` — the regime where fairness matters.

Async execution (DESIGN.md §10): with an ``executor`` attached, a flush
only SELECTS its batch under the lock — execution is handed to the worker
pool and the selected tickets become futures (``Ticket.result(timeout=...)``
blocks until their batch completes, re-raising worker crashes). The
optional ``stage`` hook runs on the SUBMITTING thread right before the
hand-off, so the next batch's host→device transfers overlap the kernel
dispatch of whatever batch a worker is currently running. Without an
executor (``sync`` mode) behavior is bit-identical to the pre-async
batcher: flushes execute inline on the submitting thread.

Time is explicit (``now`` in seconds) so schedules are deterministic and
simulation-driven; wall clock is used when ``now`` is omitted. Tickets
additionally carry wall-clock submit/done stamps (``wall_wait_ms``) so
latency benches stay meaningful under virtual-time traces.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.async_.executor import drive_until
from repro_torch.core.types import DEFAULT_TENANT, Query, QueryPlan, TenantId
from repro_torch.obs import NULL_OBSERVER


@dataclass
class Ticket:
    """One admitted request and, after its batch flushes, its result."""

    query: Query
    plan: QueryPlan
    t_submit: float
    tenant: TenantId = DEFAULT_TENANT
    t_done: float | None = None
    ids: np.ndarray | None = None
    metrics: object | None = None  # ExecutionMetrics when measuring
    batch_size: int = 0            # size of the micro-batch it flushed in
    flushed: bool = False          # selected into a flush (async: may still
                                   # be executing — ``done`` is completion)
    future: object | None = None   # async_.Future of its flush job
    t_submit_wall: float = 0.0     # wall-clock twins of t_submit/t_done
    t_done_wall: float | None = None
    cache_hit: bool = False        # served by the semantic cache, no flush
    cache_token: object | None = None  # semcache AdmissionToken on a miss
    trace: object | None = None    # obs.Trace when the observer is enabled

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def wait_ms(self) -> float:
        return ((self.t_done or self.t_submit) - self.t_submit) * 1e3

    @property
    def wall_wait_ms(self) -> float:
        """Submit→done latency on the WALL clock (virtual-time traces give
        ``wait_ms`` in trace time; this one is what a client would see)."""
        end = self.t_done_wall if self.t_done_wall is not None \
            else self.t_submit_wall
        return (end - self.t_submit_wall) * 1e3

    def wait(self, timeout: float | None = None) -> bool:
        """True once the ticket's flush has completed (or failed)."""
        if self.future is not None:
            return self.future.wait(timeout)
        return self.done

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until the flush lands and return the top-k ids. Raises
        ``TimeoutError`` if the batch has not completed in time,
        ``WorkerCrashed``/``PoolShutdown`` if the flush was lost, or the
        execution error itself if the engine raised."""
        if self.future is not None:
            self.future.result(timeout)
            return self.ids
        if not self.done:
            raise TimeoutError("ticket pending and no flush in flight "
                               "(sync batcher: poll/drain to flush)")
        return self.ids


@dataclass
class BatcherStats:
    batches: int = 0
    queries: int = 0
    flush_size: int = 0      # flushes triggered by the batch-size cap
    flush_deadline: int = 0  # flushes triggered by the oldest-waiter deadline
    flush_forced: int = 0    # explicit drains
    tenant_queries: dict = field(default_factory=dict)  # TenantId -> served
    cache_hits: int = 0      # semantic-cache hits (bypassed flush entirely)
    cache_misses: int = 0    # probed but fell through to the batcher
    plan_evictions: int = 0  # plan-cache LRU evictions (snapshot at read)

    @property
    def mean_batch(self) -> float:
        return self.queries / self.batches if self.batches else 0.0

    def copy(self) -> "BatcherStats":
        out = BatcherStats(**{k: v for k, v in vars(self).items()
                              if k != "tenant_queries"})
        out.tenant_queries = dict(self.tenant_queries)
        return out

    def as_dict(self) -> dict:
        return {"batches": self.batches, "queries": self.queries,
                "mean_batch": self.mean_batch, "flush_size": self.flush_size,
                "flush_deadline": self.flush_deadline,
                "flush_forced": self.flush_forced,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "plan_evictions": self.plan_evictions,
                "tenant_queries": dict(sorted(self.tenant_queries.items()))}


@dataclass
class _FlushJob:
    """One selected micro-batch handed to the worker pool."""

    tickets: list
    now: float            # flush (virtual) time — becomes t_done
    future: object | None = None
    staged: object | None = None


class MicroBatcher:
    """Deadline/size-triggered micro-batching over an execute callback.

    ``execute(tickets)`` runs a flushed batch and returns one result per
    ticket in order — ids (``BatchEngine.search_batch``) or metrics
    (``execute_batch``); results land on the tickets, whose ``tenant`` tag
    lets a multi-tenant executor route each entry to its tenant's engine.
    ``plan_for(query)`` resolves the plan at admission (the plan-cache hot
    path), so a generation swap between submit and flush never mixes plans
    inside one batch entry; callers that resolve plans themselves (the
    multi-tenant runtime, which needs the tenant namespace) pass ``plan=``
    to ``submit`` instead.
    """

    def __init__(self, execute: Callable[[list[Ticket]], list],
                 plan_for: Callable[[Query], QueryPlan],
                 max_batch: int = 32, max_delay_ms: float = 5.0,
                 quantum: int = 1, fair: bool = True,
                 auto_flush: bool = True, executor=None,
                 stage: Callable[[list[Ticket]], object] | None = None,
                 semcache=None, observer=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self.execute = execute
        self.plan_for = plan_for
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.quantum = quantum
        self.fair = fair
        self.auto_flush = auto_flush
        # async flush (DESIGN.md §10): executor runs flushes off the
        # submitting thread; stage(tickets) pre-uploads the batch's
        # host→device transfers on the submitting thread first. With an
        # executor attached, ``execute`` is called as
        # ``execute(tickets, staged)`` when a stage hook exists.
        self.executor = executor
        self.stage = stage
        # semantic result cache (DESIGN.md §13): probed at admission under
        # the lock — hits complete the ticket immediately and never enqueue;
        # misses carry an AdmissionToken that _apply_results redeems when
        # their flush lands. Single-tenant: a SemanticCache; multi-tenant:
        # a TenantSemCaches router (tokens bind to the owning cache).
        self.semcache = semcache
        # observability seam (DESIGN.md §14): NULL_OBSERVER is a no-op and
        # every allocation below is guarded by ``obs.enabled``, so the
        # disabled mode costs one attribute read per site and changes no
        # behavior. Ticket traces are created here at submit; the shared
        # dispatch/merge spans of a flush are adopted into every served
        # ticket's tree (async: built on the worker thread, parented back).
        self.obs = observer if observer is not None else NULL_OBSERVER
        self._inflight: list[_FlushJob] = []
        self.stats = BatcherStats()
        self._queues: dict[TenantId, deque[Ticket]] = {}
        self._ring: deque[TenantId] = deque()      # active tenants, RR order
        self._deficit: dict[TenantId, float] = {}
        self._mid_turn = False  # ring head resumes an interrupted DRR turn
        self._arrivals: deque[Ticket] = deque()    # global arrival order
        self._n_pending = 0
        # Serializes admission (plan resolution + enqueue, as one atomic
        # step) and flush execution: a thread-mode retune swap holds this
        # lock across drain + generation bump, so no request can resolve
        # an old-generation plan and enqueue it after the swap's drain —
        # and no ticket can flush twice or run the engine concurrently.
        # Reentrant because the swap path calls drain() while holding it.
        self.lock = threading.RLock()

    def __len__(self) -> int:
        return self._n_pending

    def pending(self, tenant: TenantId | None = None) -> int:
        if tenant is None:
            return self._n_pending
        return len(self._queues.get(tenant, ()))

    def submit(self, query: Query, now: float | None = None,
               tenant: TenantId = DEFAULT_TENANT,
               plan: QueryPlan | None = None) -> Ticket:
        now = time.time() if now is None else now
        t_wall = time.time()  # arrival stamp BEFORE the lock: a submitter
        # blocked behind a stop-the-world hold is measured as waiting
        obs = self.obs
        t_sub = obs.now() if obs.enabled else 0.0
        with self.lock:
            t_plan1 = t_sub
            if plan is None:
                plan = self.plan_for(query)
                if obs.enabled:
                    t_plan1 = obs.now()
            ticket = Ticket(query=query, plan=plan, t_submit=now,
                            tenant=tenant, t_submit_wall=t_wall)
            if obs.enabled:
                ticket.trace = obs.begin_trace(
                    "ticket", t0=t_sub, qid=query.qid, tenant=str(tenant))
                obs.counter("tickets_submitted", tenant=str(tenant))
            if self.semcache is not None:
                t_p0 = obs.now() if obs.enabled else 0.0
                ids, token = self.semcache.probe(query, plan, tenant)
                if obs.enabled:
                    t_p1 = obs.now()
                    root = ticket.trace.root
                    esp = obs.span_at("enqueue", t_sub, t_p0, parent=root)
                    if t_plan1 > t_sub:  # plan-cache lookup nests in enqueue
                        obs.span_at("plan_cache", t_sub, t_plan1, parent=esp)
                    obs.span_at("semcache_probe", t_p0, t_p1, parent=root,
                                hit=ids is not None)
                    t_enq = t_p1  # the probe's end opens flush_wait
                if ids is not None:  # hit: complete now, bypass the flush
                    self.stats.cache_hits += 1
                    ticket.ids = ids
                    ticket.cache_hit = True
                    ticket.flushed = True
                    ticket.t_done = now
                    ticket.t_done_wall = time.time()
                    if obs.enabled:
                        obs.counter("semcache_hits", tenant=str(tenant))
                        obs.end_trace(ticket.trace, t=t_p1)
                        obs.observe("ticket_wall_ms", ticket.wall_wait_ms,
                                    tenant=str(tenant))
                    return ticket
                if token is not None:
                    self.stats.cache_misses += 1
                    ticket.cache_token = token
            elif obs.enabled:
                t_enq = obs.now()
                esp = obs.span_at("enqueue", t_sub, t_enq, parent=ticket.trace.root)
                if t_plan1 > t_sub:
                    obs.span_at("plan_cache", t_sub, t_plan1, parent=esp)
            if obs.enabled:
                # flush_wait opens at the clock reading that closed the last
                # stage (no untimed gap between stages, whatever the load);
                # _execute_batch closes it when the ticket's flush starts
                ticket.trace.marks["enqueued"] = t_enq
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
            if not q:  # tenant (re)activates: joins the DRR ring
                self._ring.append(tenant)
                self._deficit.setdefault(tenant, 0.0)
            q.append(ticket)
            self._arrivals.append(ticket)
            self._n_pending += 1
            if self.auto_flush and self._n_pending >= self.max_batch:
                self._flush(now, "size")
        return ticket

    def poll(self, now: float | None = None) -> list[Ticket]:
        """Flush at most one batch: when the oldest pending request has
        exceeded the deadline, or (``auto_flush=False`` service mode) when a
        full batch is waiting. Returns the tickets completed by this call
        (async mode: whatever in-flight batches have landed since the last
        harvest — flushing and completing are decoupled there)."""
        now = time.time() if now is None else now
        with self.lock:
            flushed: list[Ticket] = []
            if self._n_pending:
                oldest = self._oldest_submit()
                if oldest is not None and \
                        (now - oldest) * 1e3 >= self.max_delay_ms:
                    flushed = self._flush(now, "deadline")
                elif not self.auto_flush and self._n_pending >= self.max_batch:
                    flushed = self._flush(now, "size")
            if self.executor is None:
                return flushed
            return self._harvest(block=False)

    def drain(self, now: float | None = None) -> list[Ticket]:
        """Force-flush everything pending (shutdown / end of trace), in
        batches of at most ``max_batch``. In async mode this BLOCKS until
        every in-flight flush has completed — after drain() returns there
        is no execution in flight, which is what the runtime's swap paths
        rely on (workers never take the batcher lock, so waiting while
        holding it cannot deadlock)."""
        now = time.time() if now is None else now
        out: list[Ticket] = []
        with self.lock:
            while self._n_pending:
                out.extend(self._flush(now, "forced"))
            if self.executor is not None:
                return self._harvest(block=True)
        return out

    def sync_inflight(self) -> list[Ticket]:
        """Block until every in-flight async flush lands (no-op when sync)."""
        with self.lock:
            return self._harvest(block=True)

    def inflight(self) -> int:
        return len(self._inflight)

    def snapshot_stats(self) -> BatcherStats:
        """Read-only copy of the counters. Mutating the returned object
        does NOT touch the live stats — use :meth:`reset_stats` to zero
        them (benches that window their measurements must snapshot, then
        reset, instead of resetting inside the read — the old read-and-
        reset pattern dropped counts raced in between)."""
        with self.lock:
            return self.stats.copy()

    def reset_stats(self) -> BatcherStats:
        """Zero the live counters; returns the final pre-reset snapshot."""
        with self.lock:
            out = self.stats.copy()
            self.stats = BatcherStats()
            return out

    # ---- internals (caller must hold ``self.lock``) -----------------------

    def _oldest_submit(self) -> float | None:
        while self._arrivals and self._arrivals[0].flushed:
            self._arrivals.popleft()  # lazily discard selected tickets
        return self._arrivals[0].t_submit if self._arrivals else None

    def _take(self, tenant: TenantId) -> Ticket:
        ticket = self._queues[tenant].popleft()
        ticket.flushed = True
        self._n_pending -= 1
        return ticket

    def _select(self, n: int) -> list[Ticket]:
        """Pick the next batch: DRR over active tenants, or global arrival
        order when ``fair=False``."""
        out: list[Ticket] = []
        if not self.fair:
            while len(out) < n and self._oldest_submit() is not None:
                ticket = self._arrivals.popleft()
                assert self._queues[ticket.tenant][0] is ticket
                out.append(self._take(ticket.tenant))
                if not self._queues[ticket.tenant]:
                    self._ring.remove(ticket.tenant)
                    self._deficit[ticket.tenant] = 0.0
            return out
        while len(out) < n and self._ring:
            tenant = self._ring.popleft()
            q = self._queues[tenant]
            if self._mid_turn:
                self._mid_turn = False  # resumed turn: leftover deficit only
            else:
                self._deficit[tenant] += self.quantum  # new round, new credit
            while q and self._deficit[tenant] >= 1 and len(out) < n:
                out.append(self._take(tenant))
                self._deficit[tenant] -= 1
            if not q:
                self._deficit[tenant] = 0.0  # DRR: idle tenants lose deficit
            elif len(out) < n:
                self._ring.append(tenant)    # spent its deficit this round
            elif self._deficit[tenant] >= 1:
                # batch filled mid-turn: keep the head slot AND the leftover
                # deficit, but no fresh credit on resume — otherwise a
                # quantum >= max_batch tenant would monopolize every flush
                self._ring.appendleft(tenant)
                self._mid_turn = True
            else:
                self._ring.append(tenant)  # turn ended exactly at the cap
        return out

    def _flush(self, now: float, reason: str) -> list[Ticket]:
        batch = self._select(min(self.max_batch, self._n_pending))
        # flush accounting happens at SELECTION time (under the lock) so
        # async workers never touch shared stats — only their own job
        for ticket in batch:
            self.stats.tenant_queries[ticket.tenant] = \
                self.stats.tenant_queries.get(ticket.tenant, 0) + 1
        self.stats.batches += 1
        self.stats.queries += len(batch)
        setattr(self.stats, f"flush_{reason}",
                getattr(self.stats, f"flush_{reason}") + 1)
        if self.obs.enabled:
            self.obs.counter("flushes", reason=reason)
            self.obs.observe("flush_batch", float(len(batch)))
        if self.executor is None:
            self._execute_batch(batch, None, now, pass_staged=False)
            return batch
        job = _FlushJob(tickets=batch, now=now)
        if self.stage is not None:
            # submitting-thread staging: the next batch's host→device
            # uploads are enqueued NOW (pinned buffers, the engine's side
            # stream), overlapping whatever kernel a worker is running;
            # the worker's stream waits on the staging event
            job.staged = self.stage(batch)
        job.future = self.executor.submit(self._run_job, job,
                                          label=f"flush:{reason}")
        for ticket in batch:
            ticket.future = job.future
        self._inflight.append(job)
        return batch

    def _run_job(self, job: _FlushJob) -> int:
        """Worker-side flush execution. Touches only the job's own tickets;
        needs no batcher lock (drain may hold it while waiting on us)."""
        self._execute_batch(job.tickets, job.staged, job.now,
                            pass_staged=self.stage is not None)
        return len(job.tickets)

    def _execute_batch(self, tickets: list[Ticket], staged, now: float,
                       pass_staged: bool) -> None:
        """Run + apply one selected batch (sync: submitting thread; async:
        worker thread). When observing, the batch gets ONE dispatch span
        and ONE merge span, built on whichever thread executes and adopted
        by reference into every served ticket's tree — that is how async
        flush spans parent back to the tickets they serve. The dispatch
        span is pushed as this thread's current span, so the engine's
        plan-group spans (with modeled HBM bytes) nest under it."""
        obs = self.obs
        if not obs.enabled:
            results = self.execute(tickets, staged) if pass_staged \
                else self.execute(tickets)
            self._apply_results(tickets, results, now)
            return
        t_x0 = obs.now()
        with obs.span("dispatch", t0=t_x0, batch=len(tickets)) as dsp:
            results = self.execute(tickets, staged) if pass_staged \
                else self.execute(tickets)
        t_x1 = dsp.t1
        self._apply_results(tickets, results, now)
        t_x2 = obs.now()
        msp = obs.span_at("merge", t_x1, t_x2, batch=len(tickets))
        obs.observe("dispatch_ms", (t_x1 - t_x0) * 1e3)
        for ticket in tickets:
            trace = ticket.trace
            if trace is None:
                continue
            t_enq = trace.marks.get("enqueued", t_x0)
            obs.span_at("flush_wait", t_enq, t_x0, parent=trace.root)
            trace.root.add(dsp)
            trace.root.add(msp)
            obs.end_trace(trace, t=t_x2)
            tenant = str(ticket.tenant)
            obs.observe("ticket_wall_ms", ticket.wall_wait_ms, tenant=tenant)
            obs.observe("flush_wait_ms", (t_x0 - t_enq) * 1e3, tenant=tenant)

    def _apply_results(self, batch: list[Ticket], results: list,
                       now: float) -> None:
        t_wall = time.time()
        for ticket, res in zip(batch, results):
            if hasattr(res, "ids"):  # ExecutionMetrics
                ticket.metrics = res
                ticket.ids = res.ids
            else:
                ticket.ids = res
            ticket.t_done = now
            ticket.t_done_wall = t_wall
            ticket.batch_size = len(batch)
            if ticket.cache_token is not None:
                # semcache admission: keyed at the CURRENT (generation,
                # epoch) — this result reflects the table at flush time
                ticket.cache_token.admit(ticket.ids)
                ticket.cache_token = None

    def _harvest(self, block: bool) -> list[Ticket]:
        """Collect tickets of landed flush jobs (async mode). ``block``
        waits for every in-flight job; tickets of failed jobs are returned
        too — their futures re-raise from ``Ticket.result``."""
        out: list[Ticket] = []
        keep: list[_FlushJob] = []
        for job in self._inflight:
            if block:
                drive_until(self.executor, job.future)
            if job.future.done():
                out.extend(job.tickets)
            else:
                keep.append(job)
        self._inflight = keep
        return out
