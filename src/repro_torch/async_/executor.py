"""Execution substrate for the async serving pipeline (DESIGN.md §10).

Three executors behind one ``submit(fn, *args) -> Future`` interface:

  - ``WorkerPool``     : a bounded pool of daemon worker threads — the
                         production form. ``submit`` blocks once
                         ``max_pending`` tasks are queued (backpressure, so
                         a stalled device can never grow an unbounded flush
                         queue), a task that raises fails only its own
                         future, and ``shutdown`` drains or cancels
                         deterministically (no deadlock mid-flush: pending
                         futures either run or fail with ``PoolShutdown``).
  - ``SerialExecutor`` : runs every task inline at ``submit`` — the
                         ``sync=True`` baseline; async results must be
                         bit-identical to it.
  - ``StepExecutor``   : the test harness. Tasks only run when the caller
                         steps them, on the CALLING thread, in an order
                         drawn from a seeded rng — injectable worker
                         interleavings without thread nondeterminism, plus
                         explicit fault injection (``crash_next`` fails a
                         task with ``WorkerCrashed`` as if its worker died).

Fault injection for the real pool goes through ``hooks``: a callable run on
the worker immediately before each task; raising ``InjectedCrash`` kills
the worker thread mid-task (the task's future fails with ``WorkerCrashed``
and a replacement worker is spawned so capacity is preserved), any other
exception fails just the task. ``FaultInjector`` is the seeded standard
hook (crash every Nth task, or tasks whose label matches).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.obs import NULL_OBSERVER

_PENDING = "pending"
_RUNNING = "running"
_DONE = "done"
_ERROR = "error"
_CANCELLED = "cancelled"


class WorkerCrashed(RuntimeError):
    """The worker executing this task died before completing it."""


class InjectedCrash(WorkerCrashed):
    """Raised by fault-injection hooks: kill the worker mid-task."""


class PoolShutdown(RuntimeError):
    """Submitted after shutdown, or cancelled by ``shutdown(cancel_pending=True)``."""


class Future:
    """Completion handle for one submitted task.

    Minimal by design (result/exception/wait/done + internal setters) so
    the deterministic harness can drive state transitions explicitly;
    ``result`` re-raises the task's exception, ``WorkerCrashed`` when the
    worker died, or ``PoolShutdown`` when the task was cancelled."""

    def __init__(self, label: str = "task"):
        self.label = label
        self._cond = threading.Condition()
        self._state = _PENDING
        self._result = None
        self._exc: BaseException | None = None
        self._callbacks: list[Callable] = []

    # ---- caller side ------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def done(self) -> bool:
        return self._state in (_DONE, _ERROR, _CANCELLED)

    def wait(self, timeout: float | None = None) -> bool:
        with self._cond:
            self._cond.wait_for(self.done, timeout)
            return self.done()

    def result(self, timeout: float | None = None):
        if not self.wait(timeout):
            raise TimeoutError(f"{self.label}: no result after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self.wait(timeout):
            raise TimeoutError(f"{self.label}: still pending after {timeout}s")
        return self._exc

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        with self._cond:
            if not self.done():
                self._callbacks.append(cb)
                return
        cb(self)

    # ---- executor side ----------------------------------------------------

    def _set_running(self) -> bool:
        with self._cond:
            if self._state != _PENDING:
                return False
            self._state = _RUNNING
            return True

    def _finish(self, state: str, result=None, exc: BaseException | None = None) -> bool:
        with self._cond:
            if self.done():
                return False
            self._state, self._result, self._exc = state, result, exc
            callbacks, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for cb in callbacks:
            cb(self)
        return True

    def set_result(self, result) -> bool:
        return self._finish(_DONE, result=result)

    def set_exception(self, exc: BaseException) -> bool:
        return self._finish(_ERROR, exc=exc)

    def cancel(self, exc: BaseException | None = None) -> bool:
        return self._finish(_CANCELLED,
                            exc=exc or PoolShutdown(f"{self.label}: cancelled"))


class _Task:
    __slots__ = ("fn", "args", "future")

    def __init__(self, fn, args, future):
        self.fn, self.args, self.future = fn, args, future

    def run(self, hooks=None) -> None:
        """Execute on the current thread. ``InjectedCrash`` propagates to
        the caller (the worker loop turns it into a dead worker) AFTER
        failing this task's future with ``WorkerCrashed``."""
        if not self.future._set_running():
            return  # cancelled while queued
        try:
            if hooks is not None:
                hooks(self.future.label)
            result = self.fn(*self.args)
        except InjectedCrash as e:
            self.future.set_exception(
                WorkerCrashed(f"{self.future.label}: worker crashed ({e})"))
            raise
        except BaseException as e:  # noqa: BLE001 — task isolation boundary
            self.future.set_exception(e)
        else:
            self.future.set_result(result)


class FaultInjector:
    """Deterministic crash schedule for ``WorkerPool`` hooks: crashes the
    ``crash_on`` 1-indexed task(s), and/or every task whose label contains
    ``label_match``. Counting is global across workers (guarded)."""

    def __init__(self, crash_on: tuple[int, ...] = (),
                 label_match: str | None = None):
        self.crash_on = set(crash_on)
        self.label_match = label_match
        self.seen = 0
        self._lock = threading.Lock()

    def __call__(self, label: str) -> None:
        with self._lock:
            self.seen += 1
            n = self.seen
        if n in self.crash_on:
            raise InjectedCrash(f"scheduled crash at task #{n}")
        if self.label_match is not None and self.label_match in label:
            raise InjectedCrash(f"label match {self.label_match!r}")


def _task_kind(label: str) -> str:
    """Bounded-cardinality metric label: 'flush:size' -> 'flush',
    'retune@12.5' -> 'retune'."""
    return label.split(":", 1)[0].split("@", 1)[0]


def _observed_run(obs, task: _Task, hooks) -> None:
    """Run one task, reporting duration/count (and crash events) through
    the observer. Executors share this so pool threads and the seeded
    StepExecutor harness produce the same metric series."""
    if not obs.enabled:
        task.run(hooks)
        return
    kind = _task_kind(task.future.label)
    t0 = time.perf_counter()
    try:
        task.run(hooks)
    except InjectedCrash:
        obs.event("worker_crash", label=task.future.label)
        raise
    finally:
        obs.observe("executor_task_ms", (time.perf_counter() - t0) * 1e3,
                    kind=kind)
        obs.counter("executor_tasks", kind=kind)


def drive_until(executor, future: Future, timeout: float | None = None) -> bool:
    """Wait for ``future`` to complete. On a caller-driven executor (one
    with a ``drive()`` method, i.e. the StepExecutor harness) this RUNS
    pending tasks — in the executor's seeded order — instead of blocking,
    so a drain/wait from serving code can never deadlock the harness."""
    drive = getattr(executor, "drive", None)
    if drive is not None:
        while not future.done():
            if not drive():
                break
    return future.wait(timeout)


class SerialExecutor:
    """Inline execution at submit — the sync baseline (and the degenerate
    executor for environments without threads)."""

    def __init__(self, hooks: Callable[[str], None] | None = None,
                 observer=None):
        self.hooks = hooks
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.submitted = 0
        self.order: list[str] = []  # labels in execution order

    def submit(self, fn, *args, label: str = "task") -> Future:
        fut = Future(label)
        self.submitted += 1
        self.order.append(label)
        try:
            _observed_run(self.obs, _Task(fn, args, fut), self.hooks)
        except InjectedCrash:
            pass  # future already failed with WorkerCrashed
        return fut

    def inflight(self) -> int:
        return 0

    def shutdown(self, wait: bool = True, cancel_pending: bool = False) -> None:
        pass


class WorkerPool:
    """Bounded thread pool with crash isolation and clean shutdown."""

    _STOP = object()

    def __init__(self, workers: int = 2, max_pending: int | None = 256,
                 name: str = "pool", hooks: Callable[[str], None] | None = None,
                 observer=None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.name = name
        self.hooks = hooks
        self.obs = observer if observer is not None else NULL_OBSERVER
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending or 0)
        self._lock = threading.Lock()
        self._closed = False
        self._inflight = 0            # queued or running tasks
        self._idle = threading.Condition(self._lock)
        self._threads: list[threading.Thread] = []
        self._tid = itertools.count()
        self.crashed_workers = 0
        for _ in range(workers):
            self._spawn()

    def _spawn(self) -> None:
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"{self.name}-{next(self._tid)}")
        self._threads.append(t)
        t.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is self._STOP:
                return
            try:
                _observed_run(self.obs, item, self.hooks)
            except InjectedCrash:
                # this worker is "dead": replace it so capacity survives a
                # crash, unless the pool is already shutting down
                with self._lock:
                    self.crashed_workers += 1
                    self._threads.remove(threading.current_thread())
                    if not self._closed:
                        self._spawn()
                    self._task_done()
                return
            with self._lock:
                self._task_done()

    def _task_done(self) -> None:
        self._inflight -= 1
        if self._inflight == 0:
            self._idle.notify_all()

    def submit(self, fn, *args, label: str = "task") -> Future:
        with self._lock:
            if self._closed:
                raise PoolShutdown(f"{self.name}: submit after shutdown")
            self._inflight += 1
        fut = Future(label)
        try:
            self._queue.put(_Task(fn, args, fut))  # blocks at max_pending
        except BaseException:
            with self._lock:
                self._task_done()
            raise
        # a shutdown may have slipped between the closed-check and the put,
        # landing this task BEHIND the stop sentinels where no worker will
        # ever pop it: cancel the future so waiters fail with PoolShutdown
        # instead of hanging. Completion is single-shot, so if a worker DID
        # get to the task first the cancel is a no-op — and if the cancel
        # wins, the worker (or shutdown's drain) still accounts the task.
        if self._closed:
            fut.cancel(PoolShutdown(f"{self.name}: shut down during submit"))
        return fut

    def inflight(self) -> int:
        return self._inflight

    def join(self, timeout: float | None = None) -> bool:
        """Wait until no task is queued or running."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0, timeout)

    def shutdown(self, wait: bool = True, cancel_pending: bool = False) -> None:
        """Idempotent. ``cancel_pending`` fails queued-but-unstarted futures
        with ``PoolShutdown`` instead of running them; running tasks always
        finish (workers only check the stop sentinel between tasks), so a
        shutdown mid-flush never deadlocks and never abandons a future."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
        if cancel_pending:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is self._STOP:
                    continue
                if item.future.cancel():
                    with self._lock:
                        self._task_done()
        for _ in threads:
            self._queue.put(self._STOP)
        if wait:
            for t in threads:
                t.join()
            # tasks a racing submit() enqueued behind the sentinels have no
            # worker left: cancel and account them so join() can't hang
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is self._STOP:
                    continue
                item.future.cancel(PoolShutdown(f"{self.name}: shut down"))
                with self._lock:
                    self._task_done()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)


class StepExecutor:
    """Deterministic harness executor: nothing runs until stepped.

    ``submit`` only queues; ``run_next()`` executes ONE task on the calling
    thread — by explicit index, or drawn from the seeded rng (uniform over
    the queue) so a test seed fully determines the interleaving. Determinism
    holds because tasks in this system are pure builds/flushes whose
    *completion order* is the only scheduling freedom; running them on the
    caller serializes memory effects while still permuting that order."""

    def __init__(self, seed: int | None = None,
                 hooks: Callable[[str], None] | None = None,
                 observer=None):
        self.rng = np.random.default_rng(seed)
        self.seeded = seed is not None
        self.hooks = hooks
        self.obs = observer if observer is not None else NULL_OBSERVER
        self._pending: list[_Task] = []
        self._closed = False
        self.ran: list[str] = []  # labels in the order they executed

    def submit(self, fn, *args, label: str = "task") -> Future:
        if self._closed:
            raise PoolShutdown("StepExecutor: submit after shutdown")
        fut = Future(label)
        self._pending.append(_Task(fn, args, fut))
        return fut

    def pending(self) -> list[str]:
        return [t.future.label for t in self._pending]

    def inflight(self) -> int:
        return len(self._pending)

    def _pick(self, index: int | None) -> _Task:
        if index is None:
            index = int(self.rng.integers(len(self._pending))) if self.seeded else 0
        return self._pending.pop(index)

    def run_next(self, index: int | None = None) -> Future:
        if not self._pending:
            raise IndexError("StepExecutor: nothing pending")
        task = self._pick(index)
        try:
            _observed_run(self.obs, task, self.hooks)
        except InjectedCrash:
            pass
        self.ran.append(task.future.label)
        return task.future

    def run_all(self) -> list[Future]:
        out = []
        while self._pending:
            out.append(self.run_next())
        return out

    def drive(self) -> bool:
        """Make progress on behalf of a blocking waiter: run ONE pending
        task (seeded order). Blocking waits (batcher drain, coordinator
        wait) call this so the deterministic harness can't deadlock —
        the interleaving stays fully determined by the seed."""
        if not self._pending:
            return False
        self.run_next()
        return True

    def crash_next(self, index: int | None = None) -> Future:
        """Fail one pending task as if its worker died mid-run."""
        if not self._pending:
            raise IndexError("StepExecutor: nothing pending")
        task = self._pick(index)
        task.future._set_running()
        task.future.set_exception(
            WorkerCrashed(f"{task.future.label}: worker crashed (injected)"))
        self.obs.event("worker_crash", label=task.future.label)
        self.ran.append(task.future.label)
        return task.future

    def shutdown(self, wait: bool = True, cancel_pending: bool = False) -> None:
        self._closed = True
        if cancel_pending:
            pending, self._pending = self._pending, []
            for t in pending:
                t.future.cancel()
        elif wait:
            self.run_all()
