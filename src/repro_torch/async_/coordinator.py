"""Background-build coordinator (DESIGN.md §10).

The protocol every off-path rebuild in this codebase follows — async
compaction, pooled drift retunes, per-tenant loops:

  1. *cut* on the serving thread (cheap, under the serving locks): snapshot
     whatever the build needs;
  2. *build* on the executor (slow, PURE — touches no serving state, takes
     no serving locks, so a busy pool can never deadlock against a thread
     holding the batcher lock);
  3. *finalize* back on a serving thread, from ``poll()`` inside the tick
     loop (or ``wait()``): the atomic swap, under whatever locks the caller
     takes inside its finalize callback.

The coordinator enforces at most one in-flight build per key, records
failures without poisoning serving (a failed build is dropped and listed in
``failures``; finalize never runs for it), and keeps completion
deterministic under the StepExecutor harness: builds complete exactly when
the test steps them, and finalize runs exactly at the next ``poll``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.async_.executor import Future, drive_until


@dataclass
class BackgroundBuild:
    """One in-flight (or finished) background build."""

    key: object
    label: str
    future: Future
    finalize: object                 # Callable[[build result, now], event]
    t_submit: float
    event: object | None = None      # finalize's return value
    error: BaseException | None = None
    finalized: bool = False

    @property
    def built(self) -> bool:
        return self.future.done()

    def wait(self, timeout: float | None = None) -> bool:
        """Wait for the BUILD (not the finalize) to complete."""
        return self.future.wait(timeout)


@dataclass
class BuildFailure:
    key: object
    label: str
    error: BaseException
    t: float


class BuildCoordinator:
    """At most one in-flight background build per key."""

    def __init__(self, executor):
        self.executor = executor
        self._inflight: dict[object, BackgroundBuild] = {}
        self.completed: list[BackgroundBuild] = []
        self.failures: list[BuildFailure] = []
        # serializes the pop phase: two threads polling concurrently must
        # never both claim (and finalize) the same completed build
        self._lock = threading.Lock()

    def inflight(self, key: object = None) -> bool:
        if key is None:
            return bool(self._inflight)
        return key in self._inflight

    def submit(self, key: object, build_fn, finalize,
               label: str | None = None,
               now: float | None = None) -> BackgroundBuild | None:
        """Launch ``build_fn`` on the executor unless ``key`` already has a
        build in flight (returns None — the caller's trigger will re-fire).
        ``finalize(result, now)`` runs later, on the thread that polls."""
        with self._lock:
            if key in self._inflight:
                return None
            build = BackgroundBuild(
                key=key, label=label or f"build:{key}",
                future=self.executor.submit(build_fn,
                                            label=label or f"build:{key}"),
                finalize=finalize,
                t_submit=time.time() if now is None else now)
            self._inflight[key] = build
        return build

    def poll(self, now: float | None = None) -> list[BackgroundBuild]:
        """Finalize every completed build ON THIS THREAD. Returns the
        builds finalized by this call; build errors are recorded in
        ``failures`` (serving continues on the old state), finalize errors
        propagate to the caller — they mean the swap itself is broken."""
        with self._lock:
            done = [b for b in self._inflight.values() if b.built]
            for build in done:
                del self._inflight[build.key]
        out = []
        for build in done:
            exc = build.future.exception()
            if exc is not None:
                build.error = exc
                self.failures.append(BuildFailure(
                    key=build.key, label=build.label, error=exc,
                    t=time.time() if now is None else now))
                continue
            build.event = build.finalize(build.future.result(), now)
            build.finalized = True
            self.completed.append(build)
            out.append(build)
        return out

    def wait(self, key: object = None, timeout: float | None = None,
             now: float | None = None) -> list[BackgroundBuild]:
        """Block until the build(s) complete, then finalize them here."""
        with self._lock:
            if key is not None:
                builds = [self._inflight[key]] if key in self._inflight else []
            else:
                builds = list(self._inflight.values())
        for b in builds:
            if not drive_until(self.executor, b.future, timeout):
                raise TimeoutError(f"{b.label}: build still running "
                                   f"after {timeout}s")
        return self.poll(now)

    def stats(self) -> dict:
        return {"inflight": len(self._inflight),
                "completed": len(self.completed),
                "failures": len(self.failures)}
