"""Drift-aware background re-tuner (DESIGN.md §7, §10).

When the drift detector fires, the re-tuner rebuilds a tuning workload from
the monitor's observation window, re-runs ``Mint.retune`` (estimators are
reused; the beam is warm-started from the serving configuration),
shadow-builds every index of the winning configuration through the live
``IndexStore`` (invisible to serving — plans of the old generation never
reference them), and then asks the runtime for an atomic swap: tuning
result + plan-cache generation + store prune under the same storage
constraint.

Three modes:
  - ``sync``   (default): everything inline — deterministic for tests.
  - ``thread``: a daemon thread runs tune + build + swap off the caller.
  - ``pool``   (DESIGN.md §10): the coordinator protocol — the *cut*
    (observed workload + stale-cost probe) happens on the serving thread at
    fire time, the tune + shadow-build run as a PURE task on the shared
    worker pool (no serving locks, so a busy pool can never deadlock the
    batcher), and the swap is finalized on the serving thread at the next
    ``maybe_retune``/``poll`` tick. Flushes keep landing the whole time.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.async_.coordinator import BuildCoordinator
from repro_torch.obs import NULL_OBSERVER

_RETUNE_KEY = "retune"


@dataclass
class RetuneEvent:
    t: float
    drift: float
    generation: int            # generation AFTER the swap
    window: int                # observation-window size used
    est_cost_before: float     # stale config's estimated cost on the window
    est_cost_after: float      # re-tuned estimated cost on the window
    config_before: int         # |configuration|
    config_after: int
    built: int                 # indexes shadow-built for the swap
    dropped: int               # stale indexes pruned after the swap
    tune_seconds: float


class BackgroundRetuner:
    """Owns the drift → retune → shadow-build → swap lifecycle."""

    def __init__(self, runtime, cooldown_s: float = 60.0, mode: str = "sync",
                 reps_per_vid: int = 3, executor=None):
        if mode not in ("sync", "thread", "pool"):
            raise ValueError(f"unknown retune mode {mode!r}")
        if mode == "pool" and executor is None:
            raise ValueError("retune mode 'pool' needs an executor")
        self.runtime = runtime
        self.cooldown_s = cooldown_s
        self.mode = mode
        self.reps_per_vid = reps_per_vid
        self.events: list[RetuneEvent] = []
        self._last_fire: float | None = None
        self._worker: threading.Thread | None = None
        self.builds = BuildCoordinator(executor) if mode == "pool" else None

    @property
    def obs(self):
        # the runtime owns the observer; proxies (tenant retune views)
        # forward it, and anything without one gets the no-op
        return getattr(self.runtime, "observer", NULL_OBSERVER)

    @property
    def inflight(self) -> bool:
        if self.builds is not None and self.builds.inflight(_RETUNE_KEY):
            return True
        return self._worker is not None and self._worker.is_alive()

    def poll(self, now: float) -> RetuneEvent | None:
        """Finalize a completed pool-mode tune (the swap runs HERE, on the
        serving thread). None when nothing is ready."""
        if self.builds is None:
            return None
        done = self.builds.poll(now)
        return done[0].event if done else None

    def maybe_retune(self, now: float) -> RetuneEvent | None:
        """Called from the serving loop's tick. Finalizes any completed
        background tune first; fires at most once per cooldown, and never
        while a tune is in flight."""
        finished = self.poll(now)
        if finished is not None:
            return finished
        if self.inflight:
            return None
        if self._last_fire is not None and now - self._last_fire < self.cooldown_s:
            return None
        report = self.runtime.detector.check(self.runtime.monitor)
        if not report.drifted:
            return None
        self.obs.event("drift_detected", drift=float(report.drift),
                       window=len(self.runtime.monitor), fired_at=now)
        self._last_fire = now
        if self.mode == "thread":
            self._worker = threading.Thread(
                target=self._retune, args=(now, report.drift), daemon=True)
            self._worker.start()
            return None
        if self.mode == "pool":
            cut = self._cut(now, report.drift)
            self.builds.submit(
                _RETUNE_KEY, lambda: self._tune_build(cut),
                finalize=lambda tuned, t: self._finish(cut, tuned, t),
                label=f"retune@{now:.3f}", now=now)
            return None
        return self._retune(now, report.drift)

    def join(self, timeout: float | None = None,
             now: float | None = None) -> None:
        """Wait for any in-flight tune; pool mode also finalizes it here."""
        if self._worker is not None:
            self._worker.join(timeout)
        if self.builds is not None and self.builds.inflight(_RETUNE_KEY):
            self.builds.wait(_RETUNE_KEY, timeout=timeout, now=now)

    # ---- lifecycle pieces (cut → tune/build → finish) ---------------------

    def _cut(self, now: float, drift: float) -> dict:
        """Serving-thread snapshot at fire time: the observed workload and
        the stale-cost probe (both read monitor/cache state that mutates
        under serving, so they must not run on a worker)."""
        rt = self.runtime
        observed = rt.monitor.observed_workload(reps_per_vid=self.reps_per_vid)
        # Stale-cost probe via peek(): served queries are always templated
        # (plan_for caches on miss), and a counter-free read keeps the
        # exported hit-rate metric pure serving traffic. The rare untemplated
        # query is costed as the flat-scan fallback the stale config would
        # serve it with.
        stale_cost = 0.0
        for q, p in observed:
            plan = rt.cache.peek(q)
            stale_cost += p * (plan.est_cost if plan is not None
                               else q.dim() * float(rt.db.n_rows))
        return {"now": now, "drift": drift, "observed": observed,
                "stale_cost": float(stale_cost),
                "config_before": len(rt.result.configuration),
                "window": len(rt.monitor), "t0": time.time()}

    def _tune_build(self, cut: dict) -> dict:
        """PURE off-path work: retune + shadow-build. Touches no serving
        state (shadow-built indexes are invisible until the swap installs
        plans that reference them) and takes no serving locks."""
        rt = self.runtime
        result = rt.mint.retune(cut["observed"], rt.constraints,
                                warm_start=rt.result)
        built = 0
        for spec in result.configuration:  # shadow build: not yet serving
            if spec not in rt.store:
                rt.store.get(spec)
                built += 1
        return {"result": result, "built": built,
                "tune_seconds": time.time() - cut["t0"]}

    def _finish(self, cut: dict, tuned: dict, now: float | None) -> RetuneEvent:
        """Serving-thread swap + event record."""
        rt = self.runtime
        result = tuned["result"]
        dropped = rt.swap(result, cut["observed"],
                          now=cut["now"] if now is None else now)
        event = RetuneEvent(
            t=cut["now"], drift=cut["drift"], generation=rt.cache.generation,
            window=cut["window"],
            est_cost_before=cut["stale_cost"],
            est_cost_after=float(result.est_workload_cost),
            config_before=cut["config_before"],
            config_after=len(result.configuration),
            built=tuned["built"], dropped=dropped,
            tune_seconds=tuned["tune_seconds"])
        self.events.append(event)
        self.obs.event("retune_swap", generation=event.generation,
                       drift=event.drift, built=event.built,
                       dropped=event.dropped,
                       tune_seconds=event.tune_seconds)
        return event

    def _retune(self, now: float, drift: float) -> RetuneEvent:
        cut = self._cut(now, drift)
        return self._finish(cut, self._tune_build(cut), now)
