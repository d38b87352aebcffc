"""Async serving pipeline substrate (DESIGN.md §10).

``executor``    : Future + the three executors (bounded ``WorkerPool``,
                  inline ``SerialExecutor``, deterministic ``StepExecutor``
                  test harness) and fault injection.
``coordinator`` : the cut → build-off-path → finalize-on-serving-thread
                  protocol used by async compaction and pooled retunes.
"""
from repro_torch.async_.coordinator import (BackgroundBuild, BuildCoordinator,
                                      BuildFailure)
from repro_torch.async_.executor import (FaultInjector, Future, InjectedCrash,
                                   PoolShutdown, SerialExecutor, StepExecutor,
                                   WorkerCrashed, WorkerPool)

__all__ = [
    "BackgroundBuild", "BuildCoordinator", "BuildFailure", "FaultInjector",
    "Future", "InjectedCrash", "PoolShutdown", "SerialExecutor",
    "StepExecutor", "WorkerCrashed", "WorkerPool",
]
