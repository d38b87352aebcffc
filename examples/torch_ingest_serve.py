"""Streaming ingest on the PyTorch/CUDA port: churn → compaction →
data-drift retune.

Serves a tuned table while an insert/delete stream mutates it live: new
rows are visible at the next flush (delta scan merged with the indexed
base), deleted rows never surface (tombstone mask inside the scan), the
compactor folds the delta back into the base when it grows past policy,
and when the ingested data DRIFTS away from what the configuration was
tuned for, the data-drift detector fires a compact + estimator retrain +
retune. The counterpart of ``examples/ingest_serve.py``.

    PYTHONPATH=src python examples/torch_ingest_serve.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.ingest import CompactionPolicy, IngestConfig, IngestRuntime
from repro_torch.kernels.common import resolve_device
from repro_torch.online import RuntimeConfig, churn_trace
from repro_torch.online.trace import TimedMutation


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card; cpu: plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cols = [("image", 64), ("title", 48), ("content", 64)]
    db = make_database(4000, cols, seed=2)
    drift_db = make_database(4000, cols, seed=77, spread=2.5, correlation=0.1)
    qs = make_queries(db, [(0,), (0, 1), (1, 2)], k=10, seed=0)
    wl = Workload(queries=qs, probs=np.ones(3))
    cons = Constraints(theta_recall=0.85, theta_storage=3)

    mint = Mint(db, index_kind="ivf", seed=0, device=device)
    rt = IngestRuntime(
        db, mint, wl, cons, device=device,
        config=RuntimeConfig(max_batch=8, max_delay_ms=5.0, window=64,
                             min_window=32, drift_threshold=2.0,
                             cooldown_s=1e9, measure=True),
        ingest=IngestConfig(
            policy=CompactionPolicy(max_delta_fraction=0.1,
                                    max_dead_fraction=0.15),
            min_mutated_rows=600, churn_threshold=0.25,
            data_cooldown_s=0.0))
    print(f"tuned: {sorted(s.name for s in rt.result.configuration)}")

    trace = churn_trace(db, wl, n=300, qps=500.0, mutation_rate=0.4,
                        batch=16, mix=(0.7, 0.3, 0.0),
                        insert_source=drift_db, query_drift=0.6, seed=1)
    n_mut = sum(isinstance(e, TimedMutation) for e in trace)
    print(f"replaying {len(trace) - n_mut} queries + {n_mut} mutation batches")
    tickets = rt.run_mixed_trace(trace)

    recalls = [t.metrics.recall for t in tickets]
    print(f"\nserved {len(tickets)} queries under churn; "
          f"mean recall {np.mean(recalls):.3f} "
          f"(tail {np.mean(recalls[-30:]):.3f})")
    print(f"table: {rt.table.stats()}")
    for ev in rt.compaction_events:
        print(f"  compaction [{ev.reason}]: {ev.rows_before} -> "
              f"{ev.rows_after} rows, gen {ev.generation}, "
              f"{ev.build_seconds * 1e3:.0f} ms build")
    for ev in rt.data_retune_events:
        print(f"  data retune [{ev.reason}]: churn {ev.churn_fraction:.2f}, "
              f"config {ev.config_before} -> {ev.config_after}, "
              f"gen {ev.generation}, {ev.tune_seconds:.1f}s")
    print(f"final generation: {rt.generation}; "
          f"serving {sorted(s.name for s in rt.result.configuration)}")
    rt.close()
    return rt


if __name__ == "__main__":
    main()
