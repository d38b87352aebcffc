"""Online serving on the PyTorch/CUDA port: steady traffic → drift →
background retune.

Tunes for a "day" workload, serves it through the micro-batching runtime
(the plan cache keeps the planner off the hot path), then lets the traffic
drift to "night" columns: the workload monitor detects the drift, the
background re-tuner re-runs MINT on the observed window, shadow-builds the
new configuration, and atomically swaps it in — watch the served cost drop.
The counterpart of ``examples/online_serve.py``.

    PYTHONPATH=src python examples/torch_online_serve.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.kernels.common import resolve_device
from repro_torch.online import OnlineRuntime, RuntimeConfig, diurnal_trace, steady_trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card; cpu: plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db = make_database(5000, [("image", 64), ("title", 48), ("audio", 80),
                              ("content", 64)], seed=2)
    day_qs = make_queries(db, [(0,), (0, 1), (1,)], k=10, seed=0)
    night_qs = make_queries(db, [(2,), (2, 3), (3,)], k=10, seed=1)
    day = Workload(queries=day_qs, probs=np.ones(3))
    night = Workload(queries=night_qs, probs=np.ones(3))
    cons = Constraints(theta_recall=0.85, theta_storage=3)

    mint = Mint(db, index_kind="ivf", seed=0, device=device)
    rt = OnlineRuntime(db, mint, day, cons, device=device, config=RuntimeConfig(
        max_batch=8, max_delay_ms=5.0, window=64, min_window=32,
        drift_threshold=0.35, cooldown_s=0.02, measure=True))
    print("tuned (day):", sorted(s.name for s in rt.result.configuration))

    steady = steady_trace(db, day, n=64, qps=1000.0, seed=3)
    tickets = rt.run_trace(steady)
    st = rt.stats()
    print(f"steady: {len(tickets)} queries in {st['batcher']['batches']} "
          f"micro-batches (mean {st['batcher']['mean_batch']:.1f}/batch), "
          f"plan-cache hit rate {st['plan_cache']['hit_rate']:.2f}, "
          f"mean cost {np.mean([t.metrics.cost for t in tickets]) / 1e3:.0f}K")

    drift = diurnal_trace(db, day, night, n=128, qps=1000.0, seed=4,
                          t0=1.0, qid_start=10_000)
    tickets = rt.run_trace(drift)
    for ev in rt.retune_events:
        print(f"retune @t={ev.t:.3f}s: drift={ev.drift:.2f} -> generation "
              f"{ev.generation}, est cost {ev.est_cost_before / 1e3:.0f}K -> "
              f"{ev.est_cost_after / 1e3:.0f}K ({ev.built} built, "
              f"{ev.dropped} dropped, tune {ev.tune_seconds * 1e3:.0f}ms)")
    print("serving (night):", sorted(s.name for s in rt.result.configuration))
    head, tail = tickets[:32], tickets[-32:]
    print(f"drift head: mean cost {np.mean([t.metrics.cost for t in head]) / 1e3:.0f}K"
          f"  recall {np.mean([t.metrics.recall for t in head]):.3f}")
    print(f"drift tail: mean cost {np.mean([t.metrics.cost for t in tail]) / 1e3:.0f}K"
          f"  recall {np.mean([t.metrics.recall for t in tail]):.3f}  "
          f"(re-tuned plans, plan cache generation {rt.generation})")
    rt.close()
    return rt


if __name__ == "__main__":
    main()
