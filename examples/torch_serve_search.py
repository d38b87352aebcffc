"""End-to-end serving on the PyTorch/CUDA port: tune → build → compile the
request batch into plan groups → serve through the batched engine.

The batch of (query, plan) pairs is compiled so each (plan-group, index)
pair costs ONE kernel dispatch instead of one per query (DESIGN.md
§Serving). The counterpart of ``examples/serve_search.py``.

    PYTHONPATH=src python examples/torch_serve_search.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.tuner import Mint, ground_truth_cache
from repro_torch.core.types import Constraints
from repro_torch.data.vectors import make_database, make_queries, make_workload
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.compiler import compile_batch, dispatch_plan
from repro_torch.serve.engine import BatchEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card; cpu: plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db = make_database(3000, [("text", 128), ("image", 128), ("audio", 96)],
                       seed=1)
    workload = make_workload(db, "naive", k=20, seed=1)
    mint = Mint(db, index_kind="ivf", seed=1, device=device)
    result = mint.tune(workload, Constraints(theta_recall=0.85, theta_storage=3))
    gt = ground_truth_cache(db, workload)

    store = IndexStore(db, seed=1, device=device)
    engine = BatchEngine(db, store=store)

    print(f"serving the workload as ONE compiled batch on {device}:")
    pairs = [(q, result.plans[q.qid]) for q, _ in workload]
    t0 = time.time()
    metrics = engine.execute_batch(pairs, gt_cache=gt)
    dt = (time.time() - t0) * 1e3
    for (q, _), m in zip(workload, metrics):
        print(f"  {q.name}: top-{q.k}  recall={m.recall:.2f}  "
              f"cost={m.cost/1e6:.2f}M dim-dists")
    stats = dispatch_plan(compile_batch(pairs))
    print(f"batch: {dt:.1f} ms total — {stats['queries']} queries compiled "
          f"into {stats['groups']} plan groups, "
          f"{stats['batched_scan_dispatches']} scan dispatches "
          f"(vs {stats['per_query_scan_dispatches']} per-query); "
          f"counters={engine.counters.as_dict()}")

    # a burst of identical-signature queries on the hottest plan compiles
    # into ONE plan group
    q = workload.queries[-1]
    burst = make_queries(db, [q.vid] * 16, k=q.k, seed=7)
    burst_pairs = [(bq, result.plans[q.qid]) for bq in burst]
    engine.counters.reset()
    t0 = time.time()
    engine.search_batch(burst_pairs)
    dt = time.time() - t0
    n = len(burst)
    print(f"\nburst: {n} queries on {q.name} -> {dt/n*1e3:.1f} ms/query, "
          f"{engine.counters.scan} scan + {engine.counters.rerank} rerank "
          f"dispatches for the whole burst")
    return engine


if __name__ == "__main__":
    main()
