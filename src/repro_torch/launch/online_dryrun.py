"""Dry-run of the online scheduler: micro-batching efficiency vs the
flush-deadline knob, with no data plane (hypothetical plans, null executor).

For each ``max_delay_ms`` setting, replays the same synthetic arrival
stream through a ``MicroBatcher`` and counts the kernel dispatches the
flushed plan groups WOULD cost (``serve.compiler.dispatch_plan``) — the
scheduling analogue of ``launch/search_dryrun.py``'s collective schedule:
how much batch formation amortizes dispatch overhead before any kernel
runs, and what queueing delay buys that amortization.

    PYTHONPATH=src python -m repro_torch.launch.online_dryrun [--queries 512]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.core.types import IndexSpec, Query, QueryPlan
from repro_torch.online.scheduler import MicroBatcher
from repro_torch.serve.compiler import compile_batch, dispatch_plan


def synthetic_stream(n_queries: int, qps: float, seed: int = 0):
    """Timed (query, plan) arrivals over a 3-column schema — same
    hypothetical-plan construction as search_dryrun.plan_group_stats."""
    rng = np.random.default_rng(seed)
    specs = [IndexSpec(vid=(c,), kind="ivf") for c in range(3)]
    t = 0.0
    out = []
    for qid in range(n_queries):
        t += float(rng.exponential(1.0 / qps))
        vid = tuple(sorted(rng.choice(3, size=int(rng.integers(1, 4)),
                                      replace=False).tolist()))
        q = Query(qid=qid, vid=vid,
                  vectors={c: np.zeros(8, np.float32) for c in vid}, k=50)
        used = [s for s in specs if s.vid[0] in vid]
        eks = [int(rng.choice([50, 100, 150]))] * len(used)
        out.append((t, q, QueryPlan(qid, used, eks, 0.0, 1.0)))
    return out


def run_schedule(stream, max_batch: int, max_delay_ms: float) -> dict:
    totals = {"batched_scan_dispatches": 0, "per_query_scan_dispatches": 0}
    batches = []

    def execute(tickets):
        stats = dispatch_plan(compile_batch([(t.query, t.plan)
                                             for t in tickets]))
        totals["batched_scan_dispatches"] += stats["batched_scan_dispatches"]
        totals["per_query_scan_dispatches"] += stats["per_query_scan_dispatches"]
        batches.append(len(tickets))
        return [None] * len(tickets)

    plans = {q.qid: plan for _, q, plan in stream}
    mb = MicroBatcher(execute, plan_for=lambda q: plans[q.qid],
                      max_batch=max_batch, max_delay_ms=max_delay_ms)
    tickets = []
    for t, q, _ in stream:
        tickets.append(mb.submit(q, now=t))
        mb.poll(now=t)
    mb.drain(now=stream[-1][0])
    waits = [tk.wait_ms for tk in tickets]
    return {
        "max_delay_ms": max_delay_ms,
        "max_batch": max_batch,
        "batches": len(batches),
        "mean_batch": float(np.mean(batches)),
        "mean_wait_ms": float(np.mean(waits)),
        "p99_wait_ms": float(np.percentile(waits, 99)),
        "batched_scan_dispatches": totals["batched_scan_dispatches"],
        "per_query_scan_dispatches": totals["per_query_scan_dispatches"],
        "dispatch_reduction": (totals["per_query_scan_dispatches"]
                               / max(totals["batched_scan_dispatches"], 1)),
        "flush_reasons": mb.stats.as_dict(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--qps", type=float, default=2000.0)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--out", default="experiments/torch_online_dryrun.json")
    args = ap.parse_args()

    stream = synthetic_stream(args.queries, args.qps)
    out = []
    for delay in (0.5, 2.0, 5.0, 10.0, 25.0):
        rec = run_schedule(stream, args.max_batch, delay)
        out.append(rec)
        print(f"delay={delay:5.1f}ms: {rec['batches']:4d} batches "
              f"(mean {rec['mean_batch']:5.1f}), dispatch reduction "
              f"{rec['dispatch_reduction']:5.2f}x, p99 wait "
              f"{rec['p99_wait_ms']:5.1f}ms")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
