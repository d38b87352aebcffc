"""Gate: the observability seam must be free when disabled and cheap when
enabled (DESIGN.md §14) — the port's counterpart of
``scripts/obs_overhead.py``.

Runs the same steady hot-item scenario with the observer off and on,
interleaved over several repeats (so machine noise hits both arms), and
fails if

  - results are not bit-identical between the two modes (observability
    must be strictly read-only), or
  - the disabled mode retains ANY observer state (traces, metrics,
    timeline) — the NULL seam must be structurally inert, or
  - the enabled mode's median-of-repeats p99 ticket wall wait regresses
    more than 5% + 2 ms absolute slack over the disabled mode.

    PYTHONPATH=src python -m repro_torch.launch.obs_overhead [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import NULL_OBSERVER
from repro_torch.online import OnlineRuntime, RuntimeConfig, hot_item_trace

REPEATS = 3
REL_SLACK = 1.05
ABS_SLACK_MS = 2.0


def build(device):
    db = make_database(800, [("a", 24), ("b", 32)], seed=0)
    qs = make_queries(db, [(0,), (0, 1), (1,)], k=8, seed=7)
    wl = Workload(queries=qs, probs=np.ones(len(qs)))
    cons = Constraints(theta_recall=0.85, theta_storage=3)
    mint = Mint(db, index_kind="ivf", seed=0, min_sample_rows=400, device=device)
    tuned = mint.tune(wl, cons)
    trace = hot_item_trace(db, vid=(0,), n=120, qps=2000.0, n_hot=4,
                           p_hot=0.85, k=8, seed=7, noise=0.1,
                           qid_start=500_000)
    return db, mint, wl, cons, tuned, trace


def run_once(db, mint, wl, cons, tuned, trace, observe, device):
    rt = OnlineRuntime(db, mint, wl, cons, result=tuned,
                       store=IndexStore(db, seed=0, device=device),
                       config=RuntimeConfig(max_batch=8, max_delay_ms=5.0,
                                            cooldown_s=1e9,
                                            drift_threshold=2.0,
                                            semcache=True,
                                            semcache_epsilon=0.1,
                                            observe=observe))
    rt.run_trace(trace[:24])  # warm kernels + plan cache
    t0 = time.perf_counter()
    tickets = rt.run_trace(trace)
    wall_s = time.perf_counter() - t0
    ids = [np.asarray(t.result(timeout=60)) for t in tickets]
    waits = sorted(max(t.wall_wait_ms, 0.0) for t in tickets)
    p99 = waits[min(len(waits) - 1, int(0.99 * len(waits)))]
    obs = rt.observer
    rt.close()
    return ids, p99, wall_s, obs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card; cpu: plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db, mint, wl, cons, tuned, trace = build(device)
    run_once(db, mint, wl, cons, tuned, trace, False, device)  # warm-up

    p99s = {False: [], True: []}
    ids = {}
    failures = []
    for rep in range(REPEATS):
        for observe in (False, True):  # interleaved: noise hits both arms
            out, p99, wall_s, obs = run_once(db, mint, wl, cons, tuned,
                                             trace, observe, device)
            p99s[observe].append(p99)
            ids[observe] = out
            print(f"rep {rep} observe={observe}: p99={p99:.3f}ms "
                  f"wall={wall_s * 1e3:.1f}ms")
            if not observe:
                # the NULL seam must hold NO state whatsoever
                if obs is not NULL_OBSERVER or obs.traces or \
                        obs.metrics is not None or obs.timeline is not None:
                    failures.append("disabled mode retained observer state")
        if not all(np.array_equal(a, b)
                   for a, b in zip(ids[False], ids[True])):
            failures.append(f"rep {rep}: results differ between observer "
                            "off and on (observability must be read-only)")

    off = statistics.median(p99s[False])
    on = statistics.median(p99s[True])
    limit = off * REL_SLACK + ABS_SLACK_MS
    print(f"median p99 on {device}: off={off:.3f}ms on={on:.3f}ms "
          f"limit={limit:.3f}ms (x{REL_SLACK} + {ABS_SLACK_MS}ms)")
    if on > limit:
        failures.append(f"enabled-observer p99 {on:.3f}ms exceeds "
                        f"{limit:.3f}ms")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print("obs-overhead:", "FAIL" if failures else "OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
