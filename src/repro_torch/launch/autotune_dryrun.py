"""Auto-tuner dry run: deterministic trace replay + knob search on a
small captured scenario (DESIGN.md §15).

Normal mode prints the Pareto front for one scenario; ``--smoke`` is the
CI fast-lane gate — a tiny trace, 4 trials, asserting (1) two replays of
the selected config produce identical fingerprints AND objectives, and
(2) the feasible front is non-empty. Exits non-zero on failure. Replays run
on ``--device`` (default: the CUDA card; ``cpu`` runs the kernels' plain
versions).

    PYTHONPATH=src python -m repro_torch.launch.autotune_dryrun --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.autotune_dryrun \\
        --scenario churn --trials 12 --json
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.autotune import (AutoTuner, ReplayScenario, TunerConfig,
                                  replay, serving_space)


def _scenario(name: str, rows: int, queries: int, seed: int,
              index_kind: str) -> ReplayScenario:
    return ReplayScenario(name=name, index_kind=index_kind, rows=rows,
                          n_queries=queries, seed=seed,
                          min_sample_rows=max(32, rows // 2))


def _fmt_trial(t) -> str:
    o = t.objectives
    return (f"trial {t.trial_id:>3}  p99 {o['p99_ms']:8.2f} ms  "
            f"thpt {o['throughput_qps']:8.1f} q/s  "
            f"bytes {o['device_bytes'] / 1e6:7.2f} MB  "
            f"recall {o['recall_mean']:.4f}  fp {t.fingerprint}")


def smoke(seed: int, device=None) -> int:
    """Tiny-trace determinism + feasibility gate (CI fast lane)."""
    scenario = _scenario("steady", rows=120, queries=16, seed=seed,
                         index_kind="flat")
    space = serving_space()
    tuner = AutoTuner(scenario, space=space,
                      config=TunerConfig(n_trials=4, fidelities=(0.5, 1.0),
                                         seed=seed,
                                         warm_start=(space.defaults(),)),
                      device=device)
    report = tuner.run()
    if not report.front:
        print(f"SMOKE FAIL: empty feasible front "
              f"(diagnostic: {report.diagnostic})")
        return 1
    best = report.best
    again = replay(scenario, best.params, seed=best.seed, device=device)
    if again.fingerprint != best.fingerprint:
        print(f"SMOKE FAIL: replay fingerprint {again.fingerprint} != "
              f"logged {best.fingerprint}")
        return 1
    if again.objectives != best.objectives:
        print(f"SMOKE FAIL: replay objectives {again.objectives} != "
              f"logged {best.objectives}")
        return 1
    print(f"autotune smoke OK: front={len(report.front)} "
          f"best p99 {best.objectives['p99_ms']:.2f} ms at recall "
          f"{best.objectives['recall_mean']:.4f}; determinism verified "
          f"(fp {best.fingerprint})")
    return 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: tiny trace, 4 trials, assert "
                         "determinism + non-empty front")
    ap.add_argument("--scenario", default="steady",
                    choices=("steady", "churn", "tenant_skew"))
    ap.add_argument("--index-kind", default="flat",
                    choices=("flat", "ivf", "hnsw"))
    ap.add_argument("--rows", type=int, default=400)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device of the replays (default: the CUDA card)")
    args = ap.parse_args()
    if args.smoke:
        sys.exit(smoke(args.seed, args.device))
    scenario = _scenario(args.scenario, args.rows, args.queries, args.seed,
                         args.index_kind)
    space = serving_space(churn=scenario.churn)
    tuner = AutoTuner(scenario, space=space,
                      config=TunerConfig(n_trials=args.trials,
                                         fidelities=(0.25, 0.5, 1.0),
                                         seed=args.seed,
                                         warm_start=(space.defaults(),)),
                      device=args.device)
    report = tuner.run()
    if args.json:
        print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
        return
    print(f"scenario {scenario.name} ({scenario.index_kind}), "
          f"{len(report.trials)} trials, theta={report.theta_recall}")
    if report.front:
        print("Pareto front (feasible, non-dominated):")
        for t in report.front:
            print("  " + _fmt_trial(t))
        print("best params:", json.dumps(report.best.params, sort_keys=True,
                                         default=str))
    else:
        print(f"EMPTY front — {report.diagnostic}")


if __name__ == "__main__":
    main()
