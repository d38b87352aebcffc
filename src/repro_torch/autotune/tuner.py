"""Multi-objective knob search over deterministic replays (DESIGN.md §15).

VDTuner-style loop, adapted to a replayable runtime:

  1. **Seeding**: Latin-hypercube samples over the knob space's unit
     cube (plus optional warm-start points — e.g. the hand-tuned
     defaults), each repaired into a valid configuration.
  2. **Successive halving over replay fidelity**: fidelity = the trace
     prefix fraction a trial is replayed at. Every candidate runs at the
     cheapest fidelity; only the top 1/eta advance to the next, and only
     survivors pay for the full trace. Ranking is feasible-first
     rank-sum scalarization (p99 ↓, throughput ↑, device bytes ↓) with
     the trial id as the stable tie-break — ranking a deterministic
     function of the trial set.
  3. **Constrained Pareto front**: over the full-fidelity trials, keep
     the feasible ones (recall_mean >= θ, device_bytes <= budget, knobs
     valid) that no other feasible trial dominates. An infeasible run
     returns an EMPTY front plus a diagnostic explaining the binding
     constraint — never a crash, never a θ-violating config.

Objectives are read from each replay's metrics-registry snapshot
(``ReplayResult.objectives``); the per-trial fingerprint makes every
trial independently re-checkable: ``replay(scenario, trial.params,
trial.seed)`` must reproduce the logged objectives exactly. Every replay
runs on the tuner's ``device`` (None: the CUDA card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.autotune.knobs import KnobSpace, serving_space
from repro_torch.autotune.replay import (DEFAULT_MODEL, LatencyModel,
                                         ReplayScenario, replay)
from repro_torch.kernels.common import resolve_device

# (objective key, minimize?) — the Pareto axes, in report order
OBJECTIVES = (("p99_ms", True), ("throughput_qps", False),
              ("device_bytes", True))


@dataclass
class Trial:
    trial_id: int
    params: dict
    seed: int
    fidelity: float = 0.0
    objectives: dict = field(default_factory=dict)
    feasible: bool = False
    violations: list = field(default_factory=list)
    fingerprint: str = ""
    snapshot: dict | None = None   # kept at full fidelity only

    def as_dict(self) -> dict:
        return {"trial_id": self.trial_id, "params": dict(self.params),
                "seed": self.seed, "fidelity": self.fidelity,
                "objectives": dict(self.objectives),
                "feasible": self.feasible,
                "violations": list(self.violations),
                "fingerprint": self.fingerprint,
                "snapshot": self.snapshot}


@dataclass
class TunerConfig:
    n_trials: int = 12               # LHS seeds (warm starts ride on top)
    fidelities: tuple = (0.25, 1.0)  # trace prefix fractions, ascending
    eta: float = 2.0                 # halving keep-fraction denominator
    seed: int = 0                    # LHS + StepExecutor seed
    theta_recall: float | None = None       # None: scenario's θ
    device_budget_bytes: float | None = None  # None: unconstrained
    warm_start: tuple = ()           # extra param dicts seeded into round 0
    keep_snapshots: bool = True      # retain full-fidelity snapshots
    refine_rounds: int = 0           # pattern-search rounds from the
                                     # front's best member (0 = off)


@dataclass
class TuningReport:
    scenario: str
    trials: list                    # every Trial, all fidelities
    front: list                     # feasible, non-dominated, full fidelity
    best: Trial | None              # min-p99 member of the front
    diagnostic: str | None          # why the front is empty (when it is)
    theta_recall: float = 0.0
    device_budget_bytes: float | None = None

    def as_dict(self) -> dict:
        return {"scenario": self.scenario,
                "theta_recall": self.theta_recall,
                "device_budget_bytes": self.device_budget_bytes,
                "n_trials": len(self.trials),
                "front": [t.as_dict() for t in self.front],
                "best": self.best.as_dict() if self.best else None,
                "diagnostic": self.diagnostic,
                "trials": [t.as_dict() for t in self.trials]}


def dominates(a: dict, b: dict) -> bool:
    """True when ``a`` is no worse than ``b`` on every objective and
    strictly better on at least one."""
    better = False
    for key, minimize in OBJECTIVES:
        av, bv = a[key], b[key]
        if minimize:
            if av > bv:
                return False
            better = better or av < bv
        else:
            if av < bv:
                return False
            better = better or av > bv
    return better


def feasibility(objectives: dict, theta: float,
                budget: float | None) -> list[str]:
    """Constraint violations for one trial's objectives (empty == OK)."""
    out = []
    if objectives.get("recall_mean", 0.0) < theta:
        out.append(f"recall {objectives['recall_mean']:.4f} < "
                   f"theta {theta:.4f}")
    if budget is not None and objectives.get("device_bytes", 0.0) > budget:
        out.append(f"device_bytes {objectives['device_bytes']:.0f} > "
                   f"budget {budget:.0f}")
    return out


def front_of(trials: list, theta: float,
             budget: float | None = None) -> list:
    """Feasible non-dominated subset of ``trials`` — a pure filter, so
    re-running it with a relaxed budget can only grow the feasible set
    (the monotonicity the property tests pin down)."""
    feas = [t for t in trials
            if not feasibility(t.objectives, theta, budget)]
    front = [t for t in feas
             if not any(dominates(o.objectives, t.objectives)
                        for o in feas if o is not t)]
    return sorted(front, key=lambda t: (t.objectives["p99_ms"], t.trial_id))


def best_p99(front: list) -> float | None:
    return min((t.objectives["p99_ms"] for t in front), default=None)


def _rank_sum(trials: list) -> dict[int, float]:
    """Σ over objectives of the trial's rank (ties share the lower
    rank) — scale-free scalarization for the halving step."""
    score = {t.trial_id: 0.0 for t in trials}
    for key, minimize in OBJECTIVES:
        vals = sorted(((t.objectives[key], t.trial_id) for t in trials),
                      reverse=not minimize)
        rank_of = {}
        for i, (v, tid) in enumerate(vals):
            # ties share the first tied position (stable across order)
            rank_of[tid] = i if (i == 0 or v != vals[i - 1][0]) \
                else rank_of[vals[i - 1][1]]
        for tid, r in rank_of.items():
            score[tid] += r
    return score


class AutoTuner:
    """Searches a knob space for Pareto-optimal serving configurations
    on one replay scenario."""

    def __init__(self, scenario: ReplayScenario,
                 space: KnobSpace | None = None,
                 config: TunerConfig | None = None,
                 model: LatencyModel = DEFAULT_MODEL, device=None):
        self.device = resolve_device(device)  # before any work: no card raises
        self.scenario = scenario
        self.space = space or serving_space(churn=scenario.churn)
        self.config = config or TunerConfig()
        self.model = model
        if not self.config.fidelities or \
                list(self.config.fidelities) != sorted(self.config.fidelities):
            raise ValueError("fidelities must be ascending and non-empty")

    def _theta(self) -> float:
        cfg = self.config
        return cfg.theta_recall if cfg.theta_recall is not None \
            else self.scenario.theta_recall

    def _evaluate(self, trial: Trial, fidelity: float) -> Trial:
        res = replay(self.scenario, trial.params, seed=trial.seed,
                     fidelity=fidelity, model=self.model, device=self.device)
        trial.fidelity = fidelity
        trial.objectives = res.objectives
        trial.fingerprint = res.fingerprint
        trial.violations = feasibility(res.objectives, self._theta(),
                                       self.config.device_budget_bytes)
        trial.feasible = not trial.violations
        if fidelity >= self.config.fidelities[-1] and \
                self.config.keep_snapshots:
            trial.snapshot = res.snapshot
        return trial

    def _order(self, trials: list) -> list:
        """Feasible-first ordering for the halving step: feasible trials
        by rank-sum, then infeasible by violation magnitude — a config
        that ALMOST meets θ still deserves a higher-fidelity look over
        one that is far off."""
        feas = [t for t in trials if t.feasible]
        infeas = [t for t in trials if not t.feasible]
        score = _rank_sum(feas) if feas else {}
        feas.sort(key=lambda t: (score[t.trial_id], t.trial_id))
        theta = self._theta()
        budget = self.config.device_budget_bytes

        def deficit(t: Trial) -> float:
            d = max(0.0, theta - t.objectives.get("recall_mean", 0.0))
            if budget:
                d += max(0.0, (t.objectives.get("device_bytes", 0.0)
                               - budget) / budget)
            return d

        infeas.sort(key=lambda t: (deficit(t), t.trial_id))
        return feas + infeas

    def _refine(self, incumbent: Trial, evaluated: list) -> list:
        """Greedy coordinate descent on p99 from the front's best member:
        each round tries every knob's in-domain neighbors at full
        fidelity and moves whenever a feasible candidate strictly
        improves p99. Deterministic (no RNG) — LHS finds the right
        region, this walks to the knob's sweet spot inside it."""
        cfg = self.config
        fidelity = cfg.fidelities[-1]
        seen = {tuple(sorted((k, str(v)) for k, v in t.params.items()))
                for t in evaluated}
        next_id = max(t.trial_id for t in evaluated) + 1
        new: list[Trial] = []
        for _ in range(cfg.refine_rounds):
            improved = False
            for knob in self.space:
                for cand in knob.neighbors(incumbent.params[knob.name]):
                    params = self.space.repair(
                        {**incumbent.params, knob.name: cand})
                    key = tuple(sorted((k, str(v))
                                       for k, v in params.items()))
                    if key in seen or self.space.validate(params):
                        continue
                    seen.add(key)
                    trial = Trial(trial_id=next_id, params=params,
                                  seed=cfg.seed)
                    next_id += 1
                    self._evaluate(trial, fidelity)
                    new.append(trial)
                    if trial.feasible and (trial.objectives["p99_ms"]
                                           < incumbent.objectives["p99_ms"]):
                        incumbent = trial
                        improved = True
            if not improved:
                break
        return new

    def run(self) -> TuningReport:
        cfg = self.config
        seeds = list(cfg.warm_start) + self.space.lhs(cfg.n_trials,
                                                      seed=cfg.seed)
        all_trials: list[Trial] = []
        survivors: list[Trial] = []
        for i, params in enumerate(seeds):
            params = self.space.repair(dict(params))
            trial = Trial(trial_id=i, params=params, seed=cfg.seed)
            bad = self.space.validate(params)
            if bad:  # never replay an out-of-domain config
                trial.violations = bad
                all_trials.append(trial)
                continue
            survivors.append(trial)
            all_trials.append(trial)
        for level, fidelity in enumerate(cfg.fidelities):
            if not survivors:
                break
            for trial in survivors:
                self._evaluate(trial, fidelity)
            if level + 1 < len(cfg.fidelities):
                keep = max(1, math.ceil(len(survivors) / cfg.eta))
                survivors = self._order(survivors)[:keep]
        theta = self._theta()

        def full_front():
            full = [t for t in all_trials
                    if t.fidelity >= cfg.fidelities[-1] and t.objectives]
            return front_of(full, theta, cfg.device_budget_bytes)

        front = full_front()
        best = front[0] if front else None
        if cfg.refine_rounds and best is not None:
            all_trials.extend(self._refine(best, all_trials))
            front = full_front()
            best = front[0] if front else None
        diagnostic = None
        if not front:
            evaluated = [t for t in all_trials if t.objectives]
            if not evaluated:
                diagnostic = ("no trial evaluated: every candidate failed "
                              "knob validation")
            else:
                best_rec = max(t.objectives["recall_mean"]
                               for t in evaluated)
                parts = [f"no feasible configuration at full fidelity: "
                         f"best recall {best_rec:.4f} vs theta {theta:.4f}"]
                if cfg.device_budget_bytes is not None:
                    min_bytes = min(t.objectives["device_bytes"]
                                    for t in evaluated)
                    parts.append(f"min device_bytes {min_bytes:.0f} vs "
                                 f"budget {cfg.device_budget_bytes:.0f}")
                diagnostic = "; ".join(parts)
        return TuningReport(scenario=self.scenario.name, trials=all_trials,
                            front=front, best=best, diagnostic=diagnostic,
                            theta_recall=theta,
                            device_budget_bytes=cfg.device_budget_bytes)
