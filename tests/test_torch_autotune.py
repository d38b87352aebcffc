"""Port parity of the whole-system auto-tuner (``autotune/``: the knob space,
deterministic trace replay, the successive-halving search and
``launch/autotune_dryrun.py``) against the JAX package, on the scenarios of
tests/test_autotune.py (120 rows, 16 queries).

Two replays in the port of the same (scenario, knobs, seed) give the same
fingerprint, snapshot, objectives and events; the port's replay gives the
reference's fingerprint, snapshot (compared key by key), objectives and
events; the tuner's trials and front equal the reference's trial by trial.
No snapshot series is left out of the comparison.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _pkg(name):
    A = importlib.import_module(f"{name}.autotune")
    return SimpleNamespace(name=name, A=A,
                           kw={"device": "cpu"} if name == "repro_torch" else {})


PKGS = {name: _pkg(name) for name in ("repro", "repro_torch")}
T = PKGS["repro_torch"]


def _scenario(P, name, kind, seed=3):
    return P.A.ReplayScenario(name=name, index_kind=kind, rows=120, n_queries=16,
                              seed=seed, min_sample_rows=60)


def _replay(P, name, kind, seed=7, params=None, **kw):
    scenario = _scenario(P, name, kind)
    if params is None:
        params = P.A.serving_space(churn=scenario.churn).defaults()
    return P.A.replay(scenario, params, seed=seed, **P.kw, **kw)


def _result(r):
    return dict(fingerprint=r.fingerprint, snapshot=r.snapshot, objectives=r.objectives,
                events=r.events, n_queries=r.n_queries, n_flushes=r.n_flushes,
                scenario=r.scenario, seed=r.seed, fidelity=r.fidelity)


GRID = [(name, kind) for name in ("steady", "churn", "tenant_skew")
        for kind in ("flat", "ivf")]


# ---- replay ---------------------------------------------------------------------


@pytest.mark.parametrize("name,kind", GRID)
def test_replay_determinism_grid_in_the_port(name, kind):
    a, b = _replay(T, name, kind), _replay(T, name, kind)
    assert a.fingerprint == b.fingerprint
    assert a.snapshot == b.snapshot
    assert a.objectives == b.objectives
    assert a.events == b.events
    assert a.flush_dispatches == b.flush_dispatches
    assert len(a.flush_dispatches) == a.n_flushes


@pytest.mark.parametrize("name,kind", GRID)
def test_replay_equals_reference(name, kind):
    ref = _result(_replay(PKGS["repro"], name, kind))
    got = _result(_replay(T, name, kind))
    assert sorted(got["snapshot"]) == sorted(ref["snapshot"])
    for key in ref["snapshot"]:
        assert got["snapshot"][key] == ref["snapshot"][key], key
    assert got == ref


@pytest.mark.parametrize("fidelity", [0.5, 1.0])
def test_fidelity_prefix_equals_reference(fidelity):
    ref = _result(_replay(PKGS["repro"], "steady", "flat", fidelity=fidelity))
    got = _result(_replay(T, "steady", "flat", fidelity=fidelity))
    assert got == ref and got["n_queries"] > 0


def test_replay_seeds_are_self_consistent():
    for seed in (1, 2):
        assert _replay(T, "steady", "flat", seed=seed).fingerprint == \
            _replay(T, "steady", "flat", seed=seed).fingerprint


def test_replay_objectives_come_from_the_registry():
    res = _replay(T, "steady", "flat")
    o = res.objectives
    assert o["p99_ms"] > 0 and o["throughput_qps"] > 0 and o["device_bytes"] > 0
    assert 0.0 <= o["recall_mean"] <= 1.0
    for name in importlib.import_module("repro_torch.autotune.replay").WALL_SERIES:
        assert not any(k.startswith(name) for k in res.snapshot)


def test_latency_model_equals_reference():
    assert vars(T.A.DEFAULT_MODEL) == vars(PKGS["repro"].A.DEFAULT_MODEL)


def test_replay_rejects_a_bad_fidelity():
    with pytest.raises(ValueError):
        _replay(T, "steady", "flat", fidelity=0.0)


# ---- knob space ------------------------------------------------------------------


@pytest.mark.parametrize("churn", [False, True])
def test_serving_space_equals_reference(churn):
    spaces = {n: P.A.serving_space(churn=churn) for n, P in PKGS.items()}
    assert [vars(k) for k in spaces["repro_torch"]] == [vars(k) for k in spaces["repro"]]
    assert spaces["repro_torch"].defaults() == spaces["repro"].defaults()
    assert spaces["repro_torch"].lhs(8, seed=5) == spaces["repro"].lhs(8, seed=5)
    for p in spaces["repro_torch"].lhs(8, seed=5):
        assert spaces["repro_torch"].validate(p) == []


@pytest.mark.parametrize("churn", [False, True])
def test_to_configs_equals_reference(churn):
    out = {}
    for n, P in PKGS.items():
        space = P.A.serving_space(churn=churn)
        cfgs = [P.A.to_configs(p, churn=churn) for p in [space.defaults()] + space.lhs(4)]
        out[n] = [(vars(rc), None if ic is None else
                   {**vars(ic), "policy": vars(ic.policy)}) for rc, ic in cfgs]
    assert out["repro_torch"] == out["repro"]


def test_knob_decoding_and_checks_equal_reference():
    out = {}
    for n, P in PKGS.items():
        Knob = P.A.Knob
        knobs = [Knob("x", "int", 4, 64), Knob("y", "log", 0.5, 50.0),
                 Knob("z", "choice", choices=("sync", "pool")), Knob("w", "bool"),
                 Knob("f", "float", 0.0, 0.2)]
        out[n] = [([k.from_unit(u) for u in (0.0, 0.2, 0.5, 0.99, 1.0)],
                   k.neighbors(k.from_unit(0.5)), k.check(k.from_unit(0.3)),
                   k.check(128), k.check(3.5)) for k in knobs]
        space = P.A.serving_space()
        p = space.defaults()
        p.update({"min_window": 128, "window": 32, "quantum": 8, "max_batch": 4,
                  "max_delay_ms": 500.0})
        out[n].append((space.repair(p), space.validate(p)))
    assert out["repro_torch"] == out["repro"]


# ---- Pareto helpers on the reference's fixed cases --------------------------------


def _grid(P):
    def trial(i, p99, thpt, byt, recall=1.0):
        return P.A.Trial(trial_id=i, params={}, seed=0, fidelity=1.0,
                         objectives={"p99_ms": p99, "throughput_qps": thpt,
                                     "device_bytes": byt, "recall_mean": recall})
    return [trial(0, 10.0, 100.0, 1000.0), trial(1, 20.0, 200.0, 1000.0),
            trial(2, 30.0, 300.0, 500.0), trial(3, 30.0, 100.0, 2000.0),
            trial(4, 5.0, 400.0, 4000.0), trial(5, 8.0, 50.0, 900.0, recall=0.2)]


def _pareto(P):
    g = _grid(P)
    return dict(
        fronts={str(b): [t.trial_id for t in P.A.front_of(g, theta=0.5, budget=b)]
                for b in (400.0, 600.0, 1000.0, 2500.0, None)},
        best={str(b): P.A.best_p99(P.A.front_of(g, theta=0.5, budget=b))
              for b in (400.0, 600.0, 1000.0, 2500.0, None)},
        dominates=[[P.A.dominates(a.objectives, b.objectives) for b in g] for a in g],
        feasibility=[P.A.feasibility(t.objectives, 0.5, 950.0) for t in g],
        empty=P.A.front_of(g, theta=2.0))


def test_pareto_helpers_equal_reference_on_fixed_cases():
    got, ref = _pareto(T), _pareto(PKGS["repro"])
    assert got == ref
    assert got["fronts"]["None"] == [4, 0, 1, 2] and got["best"]["None"] == 5.0


# ---- the tuner -------------------------------------------------------------------


def _report(P, **cfg):
    scenario = _scenario(P, "steady", "flat")
    space = P.A.serving_space()
    cfg = {"n_trials": 4, "fidelities": (0.5, 1.0), "seed": 0,
           "warm_start": (space.defaults(),), **cfg}
    tuner = P.A.AutoTuner(scenario, space=space, config=P.A.TunerConfig(**cfg), **P.kw)
    return scenario, tuner.run()


@pytest.fixture(scope="module")
def steady_reports():
    return {n: _report(P) for n, P in PKGS.items()}


def test_tuner_trials_and_front_equal_reference(steady_reports):
    got, ref = steady_reports["repro_torch"][1], steady_reports["repro"][1]
    assert [t.as_dict() for t in got.trials] == [t.as_dict() for t in ref.trials]
    assert [t.trial_id for t in got.front] == [t.trial_id for t in ref.front]
    assert got.best.trial_id == ref.best.trial_id and got.diagnostic == ref.diagnostic
    assert got.front and got.best is got.front[0] and got.best.snapshot is not None


def test_tuner_best_trial_replays_exactly(steady_reports):
    scenario, report = steady_reports["repro_torch"]
    best = report.best
    again = T.A.replay(scenario, best.params, seed=best.seed, device="cpu")
    assert again.fingerprint == best.fingerprint
    assert again.objectives == best.objectives
    for t in report.front:
        assert t.feasible and t.objectives["recall_mean"] >= scenario.theta_recall
        T.A.to_configs(t.params, churn=scenario.churn)


@pytest.mark.parametrize("cfg", [dict(theta_recall=1.01), dict(device_budget_bytes=1.0)])
def test_infeasible_tuner_diagnostic_equals_reference(cfg):
    cfg = dict(n_trials=2, fidelities=(1.0,), warm_start=(), **cfg)
    got, ref = _report(T, **cfg)[1], _report(PKGS["repro"], **cfg)[1]
    assert got.front == [] and got.best is None
    assert got.diagnostic == ref.diagnostic and "no feasible" in got.diagnostic


def test_tuner_refine_rounds_equal_reference():
    got = _report(T, n_trials=2, refine_rounds=1)[1]
    ref = _report(PKGS["repro"], n_trials=2, refine_rounds=1)[1]
    assert [t.as_dict() for t in got.trials] == [t.as_dict() for t in ref.trials]


def test_tuner_rejects_bad_fidelities():
    with pytest.raises(ValueError):
        T.A.AutoTuner(_scenario(T, "steady", "flat"),
                      config=T.A.TunerConfig(fidelities=(1.0, 0.5)), device="cpu")


def test_autotune_dryrun_smoke_on_cpu_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.autotune_dryrun", "--smoke",
         "--device", "cpu"], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "autotune smoke OK" in out.stdout
