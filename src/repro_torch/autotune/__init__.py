"""Whole-system auto-tuner (DESIGN.md §15): deterministic trace replay
+ typed knob space + multi-objective successive-halving search."""
from repro_torch.autotune.knobs import (Knob, KnobSpace, serving_space,
                                        to_configs)
from repro_torch.autotune.replay import (DEFAULT_MODEL, LatencyModel,
                                         ReplayResult, ReplayScenario,
                                         clear_deployments,
                                         deterministic_snapshot, fingerprint_of,
                                         replay)
from repro_torch.autotune.tuner import (AutoTuner, Trial, TunerConfig,
                                        TuningReport, best_p99, dominates,
                                        feasibility, front_of)

__all__ = [
    "Knob", "KnobSpace", "serving_space", "to_configs",
    "DEFAULT_MODEL", "LatencyModel", "ReplayResult", "ReplayScenario",
    "clear_deployments", "deterministic_snapshot", "fingerprint_of",
    "replay",
    "AutoTuner", "Trial", "TunerConfig", "TuningReport",
    "best_p99", "dominates", "feasibility", "front_of",
]
