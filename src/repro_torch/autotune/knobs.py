"""Typed knob space over the serving runtime (DESIGN.md §15).

Every tunable the stack has grown — flush deadline, batch cap, DRR
quantum, plan-cache capacity, semantic-cache ε, compaction thresholds,
drift sensitivity, retune cooldown — is declared here as a typed ``Knob``
with explicit bounds, so the tuner can only ever emit configurations the
runtime accepts. The space supports:

  - unit-cube decoding (``Knob.from_unit``): every knob maps [0, 1) onto
    its domain (ints by stratified rounding, floats linearly, ``log``
    knobs geometrically, bools by threshold, choices by bucket), which is
    what makes Latin-hypercube seeding dimension-agnostic;
  - cross-knob repair (``KnobSpace.repair``): constraints that couple
    knobs (``min_window <= window``, ``quantum <= max_batch``) are
    enforced by projection, not rejection — every LHS sample yields a
    valid config;
  - validation (``KnobSpace.validate``): returns human-readable
    violations instead of raising, so the tuner can mark a trial
    infeasible with a diagnostic.

``to_configs`` converts a knob dict into the runtime's own config
dataclasses (``RuntimeConfig`` + optional ``IngestConfig``) — the tuner
never touches runtime internals directly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.ingest.compactor import CompactionPolicy
from repro_torch.ingest.runtime import IngestConfig
from repro_torch.online.runtime import RuntimeConfig

_KINDS = ("int", "float", "log", "bool", "choice")


@dataclass(frozen=True)
class Knob:
    """One tunable: a name, a kind, and a validity domain."""

    name: str
    kind: str                 # "int" | "float" | "log" | "bool" | "choice"
    lo: float = 0.0
    hi: float = 1.0
    choices: tuple = ()

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"{self.name}: unknown knob kind {self.kind!r}")
        if self.kind == "choice" and not self.choices:
            raise ValueError(f"{self.name}: choice knob needs choices")
        if self.kind == "log" and self.lo <= 0:
            raise ValueError(f"{self.name}: log knob needs lo > 0")
        if self.kind in ("int", "float", "log") and self.hi < self.lo:
            raise ValueError(f"{self.name}: hi < lo")

    def from_unit(self, u: float):
        """Decode one unit-cube coordinate into a domain value."""
        u = min(max(float(u), 0.0), 1.0 - 1e-12)
        if self.kind == "int":
            span = int(self.hi) - int(self.lo) + 1
            return int(self.lo) + min(int(u * span), span - 1)
        if self.kind == "float":
            return self.lo + u * (self.hi - self.lo)
        if self.kind == "log":
            return float(math.exp(math.log(self.lo)
                                  + u * (math.log(self.hi)
                                         - math.log(self.lo))))
        if self.kind == "bool":
            return u >= 0.5
        return self.choices[min(int(u * len(self.choices)),
                                len(self.choices) - 1)]

    def neighbors(self, value, frac: float = 0.1) -> list:
        """Adjacent in-domain values for pattern-search refinement:
        bools/choices flip, numeric knobs step by ``frac`` of the range
        (log knobs geometrically). Never returns ``value`` itself."""
        if self.kind == "bool":
            cands = [not value]
        elif self.kind == "choice":
            cands = [c for c in self.choices if c != value]
        elif self.kind == "int":
            step = max(1, round(frac * (int(self.hi) - int(self.lo))))
            cands = [int(min(max(value + s, self.lo), self.hi))
                     for s in (step, -step)]
        elif self.kind == "log":
            f = (self.hi / self.lo) ** frac
            cands = [float(min(max(value * m, self.lo), self.hi))
                     for m in (f, 1.0 / f)]
        else:
            step = frac * (self.hi - self.lo)
            cands = [float(min(max(value + s, self.lo), self.hi))
                     for s in (step, -step)]
        out = []
        for c in cands:
            if c != value and c not in out:
                out.append(c)
        return out

    def check(self, value) -> str | None:
        """Violation description, or None when ``value`` is in-domain."""
        if self.kind == "bool":
            return None if isinstance(value, (bool, np.bool_)) else \
                f"{self.name}: expected bool, got {value!r}"
        if self.kind == "choice":
            return None if value in self.choices else \
                f"{self.name}: {value!r} not in {self.choices}"
        if self.kind == "int" and not isinstance(value, (int, np.integer)):
            return f"{self.name}: expected int, got {value!r}"
        try:
            v = float(value)
        except (TypeError, ValueError):
            return f"{self.name}: non-numeric {value!r}"
        if not (self.lo <= v <= self.hi):
            return f"{self.name}: {value!r} outside [{self.lo}, {self.hi}]"
        return None


class KnobSpace:
    """An ordered set of knobs plus the cross-knob validity constraints."""

    def __init__(self, knobs: tuple[Knob, ...] | list[Knob]):
        self.knobs = tuple(knobs)
        names = [k.name for k in self.knobs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate knob names")
        self._by_name = {k.name: k for k in self.knobs}

    def __len__(self) -> int:
        return len(self.knobs)

    def __iter__(self):
        return iter(self.knobs)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def get(self, name: str) -> Knob:
        return self._by_name[name]

    @property
    def names(self) -> list[str]:
        return [k.name for k in self.knobs]

    def decode(self, units) -> dict:
        """Unit-cube point (len == len(space)) → repaired knob dict."""
        units = list(units)
        if len(units) != len(self.knobs):
            raise ValueError(f"expected {len(self.knobs)} coordinates, "
                             f"got {len(units)}")
        return self.repair({k.name: k.from_unit(u)
                            for k, u in zip(self.knobs, units)})

    def repair(self, params: dict) -> dict:
        """Project cross-knob constraints (never rejects): the drift
        window floor cannot exceed the window, and a DRR quantum larger
        than the batch cap would let one tenant monopolize every flush."""
        out = dict(params)
        if "min_window" in out and "window" in out:
            out["min_window"] = min(out["min_window"], out["window"])
        if "quantum" in out and "max_batch" in out:
            out["quantum"] = min(out["quantum"], out["max_batch"])
        return out

    def validate(self, params: dict) -> list[str]:
        """All violations for ``params`` (empty list == valid)."""
        out = []
        for name in params:
            if name not in self._by_name:
                out.append(f"unknown knob {name!r}")
        for knob in self.knobs:
            if knob.name not in params:
                out.append(f"missing knob {knob.name!r}")
                continue
            v = knob.check(params[knob.name])
            if v is not None:
                out.append(v)
        if not out:
            if ("min_window" in params and "window" in params
                    and params["min_window"] > params["window"]):
                out.append("min_window > window")
            if ("quantum" in params and "max_batch" in params
                    and params["quantum"] > params["max_batch"]):
                out.append("quantum > max_batch")
        return out

    def lhs(self, n: int, seed: int = 0) -> list[dict]:
        """Latin-hypercube seeding: each dimension is split into ``n``
        strata, each stratum is sampled once, and strata are permuted
        independently per dimension — n configs that jointly cover every
        knob's range instead of clumping like iid sampling would."""
        if n < 1:
            raise ValueError("n must be >= 1")
        rng = np.random.default_rng(seed)
        d = len(self.knobs)
        cube = np.empty((n, d))
        for j in range(d):
            strata = (rng.permutation(n) + rng.random(n)) / n
            cube[:, j] = strata
        return [self.decode(cube[i]) for i in range(n)]

    def defaults(self) -> dict:
        """The hand-tuned runtime defaults expressed as a knob dict —
        the tuner's warm-start anchor (clipped into the space)."""
        rc = RuntimeConfig()
        out = {}
        for knob in self.knobs:
            v = _DEFAULTS.get(knob.name)
            if v is None:
                v = getattr(rc, knob.name, None)
            if v is None:
                v = knob.from_unit(0.5)
            if knob.kind in ("int", "float", "log") and not isinstance(
                    v, bool):
                v = min(max(v, knob.lo), knob.hi)
                if knob.kind == "int":
                    v = int(v)
            out[knob.name] = v
        return self.repair(out)


# defaults for knobs that are not 1:1 RuntimeConfig fields
_DEFAULTS = {
    "compact": True,
    "max_delta_fraction": 0.2,
    "max_dead_fraction": 0.25,
    "compact_min_rows": 8,
    "async_compaction": False,
    "delta_threshold": 0.25,
    "data_cooldown_s": 60.0,
    "retune_mode": "sync",
}


def serving_space(churn: bool = False) -> KnobSpace:
    """The whole-system knob surface (DESIGN.md §15 table). ``churn``
    adds the ingest/compaction knobs — they only matter when the trace
    carries mutations."""
    knobs = [
        # scheduler
        Knob("max_batch", "int", 4, 64),
        Knob("max_delay_ms", "log", 0.5, 50.0),
        Knob("quantum", "int", 1, 8),
        # plan cache
        Knob("plan_cache_capacity", "int", 64, 4096),
        # semantic result cache
        Knob("semcache", "bool"),
        Knob("semcache_epsilon", "float", 0.0, 0.2),
        Knob("semcache_capacity", "int", 32, 512),
        # async pipeline / worker pool
        Knob("async_flush", "bool"),
        Knob("workers", "int", 1, 4),
        Knob("retune_mode", "choice", choices=("sync", "pool")),
        # drift monitor + background retuner
        Knob("drift_threshold", "float", 0.2, 3.0),
        Knob("window", "int", 32, 256),
        Knob("min_window", "int", 16, 128),
        Knob("cooldown_s", "log", 0.05, 100.0),
    ]
    if churn:
        knobs += [
            Knob("compact", "bool"),
            Knob("max_delta_fraction", "log", 0.01, 0.5),
            Knob("max_dead_fraction", "log", 0.05, 0.5),
            Knob("compact_min_rows", "int", 1, 64),
            Knob("async_compaction", "bool"),
            # data-drift retune sensitivity
            Knob("delta_threshold", "float", 0.1, 0.6),
            Knob("data_cooldown_s", "log", 0.05, 100.0),
        ]
    return KnobSpace(knobs)


def to_configs(params: dict, churn: bool = False,
               measure: bool = True) -> tuple[RuntimeConfig,
                                              IngestConfig | None]:
    """Knob dict → runtime config dataclasses. ``measure=True`` keeps
    ``ExecutionMetrics`` per ticket — the replay objective needs the
    deterministic cost/recall fields."""
    rc = RuntimeConfig(
        max_batch=int(params["max_batch"]),
        max_delay_ms=float(params["max_delay_ms"]),
        quantum=int(params["quantum"]),
        window=int(params["window"]),
        min_window=int(params["min_window"]),
        drift_threshold=float(params["drift_threshold"]),
        cooldown_s=float(params["cooldown_s"]),
        retune_mode=str(params["retune_mode"]),
        measure=measure,
        async_flush=bool(params["async_flush"]),
        workers=int(params["workers"]),
        plan_cache_capacity=int(params["plan_cache_capacity"]),
        semcache=bool(params["semcache"]),
        semcache_epsilon=(float(params["semcache_epsilon"])
                          if params["semcache"] else 0.0),
        semcache_capacity=int(params["semcache_capacity"]),
    )
    if not churn:
        return rc, None
    compact = bool(params["compact"])
    policy = CompactionPolicy(
        max_delta_fraction=(float(params["max_delta_fraction"])
                            if compact else None),
        max_dead_fraction=(float(params["max_dead_fraction"])
                           if compact else None),
        min_mutated_rows=int(params["compact_min_rows"]))
    ic = IngestConfig(policy=policy,
                      delta_threshold=float(params["delta_threshold"]),
                      data_cooldown_s=float(params["data_cooldown_s"]),
                      async_compaction=bool(params["async_compaction"]))
    return rc, ic
