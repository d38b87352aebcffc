"""Scenario-diverse request traces for the online runtime (DESIGN.md §7).

Each generator emits a list of ``TimedQuery`` — (arrival time, query) —
with globally unique qids, at a fixed arrival rate (``qps``). Scenarios:

  - ``steady``   : vids drawn from a reference workload's histogram — the
                   distribution the configuration was tuned for;
  - ``diurnal``  : the vid mixture shifts from a "day" workload to a
                   "night" workload over the trace (traffic moving between
                   modalities as the clock turns);
  - ``burst``    : steady background traffic with a sudden burst window in
                   which one vid (one modality) dominates arrivals;
  - ``hot_item`` : queries concentrated around a few hot database rows
                   (skewed item popularity — identical plan signatures,
                   the plan cache's and micro-batcher's best case);
  - ``tenant_skew`` : multiple tenants' streams merged, each tagged with
                   its ``TenantId``; inside a window one "noisy" tenant's
                   arrival rate is multiplied while the victims keep their
                   base rate (the noisy-neighbor isolation scenario);
  - ``churn``    : queries interleaved with a mutation stream —
                   ``TimedMutation`` events carrying insert batches (near-
                   manifold rows), delete picks, and upserts at
                   configurable rates (the ingest subsystem's scenario;
                   ``repro_torch.ingest.IngestRuntime.run_mixed_trace`` replays
                   it);
  - ``filtered`` : queries carrying attribute predicates (DESIGN.md §12)
                   with a configurable selectivity mix — quantile ranges
                   over a numeric field hit each target selectivity — and
                   a hot-predicate skew knob (a few predicates dominate,
                   the filtered plan cache's best case).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace as dc_replace

import numpy as np

from repro_torch.core.types import (DEFAULT_TENANT, Query, TenantId, Vid, Workload,
                              norm_vid)
from repro_torch.data.vectors import MultiVectorDatabase, _normalize, _unit_noise


@dataclass
class TimedQuery:
    t: float
    query: Query
    tenant: TenantId = DEFAULT_TENANT


@dataclass
class TimedMutation:
    """One mutation event in a mixed trace. Inserts/upserts carry their
    vectors (one block per column); deletes and upsert targets are resolved
    against the LIVE table at apply time — the trace only pins the seeded
    choice (``seed``) and how many rows to touch (``count``), because which
    stable ids are alive depends on the mutations applied before this one."""

    t: float
    kind: str                    # "insert" | "delete" | "upsert"
    count: int
    vectors: list | None = None  # per-column blocks (insert / upsert)
    seed: int = 0                # live-id pick for delete / upsert targets
    tenant: TenantId = DEFAULT_TENANT
    attributes: dict | None = None  # per-field values riding insert/upsert


def row_batch(db: MultiVectorDatabase, rng: np.random.Generator, n: int,
              noise: float = 0.5,
              source: MultiVectorDatabase | None = None) -> list:
    """``n`` near-manifold full rows (every column) for an insert batch:
    each row is a random ``source`` row plus per-column unit noise.
    ``source`` defaults to ``db`` itself; pass a differently-distributed
    database to generate data-drifting inserts."""
    src = source if source is not None else db
    rows = rng.integers(0, src.n_rows, size=n)
    return [_normalize(col[rows] + _unit_noise(rng, (n, col.shape[1]), noise))
            for col in src.columns]


class _QueryFactory:
    """Builds near-manifold queries (a database row + per-column noise)
    with a monotonically increasing qid. ``qids`` lets several factories
    (one per tenant) share one counter so qids stay globally unique."""

    def __init__(self, db: MultiVectorDatabase, k: int, seed: int,
                 noise: float = 0.5, qid_start: int = 0, qids=None):
        self.db = db
        self.k = k
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self._qids = qids if qids is not None else itertools.count(qid_start)

    def make(self, vid: Vid, row: int | None = None) -> Query:
        vid = norm_vid(vid)
        row = int(self.rng.integers(0, self.db.n_rows)) if row is None else row
        vecs = {}
        for c in vid:
            base = self.db.columns[c][row]
            vecs[c] = _normalize(base + _unit_noise(self.rng, base.shape,
                                                    self.noise))
        return Query(qid=next(self._qids), vid=vid, vectors=vecs, k=self.k)


def _workload_vids(workload: Workload) -> tuple[list[Vid], np.ndarray]:
    vids = sorted({q.vid for q in workload.queries})
    mass = np.zeros(len(vids))
    for q, p in workload:
        mass[vids.index(q.vid)] += p
    return vids, mass / mass.sum()


def steady_trace(db: MultiVectorDatabase, workload: Workload, n: int,
                 qps: float = 200.0, k: int | None = None, seed: int = 0,
                 t0: float = 0.0, qid_start: int = 0) -> list[TimedQuery]:
    vids, probs = _workload_vids(workload)
    k = k if k is not None else workload.queries[0].k
    fac = _QueryFactory(db, k, seed, qid_start=qid_start)
    out = []
    for i in range(n):
        vid = vids[int(fac.rng.choice(len(vids), p=probs))]
        out.append(TimedQuery(t=t0 + i / qps, query=fac.make(vid)))
    return out


def diurnal_trace(db: MultiVectorDatabase, day: Workload, night: Workload,
                  n: int, qps: float = 200.0, k: int | None = None,
                  seed: int = 0, t0: float = 0.0,
                  qid_start: int = 0) -> list[TimedQuery]:
    """Linear day→night mixture shift: query i draws from the night
    histogram with probability i/(n-1)."""
    day_vids, day_p = _workload_vids(day)
    night_vids, night_p = _workload_vids(night)
    k = k if k is not None else day.queries[0].k
    fac = _QueryFactory(db, k, seed, qid_start=qid_start)
    out = []
    for i in range(n):
        phase = i / max(n - 1, 1)
        if fac.rng.random() < phase:
            vid = night_vids[int(fac.rng.choice(len(night_vids), p=night_p))]
        else:
            vid = day_vids[int(fac.rng.choice(len(day_vids), p=day_p))]
        out.append(TimedQuery(t=t0 + i / qps, query=fac.make(vid)))
    return out


def burst_trace(db: MultiVectorDatabase, workload: Workload, burst_vid: Vid,
                n: int, qps: float = 200.0, burst_start: float = 0.4,
                burst_len: float = 0.3, burst_qps_mult: float = 4.0,
                k: int | None = None, seed: int = 0, t0: float = 0.0,
                qid_start: int = 0) -> list[TimedQuery]:
    """Steady traffic plus a modality burst: inside the burst window
    arrivals speed up by ``burst_qps_mult`` and all hit ``burst_vid``."""
    vids, probs = _workload_vids(workload)
    burst_vid = norm_vid(burst_vid)
    k = k if k is not None else workload.queries[0].k
    fac = _QueryFactory(db, k, seed, qid_start=qid_start)
    lo, hi = int(n * burst_start), int(n * (burst_start + burst_len))
    out = []
    t = t0
    for i in range(n):
        in_burst = lo <= i < hi
        if in_burst:
            vid = burst_vid
            t += 1.0 / (qps * burst_qps_mult)
        else:
            vid = vids[int(fac.rng.choice(len(vids), p=probs))]
            t += 1.0 / qps
        out.append(TimedQuery(t=t, query=fac.make(vid)))
    return out


def hot_item_trace(db: MultiVectorDatabase, vid: Vid, n: int,
                   qps: float = 200.0, n_hot: int = 4, p_hot: float = 0.85,
                   k: int = 10, seed: int = 0, t0: float = 0.0,
                   qid_start: int = 0, noise: float = 0.5) -> list[TimedQuery]:
    """Hot-item skew: with probability ``p_hot`` a query lands near one of
    ``n_hot`` popular rows; the rest are uniform. ``noise`` is the
    per-column query noise radius — tighten it to model near-duplicate
    hot traffic (the semantic-cache bench's ε-sweep knob)."""
    vid = norm_vid(vid)
    fac = _QueryFactory(db, k, seed, qid_start=qid_start, noise=noise)
    hot_rows = fac.rng.choice(db.n_rows, size=n_hot, replace=False)
    out = []
    for i in range(n):
        row = (int(fac.rng.choice(hot_rows)) if fac.rng.random() < p_hot
               else None)
        out.append(TimedQuery(t=t0 + i / qps, query=fac.make(vid, row=row)))
    return out


def tenant_skew_trace(db: MultiVectorDatabase,
                      tenants: dict[TenantId, Workload], n: int,
                      qps: float = 200.0, noisy: TenantId | None = None,
                      noisy_mult: float = 8.0, noisy_start: float = 0.3,
                      noisy_len: float = 0.4, k: int | None = None,
                      seed: int = 0, t0: float = 0.0, qid_start: int = 0,
                      dbs: dict[TenantId, MultiVectorDatabase] | None = None,
                      n_hot: int = 0, p_hot: float = 0.0,
                      noise: float = 0.5) -> list[TimedQuery]:
    """Noisy-neighbor scenario: every tenant contributes an independent
    steady stream at ``qps / len(tenants)``; inside the noisy window
    (fractions of the nominal trace span ``n / qps``) the ``noisy``
    tenant's arrival rate is multiplied by ``noisy_mult`` while the
    victims keep their base rate. Streams are merged by arrival time and
    each ``TimedQuery`` carries its tenant tag. ``dbs`` optionally maps
    tenants to their own databases (default: the shared ``db``).
    ``n_hot`` > 0 adds per-tenant hot-item skew on top: with probability
    ``p_hot`` a tenant's query lands near one of ITS ``n_hot`` popular
    rows (``noise`` radius) — the multi-tenant semantic-cache scenario."""
    if not tenants:
        raise ValueError("tenant_skew needs at least one tenant workload")
    names = sorted(tenants)
    noisy = names[-1] if noisy is None else noisy
    if noisy not in tenants:
        raise ValueError(f"noisy tenant {noisy!r} not in workloads")
    dbs = dbs or {}
    base_rate = qps / len(names)
    span = n / qps
    win_lo, win_hi = t0 + noisy_start * span, t0 + (noisy_start + noisy_len) * span
    qids = itertools.count(qid_start)
    facs, mixes, next_t, hots = {}, {}, {}, {}
    for i, name in enumerate(names):
        wl = tenants[name]
        tdb = dbs.get(name, db)
        tk = k if k is not None else wl.queries[0].k
        facs[name] = _QueryFactory(tdb, tk, seed + 101 * i, qids=qids,
                                   noise=noise)
        mixes[name] = _workload_vids(wl)
        next_t[name] = t0 + (i + 1) / qps  # stagger first arrivals
        if n_hot > 0:
            hots[name] = facs[name].rng.choice(tdb.n_rows, size=n_hot,
                                               replace=False)
    out: list[TimedQuery] = []
    for _ in range(n):
        name = min(next_t, key=lambda tid: (next_t[tid], tid))
        t = next_t[name]
        fac = facs[name]
        vids, probs = mixes[name]
        vid = vids[int(fac.rng.choice(len(vids), p=probs))]
        row = None
        if n_hot > 0 and fac.rng.random() < p_hot:
            row = int(fac.rng.choice(hots[name]))
        out.append(TimedQuery(t=t, query=fac.make(vid, row=row),
                              tenant=name))
        rate = base_rate
        if name == noisy and win_lo <= t < win_hi:
            rate *= noisy_mult
        next_t[name] = t + 1.0 / rate
    return out


def churn_trace(db: MultiVectorDatabase, workload: Workload, n: int,
                qps: float = 200.0, mutation_rate: float = 0.25,
                batch: int = 8, mix: tuple = (0.5, 0.5, 0.0),
                insert_noise: float = 0.5,
                insert_source: MultiVectorDatabase | None = None,
                query_drift: float = 0.0,
                k: int | None = None, seed: int = 0, t0: float = 0.0,
                qid_start: int = 0,
                tenant: TenantId = DEFAULT_TENANT) -> list:
    """Interleaved query + mutation stream (the ingest scenario).

    ``n`` queries arrive at ``qps`` drawn from the workload's vid
    histogram; mutation batches of ``batch`` rows arrive at
    ``qps * mutation_rate`` with kinds drawn from ``mix`` (insert, delete,
    upsert weights). Insert/upsert rows are near-manifold (``row_batch``);
    pass ``insert_source`` to make the ingested data DRIFT away from the
    base distribution (the data-drift benchmark's knob), and
    ``query_drift`` > 0 to make queries FOLLOW it — query i lands near
    ``insert_source`` rows with probability ramping 0 → ``query_drift``
    over the trace, modeling traffic that chases freshly ingested content.
    Delete/upsert targets are left as seeded live-id picks resolved at
    apply time. Returns ``TimedQuery`` and ``TimedMutation`` events merged
    by arrival time."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    mix_arr = np.asarray(mix, dtype=np.float64)
    if mix_arr.sum() <= 0 or (mix_arr < 0).any():
        raise ValueError("mix must be non-negative with positive mass")
    mix_arr = mix_arr / mix_arr.sum()
    vids, probs = _workload_vids(workload)
    k = k if k is not None else workload.queries[0].k
    qids = itertools.count(qid_start)
    fac = _QueryFactory(db, k, seed, qids=qids)
    dfac = (_QueryFactory(insert_source, k, seed + 31, qids=qids)
            if insert_source is not None and query_drift > 0 else None)
    mrng = np.random.default_rng(seed + 7919)
    kinds = ("insert", "delete", "upsert")
    out: list = []
    for i in range(n):
        f = fac
        if dfac is not None:
            phase = i / max(n - 1, 1)
            if fac.rng.random() < phase * query_drift:
                f = dfac
        vid = vids[int(f.rng.choice(len(vids), p=probs))]
        out.append(TimedQuery(t=t0 + i / qps, query=f.make(vid),
                              tenant=tenant))
    n_mut = int(round(n * mutation_rate))
    for m in range(n_mut):
        t = t0 + (m + 0.5) / (qps * mutation_rate) if mutation_rate > 0 else t0
        kind = kinds[int(mrng.choice(3, p=mix_arr))]
        vecs = None
        if kind in ("insert", "upsert"):
            vecs = row_batch(db, mrng, batch, noise=insert_noise,
                             source=insert_source)
        out.append(TimedMutation(t=t, kind=kind, count=batch, vectors=vecs,
                                 seed=seed * 100_003 + m, tenant=tenant))
    out.sort(key=lambda e: (e.t, isinstance(e, TimedMutation)))
    return out


def filtered_trace(db: MultiVectorDatabase, workload: Workload, attrs, n: int,
                   qps: float = 200.0, field: str = "score",
                   selectivity_mix: tuple = ((0.01, 0.25), (0.1, 0.25),
                                             (0.5, 0.25), (1.0, 0.25)),
                   n_hot: int = 4, p_hot: float = 0.0,
                   k: int | None = None, seed: int = 0, t0: float = 0.0,
                   qid_start: int = 0) -> list[TimedQuery]:
    """Filtered-search scenario (DESIGN.md §12): each query carries a
    ``Range`` predicate over the numeric ``field`` whose width is a
    quantile slice of the observed values — so the predicate's TRUE
    selectivity matches the drawn target. ``selectivity_mix`` is a tuple of
    (selectivity, weight) pairs; selectivity 1.0 emits an UNFILTERED query
    (predicate None). With probability ``p_hot`` a query reuses one of
    ``n_hot`` pre-drawn hot predicates instead of a fresh one — skewed
    predicate popularity, the filtered plan cache's best case."""
    from repro_torch.filter import Range
    sels = np.asarray([s for s, _ in selectivity_mix], dtype=np.float64)
    ws = np.asarray([w for _, w in selectivity_mix], dtype=np.float64)
    if ws.sum() <= 0 or (ws < 0).any():
        raise ValueError("selectivity_mix weights must be non-negative "
                         "with positive mass")
    ws = ws / ws.sum()
    vals = attrs.take(field, np.arange(db.n_rows))
    vals = np.sort(vals[~np.isnan(vals)])
    if vals.size == 0:
        raise ValueError(f"field {field!r} has no populated values")
    vids, probs = _workload_vids(workload)
    k = k if k is not None else workload.queries[0].k
    fac = _QueryFactory(db, k, seed, qid_start=qid_start)

    def draw_pred():
        sel = float(sels[int(fac.rng.choice(len(sels), p=ws))])
        if sel >= 1.0:
            return None
        lo_q = float(fac.rng.uniform(0.0, 1.0 - sel))
        lo = float(np.quantile(vals, lo_q))
        hi = float(np.quantile(vals, min(lo_q + sel, 1.0)))
        return Range(field, lo=lo, hi=hi)

    hot = [draw_pred() for _ in range(n_hot)] if p_hot > 0 else []
    out = []
    for i in range(n):
        vid = vids[int(fac.rng.choice(len(vids), p=probs))]
        if hot and fac.rng.random() < p_hot:
            pred = hot[int(fac.rng.integers(len(hot)))]
        else:
            pred = draw_pred()
        q = fac.make(vid)
        if pred is not None:
            q = dc_replace(q, predicate=pred)
        out.append(TimedQuery(t=t0 + i / qps, query=q))
    return out


def make_trace(db: MultiVectorDatabase, scenario: str, **kw) -> list[TimedQuery]:
    gens = {"steady": steady_trace, "diurnal": diurnal_trace,
            "burst": burst_trace, "hot_item": hot_item_trace,
            "tenant_skew": tenant_skew_trace, "churn": churn_trace,
            "filtered": filtered_trace}
    if scenario not in gens:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {sorted(gens)}")
    return gens[scenario](db, **kw)
