"""One run of a cell: set-up, the measured window, the check, the result line.

A cell of ``BENCHMARK.json`` names a configuration (a deployment: schema,
rows, tuner constraints) and a traffic mix; each is a data file of its own,
and each per-layer metric is a reader in ``metrics/<name>.py``. So a new
cell, configuration, mix or metric is new files plus entries, never an edit.

The window drives the port's online serving path as deployed:
``OnlineRuntime.submit`` and ``tick`` with synchronous flushes, under a
closed loop of C clients, each sending its next query as soon as its last
one completes. Requests are timed on the harness's own clock.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from mintbench import check, gen, yardstick

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names
clock = time.perf_counter


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s manifest with its configuration, its
    mix, and the metrics it reports."""
    man = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = man["end_to_end"]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, config=load_json(root / cfg_entry["file"]),
                mix=load_json(root / "mintbench" / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def load_reader(root: Path, name: str):
    """The module ``metrics/<name>.py`` of ``root``: LAYER, UNIT, SOURCE,
    MOVES and ``read(record)``, which returns None when it finds nothing."""
    path = root / "mintbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mintbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Served:
    """One query of the stream and what became of it."""

    idx: int            # the query's place in the stream
    t_sub: float
    ticket: object
    t_done: float | None = None


@dataclass
class TraceRecord:
    """What a traced run hands the per-layer readers."""

    tune_s: float
    index_build_s: float
    rows: int
    dims: list[int]
    peaks: dict | None
    window: tuple[float, float] | None = None         # profiler clock, s
    window_s: float = 0.0
    served: int = 0                                   # queries done in the traced region
    flushes: int = 0                                  # batcher counters over it
    flushed_queries: int = 0
    groups: list[dict] = field(default_factory=list)  # plan_group spans
    dispatches: int = 0                               # dispatch spans (flushes)
    device_ops: list[tuple] = field(default_factory=list)  # (name, start_s, end_s)
    host_ops: list[tuple] = field(default_factory=list)
    busy_s: float | None = None
    lat_ms: list[float] = field(default_factory=list)  # queries done in the window

    def vid_dim(self, vid) -> int:
        return int(sum(self.dims[c] for c in vid))


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- set-up ---------------------------------------------------------------------


class Stream:
    """The served queries of a run, drawn from its seed: query ``i`` asks
    for the top-k of template ``vids[i]`` with vectors ``vecs[i]``. A stream
    is longer than any window sends, so no query repeats another; past its
    end it would start again."""

    def __init__(self, vids: list, vecs: np.ndarray, k: int, dims: list[int], qid0: int):
        self.vids, self.vecs, self.k, self.qid0 = vids, vecs, k, qid0
        self.offs = np.concatenate([[0], np.cumsum(dims)])

    def __len__(self) -> int:
        return len(self.vids)

    def query(self, pos: int):
        """The query sent at place ``pos`` of the run."""
        from repro_torch.core.types import Query
        i = pos % len(self)
        row, offs = self.vecs[i], self.offs
        return Query(qid=self.qid0 + pos, vid=self.vids[i], k=self.k,
                     vectors={c: row[offs[c]:offs[c + 1]] for c in self.vids[i]})


def build_inputs(cell: Cell, seed: int, device: torch.device):
    """The database (host numpy, as the program takes it) and the tuner's
    workload, the deployment's own (from the configuration's ``data_seed``),
    and the stream of served queries, from the run's ``seed``: warm-up
    first, then the window."""
    from repro_torch.core.types import Workload
    from repro_torch.data.vectors import MultiVectorDatabase
    cfg, mix = cell.config, cell.mix
    cols = gen.make_columns(cfg, cfg["data_seed"], device)
    vids, probs = gen.templates(len(cols), mix["templates"])
    tvecs = gen.template_vectors(cols, len(vids), mix["noise"], cfg["data_seed"])
    which, vecs = gen.draw_queries(cols, probs, mix["stream"], mix["block"], mix["noise"],
                                   seed, "served")
    host = [c.cpu().numpy() for c in cols]
    del cols
    dims = [d for _, d in cfg["columns"]]
    db = MultiVectorDatabase(host, [n for n, _ in cfg["columns"]])
    templ = Stream(vids, tvecs, mix["k"], dims, 0)
    workload = Workload([templ.query(i) for i in range(len(vids))], probs)
    return db, workload, Stream([vids[t] for t in which], vecs, mix["k"], dims, len(vids))


def build_runtime(cell: Cell, db, workload, device: torch.device, observe: bool):
    """Tune, build the tuned indexes, and start the runtime; returns it with
    the tuner's and the builds' seconds."""
    from repro_torch.core.tuner import Mint
    from repro_torch.core.types import Constraints
    from repro_torch.index.registry import IndexStore
    from repro_torch.online.runtime import OnlineRuntime, RuntimeConfig
    cfg = cell.config
    constraints = Constraints(theta_recall=cfg["theta_recall"],
                              theta_storage=cfg["theta_storage"],
                              storage_mode=cfg["storage_mode"])
    t0 = clock()
    mint = Mint(db, index_kind=cfg["index_kind"], seed=cfg["tuner_seed"],
                min_sample_rows=cfg["min_sample_rows"], device=device)
    result = mint.tune(workload, constraints)
    sync(device)
    tune_s = clock() - t0
    t0 = clock()
    store = IndexStore(db, seed=cfg["tuner_seed"], device=device)
    for spec in sorted(result.configuration, key=lambda s: s.name):
        store.get(spec)
    sync(device)
    index_build_s = clock() - t0
    rc = RuntimeConfig(**{**cfg.get("runtime", {}), **cell.mix.get("runtime", {}),
                          "observe": observe})
    rt = OnlineRuntime(db, mint, workload, constraints, result=result, store=store,
                       config=rc, device=device)
    return rt, tune_s, index_build_s


# ---- the closed loop ----------------------------------------------------------


def closed_loop(rt, stream: Stream, start: int, clients: int, *,
                rounds: int | None = None, until: float | None = None,
                label=None) -> list[Served]:
    """Run C clients against ``rt``: each sends the next query of ``stream``
    (from ``start`` on) as soon as its last one completed; a flush
    runs inside the ``submit`` that fills the batch or the ``tick`` whose
    deadline is due.
    Stops starting rounds after ``rounds`` or once the clock passes
    ``until``, then drains. Returns every query sent."""
    served: list[Served] = []
    waiting: list[Served] = []
    ready = clients
    batches = rt.batcher.stats.batches
    label = label or (lambda name: contextlib.nullcontext())

    def harvest() -> int:
        nonlocal waiting, batches
        batches = rt.batcher.stats.batches
        now, still, n = clock(), [], 0
        for s in waiting:
            if s.ticket.done:
                s.t_done = now
                n += 1
            else:
                still.append(s)
        waiting = still
        return n

    r, pos = 0, start
    while (rounds is None or r < rounds) and (until is None or clock() < until):
        r += 1
        done = 0
        with label("mintbench.submit"):
            for _ in range(ready):
                q, t_sub = stream.query(pos), clock()
                s = Served(pos % len(stream), t_sub, rt.submit(q))
                pos += 1
                served.append(s)
                waiting.append(s)
                if rt.batcher.stats.batches != batches:
                    done += harvest()
        with label("mintbench.tick"):
            rt.tick()
        if rt.batcher.stats.batches != batches:
            done += harvest()
        ready = done
    if waiting:
        rt.drain()
        harvest()
    return served


# ---- the device trace ----------------------------------------------------------


def _ev_range(ev) -> tuple[float, float]:
    """(start, end) in seconds of a kineto event, across torch versions."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


LABEL = "mintbench."  # the harness's own ranges (``record_function``)


def read_profile(prof):
    """(device ops, host ops, window) from a torch profiler run: each op as
    (name, start_s, end_s) on the profiler's clock, the window as the span of
    the harness's ``mintbench.window`` range. The harness's ranges also show
    on the device's timeline as annotations; they are no device work."""
    from torch.autograd import DeviceType
    dev, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s, e = _ev_range(ev)
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(LABEL):
                dev.append((name, s, e))
        elif name == LABEL + "window":
            window = (s, e)
        else:
            host.append((name, s, e))
    return dev, host, window


def spans_of(served: list[Served]) -> tuple[list[dict], int, list[tuple]]:
    """The engine's ``plan_group`` spans under the flushes that served
    ``served`` (each flush's ``dispatch`` span, counted once), their number,
    and every span of those flushes as (name, t0, t1) on the harness's clock."""
    seen, groups, spans = set(), [], []
    for s in served:
        trace = getattr(s.ticket, "trace", None)
        if trace is None:
            continue
        for sp in trace.root.children:
            if sp.name != "dispatch" or sp.span_id in seen:
                continue
            seen.add(sp.span_id)
            spans.extend((f"span:{x.name}", x.t0, x.t1) for x in sp.walk()
                         if x.t1 is not None)
            for g in sp.children:
                if g.name == "plan_group":
                    groups.append(dict(flush=sp.span_id, ms=g.duration_ms,
                                       plan_sig=g.attrs.get("plan_sig", ()),
                                       batch=int(g.attrs.get("batch", 0))))
    return groups, len(seen), spans


def read_trace(rec: TraceRecord, prof, served: list[Served], t0: float) -> None:
    """Fill ``rec`` from the profiler and from the spans of the flushes that
    served the window, which opened at ``t0`` on the harness's clock."""
    rec.groups, rec.dispatches, spans = spans_of(served)
    dev_ops, host_ops, window = read_profile(prof)
    note(f"trace: {len(dev_ops)} device ops, {len(host_ops)} host ops, "
         f"{len(spans)} program spans, window {window}")
    if window is None:
        return
    lo, hi = window
    rec.window, rec.window_s = window, hi - lo
    rec.device_ops = [op for op in dev_ops if op[2] > lo and op[1] < hi]
    # the program's spans on the profiler's clock: both windows open together
    # (the range, then the harness's clock reading)
    shift = lo - t0
    rec.host_ops = host_ops + [(n, a + shift, b + shift) for n, a, b in spans]
    if rec.device_ops:
        rec.busy_s = yardstick.busy_time([op[1:] for op in rec.device_ops], lo, hi)


# ---- one run ---------------------------------------------------------------------


def warmup_queries(cell: Cell) -> int:
    """The queries of the stream that warm-up sends before the window."""
    return int(cell.mix["warmup_rounds"]) * int(cell.mix["clients"])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, root: Path = ROOT, fault=None) -> dict:
    """One run of ``cell``; returns the result line as a dict. ``fault``, for
    the tests only, breaks the runtime before the window."""
    mix, cfg = cell.mix, cell.config
    if mix["loop"] != "closed":
        raise ValueError(f"traffic {mix['loop']!r}: the harness drives closed loops")
    clients = int(mix["clients"])
    warm = warmup_queries(cell)
    db, workload, stream = build_inputs(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    note(f"inputs made at {clock() - t_process:.3f} s")
    rt, tune_s, index_build_s = build_runtime(cell, db, workload, device, observe=trace)
    note(f"tune {tune_s:.3f} s, index builds {index_build_s:.3f} s: "
         f"{sorted(s.name for s in rt.result.configuration)}")
    # warm-up: each template once (the engine uploads the columns a plan
    # reads on first use), then rounds of the cell's own traffic
    for q in workload.queries:
        rt.submit(q)
    rt.drain()
    closed_loop(rt, stream, 0, clients, rounds=int(mix["warmup_rounds"]))
    if fault is not None:
        fault(rt)
    sync(device)
    before = rt.batcher.snapshot_stats()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        with profile(activities=acts) as prof:
            with record_function("mintbench.window"):
                t0 = clock()
                served = closed_loop(rt, stream, warm, clients, until=t0 + seconds,
                                     label=record_function)
                sync(device)
    else:
        t0 = clock()
        served = closed_loop(rt, stream, warm, clients, until=t0 + seconds)
    setup_s = t0 - t_process
    t_end = t0 + seconds
    after = rt.batcher.snapshot_stats()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    in_window = [s for s in served if s.t_done is not None and s.t_done <= t_end]
    lat_ms = [(s.t_done - s.t_sub) * 1e3 for s in in_window]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                "count": 1, "memory_peak_bytes": int(peak),
                "power_limit": card_power_limit() if device.type == "cuda" else None}

    rec = None
    if trace:
        rec = TraceRecord(tune_s=tune_s, index_build_s=index_build_s, rows=db.n_rows,
                          dims=db.dims,
                          peaks=yardstick.peaks_for(kind) if device.type == "cuda" else None,
                          served=sum(s.t_done is not None for s in served),
                          flushes=after.batches - before.batches,
                          flushed_queries=after.queries - before.queries,
                          lat_ms=lat_ms)
        read_trace(rec, prof, served, t0)
        del prof

    answers = [None if s.ticket.ids is None else np.asarray(s.ticket.ids) for s in served]
    qvids = [stream.vids[s.idx] for s in served]
    pos = np.array([s.idx for s in served], dtype=np.int64)
    attempted = len(served)
    # the program's state goes before the reference runs: a peak never falls
    rt.close()
    for s in served:
        s.ticket = None
    del rt, workload
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cols = [torch.as_tensor(c, device=device) for c in db.columns]
    k, theta = int(mix["k"]), float(cfg["theta_recall"])
    checks = check.judge(answers, qvids, stream.vecs, pos, cols, db.dims, k, theta, seed)
    del cols

    metrics: dict = {}
    if not trace:
        values = {
            "qps": len(in_window) / seconds,
            "recall_mean": checks["recall_mean"]["value"],
            "peak_device_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(root, m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": check.passed(checks), "attempted": attempted,
           "failed": checks["unanswered"]["value"], "metrics": metrics,
           "device": dev_info}
    if rec is not None:
        if rec.busy_s is not None:
            out["device"].update(busy_s=rec.busy_s, window_s=rec.window_s)
        out["breakdown"] = breakdown(rec)
    out["checks"] = checks
    return out


def breakdown(rec: TraceRecord) -> dict:
    """The device ops that took most time, and the idle gaps by what the host
    was doing, ten of each."""
    ops: dict[str, float] = {}
    for name, s, e in rec.device_ops:
        ops[name[:120]] = ops.get(name[:120], 0.0) + (e - s)
    gaps: dict[str, float] = {}
    if rec.device_ops and rec.window is not None:
        win = [(s, e) for _, s, e in rec.device_ops]
        gaps = yardstick.host_activity(yardstick.idle_gaps(win, *rec.window),
                                       rec.host_ops)
    return {"device_ops": yardstick.top(ops), "idle_gaps": yardstick.top(gaps)}


def note(msg: str) -> None:
    print(f"mintbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the last
    line of standard output."""
    for name, c in result["checks"].items():
        if "limit" in c:
            print(f"check {name}: {c['value']} (needs {c['need']} {c['limit']})",
                  file=sys.stderr)
        else:
            print(f"check {name}: {c['value']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
