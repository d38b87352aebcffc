#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MINT on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/kernels/``), then:

  1. environment: the card, its power limit, CUDA, nvcc, the build time;
  2. each kernel against its plain PyTorch version on the card, over the
     parity grid of ``repro_torch.kernels.parity`` (ragged cases and a deep
     k = 2048, x metrics x f32/bf16) and its tolerance rule;
  3. MINT's main path at real scale: the paper's 8-column pool at 1,000,000
     rows, the bisimple workload (k = 100), ``Mint(index_kind="ivf")``
     tuned at theta_recall = 0.9 / 4 indexes, indexes built, the MINT and
     PerColumn plans served through ``BatchEngine`` (streaming scan), again
     with the two-pass scan (ids must be equal), then 64-query bursts that
     must take one scan dispatch per (group, index). Kernel launch counts are
     zeroed before and read after; every kernel must have run. The shape of
     the largest distance dispatch of each kind (IVF centroids, rerank union,
     two-pass flat scan) is noted;
  4. each kernel against its plain version again, and timed (CUDA events,
     median of 20) beside the plain version, one PyTorch library call and
     the bound, at those main-path shapes;
  5. the same path on the CPU and on the card at the serving-test scale
     (2,500 rows): configuration, plans, numDist, costs and ids must agree.

Any failure exits non-zero. The last three lines are the card's name and
power limit, the kernel table and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


# ---- card facts --------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float, str]:
    """(bytes/s, f32 non-tensor flop/s, which data sheet) for the H100."""
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe"
    if "NVL" in name:
        return 3.9e12, 60e12, "H100 NVL"
    return 3.35e12, 67e12, "H100 SXM"


def bound(bytes_moved: float, flops: float, peaks) -> tuple[float, str]:
    t_bytes = bytes_moved / peaks[0] * 1e3
    t_ops = flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---- kernel vs plain ----------------------------------------------------------


def phase_kernel_grid(dev, errs: dict) -> None:
    from repro_torch.kernels.parity import CARD_CASES, check_case
    for name in CARD_CASES:
        for metric in ("dot", "cosine", "l2"):
            for dtype in (torch.float32, torch.bfloat16):
                res = check_case(name, metric, dtype, dev)
                errs["streaming_fused_scan"] = max(errs["streaming_fused_scan"],
                                                   res["streaming_max_abs_err"])
                errs["batched_scores"] = max(errs["batched_scores"],
                                             res["distance_max_abs_err"])
                emit("kernel_grid", case=name, metric=metric,
                     dtype=str(dtype).removeprefix("torch."), **res)


class DistanceDispatches:
    """The largest distance-kernel dispatch of each kind the engines make:
    IVF centroid scoring, the rerank over the group's candidate union, and
    the two-pass flat scan (whose scores then go through top-k). It wraps
    the engines' methods to note each dispatch's shape and queries; what
    they compute is unchanged. The kernels are then held against their plain
    versions and timed at exactly these shapes."""

    def __init__(self):
        self.kind = self.col = None
        self.largest: dict[str, dict] = {}

    def note(self, kind, qmat, n, rows, **extra):
        B, d = qmat.shape
        old = self.largest.get(kind)
        if old is None or B * n * d > math.prod(old["shape"]):
            self.largest[kind] = dict(shape=(B, n, d), qmat=qmat.clone(), rows=rows,
                                      **extra)

    def attach(self, engine) -> None:
        ivf_scan, rerank = engine._ivf_scan, engine._rerank
        flat, scored = engine._flat_scan_scored, engine._batched_scores

        def within(kind, fn):
            def run(group, *args):
                self.kind, self.col = kind, engine.cstore.device(group.key.vid)
                try:
                    return fn(group, *args)
                finally:
                    self.kind = self.col = None
            return run

        def batched_scores(qmat, sub):
            if self.kind == "centroids":  # the centroid table: kept as it is
                self.note("centroids", qmat, sub.shape[0], lambda sub=sub: sub)
            elif self.kind == "rerank":  # the union's rows: as many of the column
                self.note("rerank", qmat, sub.shape[0],
                          lambda col=self.col, n=sub.shape[0]: col.data[:n])
            return scored(qmat, sub)

        def flat_scan_scored(col, qmat, k):
            if not engine.streaming:
                self.note("flat_two_pass", qmat, col.data.shape[0],
                          lambda col=col: col.data, k=k, valid_n=col.n_rows)
            return flat(col, qmat, k)

        engine._ivf_scan = within("centroids", ivf_scan)
        engine._rerank = within("rerank", rerank)
        engine._batched_scores = batched_scores
        engine._flat_scan_scored = flat_scan_scored


# ---- the main path --------------------------------------------------------------


def run_path(db, workload, constraints, device, min_sample_rows=2000,
             per_column=True, dispatches=None):
    """tune -> build -> serve MINT (and PerColumn) on ``device``; returns a
    dict of results and wall times. ``dispatches`` (a ``DistanceDispatches``)
    is attached to the serving engine."""
    from repro_torch.core.tuner import Mint, ground_truth_cache
    from repro_torch.index.registry import IndexStore
    from repro_torch.serve.engine import BatchEngine
    out = {}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    mint = Mint(db, index_kind="ivf", seed=0, min_sample_rows=min_sample_rows,
                device=device)
    result = mint.tune(workload, constraints)
    pc = mint.per_column(workload, constraints) if per_column else None
    sync()
    out["tune_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = IndexStore(db, seed=0, device=device)
    for cfg in [result.configuration] + ([pc.configuration] if pc else []):
        for spec in sorted(cfg, key=lambda s: s.name):
            store.get(spec)
    sync()
    out["index_build_s"] = time.perf_counter() - t0
    gt = ground_truth_cache(db, workload)
    engine = BatchEngine(db, store=store, streaming=True)
    if dispatches is not None:
        dispatches.attach(engine)
    t0 = time.perf_counter()
    out["mint"] = engine.execute_workload(workload, result, gt)
    out["per_column"] = engine.execute_workload(workload, pc, gt) if pc else None
    sync()
    out["serve_s"] = time.perf_counter() - t0
    out["counters"] = engine.counters.as_dict()
    out.update(result=result, pc=pc, store=store, engine=engine, gt=gt)
    return out


def ids_of(metrics):
    return [np.asarray(m.ids) for m in metrics.per_query]


def phase_main_path(rows: int, dev) -> dict:
    from repro_torch.core.types import Constraints, QueryPlan, config_name
    from repro_torch.data.vectors import PAPER_COLUMNS, make_database, make_queries, make_workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.compiler import compile_batch
    from repro_torch.serve.engine import BatchEngine
    t0 = time.perf_counter()
    db = make_database(rows, PAPER_COLUMNS, seed=0)
    workload = make_workload(db, "bisimple", k=100, seed=0)
    emit("data", rows=db.n_rows, columns=db.dims, total_dim=sum(db.dims),
         queries=[q.name for q in workload.queries],
         seconds=time.perf_counter() - t0)
    constraints = Constraints(theta_recall=0.9, theta_storage=4)

    dispatches = DistanceDispatches()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    r = run_path(db, workload, constraints, dev, dispatches=dispatches)
    mint_m, pc_m = r["mint"], r["per_column"]
    emit("main_path", configuration=config_name(r["result"].configuration),
         per_column=config_name(r["pc"].configuration),
         mint_weighted_cost=mint_m.weighted_cost,
         per_column_weighted_cost=pc_m.weighted_cost,
         cost_ratio_mint_over_per_column=mint_m.weighted_cost / pc_m.weighted_cost,
         mint_mean_recall=mint_m.mean_recall, mint_min_recall=mint_m.min_recall,
         per_column_mean_recall=pc_m.mean_recall,
         per_column_min_recall=pc_m.min_recall,
         theta_recall=constraints.theta_recall,
         dispatch_counters=r["counters"],
         tune_s=r["tune_s"], index_build_s=r["index_build_s"], serve_s=r["serve_s"],
         plans={q.name: r["result"].plans[q.qid].describe() for q in workload.queries})

    # the two-pass scan serves the same plans with identical ids
    two = BatchEngine(db, store=r["store"], cstore=r["engine"].cstore, streaming=False)
    dispatches.attach(two)
    t0 = time.perf_counter()
    for res, ref in ((r["result"], mint_m), (r["pc"], pc_m)):
        m2 = two.execute_workload(workload, res, r["gt"])
        for a, b in zip(ids_of(m2), ids_of(ref)):
            check(np.array_equal(a, b), "two-pass ids differ from the streaming run")
        check(m2.weighted_cost == ref.weighted_cost, "two-pass cost differs")
    emit("two_pass", ids_equal=True, seconds=time.perf_counter() - t0,
         dispatch_counters=two.counters.as_dict())

    # bursts: 64 queries on one vid and plan compile into ONE plan group
    q = max(workload.queries, key=lambda q: (len(r["result"].plans[q.qid].indexes), -q.qid))
    burst = make_queries(db, [q.vid] * 64, k=q.k, seed=7)
    flat = QueryPlan(q.qid, [], [], 0.0, 1.0)  # the planner's flat-scan fallback plan
    bursts = {}
    for label, plan in (("plan", r["result"].plans[q.qid]), ("flat", flat)):
        pairs = [(bq, plan) for bq in burst]
        check(len(compile_batch(pairs)) == 1, "burst did not compile to one group")
        got = {}
        for eng in (r["engine"], two):
            eng.counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[eng.streaming] = eng.search_batch(pairs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(eng.counters.scan == max(len(plan.indexes), 1),
                  f"burst took {eng.counters.scan} scan dispatches")
            bursts[f"{label}_{'streaming' if eng.streaming else 'two_pass'}"] = dict(
                seconds=dt, dispatch_counters=eng.counters.as_dict())
        for a, b in zip(got[True], got[False]):
            check(np.array_equal(a, b), f"{label} burst: two-pass ids differ")
    emit("burst", query=q.name, plan=r["result"].plans[q.qid].describe(), batch=64,
         ids_equal_streaming_two_pass=True, **bursts)

    counts = launch_counts()
    emit("launches", **counts,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         resident_column_bytes=r["engine"].cstore.total_device_bytes())
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    col = r["engine"].cstore.device(q.vid)
    qmat = col.pad_queries(np.stack([bq.concat() for bq in burst]))
    emit("distance_dispatches", **{kind: dict(shape=rec["shape"], **{
        key: rec[key] for key in ("k", "valid_n") if key in rec})
        for kind, rec in dispatches.largest.items()})
    check(set(dispatches.largest) == {"centroids", "rerank", "flat_two_pass"},
          f"main path made distance dispatches of kinds {sorted(dispatches.largest)}")
    return dict(counts=counts, col=col, qmat=qmat, k=q.k, dispatches=dispatches.largest)


# ---- times at the main path's shapes -----------------------------------------------


def phase_kernel_times(main: dict, dev, peaks, errs: dict) -> list[dict]:
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ops import _mask_rows
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import check_scores, check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.kernels.topk.kernel import topk_scores
    from repro_torch.kernels.topk.ref import topk_ref
    col, qmat, k = main["col"], main["qmat"], main["k"]
    N, d = col.n_rows, col.padded_dim
    rows = []

    def row(name, route, source, replaces, shape, ms, plain_ms, library_ms, b):
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=main["counts"][name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                         library_ms=library_ms, shape=shape))
        emit("kernel_time", **rows[-1])

    # streaming scan over the burst's resident column: the flat burst's
    # dispatch (B = 64) and a single query
    for B in (1, 64):
        q = qmat[:B].contiguous()
        vals, ids = streaming_fused_scan(q, col.data, k=k, valid_n=N)
        rvals, rids = streaming_fused_scan_ref(q, col.data, k, valid_n=N)
        full = combined_plain_scores(q, col.data, "dot", dict(valid_n=N))
        e, swaps = check_topk(vals, ids, rvals, rids, full, d, f"streaming at B={B}")
        errs["streaming_fused_scan"] = max(errs["streaming_fused_scan"], e)
        ms = cuda_ms(lambda: streaming_fused_scan(q, col.data, k=k, valid_n=N))
        plain = cuda_ms(lambda: streaming_fused_scan_ref(q, col.data, k, valid_n=N))
        lib = cuda_ms(lambda: torch.topk(q @ col.data[:N].T, k, dim=1))
        b = bound(4 * (B * d + N * d) + 8 * B * k, 2.0 * B * N * d, peaks)
        if B == 64:
            row("streaming_fused_scan", "cuda", "src/repro_torch/csrc/streaming.cu",
                "src/repro/kernels/streaming/kernel.py:44", [B, N, d, k], ms, plain,
                lib, b)
        else:
            emit("kernel_time", name="streaming_fused_scan", shape=[B, N, d, k], ms=ms,
                 plain_ms=plain, library_ms=lib, bound_ms=b[0], bound_by=b[1],
                 near_tie_swaps=swaps)

    # distance: the largest dispatch of each kind on the main path (its own
    # queries; the rerank's rows are as many rows of the same column), then
    # the two nominal serving shapes on seeded random inputs. The table row
    # is the rerank: the largest distance dispatch of the default (streaming)
    # serving path
    g = torch.Generator().manual_seed(1)
    disp = main["dispatches"]
    cases = [(kind, disp[kind]["qmat"], disp[kind]["rows"]())
             for kind in ("centroids", "rerank", "flat_two_pass")]
    cases += [(f"nominal_{n}x{dd}", torch.randn(64, dd, generator=g).to(dev),
               torch.randn(n, dd, generator=g).to(dev))
              for n, dd in ((1000, 384), (4096, 1024))]
    for label, q, x in cases:
        (B, dd), n = q.shape, x.shape[0]
        de = check_scores(batched_scores(q, x), batched_scores_ref(q, x), dd,
                          f"distance {label} at ({B}, {n}, {dd})")
        errs["batched_scores"] = max(errs["batched_scores"], de)
        ms = cuda_ms(lambda: batched_scores(q, x))
        plain = cuda_ms(lambda: batched_scores_ref(q, x))
        lib = cuda_ms(lambda: q @ x.T)
        b = bound(4 * (B * dd + n * dd + B * n), 2.0 * B * n * dd, peaks)
        if label == "rerank":
            row("batched_scores", "cuda", "src/repro_torch/csrc/distance.cu",
                "src/repro/kernels/distance/kernel.py:23", [B, n, dd], ms, plain, lib, b)
        emit("kernel_time", name="batched_scores", dispatch=label, shape=[B, n, dd],
             ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0], bound_by=b[1],
             max_abs_err=de)

    # top-k over the two-pass flat scan's masked (B, N) scores at its own k,
    # as fused_scan computes them, then at the nominal k = 128
    flat = disp["flat_two_pass"]
    scores = _mask_rows(batched_scores_ref(flat["qmat"], flat["rows"]()), flat["valid_n"])
    B, n = scores.shape
    for kk in (min(flat["k"], flat["valid_n"]), 128):
        tv, ti = topk_scores(scores, kk)
        tr, tri = topk_ref(scores, kk)
        check(torch.equal(tv, tr) and torch.equal(ti, tri),
              f"top-k differs at ({B}, {n}, {kk})")
        ms = cuda_ms(lambda: topk_scores(scores, kk))
        plain = cuda_ms(lambda: topk_ref(scores, kk))
        lib = cuda_ms(lambda: torch.topk(scores, kk, dim=1))
        b = bound(4 * scores.numel() + 8 * B * kk, 0.0, peaks)
        if kk == 128:
            emit("kernel_time", name="topk_scores", dispatch="nominal", shape=[B, n, kk],
                 ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0], bound_by=b[1])
        else:
            row("topk_scores", "cuda", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/topk/kernel.py:42", [B, n, kk], ms, plain, lib, b)
    return rows


# ---- CPU vs card -----------------------------------------------------------------------


def phase_cpu_vs_card() -> None:
    from repro_torch.core.types import Constraints
    from repro_torch.data.vectors import make_database, make_workload
    db = make_database(2500, [("a", 32), ("b", 48), ("c", 24)], seed=0)
    workload = make_workload(db, "naive", k=10, seed=0)
    constraints = Constraints(theta_recall=0.85, theta_storage=3)
    runs = {dev: run_path(db, workload, constraints, dev, min_sample_rows=600)
            for dev in ("cpu", "cuda")}
    a, b = runs["cpu"], runs["cuda"]
    check(a["result"].configuration == b["result"].configuration,
          "configuration differs between CPU and card")
    for res in ("result", "pc"):
        for qid, p in a[res].plans.items():
            p2 = b[res].plans[qid]
            check((p.indexes, p.eks) == (p2.indexes, p2.eks), f"plan of q{qid} differs")
    for key in ("mint", "per_column"):
        for m1, m2 in zip(a[key].per_query, b[key].per_query):
            check(np.array_equal(np.asarray(m1.ids), np.asarray(m2.ids)),
                  f"{key} ids differ for q{m1.qid}")
            check((m1.num_dist, m1.cost) == (m2.num_dist, m2.cost),
                  f"{key} numDist/cost differ for q{m1.qid}")
    emit("cpu_vs_card", rows=2500, configuration_equal=True, plans_equal=True,
         ids_equal=True, num_dist_equal=True, costs_equal=True,
         cost_ratio=a["mint"].weighted_cost / a["per_column"].weighted_cost,
         cpu_counters=a["counters"], card_counters=b["counters"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="rows of the main-path database (cut only if the time "
                         "limit forces it; the cut is printed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common
    from repro_torch.kernels.parity import ParityError

    dev = torch.device("cuda")
    common.strict_fp32()
    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([common.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    lib = common.load_library()
    emit("environment", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, device=torch.cuda.get_device_name(0),
         kernel_library=Path(lib._name).name, build_s=time.perf_counter() - t0)
    peaks = card_peaks(card)
    errs = {"streaming_fused_scan": 0.0, "batched_scores": 0.0, "topk_scores": 0.0}
    try:
        phase_kernel_grid(dev, errs)
        if args.rows != 1_000_000:
            emit("scale_cut", rows=args.rows, paper_rows=1_000_000)
        main_path = phase_main_path(args.rows, dev)
        rows = phase_kernel_times(main_path, dev, peaks, errs)
        phase_cpu_vs_card()
    except (SmokeFailure, ParityError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    emit("done", seconds=time.perf_counter() - t_start, peaks=peaks[2])
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
