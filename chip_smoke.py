#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MINT on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/kernels/``), then:

  1. environment: the card, its power limit, CUDA, nvcc, the build time;
  2. each kernel against its plain PyTorch version on the card, over the
     parity grids of ``repro_torch.kernels.parity`` and their tolerance
     rules: the scan, distance and top-k grid (ragged cases, a deep
     k = 2048, and the scan's own cuts: many row blocks, two query tiles,
     a 2048-key list, a shrunk query tile; x metrics x f32/bf16/f16), then
     the flash-attention grid (MHA, GQA, MQA, causal or not, window x
     softcap, d = 128 on a ragged S, Sq = 1, fully masked rows, long split
     decodes, tensor-core tiles; x f32/bf16/f16), which must run all three
     flash routes (split_kv, tensor_core, fp32);
  3. MINT's main path at real scale: the paper's 8-column pool at 1,000,000
     rows, the bisimple workload (k = 100), ``Mint(index_kind="ivf")``
     tuned at theta_recall = 0.9 / 4 indexes, indexes built, the MINT and
     PerColumn plans served through ``BatchEngine`` (streaming scan), again
     with the two-pass scan (ids must be equal), then 64-query bursts that
     must take one scan dispatch per (group, index). Kernel launch counts are
     zeroed before and read after; every kernel must have run. The shape of
     the largest distance dispatch of each kind (IVF centroids, rerank union,
     two-pass flat scan) is noted;
  4. each kernel against its plain version again, and timed (device time:
     CUDA events around each call behind a busy stream, median of 20)
     beside the plain version, one PyTorch library call and the bound, at
     those main-path shapes;
  5. the same path on the CPU and on the card at the serving-test scale
     (2,500 rows): configuration, plans, numDist, costs and ids must agree;
  6. the model substrate's serving path at Gemma-2-27B's full width and
     depth (46 layers, d_model 4608, 32 / 16 heads of 128, d_ff 36864,
     vocab 256000; 27.2e9 random bf16 parameters from a seed), after the
     MINT phases' tensors are released: a prefill of 2 prompts x 8192
     tokens from ``TokenPipeline``, the cache grown, 16 greedy decode steps,
     then a prefill of the 8193 tokens, whose logits the first decode
     step's must match (rtol 0.15, atol 0.35, the same top-1 token).
     Attention runs in the flash kernel, whose launches are zeroed before
     and read after. The q / k / v of the first local and first global
     layer's prefill and of one decode step are noted;
  7. the flash kernel against its plain version at those noted calls, in
     bf16 and again in float32 on the same inputs, and timed beside the
     plain version, the library call of the same function (flex_attention
     with a softcap score_mod and a causal + window block mask, compiled),
     an SDPA call that does less work (no softcap), and the bound at the
     bf16 tensor-core rate;
  8. the same model path on the CPU and on the card at
     ``gemma2-27b.reduced()``: logits within the same tolerance, the same
     top-1 tokens.

Any failure exits non-zero. The last three lines are the card's name and
power limit, the kernel table and ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MINT_KERNELS = ("streaming_fused_scan", "batched_scores", "topk_scores")
MODEL = "gemma2-27b"
PROMPTS, PROMPT_LEN, DECODE_STEPS = 2, 8192, 16
# the JAX suite's prefill-vs-decode tolerance (tests/test_arch_smoke.py)
LOGIT_RTOL, LOGIT_ATOL = 0.15, 0.35
# torch.cuda._sleep spins for a count of SM clock cycles; 2e9 a second is at
# or above the card's clock, so a sleep lasts at least the time asked for
SLEEP_CYCLES_PER_S = 2e9


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


def card_peaks(name: str) -> dict:
    """The H100's published peaks (data sheet, dense): memory bytes/s, f32
    flop/s outside the tensor cores, bf16 tensor-core flop/s."""
    if "PCIe" in name:
        return dict(bytes=2.0e12, fp32=51e12, bf16=756e12, part="H100 PCIe")
    if "NVL" in name:
        return dict(bytes=3.9e12, fp32=60e12, bf16=835e12, part="H100 NVL")
    return dict(bytes=3.35e12, fp32=67e12, bf16=989e12, part="H100 SXM")


def bound(bytes_moved: float, flops: float, peaks, rate: str = "fp32"
          ) -> tuple[float, str]:
    """The least time (ms) for ``bytes_moved`` and ``flops`` at the card's
    memory rate and its peak for the operands' type (``rate``)."""
    t_bytes = bytes_moved / peaks["bytes"] * 1e3
    t_ops = flops / peaks[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The device time of one call of ``fn`` (ms): the median over ``reps``
    calls, each between two CUDA events. The stream is first held busy
    (``torch.cuda._sleep``) for longer than the host takes to enqueue the
    call, so the events time the device's work and not the Python around
    the launches (a call's host time exceeds a decode-size kernel's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(SLEEP_CYCLES_PER_S * (3 * host_s + 1e-3))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
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
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
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

    counts = {name: n for name, n in launch_counts().items() if name in MINT_KERNELS}
    emit("launches", **counts,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         resident_column_bytes=r["engine"].cstore.total_device_bytes())
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the MINT path")
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
    from repro_torch.kernels.streaming.kernel import scan_grid
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.kernels.topk.kernel import topk_scores
    from repro_torch.kernels.topk.ref import topk_ref
    col, qmat, k = main["col"], main["qmat"], main["k"]
    N, d = col.n_rows, col.padded_dim
    rows = []

    def row(name, route, source, replaces, shape, ms, plain_ms, library_ms, b, **extra):
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=main["counts"][name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                         library_ms=library_ms, shape=shape))
        emit("kernel_time", **rows[-1], **extra)

    def rates(flops, nbytes, ms):
        return dict(achieved_tflops=flops / ms / 1e9, achieved_gbps=nbytes / ms / 1e6)

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
        nbytes, flops = 4 * (B * d + N * d) + 8 * B * k, 2.0 * B * N * d
        b = bound(nbytes, flops, peaks)
        grid = scan_grid(B, col.data.shape[0], 0, k,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
        extra = dict(**rates(flops, nbytes, ms), near_tie_swaps=swaps,
                     grid=dict(query_tile=grid.qt, query_tiles=grid.n_qtiles,
                               rows_per_block=grid.rows_per_block, blocks=grid.P,
                               list_len=grid.lc))
        if B == 64:
            row("streaming_fused_scan", "cuda", "src/repro_torch/csrc/streaming.cu",
                "src/repro/kernels/streaming/kernel.py:44", [B, N, d, k], ms, plain,
                lib, b, **extra)
        else:
            emit("kernel_time", name="streaming_fused_scan", route="cuda",
                 shape=[B, N, d, k], ms=ms, plain_ms=plain, library_ms=lib,
                 bound_ms=b[0], bound_by=b[1], **extra)

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
        nbytes, flops = 4 * (B * dd + n * dd + B * n), 2.0 * B * n * dd
        b = bound(nbytes, flops, peaks)
        if label == "rerank":
            row("batched_scores", "cuda", "src/repro_torch/csrc/distance.cu",
                "src/repro/kernels/distance/kernel.py:23", [B, n, dd], ms, plain, lib, b,
                **rates(flops, nbytes, ms))
        emit("kernel_time", name="batched_scores", route="cuda", dispatch=label,
             shape=[B, n, dd], ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
             bound_by=b[1], max_abs_err=de, **rates(flops, nbytes, ms))

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
        nbytes = 4 * scores.numel() + 8 * B * kk
        b = bound(nbytes, 0.0, peaks)
        if kk == 128:
            emit("kernel_time", name="topk_scores", route="cuda", dispatch="nominal",
                 shape=[B, n, kk], ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
                 bound_by=b[1], **rates(0.0, nbytes, ms))
        else:
            row("topk_scores", "cuda", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/topk/kernel.py:42", [B, n, kk], ms, plain, lib, b,
                **rates(0.0, nbytes, ms))
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


# ---- the model substrate: Gemma-2-27B serving through the flash kernel ---------------


def phase_flash_grid(dev, errs: dict) -> None:
    from repro_torch.kernels.flash_attention.kernel import ROUTES, flash_attention
    from repro_torch.kernels.parity import FLASH_CASES, FLASH_DTYPES, check_flash_case
    routes = set()
    for name in FLASH_CASES:
        for label, dtype in FLASH_DTYPES.items():
            err = check_flash_case(name, dtype, dev)
            route, splits = flash_attention.last_route
            routes.add(route)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            emit("flash_grid", case=name, dtype=label, route=route, splits=splits,
                 max_abs_err=err)
    check(routes == set(ROUTES), f"the flash grid ran routes {sorted(routes)}")


def same_logits(got, want, what: str) -> dict:
    """Checks two (B, 1, V) logit tensors agree within the JAX suite's
    prefill-vs-decode tolerance with the same top-1 token; returns the
    numbers."""
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          f"{what}: logits not finite")
    diff = (got - want).abs()
    check(bool((diff <= LOGIT_ATOL + LOGIT_RTOL * want.abs()).all()),
          f"{what}: logits differ beyond rtol {LOGIT_RTOL} / atol {LOGIT_ATOL} "
          f"(max abs diff {diff.max().item():.4g})")
    top2 = want.topk(2, dim=-1).values
    check(torch.equal(got.argmax(-1), want.argmax(-1)), f"{what}: top-1 tokens differ")
    return dict(max_abs_diff=diff.max().item(), top1=want.argmax(-1).flatten().tolist(),
                top1_top2_gap=(top2[..., 0] - top2[..., 1]).flatten().tolist())


class FlashCalls:
    """The q / k / v of chosen flash-attention calls on the model path: the
    first local and the first global layer of the prefill, and of the first
    decode step. It wraps the kernel wrapper that the model's attention
    calls and holds what it is given (nothing is copied inside a timed
    window: later layers and steps leave those tensors and cache slots as
    they are); ``keep`` then makes compact copies in the model's
    (B, S, H, d) layout, once the timer has stopped. What the model computes
    is unchanged. The kernel is then held against its plain version and
    timed at exactly these inputs."""

    def __init__(self):
        self.phase = None
        self.noted: dict[str, dict] = {}

    def keep(self) -> None:
        for n in self.noted.values():
            if n.pop("held", False):
                for x in "qkv":
                    n[x] = n[x].transpose(1, 2).clone(memory_format=torch.contiguous_format)

    def attach(self):
        """Wraps ``models.attention.flash_attention``; returns an undo."""
        from repro_torch.models import attention as A
        from repro_torch.models.model import NO_WINDOW
        fn = A.flash_attention

        def noted(q, k, v, causal=True, window=0, softcap=0.0, scale=None):
            key = f"{self.phase}_{'global' if window >= NO_WINDOW else 'local'}"
            if self.phase and key not in self.noted:
                self.noted[key] = dict(q=q, k=k, v=v, causal=causal, window=window,
                                       softcap=softcap, held=True)
            return fn(q, k, v, causal=causal, window=window, softcap=softcap,
                      scale=scale)

        A.flash_attention = noted

        def undo():
            A.flash_attention = fn
        return undo


def decode_profile(step) -> dict:
    """One call of ``step`` under torch.profiler: its host wall time, the
    device time summed over its kernels (so the device's busy share of the
    step), and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                                  calls=e.count) for e in top])


def phase_model_path(dev) -> dict:
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step, make_serve_step
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated after the MINT phases")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    cfg = get_arch(MODEL)
    B, S = PROMPTS, PROMPT_LEN
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    emit("model_init", model=cfg.name, source=cfg.source, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         sliding_window=cfg.sliding_window, attn_softcap=cfg.attn_softcap,
         logit_softcap=cfg.logit_softcap, param_count=n_params,
         param_bytes=2 * n_params, allocated_bytes_before=left,
         seconds=time.perf_counter() - t0)
    tokens = TokenPipeline(cfg.vocab_size, B, S, seed=0).batch_at(0)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    calls = FlashCalls()
    undo = calls.attach()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        calls.phase = "prefill"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        calls.phase = None
        calls.keep()
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        big = M.grow_cache(cache, S + DECODE_STEPS + 1)
        del cache
        tok = logits.argmax(-1)
        first_tok, step_ms, generated = tok, [], []
        calls.phase = "decode"
        torch.cuda.synchronize()
        t_window = time.perf_counter()
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            step_logits, big = serve_step(params, big, tok, S + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            calls.phase = None
            check(bool(torch.isfinite(step_logits).all()),
                  f"decode step {i} logits not finite")
            if i == 0:
                first_logits = step_logits
            tok = step_logits.argmax(-1)
            generated.append(tok.flatten().tolist())
        decode_window_ms = (time.perf_counter() - t_window) * 1e3
        # one more step under the profiler: the device time by kernel
        profile = decode_profile(lambda: serve_step(params, big, tok, S + DECODE_STEPS))
        calls.keep()
        del big
        # the prompt and the first greedy token, prefilled at once
        full_tokens = np.concatenate([tokens, first_tok.cpu().numpy()], axis=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full_logits, cache = prefill_step(params, {"tokens": full_tokens})
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
        del cache
    finally:
        undo()
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    launches = launch_counts()["flash_attention"]
    route_launches = dict(flash_attention.route_launches)
    check(launches > 0, "kernel flash_attention never launched on the model path")
    check(route_launches["split_kv"] > 0 and route_launches["tensor_core"] > 0,
          f"flash routes on the model path: {route_launches}")
    agree = same_logits(first_logits, full_logits,
                        f"decode at position {S} vs prefill of {S + 1} tokens")
    peak = torch.cuda.max_memory_allocated()
    emit("model_path", model=cfg.name, prompts=B, prompt_len=S,
         decode_steps=DECODE_STEPS, prefill_s=prefill_s,
         prefill_tokens_per_s=B * S / prefill_s, prefill_s_at_len_plus_1=prefill2_s,
         decode_window_ms=decode_window_ms,
         decode_ms_per_step=decode_window_ms / DECODE_STEPS,
         decode_tokens_per_s=B * DECODE_STEPS * 1e3 / decode_window_ms,
         decode_ms_per_step_median=statistics.median(step_ms), decode_ms=step_ms,
         decode_step_profile=profile,
         first_tokens=first_tok.flatten().tolist(), generated=generated,
         decode_vs_prefill=agree, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
         flash_attention_launches=launches, flash_route_launches=route_launches,
         kv_cache_bytes=cache_bytes,
         max_memory_allocated_bytes=peak, card_memory_bytes=card_bytes,
         noted_calls={key: dict(q=list(n["q"].shape), k=list(n["k"].shape),
                                window=n["window"], softcap=n["softcap"])
                      for key, n in calls.noted.items()})
    check(set(calls.noted) == {"prefill_local", "prefill_global", "decode_local",
                               "decode_global"},
          f"noted flash calls {sorted(calls.noted)}")
    return dict(params=params, noted=calls.noted, launches=launches)


def kept_ranges(Sq: int, Skv: int, causal: bool, window: int):
    """Per q row, the first and last kv position the flash kernel's mask
    keeps (an empty row has last < first)."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return lo, hi


def kept_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the flash kernel's mask keeps: the work of this call."""
    lo, hi = kept_ranges(Sq, Skv, causal, window)
    return int(np.maximum(hi - lo + 1, 0).sum())


def kept_kv_rows(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """kv positions some q row keeps: the k / v rows this call must read
    (the rows' ranges move with q, so their union is one range)."""
    lo, hi = kept_ranges(Sq, Skv, causal, window)
    live = hi >= lo
    return int(hi[live].max() - lo[live].min() + 1) if live.any() else 0


def flex_call(q, k, v, *, causal: bool, window: int, softcap: float):
    """One compiled ``torch.nn.attention.flex_attention`` call that computes
    the flash kernel's function: a tanh-softcap score_mod (applied to the
    scaled score, as the kernel does), a block mask of causality with q
    aligned to the end of the kv sequence and the sliding window, and GQA.
    Returns a callable. Used here as the library yardstick only."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    Sq, Skv = q.shape[2], k.shape[2]
    offset = Skv - Sq

    def mask_mod(b, h, q_idx, kv_idx):
        qpos = q_idx + offset
        keep = kv_idx <= qpos if causal else kv_idx >= 0
        if 0 < window < Skv:
            keep = keep & (kv_idx > qpos - window)
        return keep

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    block_mask = create_block_mask(mask_mod, None, None, Sq, Skv, device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score_mod if softcap > 0 else None,
                      block_mask=block_mask, enable_gqa=True)


def phase_flash_times(model: dict, peaks, errs: dict) -> list[dict]:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.parity import check_flash
    rows = []
    for key in ("prefill_global", "prefill_local", "decode_global", "decode_local"):
        n = model["noted"][key]
        q, k, v = (n[x].transpose(1, 2) for x in "qkv")
        kw = dict(causal=n["causal"], window=n["window"], softcap=n["softcap"])
        (B, Hq, Sq, d), Skv = q.shape, k.shape[2]
        out = flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = check_flash(out, want, f"flash at {key}")
        mag = want.float().abs()
        # again in float32 on the same q / k / v, at the f32 tolerance, where
        # a mask one tile or one position off would show
        q32, k32, v32 = (x.float() for x in (q, k, v))
        err32 = check_flash(flash_attention(q32, k32, v32, **kw),
                            attention_ref(q32, k32, v32, **kw), f"flash at {key} (f32)")
        del q32, k32, v32
        errs["flash_attention"] = max(errs["flash_attention"], err, err32)
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
        route, splits = flash_attention.last_route
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw), reps=5, warmup=1)
        # the library call of the same function: flex_attention, compiled;
        # it is checked against the plain version like the kernel
        try:
            flex = flex_call(q, k, v, **kw)
            flex_err = check_flash(flex(), want, f"flex_attention at {key}")
            library = cuda_ms(flex)
            flex_note = None
        except Exception as exc:  # reported in the line; the port does not use it
            library, flex_err, flex_note = None, None, f"{type(exc).__name__}: {exc}"[:300]
        # SDPA does less work (causal only, no softcap; top-left aligned, so the
        # one-row decode call is unmasked, which at the cache's end is the same)
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=Sq > 1, enable_gqa=True))
        pairs = kept_pairs(Sq, Skv, kw["causal"], kw["window"])
        flops = 4.0 * B * Hq * d * pairs
        # q and out once, and the k / v rows the mask keeps (a local layer's
        # decode step reads its window only)
        rows_kv = kept_kv_rows(Sq, Skv, kw["causal"], kw["window"])
        nbytes = (q.numel() + out.numel()
                  + 2 * k.numel() * rows_kv // Skv) * q.element_size()
        # bf16 operands: both products at the bf16 tensor-core rate (QK^T is
        # exact there with f32 accumulation; PV takes p in bf16, a rounding the
        # bf16 tolerance admits and the bf16 output makes anyway)
        b = bound(nbytes, flops, peaks, rate="bf16")
        rec = dict(name="flash_attention", route="cuda",
                   source="src/repro_torch/csrc/flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention/kernel.py:24",
                   launches=model["launches"], max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=b[0], bound_by=b[1], library_ms=library)
        emit("kernel_time", **dict(rec, route=route), splits=splits, call=key,
             shape=[B, Hq, k.shape[1], Sq, Skv, d],
             window=kw["window"], softcap=kw["softcap"], max_abs_err_f32=err32,
             plain_mean_abs=mag.mean().item(), plain_max_abs=mag.max().item(),
             library="flex_attention (compiled; softcap score_mod, causal + window "
                     "block mask, enable_gqa)", library_max_abs_err=flex_err,
             library_failed=flex_note, library_less_work_ms=sdpa,
             library_less_work="sdpa causal, no softcap", kept_pairs=pairs,
             kept_kv_rows=rows_kv, flops=flops,
             bytes=nbytes, achieved_tflops=flops / ms / 1e9,
             achieved_gbps=nbytes / ms / 1e6,
             bound_fp32_non_tensor_ms=bound(nbytes, flops, peaks)[0])
        if key == "prefill_global":
            rows.append(dict(rec, max_abs_err=errs["flash_attention"]))
    return rows


def phase_model_cpu_vs_card() -> None:
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cfg = get_arch(MODEL).reduced()
    B, S = 2, 96  # S > the reduced window of 64: local layers mask
    tokens = TokenPipeline(cfg.vocab_size, B, S + 1, seed=0).batch_at(0)
    params = M.init_params(cfg, seed=0, device="cpu")
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        pre, cache = prefill_step(p, {"tokens": tokens[:, :S]})
        dec, _ = serve_step(p, M.grow_cache(cache, S + 1), tokens[:, S:], S)
        out[dev] = (pre, dec)
    emit("model_cpu_vs_card", model=cfg.name, layers=cfg.n_layers, prompts=B,
         prompt_len=S, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
         prefill=same_logits(out["cuda"][0], out["cpu"][0], "reduced prefill"),
         decode=same_logits(out["cuda"][1], out["cpu"][1], "reduced decode"))


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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
    # the library yardstick's compiled kernels are cached inside the checkout
    # and compiled in this process (no pool of compile workers left behind)
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
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
    errs = {"streaming_fused_scan": 0.0, "batched_scores": 0.0, "topk_scores": 0.0,
            "flash_attention": 0.0}
    try:
        phase_kernel_grid(dev, errs)
        phase_flash_grid(dev, errs)
        if args.rows != 1_000_000:
            emit("scale_cut", rows=args.rows, paper_rows=1_000_000)
        main_path = phase_main_path(args.rows, dev)
        rows = phase_kernel_times(main_path, dev, peaks, errs)
        phase_cpu_vs_card()
        del main_path  # the model needs the card's memory
        model = phase_model_path(dev)
        del model["params"]
        rows += phase_flash_times(model, peaks, errs)
        del model
        phase_model_cpu_vs_card()
    except (SmokeFailure, ParityError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    emit("done", seconds=time.perf_counter() - t_start, peaks=peaks)
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
