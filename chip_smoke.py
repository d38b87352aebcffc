#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MINT on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--graph-rows N]

Builds the hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/kernels/``), then:

  1. environment: the card, its power limit, CUDA, nvcc, the build time;
  2. each kernel against its plain PyTorch version on the card, over the
     parity grids of ``repro_torch.kernels.parity`` and their tolerance
     rules: the top-k cases (rising scores, ties, NEG_INF tails, k beyond
     the live columns, 1e6 columns, k = 2048, odd N in f16 / bf16 / f32),
     equal to the plain version; the scan, distance and top-k grid (ragged
     cases, a deep k = 2048, and the scan's own cuts: many row blocks, two
     query tiles, a 2048-key list, a shrunk query tile; the filtered and
     mutated paths' operands: keep bitmaps with tombstones on base and
     base + delta, a keep bitmap sparser than k; the cache probe's k = 1;
     x metrics x f32/bf16/f16), where the two-pass scan must also equal the
     streaming scan bit for bit; then
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
     those main-path shapes; the two-pass scan bit-equal to the streaming
     scan at B = 1 and 64 over the 1,000,000-row column, and timed; top-k
     also at its worst case (scores rising along each row);
  5. filtered serving on that tuned database (phase ``filter_path``):
     ``synth_attributes`` over its rows, the bisimple queries under Range
     predicates keeping 0.1%, 1%, 10% and 50% of the rows, an Eq and a
     predicate matching nothing, planned with the planner's access choice
     and with each forced access (pre, masked, post) and served in
     batches: one scan dispatch per (group, index), no launch for a
     zero-match group, the pre / masked / flat results equal to the
     engine's oracle (up to near ties, ``same_topk``), the two-pass ids
     equal to the streaming ids;
  6. mutated serving (phase ``mutation_path``): 10,000 inserted rows and
     10,000 deletes through a ``MutationView``; each streaming flat group
     one merged base + delta launch (no delta dispatch), the two-pass path
     a separate one, equal ids, flat results equal to the live oracle;
     then a compaction (``Compactor``, ``swap_store``, ``rebase``) after
     which the flat ids are unchanged;
  7. the semantic-cache probe (phase ``cache_probe``, 64 x 256 rows
     filled to 200) and the torch DP against the Python DP (phase
     ``planner_dp``); then each new kernel use (keep-masked scan, merged
     base + delta scan, cache probe, distance at the largest pre-filter
     gather) held against its plain version and timed as in 4;
  8. the same path on the CPU and on the card at the serving-test scale
     (2,500 rows): configuration, plans, numDist, costs and ids must agree;
     then the torch quickstart (``examples/torch_quickstart.py``) over
     ``hnsw`` at 100,000 rows (phase ``graph_path``; MINT's recall >=
     theta) and its plans over ``diskann``;
  9. the model substrate's serving path at Gemma-2-27B's full width and
     depth (46 layers, d_model 4608, 32 / 16 heads of 128, d_ff 36864,
     vocab 256000; 27.2e9 random bf16 parameters from a seed), after the
     MINT phases' tensors are released: a prefill of 2 prompts x 8192
     tokens from ``TokenPipeline``, the cache grown, 16 greedy decode steps,
     then a prefill of the 8193 tokens, whose logits the first decode
     step's must match (rtol 0.15, atol 0.35, the same top-1 token).
     Attention runs in the flash kernel, whose launches are zeroed before
     and read after. The q / k / v of the first local and first global
     layer's prefill and of one decode step are noted;
  10. the flash kernel against its plain version at those noted calls, in
     bf16 and again in float32 on the same inputs, and timed beside the
     plain version, the library call of the same function (flex_attention
     with a softcap score_mod and a causal + window block mask, compiled),
     an SDPA call that does less work (no softcap), and the bound at the
     bf16 tensor-core rate;
  11. the same model path on the CPU and on the card at
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
    """The device time of one call of ``fn`` (ms), median of ``reps``, behind
    a busy stream (``repro_torch.launch.kernel_bench.cuda_ms``)."""
    from repro_torch.launch.kernel_bench import cuda_ms as device_ms
    return device_ms(fn, reps=reps, warmup=warmup)


# ---- kernel vs plain ----------------------------------------------------------


def phase_kernel_grid(dev, errs: dict) -> None:
    from repro_torch.kernels.parity import CARD_CASES, TOPK_CASES, check_case, check_topk_case
    for name in TOPK_CASES:
        emit("topk_grid", case=name, **TOPK_CASES[name], slots_equal=check_topk_case(name, dev))
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

    def attach(self, engine):
        """Wraps the engine's dispatch methods; returns an undo."""
        names = ("_ivf_scan", "_rerank", "_prefilter_group", "_flat_scan_scored",
                 "_batched_scores")
        ivf_scan, rerank, prefilter, flat, scored = (getattr(engine, n) for n in names)

        def within(kind, fn):
            def run(group, *args, **kw):
                self.kind, self.col = kind, engine.cstore.device(group.key.vid)
                try:
                    return fn(group, *args, **kw)
                finally:
                    self.kind = self.col = None
            return run

        def batched_scores(qmat, sub):
            if self.kind in ("centroids", "prefilter"):  # kept as they are
                self.note(self.kind, qmat, sub.shape[0], lambda sub=sub: sub)
            elif self.kind == "rerank":  # the union's rows: as many of the column
                self.note("rerank", qmat, sub.shape[0],
                          lambda col=self.col, n=sub.shape[0]: col.data[:n])
            return scored(qmat, sub)

        def flat_scan_scored(col, qmat, k, **kw):
            if not engine.streaming and not kw:
                self.note("flat_two_pass", qmat, col.data.shape[0],
                          lambda col=col: col.data, k=k, valid_n=col.n_rows)
            return flat(col, qmat, k, **kw)

        engine._ivf_scan = within("centroids", ivf_scan)
        engine._rerank = within("rerank", rerank)
        engine._prefilter_group = within("prefilter", prefilter)
        engine._batched_scores = batched_scores
        engine._flat_scan_scored = flat_scan_scored

        def undo():
            for n in names:
                delattr(engine, n)
        return undo


# ---- the main path --------------------------------------------------------------


def run_path(db, workload, constraints, device, min_sample_rows=2000,
             per_column=True, dispatches=None):
    """tune -> build -> serve MINT (and PerColumn) on ``device``; returns a
    dict of results and wall times. ``dispatches`` (a ``DistanceDispatches``)
    is attached to the serving engine (its undo is ``undo_dispatches``)."""
    from repro_torch.core.tuner import Mint, ground_truth_cache
    from repro_torch.index.registry import IndexStore
    from repro_torch.serve.engine import BatchEngine
    out = {}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    mint = Mint(db, index_kind="ivf", seed=0, min_sample_rows=min_sample_rows,
                device=device)
    out["tuner"] = mint
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
        out["undo_dispatches"] = dispatches.attach(engine)
    t0 = time.perf_counter()
    out["mint"] = engine.execute_workload(workload, result, gt)
    out["per_column"] = engine.execute_workload(workload, pc, gt) if pc else None
    sync()
    out["serve_s"] = time.perf_counter() - t0
    out["counters"] = engine.counters.as_dict()
    out.update(result=result, pc=pc, store=store, engine=engine, gt=gt,
               constraints=constraints)
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
    undo_two = dispatches.attach(two)
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
    r.pop("undo_dispatches")()
    undo_two()
    return dict(counts=counts, col=col, qmat=qmat, k=q.k, dispatches=dispatches.largest,
                db=db, workload=workload, path=r, two=two)


# ---- times at the main path's shapes -----------------------------------------------


def phase_kernel_times(main: dict, dev, peaks, errs: dict) -> list[dict]:
    from repro_torch.kernels.distance.kernel import batched_scores, distance_tiles
    from repro_torch.kernels.distance.ops import _mask_rows, fused_scan
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import check_scores, check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.kernel import scan_grid
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.kernels.topk.kernel import topk_grid, topk_scores
    from repro_torch.kernels.topk.ref import topk_ref
    col, qmat, k = main["col"], main["qmat"], main["k"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    N, d = col.n_rows, col.padded_dim
    rows = []

    def row(name, route, source, replaces, shape, ms, plain_ms, library_ms, b, **extra):
        rows.append(table_row(name, route, source, replaces, main["counts"][name],
                              errs[name], ms, plain_ms, library_ms, b, shape=shape, **extra))

    def rates(flops, nbytes, ms):
        return dict(achieved_tflops=flops / ms / 1e9, achieved_gbps=nbytes / ms / 1e6)

    # streaming scan over the burst's resident column: the flat burst's
    # dispatch (B = 64) and a single query; the two-pass scan (distance ->
    # mask -> top-k) must give its values and ids bit for bit, and is timed
    # beside it
    for B in (1, 64):
        q = qmat[:B].contiguous()
        vals, ids = streaming_fused_scan(q, col.data, k=k, valid_n=N)
        v2, i2 = fused_scan(q, col.data, k=k, valid_n=N)
        check(torch.equal(v2, vals) and torch.equal(i2, ids),
              f"two-pass scan differs from the streaming scan at B={B}")
        two_pass_ms = cuda_ms(lambda: fused_scan(q, col.data, k=k, valid_n=N))
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
                     two_pass_equal=True, two_pass_ms=two_pass_ms,
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
        t = distance_tiles(B, n, dd, sms)
        tiles = dict(tile=[t.bm, t.bn], thread_tile=t.tm, blocks=t.blocks)
        if label == "rerank":
            row("batched_scores", "cuda", "src/repro_torch/csrc/distance.cu",
                "src/repro/kernels/distance/kernel.py:23", [B, n, dd], ms, plain, lib, b,
                **rates(flops, nbytes, ms), **tiles)
        emit("kernel_time", name="batched_scores", route="cuda", dispatch=label,
             shape=[B, n, dd], ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
             bound_by=b[1], max_abs_err=de, **rates(flops, nbytes, ms), **tiles)

    # top-k over the two-pass flat scan's masked (B, N) scores at its own k,
    # as fused_scan computes them, then at the nominal k = 128, then at the
    # threshold's worst case: scores rising along each row (every key
    # survives the threshold), at the same shape and k
    flat = disp["flat_two_pass"]
    scores = _mask_rows(batched_scores_ref(flat["qmat"], flat["rows"]()), flat["valid_n"])
    B, n = scores.shape
    k_path = min(flat["k"], flat["valid_n"])
    rising = torch.arange(n, device=dev, dtype=torch.float32).expand(B, n).contiguous()
    for label, s_in, kk in (("flat_two_pass", scores, k_path), ("nominal", scores, 128),
                            ("ascending_worst_case", rising, k_path)):
        tv, ti = topk_scores(s_in, kk)
        tr, tri = topk_ref(s_in, kk)
        check(torch.equal(tv, tr) and torch.equal(ti, tri),
              f"top-k differs at {label} ({B}, {n}, {kk})")
        ms = cuda_ms(lambda: topk_scores(s_in, kk))
        plain = cuda_ms(lambda: topk_ref(s_in, kk))
        lib = cuda_ms(lambda: torch.topk(s_in, kk, dim=1))
        nbytes = 4 * s_in.numel() + 8 * B * kk
        b = bound(nbytes, 0.0, peaks)
        g = topk_grid(B, n, kk, sms)
        grid = dict(grid=dict(blocks_per_row=g.blocks_per_row, cols_per_block=g.cols_per_block,
                              list_len=g.lc, list_pad=g.lpad, cand_cap=g.cap))
        if label == "flat_two_pass":
            row("topk_scores", "cuda", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/topk/kernel.py:42", [B, n, kk], ms, plain, lib, b,
                **rates(0.0, nbytes, ms), **grid)
        else:
            emit("kernel_time", name="topk_scores", route="cuda", dispatch=label,
                 shape=[B, n, kk], ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
                 bound_by=b[1], **rates(0.0, nbytes, ms), **grid)
    del rising
    return rows


# ---- the filtered, mutated, cache-probe, DP and graph paths ----------------------------

SELECTIVITIES = (0.001, 0.01, 0.1, 0.5)
ACCESSES = (None, "pre", "masked", "post")  # None: the planner's choice
CHURN_ROWS = 10_000  # inserted and deleted each: 1% of the paper's rows each way
GRAPH_ROWS = 100_000


def quantile_pred(attrs, n_rows: int, sel: float, lo_q: float = 0.2):
    """A Range over the uniform ``score`` field keeping ~``sel`` of the rows
    (``benchmarks/filter_bench.py``'s rule); sel = 0 keeps none."""
    from repro_torch.filter import Range
    vals = np.sort(attrs.take("score", np.arange(n_rows)))
    if sel <= 0.0:
        return Range("score", lo=float(vals[-1]) + 1.0, hi=float(vals[-1]) + 2.0)
    lo_q = min(lo_q, 1.0 - sel)
    return Range("score", lo=float(np.quantile(vals, lo_q)),
                 hi=float(np.quantile(vals, lo_q + sel)))


def expected_scans(engine, pairs) -> int:
    """Scan dispatches a batch must take: one per (group, index), one per
    flat-fallback or pre-filter group, none for a group whose predicate
    matches no live row."""
    from repro_torch.serve.compiler import compile_batch
    n = 0
    for g in compile_batch(pairs):
        if g.key.pred is not None and engine._filter_state(g.key.pred).n_match == 0:
            continue
        n += 1 if (not g.specs or g.key.access == "pre") else len(g.specs)
    return n


def host_scores(eng, q, ids: np.ndarray) -> np.ndarray:
    """The host's float32 scores of stable ``ids`` for query ``q`` over the
    engine's live table (base rows, and delta rows under a mutation view)."""
    qv = q.concat()
    mv = eng._mv()
    if mv is None:
        return eng.cstore.host(q.vid)[ids] @ qv
    is_delta, phys = mv.locate(ids)
    out = np.empty(len(ids), dtype=np.float32)
    t = mv.table
    if (~is_delta).any():
        rows = np.concatenate([t.base.columns[c][phys[~is_delta]] for c in q.vid], axis=1)
        out[~is_delta] = rows @ qv
    if is_delta.any():
        out[is_delta] = t.delta_concat(q.vid)[phys[is_delta]] @ qv
    return out


def same_topk(eng, q, got, want, what: str) -> int:
    """Checks ids equal to the oracle's slot by slot, except at near ties:
    where a slot differs, the host's score of the returned id lies within
    the kernels' tolerance (``kernels.parity.tolerance``) of the host's
    score at that slot. The kernels sum in another order than the host's
    BLAS, so two scores a last bit apart may swap. Returns such slots."""
    from repro_torch.kernels.parity import tolerance
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{what}: {got.shape[0]} ids, the oracle {want.shape[0]}")
    check(len(set(got.tolist())) == got.shape[0], f"{what}: duplicate ids")
    diff = np.nonzero(got != want)[0]
    if diff.size:
        sg, sw = host_scores(eng, q, got[diff]), host_scores(eng, q, want[diff])
        check(bool(np.all(np.abs(sg - sw) <= tolerance(q.dim())
                          * np.maximum(np.abs(sw), 1.0))),
              f"{what}: ids differ from the oracle beyond a near tie "
              f"(slots {diff[:8].tolist()}, scores {sg[:4]} vs {sw[:4]})")
    return int(diff.size)


def serve_checked(eng, two, pairs, gt, what: str) -> dict:
    """Serves ``pairs`` on the streaming engine (timed) and the two-pass
    engine; checks one scan dispatch per (group, index), the exact paths
    (flat fallback, pre, masked) against the oracle ``gt`` (``same_topk``)
    and the two-pass ids against the streaming ids (equal). Returns the
    numbers of the cell."""
    from repro_torch.kernels import launch_counts
    eng.counters.reset()
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eng.execute_batch(pairs, gt_cache=gt)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    after = launch_counts()
    launches = {n: after[n] - before[n] for n in MINT_KERNELS}
    want = expected_scans(eng, pairs)
    check(eng.counters.scan == want,
          f"{what}: {eng.counters.scan} scan dispatches, expected {want}")
    swaps = 0
    for (q, p), m in zip(pairs, metrics):
        if not p.indexes or p.access_path in ("pre", "masked"):
            swaps += same_topk(eng, q, m.ids, gt[q.qid],
                               f"{what}: q{q.qid} ({p.access_path or 'flat'})")
    counters = eng.counters.as_dict()
    two.counters.reset()
    for (q, _), m, t in zip(pairs, metrics, two.search_batch(pairs)):
        check(np.array_equal(np.asarray(m.ids), t), f"{what}: q{q.qid} two-pass ids differ")
    post = [m.recall for (_, p), m in zip(pairs, metrics) if p.access_path == "post"]
    return dict(queries=len(pairs), access=sorted({str(p.access_path) for _, p in pairs}),
                serve_s=serve_s, dispatch_counters=counters, launches=launches,
                oracle_near_tie_swaps=swaps,
                two_pass_counters=two.counters.as_dict(),
                mean_recall=float(np.mean([m.recall for m in metrics])),
                post_filter_recall=dict(mean=float(np.mean(post)), min=float(min(post)))
                if post else None)


def phase_filter_path(main: dict, dev) -> dict:
    """Filtered serving at the main path's scale: ``synth_attributes`` over
    the 1,000,000 rows, the bisimple queries under Range predicates at four
    selectivities, one Eq and one that matches nothing, planned against the
    tuned configuration with the planner's access choice and with each
    forced access, served in batches (12 queries a batch)."""
    from dataclasses import replace
    from repro_torch.filter import Eq, describe, synth_attributes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    db, wl, r, two = main["db"], main["workload"], main["path"], main["two"]
    eng, mint = r["engine"], r["tuner"]
    t_phase = t0 = time.perf_counter()
    attrs = synth_attributes(db.n_rows, seed=0, device=dev)
    attrs_s = time.perf_counter() - t0
    preds = {f"score_sel_{sel:g}": quantile_pred(attrs, db.n_rows, sel)
             for sel in SELECTIVITIES}
    preds["category_eq_cat0"] = Eq("category", "cat0")
    preds["zero_match"] = quantile_pred(attrs, db.n_rows, 0.0)
    mint.attributes = attrs
    planner = mint.planner(r["constraints"])
    config = r["result"].configuration
    for e in (eng, two):
        e.attach_filters(attrs, planner.selectivity)
    dispatches = DistanceDispatches()
    undo = dispatches.attach(eng)
    reset_launch_counts()
    cells, oracle_s = {}, 0.0
    try:
        for pname, pred in preds.items():
            fqs = [replace(q, predicate=pred) for q in wl.queries]
            t0 = time.perf_counter()
            gt = {q.qid: eng.ground_truth(q) for q in fqs}
            oracle_s += time.perf_counter() - t0
            fs = eng._filter_state(pred)
            for access in ACCESSES:
                pairs = []
                for q in fqs:
                    try:
                        pairs.append((q, planner.plan(q, config, force_access=access)))
                    except ValueError:  # "post" with no useful index for the query
                        pass
                what = f"filter {pname}/{access or 'auto'}"
                cell = serve_checked(eng, two, pairs, gt, what)
                if fs.n_match == 0:
                    check(not any(cell["launches"].values()),
                          f"{what}: a zero-match group launched {cell['launches']}")
                cell.update(predicate=describe(pred), n_match=fs.n_match)
                cells[f"{pname}/{access or 'auto'}"] = cell
        counts = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
        keep = eng._filter_state(preds["score_sel_0.1"]).base_keep_dev(
            int(main["col"].data.shape[0]))
    finally:
        undo()
        for e in (eng, two):
            e.detach_filters()
    check("prefilter" in dispatches.largest, "no pre-filter gather was scored")
    emit("filter_path", rows=db.n_rows, attributes_s=attrs_s, oracle_s=oracle_s,
         launches=counts, seconds=time.perf_counter() - t_phase,
         selectivity_estimates={p: planner.selectivity.estimate(pred)
                                for p, pred in preds.items()},
         largest_prefilter_gather=dispatches.largest["prefilter"]["shape"], cells=cells)
    return dict(attrs=attrs, planner=planner, preds=preds, keep=keep, counts=counts,
                prefilter=dispatches.largest["prefilter"])


def phase_mutation_path(main: dict, filt: dict, dev) -> dict:
    """Mutated serving: the 1,000,000-row table takes 10,000 inserted rows
    (``make_database(10_000, PAPER_COLUMNS, seed=77)``, with attributes) and
    10,000 deletes of seeded live ids; flat plans, the MINT plans and the
    filtered workload are served over base + delta; then the table is
    compacted (``Compactor``, ``swap_store``, ``rebase``) and the flat plans
    served again."""
    from dataclasses import replace
    from repro_torch.core.types import QueryPlan
    from repro_torch.data.vectors import PAPER_COLUMNS, make_database
    from repro_torch.ingest import (CompactionPolicy, Compactor, DeleteBatch, InsertBatch,
                                    MutableTable, MutationView)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.compiler import compile_batch
    db, wl, r, two = main["db"], main["workload"], main["path"], main["two"]
    eng, attrs, planner = r["engine"], filt["attrs"], filt["planner"]
    t_phase = t0 = time.perf_counter()
    table = MutableTable(db)
    fresh = make_database(CHURN_ROWS, PAPER_COLUMNS, seed=77)
    _, new_ids = table.apply(InsertBatch(fresh.columns))
    rng = np.random.default_rng(78)
    attrs.put(new_ids, {"category": [f"cat{c}" for c in rng.integers(0, 8, CHURN_ROWS)],
                        "score": rng.random(CHURN_ROWS).astype(np.float32),
                        "source": [f"src{s}" for s in rng.integers(0, 4, CHURN_ROWS)]})
    table.apply(DeleteBatch(rng.choice(table.live_ids(), size=CHURN_ROWS, replace=False)))
    check(CompactionPolicy().should_compact(table) is None,
          "1% churn each way should stay under the compaction policy")
    mv = MutationView(table, device=dev)
    for e in (eng, two):
        e.attach_mutations(mv)
        e.attach_filters(attrs, planner.selectivity)
    churn_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    qs = wl.queries
    gt = {q.qid: eng.ground_truth(q) for q in qs}
    flat = [(q, QueryPlan(q.qid, [], [], 0.0, 1.0)) for q in qs]
    groups = len(compile_batch(flat))
    cells = {"flat": serve_checked(eng, two, flat, gt, "mutated flat")}
    c = cells["flat"]
    check(c["dispatch_counters"]["delta"] == 0
          and c["launches"]["streaming_fused_scan"] == groups,
          f"mutated flat: {c['launches']} launches, {c['dispatch_counters']} for "
          f"{groups} groups (one merged base+delta launch each)")
    check(c["two_pass_counters"]["delta"] == groups,
          "the two-pass flat scans took no separate delta dispatch")
    flat_ids = [np.asarray(i) for i in eng.search_batch(flat)]
    mint_pairs = [(q, r["result"].plans[q.qid]) for q in qs]
    cells["mint"] = serve_checked(eng, two, mint_pairs, gt, "mutated MINT plans")
    for pname in ("score_sel_0.01", "score_sel_0.1"):
        fqs = [replace(q, predicate=filt["preds"][pname]) for q in qs]
        fgt = {q.qid: eng.ground_truth(q) for q in fqs}
        pairs = [(q, planner.plan(q, r["result"].configuration)) for q in fqs]
        cells[f"{pname}/auto"] = serve_checked(eng, two, pairs, fgt, f"mutated {pname}")
    counts = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
    col = main["col"]
    dcol = mv.delta(col.vid)
    noted = dict(delta=dcol.col.data, delta_n=dcol.n_rows, delta_dead=dcol.dead_mask,
                 dead=mv.base_dead_mask(int(col.data.shape[0])), counts=counts)
    serve_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = Compactor(table, seed=0, device=dev).build(r["result"].configuration,
                                                      reason="chip_smoke")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for e in (eng, two):
        e.swap_store(state.store, state.cstore, state.db)
    table.rebase(state.db, state.ids, state.stats.upto_lsn)
    after = [np.asarray(i) for i in eng.search_batch(flat)]
    for q, a, b in zip(qs, flat_ids, after):
        check(np.array_equal(a, b), f"q{q.qid}: flat ids changed across compaction")
    cells["flat_after_compaction"] = serve_checked(
        eng, two, flat, {q.qid: eng.ground_truth(q) for q in qs}, "compacted flat")
    for e in (eng, two):
        e.detach_mutations()
        e.detach_filters()
    emit("mutation_path", rows=db.n_rows, inserted=CHURN_ROWS, deleted=CHURN_ROWS,
         live=table.n_live, churn_s=churn_s, serve_s=serve_s,
         compaction=dict(build_s=build_s, rows_after=state.stats.rows_after,
                         delta_folded=state.stats.delta_folded,
                         dead_reclaimed=state.stats.dead_reclaimed,
                         specs_rebuilt=state.stats.specs_rebuilt),
         flat_ids_equal_across_compaction=True, launches=counts,
         seconds=time.perf_counter() - t_phase, cells=cells)
    return noted


def phase_cache_probe(main: dict, dev) -> dict:
    """The semantic-cache probe through ``BatchEngine.cache_probe``: 64 query
    vectors against a 256-row cache matrix filled to 200 rows (16 of them
    exact repeats of live cache rows, 4 of rows past the fill level), held
    against the plain version on the card and the CPU path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.parity import check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.serve.engine import cache_probe_scan
    B, C, d, valid = 64, 256, 384, 200
    rng = np.random.default_rng(5)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    mat = unit(rng.standard_normal((C, d)))
    q = unit(rng.standard_normal((B, d)))
    hits = rng.choice(valid, size=16, replace=False)
    q[:16] = mat[hits]
    q[16:20] = mat[valid:valid + 4]
    reset_launch_counts()
    t0 = time.perf_counter()
    vals, ids = main["path"]["engine"].cache_probe(q, mat, valid)
    probe_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()["streaming_fused_scan"]
    check(launches == 1, f"the cache probe made {launches} scan launches")
    qt, mt = torch.as_tensor(q, device=dev), torch.as_tensor(mat, device=dev)
    rvals, rids = streaming_fused_scan_ref(qt, mt, 1, metric="l2", valid_n=valid)
    full = combined_plain_scores(qt, mt, "l2", dict(valid_n=valid))
    err, swaps = check_topk(torch.as_tensor(vals, device=dev),
                            torch.as_tensor(ids, device=dev), rvals, rids, full, d,
                            "cache probe")
    check(bool((ids < valid).all()), "the cache probe returned a row past valid_n")
    check(np.array_equal(ids[:16, 0], hits), "the cache probe missed exact repeats")
    cvals, cids = cache_probe_scan(q, mat, valid, device="cpu")
    check(np.array_equal(cids, ids), "the cache probe's ids differ between CPU and card")
    emit("cache_probe", batch=B, cache_rows=C, width=d, valid_n=valid, launches=launches,
         max_abs_err=err, near_tie_swaps=swaps, exact_hits_found=16, host_ms=probe_ms,
         max_abs_diff_cpu=float(np.abs(cvals - vals).max()))
    return dict(q=qt, m=mt, valid=valid, launches=launches)


def phase_planner_dp(main: dict, dev) -> None:
    """The vectorized DP (``core/planner_jax.py``, a torch DP) on the card
    against the Python DP, for each bisimple query with at least 4 useful
    specs (every ivf index over a subset of its columns), on the main
    path's estimators."""
    from itertools import combinations
    from repro_torch.core.planner import algorithm2_dp
    from repro_torch.core.planner_jax import plan_dp_jax
    from repro_torch.core.types import IndexSpec
    r = main["path"]
    planner = r["tuner"].planner(r["constraints"])
    theta = planner.theta_plan
    out = []
    for q in main["workload"].queries:
        config = frozenset(IndexSpec(v, "ivf") for n in range(1, len(q.vid) + 1)
                           for v in combinations(q.vid, n))
        specs = planner.useful_indexes(q, config)
        if len(specs) < 4:
            continue
        ctx = planner.context(q)
        kw = dict(k_prime=planner.dp_k_prime, n_samples=planner.dp_samples,
                  seed=planner.seed)
        # both DPs read the same per-spec required eks, which the context
        # computes once (a host scan of the full table per spec): fill them
        # and warm the card's first launches before either is timed
        for x in specs:
            ctx.ek_req(x)
        plan_dp_jax(ctx, specs, theta, device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_dp = plan_dp_jax(ctx, specs, theta, device=dev, **kw)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_py = algorithm2_dp(ctx, specs, theta, **kw)
        py_s = time.perf_counter() - t0
        check(p_dp is not None and p_dp.est_recall >= theta - 1e-9,
              f"q{q.qid}: the torch DP found no plan covering theta")
        check(p_py is None or p_py.est_recall >= theta - 1e-9,
              f"q{q.qid}: the Python DP's plan misses theta")
        out.append(dict(query=q.name, specs=len(specs), torch_dp_cost=p_dp.est_cost,
                        torch_dp_coverage=p_dp.est_recall, torch_dp_s=dp_s,
                        python_dp_cost=None if p_py is None else p_py.est_cost,
                        python_dp_coverage=None if p_py is None else p_py.est_recall,
                        python_dp_s=py_s, torch_dp_plan=p_dp.describe()))
    check(len(out) > 0, "no bisimple query has 4 useful specs")
    emit("planner_dp", theta_plan=theta, queries=out)


def phase_graph_path(dev, rows: int) -> None:
    """The torch quickstart (``examples/torch_quickstart.py``) on the card:
    4 columns, the news workload, MINT tuned over hnsw and executed beside
    the one-index-per-column baseline; then the same plans over diskann."""
    from repro_torch.core.tuner import execute_workload
    from repro_torch.index.registry import IndexStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BatchEngine
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart as tq
    t_phase = time.perf_counter()
    reset_launch_counts()
    r = tq.run(rows, "hnsw", device=dev)
    mint_m, pc_m = r["mint"], r["per_column"]
    theta = tq.CONSTRAINTS.theta_recall
    check(mint_m.mean_recall >= theta,
          f"graph path: MINT recall {mint_m.mean_recall:.4f} under theta {theta}")
    dk = tq.with_kind(r["result"], "diskann")
    store = IndexStore(r["db"], seed=0, device=dev)
    t0 = time.perf_counter()
    for spec in sorted(dk.configuration, key=lambda s: s.name):
        store.get(spec)
    dk_build_s = time.perf_counter() - t0
    eng = BatchEngine(r["db"], store=store)
    t0 = time.perf_counter()
    dk_m = execute_workload(r["db"], store, r["workload"], dk, r["gt"], engine=eng)
    dk_walk_s = time.perf_counter() - t0
    counts = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
    check(counts["streaming_fused_scan"] > 0, "the graph builds made no scan launch")
    emit("graph_path", rows=rows, columns=[d for _, d in tq.COLUMNS],
         configuration=sorted(s.name for s in r["result"].configuration),
         per_column=sorted(s.name for s in r["pc"].configuration),
         plans={q.name: r["result"].plans[q.qid].describe() for q in r["workload"].queries},
         mint_mean_recall=mint_m.mean_recall, mint_min_recall=mint_m.min_recall,
         per_column_mean_recall=pc_m.mean_recall, theta_recall=theta,
         cost_ratio_mint_over_per_column=mint_m.weighted_cost / pc_m.weighted_cost,
         hnsw=dict(tune_s=r["tune_s"], build_s=r["build_s"], walk_s=r["walk_s"],
                   dispatch_counters=r["counters"]),
         diskann=dict(build_s=dk_build_s, walk_s=dk_walk_s, mean_recall=dk_m.mean_recall,
                      min_recall=dk_m.min_recall, dispatch_counters=eng.counters.as_dict()),
         launches=counts, seconds=time.perf_counter() - t_phase)


def table_row(name, route, source, replaces, launches, max_abs_err, ms, plain_ms,
              library_ms, b, **extra) -> dict:
    """One row of the kernel table, also printed as a ``kernel_time`` line."""
    rec = dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
               max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
               bound_by=b[1], library_ms=library_ms)
    emit("kernel_time", **rec, **extra)
    return dict(rec, shape=extra.get("shape"))


def phase_slice_kernel_times(main: dict, filt: dict, mut: dict, probe: dict, dev,
                             peaks) -> list[dict]:
    """The kernel uses of the filtered, mutated and cache-probe paths, each
    held against its plain version and timed beside it, its library call
    and its bound. Launches are the counts of the phase that drove the use;
    bounds count what this run's data needs (the kept or live rows)."""
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import (check_scores, check_topk,
                                            combined_plain_scores, two_pass_scan)
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.kernels.common import NEG_INF
    col, q, k = main["col"], main["qmat"], main["k"]
    x, N = col.data, col.n_rows
    B, d = q.shape
    rows = []

    def scan_row(use, kw, launches, library_call, live_rows, mask_bytes, qq=q, xx=x,
                 kk=k, metric="dot", **extra):
        vals, ids = streaming_fused_scan(qq, xx, k=kk, metric=metric, **kw)
        rvals, rids = streaming_fused_scan_ref(qq, xx, kk, metric=metric, **kw)
        full = combined_plain_scores(qq, xx, metric, kw)
        err, swaps = check_topk(vals, ids, rvals, rids, full, qq.shape[1], f"scan {use}")
        v2, i2 = two_pass_scan(qq, xx, kk, metric, kw)
        check(torch.equal(v2, vals) and torch.equal(i2, ids),
              f"two-pass scan differs from the streaming scan ({use})")
        ms = cuda_ms(lambda: streaming_fused_scan(qq, xx, k=kk, metric=metric, **kw))
        plain = cuda_ms(lambda: streaming_fused_scan_ref(qq, xx, kk, metric=metric, **kw))
        lib = cuda_ms(library_call)
        bq, dd = qq.shape
        nbytes = 4 * (bq * dd + live_rows * dd) + mask_bytes + 8 * bq * kk
        flops = 2.0 * bq * live_rows * dd
        rows.append(table_row(
            f"streaming_fused_scan[{use}]", "cuda", "src/repro_torch/csrc/streaming.cu",
            "src/repro/kernels/streaming/kernel.py:44", launches, err, ms, plain, lib,
            bound(nbytes, flops, peaks), use=use, near_tie_swaps=swaps,
            two_pass_equal=True, live_rows=live_rows, achieved_gbps=nbytes / ms / 1e6,
            achieved_tflops=flops / ms / 1e9, **extra))

    # keep-masked scan: the 64-query burst over the 1M-row column, selectivity 0.1
    keep = filt["keep"]
    kept = int(keep[:N].sum())
    outside = ~keep[:N]
    scan_row("keep_mask", dict(valid_n=N, keep_mask=keep),
             filt["counts"]["streaming_fused_scan"],
             lambda: torch.topk((q @ x[:N].T).masked_fill(outside, NEG_INF), k, dim=1),
             kept, N, shape=[B, N, d, k], selectivity=kept / N,
             library="matmul + masked_fill + topk")
    # base + delta in one launch, tombstones on both sides
    delta, dn = mut["delta"], mut["delta_n"]
    kw = dict(valid_n=N, dead_mask=mut["dead"], delta=delta, delta_valid_n=dn,
              delta_dead_mask=mut["delta_dead"])
    both = torch.cat([x[:N], delta[:dn]])
    ddead = (torch.zeros(dn, dtype=torch.bool, device=dev) if mut["delta_dead"] is None
             else mut["delta_dead"][:dn])
    dead_both = torch.cat([mut["dead"][:N], ddead])
    live = int((~dead_both).sum())
    scan_row("base_plus_delta", kw, mut["counts"]["streaming_fused_scan"],
             lambda: torch.topk((q @ both.T).masked_fill(dead_both, NEG_INF), k, dim=1),
             live, N + dn, shape=[B, N, dn, d, k],
             library="matmul + masked_fill + topk over the concatenation")
    del both, dead_both
    # the cache probe: l2, k = 1 over the 256-row cache matrix filled to 200
    qp, mp, valid = probe["q"], probe["m"], probe["valid"]
    scan_row("cache_probe", dict(valid_n=valid), probe["launches"],
             lambda: torch.cdist(qp, mp[:valid]).min(dim=1), valid, 0, qq=qp, xx=mp,
             kk=1, metric="l2", shape=[qp.shape[0], mp.shape[0], qp.shape[1], 1],
             library="cdist + min")
    # distance at the largest pre-filter gather (its own queries and rows)
    rec = filt["prefilter"]
    qg, xg = rec["qmat"], rec["rows"]()
    (bg, dg), n = qg.shape, xg.shape[0]
    err = check_scores(batched_scores(qg, xg), batched_scores_ref(qg, xg), dg,
                       "distance at the pre-filter gather")
    ms = cuda_ms(lambda: batched_scores(qg, xg))
    plain = cuda_ms(lambda: batched_scores_ref(qg, xg))
    lib = cuda_ms(lambda: qg @ xg.T)
    nbytes, flops = 4 * (bg * dg + n * dg + bg * n), 2.0 * bg * n * dg
    rows.append(table_row(
        "batched_scores[prefilter_gather]", "cuda", "src/repro_torch/csrc/distance.cu",
        "src/repro/kernels/distance/kernel.py:23", filt["counts"]["batched_scores"], err,
        ms, plain, lib, bound(nbytes, flops, peaks), use="prefilter_gather",
        shape=[bg, n, dg], library="matmul", achieved_gbps=nbytes / ms / 1e6,
        achieved_tflops=flops / ms / 1e9))
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
    ap.add_argument("--graph-rows", type=int, default=GRAPH_ROWS,
                    help="rows of the graph path's quickstart database (cut only "
                         "if the phase runs past 150 s; the cut is printed)")
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
         kernel_library=Path(lib._name).name, build_s=time.perf_counter() - t0,
         ptxas=common.ptxas_report(("scan_kernel", "distance_kernel", "topk_select",
                                    "flash")))
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
        filt = phase_filter_path(main_path, dev)
        mut = phase_mutation_path(main_path, filt, dev)
        probe = phase_cache_probe(main_path, dev)
        phase_planner_dp(main_path, dev)
        rows += phase_slice_kernel_times(main_path, filt, mut, probe, dev, peaks)
        del main_path, filt, mut, probe  # the model needs the card's memory
        phase_cpu_vs_card()
        if args.graph_rows != GRAPH_ROWS:
            emit("scale_cut", graph_rows=args.graph_rows, graph_rows_default=GRAPH_ROWS)
        phase_graph_path(dev, args.graph_rows)
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
