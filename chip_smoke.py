#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MINT on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--online-queries N] [--graph-rows N]

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
     ``planner_dp``);
  8. the online runtime on that tuned database (phase ``online_path``,
     ``--online-queries`` arrivals, a third of them exact re-arrivals):
     ``OnlineRuntime`` sync, async on a worker pool with staged uploads and
     without (ids equal), with the semantic cache (every re-arrival hits,
     probes scan the namespace's resident CUDA matrix, ids equal), observed
     (ids equal; ``launch/obs_report`` stage rows); an ``IngestRuntime``
     with 1% inserts and 1% deletes and a forced async compaction (every
     flush sees one (store, generation, table) state, flat ids equal the
     live oracle after the finalize); a drift to column 0 that fires one
     pooled retune (tune and shadow build on a worker thread while this
     thread serves, post-swap recall >= theta). Then each new kernel use
     (keep-masked scan, merged base + delta scan, cache probe with kept
     norms, distance at the largest pre-filter gather, the online probe and
     the online rerank) held against its plain version and timed as in 4;
  9. three tenants over that tuned database (phase ``tenant_path``, each
     serving a third of the bisimple queries, 96 arrivals of a tenant-skew
     trace with t0 the noisy neighbour and a third exact re-arrivals, 1%
     inserts and 1% deletes on t2): a ``MultiTenantRuntime`` at one
     micro-batch every 10 ms, ungoverned, then under a ``MemoryGovernor``
     budget of 2/3 of its peak with t0's quota half of its bytes (DRR and
     FIFO: the queue backs up, the two flush different batches and DRR
     serves t1 and t2 sooner), and each tenant
     alone: equal ids in all four, evictions by quota and by budget of
     columns, delta segments and semantic-cache namespaces, every re-arrival
     a cache hit, t2's flat ids equal to the live oracle, and an explicit
     spill that lowers ``torch.cuda.memory_allocated`` by the column's padded
     bytes; then the auto-tuner (phase ``autotune_path``): its steady, churn
     and tenant-skew replay scenarios at 100,000 rows and the
     paper's sift1m and glove200 widths, 4 trials and the defaults at two
     fidelities on the card, the best trial's replay on the card equal to
     its trial (fingerprint, snapshot, objectives) and on the CPU equal in
     device bytes, dispatches a flush and fingerprint; the scan at the
     replays' largest dispatch held against its plain version and timed as
     in 4;
  10. the same path on the CPU and on the card at the serving-test scale
     (2,500 rows): configuration, plans, numDist, costs and ids must agree,
     and a StepExecutor-driven async online run of 48 arrivals gives equal
     ids, flush, plan-cache and semantic-cache stats; then the torch
     quickstart (``examples/torch_quickstart.py``) over
     ``hnsw`` at 100,000 rows (phase ``graph_path``; MINT's recall >=
     theta) and its plans over ``diskann``;
  11. the model substrate's serving path at Gemma-2-27B's full width and
     depth (46 layers, d_model 4608, 32 / 16 heads of 128, d_ff 36864,
     vocab 256000; 27.2e9 random bf16 parameters from a seed), after the
     MINT phases' tensors are released: a prefill of 2 prompts x 8192
     tokens from ``TokenPipeline``, the cache grown, 16 greedy decode steps,
     then a prefill of the 8193 tokens, whose logits the first decode
     step's must match (rtol 0.15, atol 0.35, the same top-1 token).
     Attention runs in the flash kernel, whose launches are zeroed before
     and read after. The q / k / v of the first local and first global
     layer's prefill and of one decode step are noted;
  12. the flash kernel against its plain version at those noted calls, in
     bf16 and again in float32 on the same inputs, and timed beside the
     plain version, the library call of the same function (flex_attention
     with a softcap score_mod and a causal + window block mask, compiled),
     an SDPA call that does less work (no softcap), and the bound at the
     bf16 tensor-core rate;
  13. the same model path on the CPU and on the card at
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
import resource
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
                db=db, workload=workload, path=r, two=two, cstore=r["engine"].cstore)


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
    from repro_torch.kernels.distance.ref import batched_scores_ref, squared_norms
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
                 kk=k, metric="dot", kernel_kw=None, **extra):
        kernel_kw = dict(kw, **(kernel_kw or {}))
        vals, ids = streaming_fused_scan(qq, xx, k=kk, metric=metric, **kernel_kw)
        rvals, rids = streaming_fused_scan_ref(qq, xx, kk, metric=metric, **kw)
        full = combined_plain_scores(qq, xx, metric, kw)
        err, swaps = check_topk(vals, ids, rvals, rids, full, qq.shape[1], f"scan {use}")
        v2, i2 = two_pass_scan(qq, xx, kk, metric, kw)
        check(torch.equal(v2, vals) and torch.equal(i2, ids),
              f"two-pass scan differs from the streaming scan ({use})")
        ms = cuda_ms(lambda: streaming_fused_scan(qq, xx, k=kk, metric=metric, **kernel_kw))
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
    # the cache probe: l2, k = 1 over the 256-row cache matrix filled to 200,
    # resident with its squared norms kept beside it (as the semantic cache
    # keeps them); also timed recomputing the norms on every call
    qp, mp, valid = probe["q"], probe["m"], probe["valid"]
    mp_sq = squared_norms(mp)
    ms_norms = cuda_ms(lambda: streaming_fused_scan(qp, mp, k=1, metric="l2",
                                                    valid_n=valid))
    scan_row("cache_probe", dict(valid_n=valid), probe["launches"],
             lambda: torch.cdist(qp, mp[:valid]).min(dim=1), valid, 0, qq=qp, xx=mp,
             kk=1, metric="l2", kernel_kw=dict(db_sq=mp_sq),
             shape=[qp.shape[0], mp.shape[0], qp.shape[1], 1],
             library="cdist + min", ms_recomputing_norms=ms_norms)
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


# ---- the online runtime on the card --------------------------------------------------

ONLINE_QUERIES = 96      # the online trace's arrivals: 2/3 fresh, 1/3 exact re-arrivals
ONLINE_BUDGET_S = 250.0  # the phase's share of the script's time limit
# the drift phase's "night" traffic: column 0 (glove25), which no bisimple
# query touches, with columns the day traffic also uses
NIGHT_VIDS = [(0,), (0, 4), (0, 6), (0, 3, 5)]


def online_trace(db, wl, n: int, seed: int = 11):
    """A steady bisimple trace of ``n`` arrivals at 1,000 queries/s: the first
    n - n // 3 fresh, then n // 3 exact re-arrivals (the same ``Query``
    vectors under new qids) of the earliest fresh ones, 50 ms after the last
    fresh arrival, when every one of them has flushed."""
    from dataclasses import replace
    from repro_torch.online import steady_trace
    from repro_torch.online.trace import TimedQuery
    n_rep = n // 3
    fresh = steady_trace(db, wl, n=n - n_rep, qps=1000.0, seed=seed, qid_start=200_000)
    t0 = fresh[-1].t + 0.05
    reps = [TimedQuery(t=t0 + i * 1e-3, query=replace(tq.query, qid=300_000 + i))
            for i, tq in enumerate(fresh[:n_rep])]
    return fresh + reps, n_rep


def online_engine(main, dispatches=None):
    """A fresh engine over the main path's database, built store and resident
    columns (the main engine's own counters and attachments stay apart)."""
    from repro_torch.serve.engine import BatchEngine
    eng = BatchEngine(main["db"], store=main["path"]["store"], cstore=main["cstore"])
    if dispatches is not None:
        dispatches.attach(eng)
    return eng


def serve_online(rt, trace) -> dict:
    """Replays ``trace`` through ``rt`` with the launch counts zeroed just
    before and read just after; returns ids, wall time, stats, launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tickets = rt.run_trace(trace)
    ids = [np.asarray(t.result(timeout=600)) for t in tickets]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
    st = rt.stats()
    return dict(ids=ids, tickets=tickets, wall_s=wall, launches=launches, stats=st,
                summary=dict(wall_s=wall, batches=st["batcher"]["batches"],
                             mean_batch=st["batcher"]["mean_batch"],
                             scan_launches=launches["streaming_fused_scan"],
                             distance_launches=launches["batched_scores"],
                             dispatch_counters=st["dispatches"]))


def host_rss_gib() -> float:
    """This process's resident host memory now (GiB)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def same_ids(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} tickets vs {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        check(np.array_equal(x, y), f"{what}: ticket {i} ids differ")


def phase_online_path(main: dict, dev, queries: int) -> dict:
    """The online runtime over the main path's tuned 1,000,000-row database:
    sync vs async flush (staged and unstaged) on a real worker pool, the
    semantic cache (exact re-arrivals hit), the observer, an
    ``IngestRuntime`` with 1% churn each way and a forced async compaction,
    then a drift to other columns that fires one pooled retune."""
    from dataclasses import replace
    from repro_torch.core.types import QueryPlan, Workload
    from repro_torch.data.vectors import make_queries
    from repro_torch.ingest import CompactionPolicy, IngestConfig, IngestRuntime
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.obs_report import report
    from repro_torch.online import OnlineRuntime, RuntimeConfig, churn_trace, diurnal_trace
    t_phase = time.perf_counter()
    db, wl, r = main["db"], main["workload"], main["path"]
    cons, tuned = r["constraints"], r["result"]
    # the main path's tuner (its trained estimators and sample), without the
    # attribute store the filter phase attached
    mint = replace(r["tuner"], attributes=None, _selest=None)
    if queries != ONLINE_QUERIES:
        emit("scale_cut", online_queries=queries, online_queries_default=ONLINE_QUERIES)
    rss0 = host_rss_gib()
    peak0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    trace, n_rep = online_trace(db, wl, queries)
    base = dict(max_batch=16, max_delay_ms=5.0, cooldown_s=1e9, drift_threshold=2.0)
    steps, runs = {}, {}
    dispatches = DistanceDispatches()

    def run(label, engine=None, **cfg):
        t0 = time.perf_counter()
        rt = OnlineRuntime(db, mint, wl, cons, result=tuned, store=r["store"],
                           engine=engine or online_engine(main),
                           config=RuntimeConfig(**base, **cfg))
        out = serve_online(rt, trace)
        out["rt"] = rt
        rt.close()
        runs[label] = out
        steps[label] = time.perf_counter() - t0
        emit("online_step", step=label, **out["summary"])
        return out

    # 1. sync vs async flush, with and without staged uploads
    sync = run("sync", engine=online_engine(main, dispatches), semcache=False)
    run("async_staged", semcache=False, async_flush=True, workers=2, stage_transfers=True)
    run("async_unstaged", semcache=False, async_flush=True, workers=2,
        stage_transfers=False)
    for label in ("async_staged", "async_unstaged"):
        same_ids(runs[label]["ids"], sync["ids"], f"online {label} vs sync")
    check(sync["launches"]["batched_scores"] > 0, "the online path launched no distance kernel")

    # 2. the semantic cache: every exact re-arrival hits, equal to its uncached ids
    probes = dict(calls=0, launches=0, resident=0)
    eng = online_engine(main)
    probe = eng.cache_probe

    def spy(qmat, mat, valid_n, mat_sq=None):
        probes["calls"] += 1
        probes["resident"] += int(isinstance(mat, torch.Tensor)
                                  and mat.device.type == dev.type
                                  and mat_sq is not None and mat_sq.device.type == dev.type)
        before = launch_counts()["streaming_fused_scan"]
        out = probe(qmat, mat, valid_n, mat_sq)
        probes["launches"] += launch_counts()["streaming_fused_scan"] - before
        return out
    eng.cache_probe = spy
    sem = run("semcache", engine=eng, semcache=True, semcache_epsilon=0.0)
    same_ids(sem["ids"], sync["ids"], "online semcache vs uncached")
    hits = [i for i, t in enumerate(sem["tickets"]) if t.cache_hit]
    check(hits == list(range(len(trace) - n_rep, len(trace))),
          f"semcache hits at tickets {hits[:8]}..., expected the {n_rep} re-arrivals")
    check(probes["calls"] > 0 and probes["resident"] == probes["calls"],
          f"{probes['calls'] - probes['resident']} probes took a host matrix")
    sc = sem["rt"].semcache
    probed = [ns for ns in sc._ns.values() if ns.dev is not None]
    check(probed and all(isinstance(ns.dev, torch.Tensor) and ns.dev.device.type == dev.type
                         for ns in probed), "a probed namespace matrix is not on the card")

    # 3. the observer: the same ids, and the per-stage breakdown
    obs = run("observed", semcache=True, semcache_epsilon=0.0, observe=True)
    same_ids(obs["ids"], sem["ids"], "online observe on vs off")
    rep = report(obs["rt"].observer)
    stage_rows = {name: dict(count=row["count"], p50_ms=row["p50_ms"], p99_ms=row["p99_ms"])
                  for name, row in rep["breakdown"]["stages"].items()}
    check({"dispatch", "merge", "semcache_probe"} <= set(stage_rows),
          f"observed stages {sorted(stage_rows)}")

    # 4. IngestRuntime: 1% inserts + 1% deletes, one forced async compaction.
    #    Maintenance is driven by hand, so the finalize (the atomic rebase)
    #    lands after the whole post-cut trace: every flush after the cut runs
    #    while the compaction is built or waits to be installed
    t0 = time.perf_counter()
    ing = IngestRuntime(db, mint, wl, cons, result=tuned, store=r["store"],
                        engine=online_engine(main),
                        config=RuntimeConfig(**base, semcache=False),
                        ingest=IngestConfig(policy=CompactionPolicy(
                            max_delta_fraction=None, max_dead_fraction=None),
                            min_mutated_rows=10**9, auto_maintain=False,
                            async_compaction=True))
    batch = CHURN_ROWS // 12
    events = churn_trace(db, wl, n=queries // 2, qps=1000.0,
                         mutation_rate=24 / (queries // 2), batch=batch,
                         mix=(0.5, 0.5, 0.0), seed=12, qid_start=400_000)
    seen, compacting = [], {"on": False}
    execute = ing.batcher.execute

    def observed_execute(tickets, staged=None):
        state = (id(ing.engine.store), ing.generation, ing.table.version)
        out = execute(tickets, staged)
        seen.append((compacting["on"], state,
                     (id(ing.engine.store), ing.generation, ing.table.version)))
        return out
    ing.batcher.execute = observed_execute
    reset_launch_counts()
    cut_at = len(events) // 3
    for i, ev in enumerate(events):
        if i == cut_at:
            check(ing.compact_async(reason="chip_smoke", now=ev.t) is not None,
                  "the async compaction did not start")
            compacting["on"] = True
        if hasattr(ev, "query"):
            ing.submit(ev.query, ev.t)
        else:
            ing.apply_timed(ev)
        ing.tick(ev.t)
    ing.drain(events[-1].t)
    check(not ing.compaction_events, "the compaction was installed before its finalize")
    ing.wait_maintenance(now=events[-1].t)
    compacting["on"] = False
    torch.cuda.synchronize()
    ing_launches = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
    check(len(ing.compaction_events) == 1 and ing.compaction_events[0].mode == "async",
          f"compactions: {ing.compaction_events}")
    check(not ing.builds.failures, f"build failures: {ing.builds.failures}")
    mid = [s for s in seen if s[0]]
    check(all(a == b for _, a, b in seen), "a flush saw two (store, generation, table) states")
    check(len(mid) > 0, "no flush landed while the compaction built")
    log = ing.table.log.stats()
    # flat groups after the finalize, over the queries of one or two columns
    # (one-column concats alias the table; wider ones would copy it again)
    flat = [(q, QueryPlan(q.qid, [], [], 0.0, 1.0)) for q in wl.queries if len(q.vid) <= 2]
    swaps = 0
    for (q, _), got in zip(flat, ing.engine.search_batch(flat)):
        swaps += same_topk(ing.engine, q, got, ing.engine.ground_truth(q),
                           f"ingest q{q.qid} after finalize")
    ev = ing.compaction_events[0]
    ingest = dict(inserted=log["inserted"], deleted=log["deleted"],
                  queries=sum(hasattr(e, "query") for e in events),
                  flushes=len(seen), flushes_mid_compaction=len(mid),
                  compaction=dict(build_s=ev.build_seconds, replayed=ev.replayed,
                                  stall_s=ev.stall_s, rows_after=ev.rows_after,
                                  generation=ev.generation),
                  launches=ing_launches, flat_oracle_near_tie_swaps=swaps,
                  failures=len(ing.builds.failures))
    check(ing_launches["streaming_fused_scan"] > 0, "the ingest runtime launched no scan")
    ing.close()
    # the compacted copy of the table and its columns go before the drift
    # step's retune concatenates the columns it plans over
    del ing, seen, events, observed_execute, execute
    gc.collect()
    steps["ingest"] = time.perf_counter() - t0
    emit("online_step", step="ingest", seconds=steps["ingest"], **ingest)

    # 5. drift to other columns -> one pooled retune (tune + shadow build on a
    #    worker thread while this thread serves)
    t0 = time.perf_counter()
    night = Workload(queries=make_queries(db, NIGHT_VIDS, k=wl.queries[0].k, seed=5),
                     probs=np.ones(len(NIGHT_VIDS)))
    drift = diurnal_trace(db, wl, night, n=queries, qps=1000.0, seed=13,
                          qid_start=500_000)
    rt = OnlineRuntime(db, mint, wl, cons, result=tuned, store=r["store"],
                       engine=online_engine(main),
                       config=RuntimeConfig(max_batch=16, max_delay_ms=5.0, window=32,
                                            min_window=16, drift_threshold=0.35,
                                            cooldown_s=1e9, retune_mode="pool",
                                            workers=2))
    builds = dict(n=0, s=0.0)
    get = rt.store.get

    def timed_get(spec):
        if spec in rt.store:
            return get(spec)
        t = time.perf_counter()
        out = get(spec)
        torch.cuda.synchronize()
        builds["n"] += 1
        builds["s"] += time.perf_counter() - t
        return out
    rt.store.get = timed_get
    flushes = []
    execute = rt.batcher.execute

    def gen_execute(tickets, staged=None):
        g0, inflight = rt.generation, rt.retuner.inflight
        out = execute(tickets, staged)
        flushes.append((inflight, g0, rt.generation))
        return out
    rt.batcher.execute = gen_execute
    dr = serve_online(rt, drift)
    check(len(rt.retune_events) == 1, f"{len(rt.retune_events)} retunes, expected one")
    check(not rt.retuner.builds.failures, f"retune failures: {rt.retuner.builds.failures}")
    check(all(a == b for _, a, b in flushes), "a flush saw two generations")
    during = sum(1 for f in flushes if f[0])
    rev = rt.retune_events[0]
    sample = make_queries(db, NIGHT_VIDS * 2, k=wl.queries[0].k, seed=17)
    recalls = []
    for i, q in enumerate(sample):
        q.qid = 600_000 + i
        tk = rt.submit(q, 10.0 + i * 1e-3)
        rt.drain(10.0 + i * 1e-3)
        gt = set(rt.engine.ground_truth(q).tolist())
        recalls.append(len(gt & set(np.asarray(tk.ids).tolist())) / len(gt))
    theta = cons.theta_recall
    check(float(np.mean(recalls)) >= theta,
          f"post-swap recall {float(np.mean(recalls)):.3f} under {theta}")
    drift_out = dict(
        retune=dict(generation=rev.generation, drift=rev.drift, window=rev.window,
                    config_before=rev.config_before, config_after=rev.config_after,
                    built=rev.built, dropped=rev.dropped, tune_seconds=rev.tune_seconds,
                    est_cost_before=rev.est_cost_before, est_cost_after=rev.est_cost_after),
        configuration=sorted(s.name for s in rt.result.configuration),
        build_wall_s=builds["s"], builds=builds["n"], flushes=len(flushes),
        flushes_during_retune=during, post_swap_recall=dict(mean=float(np.mean(recalls)),
                                                            min=float(min(recalls))),
        **dr["summary"])
    rt.close()
    del r["store"].get  # the main path's store serves unwrapped again
    steps["drift_retune"] = time.perf_counter() - t0

    seconds = time.perf_counter() - t_phase
    emit("online_path", rows=db.n_rows, queries=len(trace), re_arrivals=n_rep,
         seconds=seconds, budget_s=ONLINE_BUDGET_S, step_s=steps,
         host_rss_gib_at_start=rss0, host_peak_rss_gib_at_start=peak0,
         host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
         runs={k: v["summary"] for k, v in runs.items()},
         ids_equal=dict(sync_async_staged=True, sync_async_unstaged=True,
                        semcache_uncached=True, observe_on_off=True),
         semcache=dict(hits=sc.hits, misses=sc.misses, near_misses=sc.near_misses,
                       probes=probes["calls"], probe_launches=probes["launches"],
                       resident_probes=probes["resident"]),
         stages=stage_rows, ingest=ingest, drift=drift_out)
    return dict(launches={k: v["launches"] for k, v in runs.items()}, ingest=ingest,
                probe_launches=probes["launches"], dispatches=dispatches.largest,
                sync_launches=sync["launches"], semcache=sc)


def phase_online_kernel_times(online: dict, dev, peaks) -> list[dict]:
    """The online path's kernel uses, held against their plain versions and
    timed beside their library call and bound: the semantic cache's probe as
    the runtime makes it (one query over a namespace's resident ring with
    its kept squared norms; also timed recomputing them), and the distance
    kernel at the largest rerank of a micro-batch. Launches are the online
    runs' counts (the semcache run's probes; the sync run's distance)."""
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import check_scores, check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    rows = []
    ns = max(online["semcache"]._ns.values(), key=lambda ns: (ns.n, ns.queries.shape[1]))
    m, msq, n = ns.dev, ns.dev_sq, ns.n
    q = m[:1].clone()
    C, d = m.shape
    vals, ids = streaming_fused_scan(q, m, k=1, metric="l2", valid_n=n, db_sq=msq)
    rvals, rids = streaming_fused_scan_ref(q, m, 1, metric="l2", valid_n=n)
    full = combined_plain_scores(q, m, "l2", dict(valid_n=n))
    err, swaps = check_topk(vals, ids, rvals, rids, full, d, "online cache probe")
    check(int(ids[0, 0]) == 0, "the online probe missed its own row")
    ms = cuda_ms(lambda: streaming_fused_scan(q, m, k=1, metric="l2", valid_n=n, db_sq=msq))
    ms_norms = cuda_ms(lambda: streaming_fused_scan(q, m, k=1, metric="l2", valid_n=n))
    plain = cuda_ms(lambda: streaming_fused_scan_ref(q, m, 1, metric="l2", valid_n=n))
    lib = cuda_ms(lambda: torch.cdist(q, m[:n]).min(dim=1))
    nbytes, flops = 4 * (d + n * d) + 8, 2.0 * n * d
    rows.append(table_row(
        "streaming_fused_scan[online_cache_probe]", "cuda",
        "src/repro_torch/csrc/streaming.cu", "src/repro/kernels/streaming/kernel.py:44",
        online["probe_launches"], err, ms, plain, lib, bound(nbytes, flops, peaks),
        use="online_cache_probe", shape=[1, C, d, 1], valid_n=n,
        ms_recomputing_norms=ms_norms, near_tie_swaps=swaps, library="cdist + min",
        achieved_gbps=nbytes / ms / 1e6))
    disp = online["dispatches"]
    kind = "rerank" if "rerank" in disp else "centroids"
    rec = disp[kind]
    qd, xd = rec["qmat"], rec["rows"]()
    (B, dd), nn = qd.shape, xd.shape[0]
    err = check_scores(batched_scores(qd, xd), batched_scores_ref(qd, xd), dd,
                       f"distance at the online {kind}")
    ms = cuda_ms(lambda: batched_scores(qd, xd))
    plain = cuda_ms(lambda: batched_scores_ref(qd, xd))
    lib = cuda_ms(lambda: qd @ xd.T)
    nbytes, flops = 4 * (B * dd + nn * dd + B * nn), 2.0 * B * nn * dd
    rows.append(table_row(
        f"batched_scores[online_{kind}]", "cuda", "src/repro_torch/csrc/distance.cu",
        "src/repro/kernels/distance/kernel.py:23",
        online["sync_launches"]["batched_scores"], err, ms, plain, lib,
        bound(nbytes, flops, peaks), use=f"online_{kind}", shape=[B, nn, dd],
        library="matmul", achieved_gbps=nbytes / ms / 1e6,
        achieved_tflops=flops / ms / 1e9))
    return rows


# ---- multi-tenant serving under the device-memory governor ---------------------------

TENANT_BUDGET_S = 150.0  # the phase's share of the script's time limit
TENANT_ARRIVALS = 96  # the tenant trace's arrivals: 2/3 fresh, 1/3 exact re-arrivals
# the runtimes flush one micro-batch a service tick (1,600 queries a second at
# 16 a batch), below the rate inside t0's burst, so the queue backs up past one
# batch and the flush order (DRR or FIFO) decides who waits
TENANT_SERVICE_S = 0.010
TENANTS = ("t0", "t1", "t2")  # t0 is the noisy neighbour; t2 takes the churn


def key_kind(vid) -> str:
    """The kind of a governor key: a column, a delta segment or a
    semantic-cache namespace."""
    return vid[0] if vid and vid[0] in ("delta", "semcache") else "column"


def tenant_trace(db, wls, n: int, seed: int = 21):
    """``tenant_skew_trace`` over the tenants' workloads: n - n // 3 fresh
    arrivals at 1,000 a second, t0 six times as busy inside its window, then
    n // 3 exact re-arrivals of the earliest fresh ones (same tenant, new
    qids) 50 ms after the last fresh arrival, when every one has flushed
    (five service ticks)."""
    from dataclasses import replace
    from repro_torch.online import TimedQuery, tenant_skew_trace
    n_rep = n // 3
    fresh = tenant_skew_trace(db, wls, n=n - n_rep, qps=1000.0, noisy="t0", noisy_mult=6.0,
                              seed=seed, qid_start=700_000)
    t0 = fresh[-1].t + 0.05
    reps = [TimedQuery(t=t0 + i * 1e-3, query=replace(tq.query, qid=800_000 + i),
                       tenant=tq.tenant) for i, tq in enumerate(fresh[:n_rep])]
    return fresh + reps, n_rep


def serve_at_capacity(mt, trace, backlog: list):
    """Replay a tenant trace in trace time at one micro-batch a service tick
    (the runtime built with ``auto_flush=False``; one poll every
    ``TENANT_SERVICE_S``), then tick until the queue is empty. Notes the
    pending count before each tick in ``backlog``."""
    tickets, t_next = [], trace[0].t

    def tick():
        nonlocal t_next
        backlog.append(len(mt.batcher))
        mt.tick(t_next)
        t_next += TENANT_SERVICE_S
    for tq in trace:
        while t_next <= tq.t:
            tick()
        tickets.append(mt.submit(tq.tenant, tq.query, tq.t))
    while len(mt.batcher):
        tick()
    return tickets


class GovernorWatch:
    """Notes what a multi-tenant runtime's governor and stores do, without
    changing it: admissions by key kind, evictions by scope (the tenant's
    quota or the global budget) and key kind, uploads of columns, delta
    segments and semantic-cache namespaces (an upload of what was resident
    before is a re-upload, timed to the end of its copy), and each flush's
    tickets (tenant, qid) in the order the scheduler chose them."""

    def __init__(self, mt):
        from repro_torch.core.types import norm_vid
        self.acquired, self.evicted, self.flush_s, self.orders = [], [], [], []
        self.batches = {t: 0 for t in mt.tenants()}
        self.uploads = {k: 0 for k in ("column", "delta", "semcache")}
        self.reuploads = dict(self.uploads)
        self.reupload_s = {k: 0.0 for k in self.uploads}
        gov, scope = mt.governor, {}
        acquire, evict_until, evict = gov.acquire, gov._evict_until, gov._evict

        def w_acquire(tenant, vid, nbytes):
            scope.update(calls=0, quota=gov.quota(tenant) is not None)
            self.acquired.append((tenant, key_kind(vid)))
            return acquire(tenant, vid, nbytes)

        def w_evict_until(fits, victims):  # the quota's pass comes first
            scope["calls"] += 1
            scope["now"] = "quota" if scope["quota"] and scope["calls"] == 1 else "budget"
            return evict_until(fits, victims)

        def w_evict(tenant, vid):
            self.evicted.append((scope.get("now"), key_kind(vid), tenant))
            return evict(tenant, vid)
        gov.acquire, gov._evict_until, gov._evict = w_acquire, w_evict_until, w_evict
        for t in mt.tenants():
            st = mt.state(t)
            cs = st.cstore
            self._watch(cs, "device", "column", norm_vid,
                        lambda vid, cs=cs: norm_vid(vid) in cs._device)
            if st.view is not None:
                seg, table = st.view.segments, st.view.table
                self._watch(seg, "column", "delta", lambda vid: (norm_vid(vid), table.version),
                            lambda vid: seg._cache.get(norm_vid(vid), (None,))[0]
                            == table.version or table.n_delta == 0)
            if t in mt.semcaches:
                self._watch(mt.semcaches[t], "_device", "semcache",
                            lambda ns: (ns.ns_id, ns.version),
                            lambda ns: ns.dev is not None and ns.dev_version == ns.version)
        execute = mt.batcher.execute

        def w_execute(tickets, staged=None):
            for t in {tk.tenant for tk in tickets}:
                self.batches[t] += 1
            self.orders.append([(tk.tenant, tk.query.qid) for tk in tickets])
            t0 = time.perf_counter()
            out = execute(tickets, staged)
            torch.cuda.synchronize()
            self.flush_s.append(time.perf_counter() - t0)
            return out
        mt.batcher.execute = w_execute

    def _watch(self, obj, name, kind, key_of, resident):
        fn, seen = getattr(obj, name), set()

        def wrapped(arg):
            if resident(arg):
                return fn(arg)
            key = key_of(arg)
            t0 = time.perf_counter()
            out = fn(arg)
            torch.cuda.synchronize()
            self.uploads[kind] += 1
            if key in seen:
                self.reuploads[kind] += 1
                self.reupload_s[kind] += time.perf_counter() - t0
            seen.add(key)
            return out
        setattr(obj, name, wrapped)

    def eviction_counts(self) -> dict:
        out: dict = {}
        for scope, kind, _ in self.evicted:
            out.setdefault(scope, {}).setdefault(kind, 0)
            out[scope][kind] += 1
        return out


def pctl(xs, q) -> float | None:
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def phase_tenant_path(main: dict, dev, arrivals: int) -> dict:
    """Three tenants over the main path's tuned 1,000,000-row database and
    its tuned result (no re-tune), each serving a third of the bisimple
    queries, with 1% inserts and 1% deletes on t2: ungoverned (a), governed
    under 2/3 of (a)'s peak with t0's quota half of its bytes, fair (b) and
    FIFO (c), each served at one micro-batch a service tick, and each tenant
    alone (d). Ids must be equal across all four; (b) and (c) must flush
    different batches out of the backlog, and DRR must serve t1 and t2
    sooner than FIFO does."""
    from dataclasses import replace
    from repro_torch.core.types import QueryPlan, Workload
    from repro_torch.data.vectors import PAPER_COLUMNS, make_database
    from repro_torch.ingest import (CompactionPolicy, DeleteBatch, IngestConfig,
                                    IngestRuntime, InsertBatch)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.online import OnlineRuntime, RuntimeConfig, TimedQuery
    from repro_torch.tenancy import MultiTenantRuntime, Tenant
    t_phase = time.perf_counter()
    db, wl, r = main["db"], main["workload"], main["path"]
    cons, tuned = r["constraints"], r["result"]
    mint = replace(r["tuner"], attributes=None, _selest=None)
    if arrivals != TENANT_ARRIVALS:
        emit("scale_cut", tenant_arrivals=arrivals, tenant_arrivals_full=TENANT_ARRIVALS)
    rss0 = host_rss_gib()
    qs = sorted(wl.queries, key=lambda q: q.qid)
    share = len(qs) // len(TENANTS)
    wls = {t: Workload(queries=qs[i * share:(i + 1) * share], probs=np.ones(share))
           for i, t in enumerate(TENANTS)}
    trace, n_rep = tenant_trace(db, wls, arrivals)
    fresh = make_database(CHURN_ROWS, PAPER_COLUMNS, seed=77)
    deletes = np.random.default_rng(78).choice(db.n_rows, size=CHURN_ROWS, replace=False)
    cfg = dict(max_batch=16, max_delay_ms=5.0, cooldown_s=1e9, drift_threshold=2.0,
               semcache=True, semcache_epsilon=0.0)
    steps, runs = {}, {}

    def run(label, budget, quota_t0=None, fair=True):
        t0 = time.perf_counter()
        mt = MultiTenantRuntime(
            [Tenant(t, db, mint, wls[t], cons, result=tuned,
                    quota_bytes=quota_t0 if t == "t0" else None) for t in TENANTS],
            budget, config=RuntimeConfig(**cfg), fair=fair, auto_flush=False, device=dev)
        mt.enable_ingest("t2")
        mt.mutate("t2", InsertBatch(fresh.columns))
        mt.mutate("t2", DeleteBatch(deletes))
        for t in TENANTS:  # each tenant's IVF indexes, built before the trace
            for spec in sorted({s for q in wls[t].queries for s in tuned.plans[q.qid].indexes},
                               key=lambda s: s.name):
                mt.state(t).store.get(spec)
        watch = GovernorWatch(mt)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        reset_launch_counts()
        t1 = time.perf_counter()
        backlog = []
        tickets = serve_at_capacity(mt, trace, backlog)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
        gov = mt.governor.stats()
        waits = {}
        for t in TENANTS:
            mine = [tk for tk in tickets if tk.tenant == t]
            wall_ms, trace_ms = [tk.wall_wait_ms for tk in mine], [tk.wait_ms for tk in mine]
            waits[t] = dict(p50_wall_ms=pctl(wall_ms, 50), p99_wall_ms=pctl(wall_ms, 99),
                            p50_trace_ms=pctl(trace_ms, 50), p99_trace_ms=pctl(trace_ms, 99),
                            tickets=len(mine), batches=watch.batches[t])
        hits = [i for i, tk in enumerate(tickets) if tk.cache_hit]
        out = dict(mt=mt, watch=watch, ids=[np.asarray(tk.ids) for tk in tickets], hits=hits,
                   orders=watch.orders, summary=dict(
                       wall_s=wall, setup_s=setup_s, budget_bytes=budget, fair=fair,
                       quota_t0=quota_t0, governor=gov, evictions=watch.eviction_counts(),
                       acquired=sorted(set(watch.acquired)), uploads=watch.uploads,
                       reuploads=watch.reuploads, reupload_s=watch.reupload_s,
                       flushes=len(watch.flush_s), backlog_max=max(backlog),
                       flush_p50_s=pctl(watch.flush_s, 50),
                       flush_p99_s=pctl(watch.flush_s, 99),
                       max_memory_allocated_bytes=torch.cuda.max_memory_allocated() - alloc0,
                       peak_bytes=gov["peak_bytes"], launches=launches, tenants=waits,
                       cache_hits=len(hits)))
        runs[label] = out
        emit("tenant_step", step=label, **out["summary"])
        return out

    def done(label):
        runs[label]["mt"].close()
        runs[label].pop("mt")
        runs[label].pop("watch")
        gc.collect()
        steps[label] = time.perf_counter() - t_step

    # (a) ungoverned: the budget above anything
    t_step = time.perf_counter()
    a = run("ungoverned", 1 << 50)
    P = a["summary"]["peak_bytes"]
    t0_bytes = a["summary"]["governor"]["tenants"]["t0"]["bytes"]
    check(a["summary"]["governor"]["evictions"] == 0, "the ungoverned run evicted")
    done("ungoverned")
    rep = list(range(len(trace) - n_rep, len(trace)))
    check(a["hits"] == rep, f"ungoverned hits at {a['hits'][:8]}..., expected the re-arrivals")

    # (b) governed, fair: 2/3 of (a)'s peak, t0's quota half of its bytes in (a)
    t_step = time.perf_counter()
    budget, quota = int(2 * P / 3), t0_bytes // 2
    b = run("governed_fair", budget, quota_t0=quota)
    mt, watch = b["mt"], b["watch"]
    same_ids(b["ids"], a["ids"], "governed fair vs ungoverned")
    ev = b["summary"]["evictions"]
    check({"quota", "budget"} <= set(ev), f"evictions by scope: {ev}")
    gov = b["summary"]["governor"]
    check(gov["peak_bytes"] <= budget or gov["overcommits"] > 0,
          f"peak {gov['peak_bytes']} over the budget {budget} with no overcommit")
    check({k for _, k in b["summary"]["acquired"]} == {"column", "delta", "semcache"},
          f"governor keys: {b['summary']['acquired']}")
    check(b["hits"] == rep, f"governed hits at {b['hits'][:8]}..., expected the re-arrivals")
    check(b["summary"]["launches"]["streaming_fused_scan"] > 0
          and b["summary"]["launches"]["batched_scores"] > 0,
          f"the tenant path's launches: {b['summary']['launches']}")
    # an explicit spill of the largest resident column, no flush in flight
    nbytes, tenant, vid = max((n, t, v) for t, v, n in mt.governor.resident()
                              if key_kind(v) == "column")
    cs = mt.state(tenant).cstore
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    check(cs.evict_device(vid), f"{tenant} {vid} was not resident")
    torch.cuda.synchronize()
    drop = before - torch.cuda.memory_allocated()
    check(drop >= cs.device_bytes(vid),
          f"evicting {tenant} {vid} freed {drop} bytes of {cs.device_bytes(vid)}")
    spill = dict(tenant=tenant, vid=list(vid), padded_bytes=cs.device_bytes(vid),
                 memory_allocated_drop=drop, governor_bytes=nbytes)
    # t2's flat results after the churn equal the live oracle
    eng = mt.state("t2").engine
    flat = [(q, QueryPlan(q.qid, [], [], 0.0, 1.0)) for q in wls["t2"].queries]
    swaps = sum(same_topk(eng, q, got, eng.ground_truth(q), f"t2 q{q.qid} after the churn")
                for (q, _), got in zip(flat, eng.search_batch(flat)))
    table = mt.state("t2").table.stats()
    del mt, watch, eng, cs
    done("governed_fair")

    # (c) governed, FIFO
    t_step = time.perf_counter()
    c = run("governed_fifo", budget, quota_t0=quota, fair=False)
    same_ids(c["ids"], a["ids"], "governed FIFO vs ungoverned")
    check(c["summary"]["backlog_max"] > cfg["max_batch"],
          f"the queue never backed up past one batch: {c['summary']['backlog_max']}")
    check(b["orders"] != c["orders"], "DRR and FIFO flushed the same batches")
    fairness = {t: dict(drr_p99_trace_ms=b["summary"]["tenants"][t]["p99_trace_ms"],
                        fifo_p99_trace_ms=c["summary"]["tenants"][t]["p99_trace_ms"])
                for t in TENANTS}
    check(all(fairness[t]["drr_p99_trace_ms"] < fairness[t]["fifo_p99_trace_ms"]
              for t in ("t1", "t2")), f"DRR did not serve t1 and t2 sooner: {fairness}")
    gov = c["summary"]["governor"]
    check(gov["peak_bytes"] <= budget or gov["overcommits"] > 0,
          f"FIFO peak {gov['peak_bytes']} over the budget {budget} with no overcommit")
    check(c["hits"] == rep, f"FIFO hits at {c['hits'][:8]}..., expected the re-arrivals")
    done("governed_fifo")

    # (d) each tenant alone, over its own slice of the trace
    t_step = time.perf_counter()
    want = {tq.query.qid: ids for tq, ids in zip(trace, a["ids"])}
    alone = {}
    for t in TENANTS:
        sub = [TimedQuery(t=tq.t, query=tq.query) for tq in trace if tq.tenant == t]
        kw = dict(result=tuned, config=RuntimeConfig(**cfg), device=dev)
        if t == "t2":
            rt = IngestRuntime(db, mint, wls[t], cons, ingest=IngestConfig(
                policy=CompactionPolicy(max_delta_fraction=None, max_dead_fraction=None),
                auto_maintain=False), **kw)
            rt.mutate(InsertBatch(fresh.columns))
            rt.mutate(DeleteBatch(deletes))
        else:
            rt = OnlineRuntime(db, mint, wls[t], cons, **kw)
        t0 = time.perf_counter()
        tks = rt.run_trace(sub)
        torch.cuda.synchronize()
        alone[t] = dict(wall_s=time.perf_counter() - t0, tickets=len(tks),
                        batches=rt.stats()["batcher"]["batches"])
        for tk in tks:
            check(np.array_equal(np.asarray(tk.ids), want[tk.query.qid]),
                  f"{t} q{tk.query.qid}: ids differ from its run alone")
        rt.close()
        del rt, tks
        gc.collect()
    steps["alone"] = time.perf_counter() - t_step

    seconds = time.perf_counter() - t_phase
    emit("tenant_path", rows=db.n_rows, tenants=list(TENANTS), arrivals=len(trace),
         re_arrivals=n_rep, seconds=seconds, budget_s=TENANT_BUDGET_S, step_s=steps,
         ungoverned_peak_bytes=P, budget_bytes=budget, quota_t0_bytes=quota,
         runs={k: {f: v["summary"][f] for f in (
             "wall_s", "flushes", "backlog_max", "evictions", "reuploads", "reupload_s",
             "peak_bytes", "max_memory_allocated_bytes", "cache_hits")}
             for k, v in runs.items()},
         alone=alone,
         service_s=TENANT_SERVICE_S, fairness=fairness,
         flush_orders_differ=True,
         ids_equal=dict(governed_fair=True, governed_fifo=True, each_alone=True),
         explicit_spill=spill, t2_table=table, t2_flat_oracle_near_tie_swaps=swaps,
         host_rss_gib_at_start=rss0, host_rss_gib_at_end=host_rss_gib(),
         host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    return dict(launches={k: v["summary"]["launches"] for k, v in runs.items()})


# ---- the auto-tuner's replays on the card -----------------------------------------------

AUTOTUNE_ROWS = 100_000  # cut from the paper's 1,000,000: each trial replays the whole
AUTOTUNE_BUDGET_S = 120.0  # trace and scores recall against the host oracle
AUTOTUNE_COLS = (("sift1m", 128), ("glove200", 200))  # data/vectors.py: PAPER_COLUMNS


class ScanCalls:
    """Notes the largest plain streaming-scan dispatch (no masks, no delta,
    the default metric) the engines make on ``device`` while installed: its
    queries, rows and k. What the scan computes is unchanged."""

    def __init__(self, device):
        self.device = device
        self.largest = None

    def install(self):
        import repro_torch.serve.engine as engine
        scan = engine.streaming_fused_scan

        def noted(q, db, k, **kw):
            if (q.device.type == self.device.type and "metric" not in kw
                    and all(v is None for n, v in kw.items() if n != "valid_n")):
                size = q.shape[0] * db.shape[0] * db.shape[1]
                if self.largest is None or size > math.prod(self.largest["shape"][:3]):
                    self.largest = dict(shape=(q.shape[0], db.shape[0], db.shape[1], k),
                                        q=q.clone(), db=db, k=k, valid_n=kw.get("valid_n"))
            return scan(q, db, k, **kw)
        engine.streaming_fused_scan = noted

        def undo():
            engine.streaming_fused_scan = scan
        return undo


def phase_autotune_path(dev, rows: int) -> dict:
    """The auto-tuner's three replay scenarios (steady, churn, tenant_skew;
    flat indexes) at the paper's column widths: an ``AutoTuner`` of 4 trials
    plus the defaults at fidelities 0.5 and 1.0 on the card, then the best
    trial replayed on the card (the same fingerprint, snapshot and
    objectives) and on the CPU (the same device bytes, the same dispatches
    in every flush and the same fingerprint)."""
    from repro_torch.autotune import (AutoTuner, ReplayScenario, TunerConfig,
                                      clear_deployments, replay, serving_space)
    from repro_torch.autotune.replay import deployment
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    emit("scale_cut", autotune_rows=rows, paper_rows=1_000_000,
         why="every trial replays its trace and scores recall against the host oracle")
    scans = ScanCalls(dev)
    undo = scans.install()
    reset_launch_counts()
    out, replays = {}, 0
    try:
        for name in ("steady", "churn", "tenant_skew"):
            sc = ReplayScenario(name=name, index_kind="flat", rows=rows, cols=AUTOTUNE_COLS,
                                vids=((0,), (0, 1)), n_queries=64, k=10,
                                min_sample_rows=2000, budget_mb=400)
            space = serving_space(churn=sc.churn)
            t0 = time.perf_counter()
            deployment(sc, dev)
            deploy_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            report = AutoTuner(sc, space=space, device=dev, config=TunerConfig(
                n_trials=4, fidelities=(0.5, 1.0), seed=0,
                warm_start=(space.defaults(),))).run()
            tune_s = time.perf_counter() - t0
            evaluated = sum(1 for t in report.trials if t.objectives)
            check(bool(report.front), f"{name}: empty front ({report.diagnostic})")
            best = report.best
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = replay(sc, best.params, seed=best.seed, device=dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            check(card.fingerprint == best.fingerprint and card.snapshot == best.snapshot
                  and card.objectives == best.objectives,
                  f"{name}: the best trial's replay on the card differs from its trial")
            t0 = time.perf_counter()
            cpu = replay(sc, best.params, seed=best.seed, device="cpu")
            cpu_s = time.perf_counter() - t0
            check(cpu.objectives["device_bytes"] == card.objectives["device_bytes"],
                  f"{name}: device bytes {card.objectives['device_bytes']} on the card, "
                  f"{cpu.objectives['device_bytes']} on the CPU")
            check(cpu.flush_dispatches == card.flush_dispatches,
                  f"{name}: dispatches a flush differ between the card and the CPU")
            # what the card computed: every ticket's recall and the cache's
            # hits are in the deterministic snapshot the fingerprint hashes
            check(cpu.fingerprint == card.fingerprint and cpu.snapshot == card.snapshot,
                  f"{name}: fingerprint {card.fingerprint} on the card, "
                  f"{cpu.fingerprint} on the CPU")
            svc = card.snapshot["replay_service_ms"]
            replays += evaluated + 1
            out[name] = dict(
                trials=len(report.trials), evaluated=evaluated, front=len(report.front),
                best_trial=best.trial_id, best_params=best.params, deploy_s=deploy_s,
                tune_s=tune_s, replay_card_s=card_s, replay_cpu_s=cpu_s,
                flushes=card.n_flushes, queries=card.n_queries,
                wall_ms_per_flush=card_s / max(card.n_flushes, 1) * 1e3,
                modeled_mean_service_ms=svc["total"] / max(svc["count"], 1),
                objectives_card=card.objectives, objectives_cpu=cpu.objectives,
                fingerprint_card=card.fingerprint, fingerprint_cpu=cpu.fingerprint,
                events_card=card.events, events_cpu=cpu.events,
                dispatches=sum(card.flush_dispatches))
            emit("autotune_step", scenario=name, **out[name])
    finally:
        undo()
    torch.cuda.synchronize()
    launches = {n: c for n, c in launch_counts().items() if n in MINT_KERNELS}
    check(launches["streaming_fused_scan"] > 0, "the replays launched no scan")
    check(scans.largest is not None, "no plain scan dispatch was noted")
    clear_deployments()
    gc.collect()
    emit("autotune_path", rows=rows, columns=[list(c) for c in AUTOTUNE_COLS],
         seconds=time.perf_counter() - t_phase, budget_s=AUTOTUNE_BUDGET_S,
         replays_on_card=replays, launches=launches,
         largest_scan=list(scans.largest["shape"]), scenarios=out)
    return dict(launches=launches, scan=scans.largest)


def phase_autotune_kernel_time(at: dict, peaks) -> list[dict]:
    """The scan at the replays' largest plain dispatch, held against its
    plain version and the two-pass scan and timed beside ``matmul`` +
    ``topk`` and its bound. Launches are the autotune phase's."""
    from repro_torch.kernels.parity import check_topk, combined_plain_scores, two_pass_scan
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    rec = at["scan"]
    q, x, k, n = rec["q"], rec["db"], rec["k"], rec["valid_n"]
    n = x.shape[0] if n is None else n
    (B, d), kw = q.shape, dict(valid_n=n)
    vals, ids = streaming_fused_scan(q, x, k=k, **kw)
    rvals, rids = streaming_fused_scan_ref(q, x, k, **kw)
    err, swaps = check_topk(vals, ids, rvals, rids, combined_plain_scores(q, x, "dot", kw),
                            d, "autotune scan")
    v2, i2 = two_pass_scan(q, x, k, "dot", kw)
    check(torch.equal(v2, vals) and torch.equal(i2, ids),
          "two-pass scan differs from the streaming scan (autotune)")
    ms = cuda_ms(lambda: streaming_fused_scan(q, x, k=k, **kw))
    plain = cuda_ms(lambda: streaming_fused_scan_ref(q, x, k, **kw))
    lib = cuda_ms(lambda: torch.topk(q @ x[:n].T, k, dim=1))
    nbytes, flops = 4 * (B * d + n * d) + 8 * B * k, 2.0 * B * n * d
    return [table_row(
        "streaming_fused_scan[autotune_replay]", "cuda", "src/repro_torch/csrc/streaming.cu",
        "src/repro/kernels/streaming/kernel.py:44", at["launches"]["streaming_fused_scan"],
        err, ms, plain, lib, bound(nbytes, flops, peaks), use="autotune_replay",
        shape=[B, n, d, k], near_tie_swaps=swaps, two_pass_equal=True,
        library="matmul + topk", achieved_gbps=nbytes / ms / 1e6,
        achieved_tflops=flops / ms / 1e9)]


# ---- CPU vs card -----------------------------------------------------------------------


def phase_cpu_vs_card() -> None:
    from repro_torch.async_ import StepExecutor
    from repro_torch.core.types import Constraints
    from repro_torch.data.vectors import make_database, make_workload
    from repro_torch.online import OnlineRuntime, RuntimeConfig
    from repro_torch.serve.engine import BatchEngine
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
    # the online path: an async flush driven by a seeded StepExecutor, with the
    # semantic cache in front (16 of the 48 arrivals are exact re-arrivals)
    trace, n_rep = online_trace(db, workload, 48)
    online = {}
    for dev, run in runs.items():
        rt = OnlineRuntime(db, run["tuner"], workload, constraints, result=run["result"],
                           store=run["store"], engine=BatchEngine(db, store=run["store"]),
                           executor=StepExecutor(seed=0),
                           config=RuntimeConfig(max_batch=8, cooldown_s=1e9,
                                                drift_threshold=2.0, async_flush=True,
                                                semcache=True, semcache_epsilon=0.0))
        # fresh arrivals first, drained, so the re-arrivals find them admitted
        tickets = rt.run_trace(trace[:-n_rep]) + rt.run_trace(trace[-n_rep:])
        st = rt.stats()
        online[dev] = dict(ids=[np.asarray(t.result(timeout=60)) for t in tickets],
                           batcher=st["batcher"], plan_cache=st["plan_cache"],
                           hits=st["semcache"]["hits"], misses=st["semcache"]["misses"])
        rt.close()
    same_ids(online["cuda"]["ids"], online["cpu"]["ids"], "online path CPU vs card")
    for key in ("batcher", "plan_cache", "hits", "misses"):
        check(online["cuda"][key] == online["cpu"][key],
              f"online {key} differs between CPU and card")
    check(online["cuda"]["hits"] == n_rep, f"{online['cuda']['hits']} semcache hits of {n_rep}")
    emit("cpu_vs_card", rows=2500, configuration_equal=True, plans_equal=True,
         ids_equal=True, num_dist_equal=True, costs_equal=True,
         cost_ratio=a["mint"].weighted_cost / a["per_column"].weighted_cost,
         cpu_counters=a["counters"], card_counters=b["counters"],
         online=dict(queries=len(trace), ids_equal=True, batcher=online["cuda"]["batcher"],
                     plan_cache=online["cuda"]["plan_cache"],
                     semcache_hits=online["cuda"]["hits"]))


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
    ap.add_argument("--online-queries", type=int, default=ONLINE_QUERIES,
                    help="arrivals of the online path's traces (cut only if the "
                         "phase runs past its budget; the cut is printed)")
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
        # what no later phase reads: the engines the mutation phase swapped
        # onto its compacted table (its host and card columns) and the
        # filter phase's planner (its host column concatenations); the
        # online phase's retune concatenates columns afresh
        del main_path["path"]["engine"], main_path["two"], filt["planner"]
        gc.collect()
        online = phase_online_path(main_path, dev, args.online_queries)
        rows += phase_slice_kernel_times(main_path, filt, mut, probe, dev, peaks)
        rows += phase_online_kernel_times(online, dev, peaks)
        # the online phase's runtimes and the earlier phases' noted tensors go
        # before three tenants concatenate their columns again
        del filt, mut, probe, online
        gc.collect()
        phase_tenant_path(main_path, dev, TENANT_ARRIVALS)
        at = phase_autotune_path(dev, AUTOTUNE_ROWS)
        rows += phase_autotune_kernel_time(at, peaks)
        del main_path, at  # the model needs the card's memory
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
