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
     flash routes (split_kv, tensor_core, fp32); then the flash backward's
     grid (phase ``flash_bwd_grid``: causal or not, window, softcap 50, GQA
     groups 1 / 2 / 6, d = 32 / 64 / 128, Sq < Skv aligned to the end,
     unmasked cross attention, ragged lengths, cases spanning several 64-row
     tiles each way, x f32/bf16/f16): the kernel against
     ``attention_bwd_ref`` on the same inputs, on its dtype's route
     (``tensor_core`` for bf16 / f16, ``ffma`` for f32), the forward's lse
     (every route) against ``attention_lse_ref``, two backward calls bit for
     bit, and the serving forward bit for bit the lse-writing one's;
  3. MINT's main path at real scale: the paper's 8-column pool at 500,000
     rows (``--rows``; cut from the paper's 1,000,000 to keep the script in
     half its time limit, printed as a ``scale_cut``), the bisimple
     workload (k = 100), ``Mint(index_kind="ivf")`` tuned at theta_recall =
     0.9 / 4 indexes, indexes built, the MINT and PerColumn plans served
     through ``BatchEngine`` (streaming scan), again with the two-pass scan
     (ids must be equal), then 64-query bursts that
     must take one scan dispatch per (group, index). The device rerank's ids
     at its largest single-query group and at the plan burst's 64-query
     group must equal the host algorithm's (``np.unique`` unions, stable
     ``argsort``) over the same scores, and the plan burst and its rerank
     are timed (median of 5). Kernel launch counts are
     zeroed before and read after; every kernel must have run. The shape of
     the largest distance dispatch of each kind (IVF centroids, rerank union,
     a single query's rerank union, two-pass flat scan) and of the rerank's
     top-k input is noted;
  4. each kernel against its plain version again, and timed (device time:
     CUDA events around each call behind a busy stream, median of 20)
     beside the plain version, one PyTorch library call and the bound, at
     those main-path shapes; the two-pass scan bit-equal to the streaming
     scan at B = 1 and 64 over the main path's column, and timed; top-k
     also at its worst case (scores rising along each row) and at the
     rerank's own (1, U) and masked (64, U) inputs, bit for bit;
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
     ``--online-queries`` arrivals, 48 by default: cut from 96, printed as
     a ``scale_cut``; a third of them exact re-arrivals):
     ``OnlineRuntime`` sync, async on a worker pool with staged uploads and
     without (ids equal), with the semantic cache (every re-arrival hits,
     probes scan the namespace's resident CUDA matrix, ids equal), observed
     (ids equal; ``launch/obs_report`` stage rows); an ``IngestRuntime``
     with ~10,000 inserts and deletes and a forced async compaction (every
     flush sees one (store, generation, table) state, flat ids equal the
     live oracle after the finalize); a drift to column 0 that fires one
     pooled retune (tune and shadow build on a worker thread while this
     thread serves, post-swap recall >= theta). Then each new kernel use
     (keep-masked scan, merged base + delta scan, cache probe with kept
     norms, distance at the largest pre-filter gather, the online probe and
     the online rerank) held against its plain version and timed as in 4;
  9. three tenants over that tuned database (phase ``tenant_path``, each
     serving a third of the bisimple queries, 96 arrivals of a tenant-skew
     trace with t0 the noisy neighbour and a third exact re-arrivals, 10,000
     inserts and 10,000 deletes on t2): a ``MultiTenantRuntime`` at one
     micro-batch every 10 ms, ungoverned, then under a ``MemoryGovernor``
     budget of 2/3 of its peak with t0's quota half of its bytes (DRR and
     FIFO: the queue backs up, the two flush different batches and DRR
     serves t1 and t2 sooner), and each tenant
     alone: equal ids in all four, evictions by quota and by budget of
     columns, delta segments and semantic-cache namespaces, every re-arrival
     a cache hit, t2's flat ids equal to the live oracle, and an explicit
     spill that lowers ``torch.cuda.memory_allocated`` by the column's padded
     bytes; then the auto-tuner (phase ``autotune_path``): its steady, churn
     and tenant-skew replay scenarios at 10,000 rows (cut from 100,000 to
     make room for ``sharded_ssm_path``, printed as ``scale_cut``) and the
     paper's sift1m and glove200 widths, 4 trials and the defaults at two
     fidelities on the card, the best trial's replay on the card equal to
     its trial (fingerprint, snapshot, objectives) and on the CPU equal in
     device bytes, dispatches a flush and fingerprint; the scan at the
     replays' largest dispatch held against its plain version and timed as
     in 4; then serving over a row-sharded mesh (phase ``mesh_path``):
     ``make_debug_mesh(4, 1)`` repeats the card over four data ranks of
     a quarter of the rows each, and against the single-device engine over the same
     store (a) the MINT and PerColumn plans through ``BatchEngine`` on the
     mesh give equal ids, numDist, costs and dispatch counters, (b) a
     64-query flat burst takes one dispatch and four scan launches and the
     tournament step's values equal the single-device scan bit for bit
     (exact ties counted), (c) flat and keep-masked (~10%) flat scans over
     10,000 inserts and 10,000 deletes ride the step's ``bad`` operand in
     two dispatches a group and give equal ids (``same_topk``), (d)
     ``distributed_rerank`` of 200,000 candidates equals one distance-kernel
     call bit for bit, (e) ``launch/search_dryrun`` on the meta production
     mesh prints the tournament's and the naive gather's collective bytes;
     the scan at a shard's shape and the distance kernel at the rows rank 0
     owns in the rerank held against their plain versions and timed as in 4;
  10. the same path on the CPU and on the card at the serving-test scale
     (2,500 rows): configuration, plans, numDist, costs and ids must agree,
     and a StepExecutor-driven async online run of 48 arrivals gives equal
     ids, flush, plan-cache and semantic-cache stats; then the torch
     quickstart (``examples/torch_quickstart.py``) over
     ``hnsw`` at 50,000 rows (phase ``graph_path``, cut from 100,000 to make
     room for ``mesh_path``; MINT's recall >=
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
  13. the other five families at their published width and depth (phase
     ``families_path``, random bf16 weights from a seed, each freed before
     the next): granite-moe-3b-a800m, zamba2-1.2b and xlstm-350m on 2 x
     2,048 tokens, whisper-medium on 2 x 1,500 random frames (the stubbed
     conv front end) and a 384-token decoder prompt, qwen2-vl-2b on 2 x
     (256 vision embeddings + 2,048 tokens); each a timed prefill, 16 greedy
     decode steps and the decode-vs-prefill check (for the MoE, where a
     capacity drop or a router near tie makes the two compute different
     functions, the rules of ``moe_decode_vs_prefill``), with the MoE's
     dropped pairs per layer, the flash launches by route (tensor cores and
     split-KV for every family with attention, whisper's cross attention
     on tensor cores at prefill and split-KV at decode; none for xLSTM) and
     the noted q / k / v; then the flash kernel at five of those calls
     (granite's prefill, whisper's encoder, its cross attention at prefill
     and at decode, qwen2-vl's decode) held and timed as in 12;
  14. the same model path on the CPU and on the card at the six
     ``reduced()`` configs: logits within the same tolerance, the same
     top-1 tokens (for the five new families, up to a near tie).
  15. training (phase ``train_path``): granite-moe-1b-a400m at its full
     width and depth (24 layers, d_model 1024, 32 experts top-8, random f32
     weights from a seed) through ``make_train_step`` for 8 steps of
     8 x 2,048 ``TokenPipeline`` tokens, bf16 grads, remat, peak lr 1e-3:
     finite losses and gnorms, a loss that falls after step 0 (lr 0), flash
     forward launches 2 x 24 a step (remat) and backward launches 24, all on
     the backward's ``tensor_core`` route; every
     leaf's gradient finite and non-zero, each layer's wq / wk / wv / wo by
     name; a profiled step (the device's busy share, the top kernels); at 2
     layers of the same width one step's loss and gradients with the
     kernels against the plain attention on the card (per-leaf relative L2
     <= 0.05); then the backward kernel at that attention call held, timed
     beside its plain version, an SDPA backward and its bound;
  16. the fault-tolerant loop (phase ``train_loop``): ``train()`` at
     granite-moe-1b-a400m ``reduced()`` (60 steps of 8 x 128, checkpoints
     every 10), clean with no restart, then with a failure injected at step
     30: one restart, the loss after the restore bit-equal to the clean
     run's at that step, and a falling loss;
  17. one training step of each family's ``reduced()`` config on the CPU and
     on the card (phase ``train_cpu_vs_card``): loss, gnorm, lr and every
     leaf's gradient within the bf16 bounds of
     tests/test_torch_train_families.py;
  18. sharded training (phase ``sharded_train_path``): granite-moe-1b-a400m
     at full width and depth on ``make_debug_mesh(2, 4)`` of the card (tp
     mode: each of the 8 ranks runs the flash kernels on its 4 q heads and 2
     kv heads, both ways; ZeRO-1 moments), 3 steps of train_path's master
     params and batches: the step-0 loss within 1e-2 relative of one
     device's, a repeat of step 0 bit-equal, flash launches 2 x 24 x 8
     forward and 24 x 8 backward a step, each step's collectives (calls and
     bytes by kind); an elastic reshard onto (4, 2) and one step there; at 2
     layers of the width, on the unsharded bf16 step's MoE routes replayed,
     every gradient of the sharded step against the unsharded one in float32
     (relative L2 <= 1e-4) and in bf16 (<= 0.05, every leaf but the
     embedding, whose bf16 index backward is held through float32), and on
     each side's own routes in float32 the loss (1e-5 relative) and, where
     no token routes otherwise, every gradient (1e-4); then the flash forward
     (with lse) and backward at one rank's call, held, timed beside their
     plain versions and SDPA, and bounded;
  19. serving on the mesh (phase ``sharded_serve_path``): granite-moe-3b-a800m
     at full width and depth on ``make_debug_mesh(2, 4)`` (each rank 6 q / 2
     kv heads) through ``make_prefill_step`` / ``make_serve_step`` under
     ``use_mesh``: a prefill of 2 x 2,048 tokens, the cache grown to 2,064
     positions (its sequence split over the 4 model ranks), 16 decode steps
     (each sequence shard through the flash kernel's split-KV route with its
     lse, combined by a pmax and two psums), against one device's run on its
     replayed MoE routes and greedy tokens (families_path's tolerance and
     near-tie rule), a repeat bit-equal, flash launches by route, the
     collectives by kind, prefill s, decode ms a step and peak memory; a
     ``shard_seq`` decode at batch 1 over a 32,768-position cache spread over
     all 8 ranks (cut from long_500k's 524,288, printed as ``scale_cut``);
     then the flash kernel at one rank's prefill call and one shard's decode
     call, held, timed beside its plain version and SDPA, and bounded;
  20. the Mamba-2 and xLSTM blocks split by head over the mesh's model axis
     (phase ``sharded_ssm_path``): zamba2-1.2b (64 SSM heads, 16 a rank;
     its shared attention 8 q heads a rank in the flash kernels) and
     xlstm-350m (4 mLSTM heads, 1 a rank) at full width and depth on
     ``make_debug_mesh(2, 4)``: a prefill of 2 x S tokens (S 2,048 for
     zamba2, 256 for xlstm: its sLSTM loops over time on the host, printed
     as ``scale_cut``) and 16 decode steps against one device's run on the
     card (sharded_serve_path's tolerance and near-tie rule), a repeat
     bit-equal; one tp training step (bf16 grads, remat) at 2 x S, its loss
     within 1e-2 of one device's and a repeat bit-equal; the collectives by
     kind per prefill, decode step and training step beside the bytes the
     gathered blocks logged, no whole split weight delivered by any
     collective, peak memory, prefill s, decode ms a step, step ms and
     zamba2's flash launches by route; then the flash kernel at one zamba2
     rank's prefill call and one sequence shard's decode call, held, timed
     beside its plain version and SDPA, and bounded;
  21. attention's q heads split unevenly over the mesh's model axis (phase
     ``uneven_tp_path``): qwen2-7b at full width and depth (28 layers, 28 q
     / 4 kv heads of 128) on ``make_debug_mesh(1, 16)``, the production
     mesh's 16 model ranks: each rank owns 2 q heads (ranks 14-15 none;
     ranks 3 and 10 straddle the kv groups of 7), its ``wq`` columns and
     ``wo`` rows outside its own block moved as weights or products; a
     prefill of 2 x 2,048 tokens and 16 decode steps over the
     sequence-split cache against one device's run (sharded_serve_path's
     tolerance and near-tie rule), a repeat bit-equal; one tp training step
     with the depth cut to 2 layers (printed as ``scale_cut``), its loss
     within 1e-2 of one device's, a repeat bit-equal; no whole ``wq`` /
     ``bq`` / ``wo`` delivered by a collective, the bytes moved against the
     whole weights', flash launches by route, the collectives by kind,
     prefill s, decode ms a step, step s and peak memory; then the flash
     kernel at the straddling rank's prefill call and one shard's decode
     call, held, timed beside its plain version and SDPA, and bounded;
  22. the scan sweep (phase ``scan_sweep``): ``launch.roofline.
     streaming_vs_twopass(measure=True)``: the modeled bytes of the streaming
     and two-pass scans and both timed per N (2,048 to 262,144; B 128, d 128,
     k 16, every 64th row dead), bit-equal at each N, the acceptance (at the
     largest N the two-pass score block exceeds the 50 MB L2 and moves >= 2x
     the bytes); the three kernels at the largest N held, timed and bounded;
  23. the dry-run (phase ``dryrun``): ``launch.dryrun.run_cell`` on the meta
     16 x 16 mesh for granite-moe-1b-a400m's decode_32k and prefill_32k, and
     the counting pass over train_path's step on meta, its FLOPs beside the
     analytic ``flops_per_step``.

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


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase; ``at_s`` is the script's wall clock when it
    was printed, so each phase's share of the time limit can be read off."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T_START},
                     default=float), flush=True)


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
    versions and timed at exactly these shapes.

    It also notes the largest top-k input of the device rerank's order, one
    for single-query groups (``rerank_order``) and one for wider groups,
    whose non-members are masked to NEG_INF (``rerank_order_masked``): the
    (B, U) scores, the group's k, each query's k, its candidate lists and the
    ids the engine returned (``check_rerank_order`` holds them)."""

    def __init__(self):
        self.kind = self.col = None
        self.largest: dict[str, dict] = {}

    def note(self, kind, qmat, n, rows, **extra):
        B, d = qmat.shape
        old = self.largest.get(kind)
        if old is None or B * n * d > math.prod(old["shape"]):
            self.largest[kind] = dict(shape=(B, n, d), qmat=qmat.clone(), rows=rows,
                                      **extra)

    def note_order(self, group, cand, scores, k, out):
        kind = "rerank_order" if scores.shape[0] == 1 else "rerank_order_masked"
        old = self.largest.get(kind)
        if old is None or scores.numel() > math.prod(old["shape"]):
            self.largest[kind] = dict(
                shape=tuple(scores.shape), scores=scores.clone(), k=k,
                ks=[it.query.k for it in group.items], cand=[list(r) for r in cand],
                out=[np.array(o) for o in out])

    def attach(self, engine):
        """Wraps the engine's dispatch methods; returns an undo."""
        import repro_torch.serve.engine as engine_mod
        names = ("_ivf_scan", "_rerank", "_prefilter_group", "_flat_scan_scored",
                 "_batched_scores")
        ivf_scan, rerank, prefilter, flat, scored = (getattr(engine, n) for n in names)
        topk = engine_mod.topk_scores

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
                def rows(col=self.col, n=sub.shape[0]):
                    return col.data[:n]
                self.note("rerank", qmat, sub.shape[0], rows)
                if qmat.shape[0] == 1:  # a single query's union, as a served query's
                    self.note("rerank_single", qmat, sub.shape[0], rows)
            return scored(qmat, sub)

        def flat_scan_scored(col, qmat, k, **kw):
            if not engine.streaming and not kw:
                self.note("flat_two_pass", qmat, col.data.shape[0],
                          lambda col=col: col.data, k=k, valid_n=col.n_rows)
            return flat(col, qmat, k, **kw)

        def reranked(group, cand, *args, **kw):
            seen = []

            def topk_noted(scores, k):
                seen.append((scores, k))
                return topk(scores, k)
            engine_mod.topk_scores = topk_noted
            try:
                out = within("rerank", rerank)(group, cand, *args, **kw)
            finally:
                engine_mod.topk_scores = topk
            for scores, k in seen:
                self.note_order(group, cand, scores, k, out)
            return out

        engine._ivf_scan = within("centroids", ivf_scan)
        engine._rerank = reranked
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


def check_rerank_order(rec: dict, what: str) -> None:
    """Holds a device rerank (a ``DistanceDispatches`` order record) against
    the host algorithm it replaced, over the device's own scores: each
    query's ``np.unique`` union and the group's, ``searchsorted`` of one into
    the other, and a stable descending ``argsort`` of the query's scores cut
    to its k. The scores' columns must be the group's union, a query's
    members exactly its scores above NEG_INF, and the ids equal."""
    from repro_torch.kernels.common import NEG_INF
    empty = np.empty(0, np.int64)
    unions = [np.unique(np.concatenate(row + [empty])) for row in rec["cand"]]
    gunion = np.unique(np.concatenate(unions))
    scores = rec["scores"].cpu().numpy()
    check(scores.shape == (len(unions), gunion.shape[0]),
          f"{what}: scores {scores.shape}, the host union {gunion.shape[0]}")
    for i, (u, k, got) in enumerate(zip(unions, rec["ks"], rec["out"])):
        s = scores[i]
        check(int((s > NEG_INF / 2).sum()) == u.shape[0],
              f"{what}: query {i}'s mask holds {(s > NEG_INF / 2).sum()} of {u.shape[0]}")
        s = s[np.searchsorted(gunion, u)]
        want = u[np.argsort(-s, kind="stable")[:k]]
        check(np.array_equal(got, want), f"{what}: query {i}'s ids differ from the host's")


def timed_burst(eng, pairs, reps: int = 5) -> dict:
    """Serves one burst once to warm it, then ``reps`` times, synchronising
    around the burst and around its rerank: each rep's wall time and its
    reranks' (ms), and their medians."""
    rerank, walls, spent = eng._rerank, [], []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return rerank(*args, **kw)
        finally:
            torch.cuda.synchronize()
            spent[-1] += (time.perf_counter() - t0) * 1e3
    eng._rerank = timed
    try:
        for _ in range(reps + 1):
            spent.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.search_batch(pairs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        eng._rerank = rerank
    return dict(group_ms=walls[1:], rerank_ms=spent[1:],
                group_ms_median=statistics.median(walls[1:]),
                rerank_ms_median=statistics.median(spent[1:]))


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
    # the device rerank's answers against the host algorithm it replaced, at
    # the largest single-query group and at the burst's masked 64-query group
    for kind in ("rerank_order", "rerank_order_masked"):
        check(kind in dispatches.largest, f"no device rerank of kind {kind}")
        check_rerank_order(dispatches.largest[kind], kind)
    bursts["plan_streaming_timed"] = timed_burst(
        r["engine"], [(bq, r["result"].plans[q.qid]) for bq in burst])
    emit("burst", query=q.name, plan=r["result"].plans[q.qid].describe(), batch=64,
         ids_equal_streaming_two_pass=True, rerank_equal_host=True, **bursts)

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
    check(set(dispatches.largest) == {"centroids", "rerank", "rerank_single", "flat_two_pass",
                                      "rerank_order", "rerank_order_masked"},
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
    # queries; the rerank's rows are as many rows of the same column; the
    # largest single-query rerank beside the largest of all), then
    # the two nominal serving shapes on seeded random inputs. The table row
    # is the rerank: the largest distance dispatch of the default (streaming)
    # serving path
    g = torch.Generator().manual_seed(1)
    disp = main["dispatches"]
    cases = [(kind, disp[kind]["qmat"], disp[kind]["rows"]())
             for kind in ("centroids", "rerank", "rerank_single", "flat_two_pass")]
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
    # survives the threshold), at the same shape and k; then the rerank's
    # order at its largest inputs as the engine made them, a single query's
    # union and the burst's 64 queries over their group's union with each
    # query's non-members at NEG_INF, at the group's k
    flat = disp["flat_two_pass"]
    scores = _mask_rows(batched_scores_ref(flat["qmat"], flat["rows"]()), flat["valid_n"])
    k_path = min(flat["k"], flat["valid_n"])
    rising = torch.arange(scores.shape[1], device=dev,
                          dtype=torch.float32).expand(*scores.shape).contiguous()
    cases = [("flat_two_pass", scores, k_path), ("nominal", scores, 128),
             ("ascending_worst_case", rising, k_path)]
    cases += [(label, disp[kind]["scores"], disp[kind]["k"])
              for label, kind in (("rerank", "rerank_order"),
                                  ("rerank_masked", "rerank_order_masked"))]
    for label, s_in, kk in cases:
        B, n = s_in.shape
        tv, ti = topk_scores(s_in, kk)
        tr, tri = topk_ref(s_in, kk)
        check(torch.equal(tv, tr) and torch.equal(ti, tri),
              f"top-k differs at {label} ({B}, {n}, {kk})")
        ms = cuda_ms(lambda: topk_scores(s_in, kk))
        plain = cuda_ms(lambda: topk_ref(s_in, kk))
        lib = cuda_ms(lambda: torch.topk(s_in, min(kk, n), dim=1))
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
MAIN_ROWS_UNCUT = 1_000_000  # the paper's rows
MAIN_ROWS = 500_000  # cut so the script ends in half its time limit on a slow host
CHURN_ROWS = 10_000  # inserted and deleted each: 1% of the paper's rows each way
GRAPH_ROWS_UNCUT = 100_000
GRAPH_ROWS = 50_000  # cut to make room for mesh_path (host-numpy kNN pools)


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
    its rows, the bisimple queries under Range predicates at four
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


def churned_table(db, attrs):
    """A ``MutableTable`` over ``db`` after 10,000 inserted rows
    (``make_database(10_000, PAPER_COLUMNS, seed=77)``, with attributes in
    ``attrs``) and 10,000 deletes of seeded live ids."""
    from repro_torch.data.vectors import PAPER_COLUMNS, make_database
    from repro_torch.ingest import DeleteBatch, InsertBatch, MutableTable
    table = MutableTable(db)
    fresh = make_database(CHURN_ROWS, PAPER_COLUMNS, seed=77)
    _, new_ids = table.apply(InsertBatch(fresh.columns))
    rng = np.random.default_rng(78)
    attrs.put(new_ids, {"category": [f"cat{c}" for c in rng.integers(0, 8, CHURN_ROWS)],
                        "score": rng.random(CHURN_ROWS).astype(np.float32),
                        "source": [f"src{s}" for s in rng.integers(0, 4, CHURN_ROWS)]})
    table.apply(DeleteBatch(rng.choice(table.live_ids(), size=CHURN_ROWS, replace=False)))
    return table


def phase_mutation_path(main: dict, filt: dict, dev) -> dict:
    """Mutated serving: the main path's table after ``churned_table``'s
    10,000 inserts and 10,000 deletes; flat plans, the MINT plans and the
    filtered workload are served over base + delta; then the table is
    compacted (``Compactor``, ``swap_store``, ``rebase``) and the flat plans
    served again."""
    from dataclasses import replace
    from repro_torch.core.types import QueryPlan
    from repro_torch.ingest import CompactionPolicy, Compactor, MutationView
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.compiler import compile_batch
    db, wl, r, two = main["db"], main["workload"], main["path"], main["two"]
    eng, attrs, planner = r["engine"], filt["attrs"], filt["planner"]
    t_phase = t0 = time.perf_counter()
    table = churned_table(db, attrs)
    check(CompactionPolicy().should_compact(table) is None,
          f"{CHURN_ROWS} rows of churn each way should stay under the compaction policy")
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
# the arrivals run by default, cut to make room for sharded_train_path (to
# 64) and then for sharded_serve_path, scan_sweep and dryrun (to 48); the
# tenant path's DRR-vs-FIFO check needs its 96 arrivals, this phase's
# checks hold at 48 (a CPU rehearsal at 4,000 rows fails the same
# CPU-only launch checks at 48 as at 64, and nothing else)
ONLINE_QUERIES_CUT = 48
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
    """The online runtime over the main path's tuned database:
    sync vs async flush (staged and unstaged) on a real worker pool, the
    semantic cache (exact re-arrivals hit), the observer, an
    ``IngestRuntime`` with ~CHURN_ROWS of churn each way and a forced async compaction,
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
        emit("scale_cut", online_queries=queries, online_queries_default=ONLINE_QUERIES,
             why="room for the sharded training and serving, scan sweep and dry-run "
                 "phases in the time limit")
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

    # 4. IngestRuntime: ~CHURN_ROWS inserts and deletes, one forced async compaction.
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
    """Three tenants over the main path's tuned database and
    its tuned result (no re-tune), each serving a third of the bisimple
    queries, with CHURN_ROWS inserts and deletes on t2: ungoverned (a), governed
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

AUTOTUNE_ROWS_UNCUT = 100_000  # cut from the paper's 1,000,000: each trial replays the
AUTOTUNE_BUDGET_S = 120.0  # whole trace and scores recall against the host oracle
AUTOTUNE_ROWS = 10_000  # cut again to make room for sharded_ssm_path (printed)
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
    emit("scale_cut", autotune_rows=rows, autotune_rows_uncut=AUTOTUNE_ROWS_UNCUT,
         paper_rows=1_000_000,
         why="every trial replays its trace and scores recall against the host oracle; "
             "cut from 100,000 to make room for sharded_ssm_path in the time limit")
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


# ---- serving over a row-sharded mesh on the card ------------------------------------

MESH_SHARDS = 4       # make_debug_mesh(4, 1): the card repeated over four data ranks
MESH_BUDGET_S = 60.0  # the phase's share of the script's time limit
RERANK_CANDIDATES = 200_000


def phase_mesh_path(main: dict, dev) -> dict:
    """The main path's tuned database served over a 4-shard
    row mesh on the card (``make_debug_mesh(4, 1)``), against the
    single-device engine over the same store: (a) the MINT and PerColumn
    plans, (b) a 64-query flat burst, (c) flat and keep-masked flat scans
    over 10,000 inserts and 10,000 deletes, (d) ``distributed_rerank``,
    (e) the search dry-run on the meta mesh."""
    from dataclasses import replace
    from repro_torch.core.types import QueryPlan
    from repro_torch.data.vectors import make_queries
    from repro_torch.filter import synth_attributes
    from repro_torch.ingest import MutationView
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.launch import search_dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.search.distributed import distributed_rerank, make_search_step
    from repro_torch.serve.columnstore import ColumnStore
    from repro_torch.serve.compiler import compile_batch
    from repro_torch.serve.engine import BatchEngine
    t_phase = time.perf_counter()
    db, wl, r = main["db"], main["workload"], main["path"]
    col, qmat, k = main["col"], main["qmat"], main["k"]
    mesh = make_debug_mesh(MESH_SHARDS, 1)
    mcs = ColumnStore(db, mesh=mesh)
    # the main store's host concatenations, shared: no second host copy of
    # the columns (the mesh store pads and uploads its own device shards)
    mcs._host = main["cstore"]._host
    mesh_eng = BatchEngine(db, store=r["store"], cstore=mcs)
    one = BatchEngine(db, store=r["store"], cstore=main["cstore"])
    steps, out = {}, {}
    # the mesh's own launches: the sum, over every mesh call below, of the
    # launches between reading the counts just before it and just after;
    # the single-device runs it is compared with stay outside the sum
    counts = dict.fromkeys(MINT_KERNELS, 0)

    def on_mesh(fn, *args):
        """``fn(*args)`` (a mesh call) -> (its result, its launches), which
        are added to ``counts``."""
        before = launch_counts()
        res = fn(*args)
        after = launch_counts()
        d = {n: after[n] - before[n] for n in MINT_KERNELS}
        for n, c in d.items():
            counts[n] += c
        return res, d

    def on_one(fn, *args):
        """``fn(*args)`` (a single-device call) -> (its result, its launches)."""
        before = launch_counts()
        res = fn(*args)
        return res, {n: launch_counts()[n] - before[n] for n in MINT_KERNELS}

    reset_launch_counts()

    # (a) the tuned plans: ids, numDist, costs and counters equal; each flat
    #     scan that is one launch on one device is one launch a shard
    t0 = time.perf_counter()
    for label, res in (("mint", r["result"]), ("per_column", r["pc"])):
        t1 = time.perf_counter()
        m, md = on_mesh(mesh_eng.execute_workload, wl, res, r["gt"])
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        o, od = on_one(one.execute_workload, wl, res, r["gt"])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        for a, b in zip(m.per_query, o.per_query):
            check(np.array_equal(np.asarray(a.ids), np.asarray(b.ids)),
                  f"mesh {label}: q{a.qid} ids differ from the single-device engine")
            check((a.num_dist, a.cost) == (b.num_dist, b.cost),
                  f"mesh {label}: q{a.qid} numDist / cost differ")
        check(md == dict(od, streaming_fused_scan=MESH_SHARDS * od["streaming_fused_scan"]),
              f"mesh {label}: launches {md} (mesh), {od} (one device)")
        out[label] = dict(mesh_serve_s=mesh_s, single_serve_s=one_s,
                          weighted_cost=m.weighted_cost, mean_recall=m.mean_recall,
                          mesh_launches=md, single_launches=od)
    check(mesh_eng.counters.as_dict() == one.counters.as_dict(),
          f"mesh counters {mesh_eng.counters.as_dict()} vs {one.counters.as_dict()}")
    check(counts["streaming_fused_scan"] > 0, "the tuned plans made no flat scan on the mesh")
    out["tuned_counters"] = mesh_eng.counters.as_dict()
    steps["tuned_plans"] = time.perf_counter() - t0

    # (b) a flat burst: one dispatch, four shard launches, the single-device
    #     scan's values bit for bit
    t0 = time.perf_counter()
    mflat = BatchEngine(db, store=None, cstore=mcs)
    oflat = BatchEngine(db, store=None, cstore=main["cstore"])
    burst = make_queries(db, [col.vid] * 64, k=k, seed=7)
    pairs = [(bq, QueryPlan(bq.qid, [], [], 0.0, 1.0)) for bq in burst]
    check(len(compile_batch(pairs)) == 1, "the mesh burst did not compile to one group")
    got, d = on_mesh(mflat.search_batch, pairs)
    shard_launches = d["streaming_fused_scan"]
    check(mflat.counters.scan == 1 and shard_launches == MESH_SHARDS,
          f"mesh burst: {mflat.counters.scan} dispatches, {shard_launches} scan launches")
    for a, b in zip(got, oflat.search_batch(pairs)):
        check(np.array_equal(a, b), "mesh burst: ids differ from the single-device engine")
    mcol = mcs.device(col.vid)
    step = make_search_step(mesh, k, valid_n=col.n_rows)
    (vals, ids), d = on_mesh(step, mcol.shards, qmat)
    check(d["streaming_fused_scan"] == MESH_SHARDS,
          f"the mesh step made {d['streaming_fused_scan']} scan launches")
    v1, i1 = streaming_fused_scan(qmat, col.data, k=k, valid_n=col.n_rows)
    check(torch.equal(vals, v1), "mesh step values differ from the single-device scan")
    ties = int((v1[:, 1:] == v1[:, :-1]).sum())
    diff = (ids != i1).nonzero().tolist()
    check(all(bool((v1[b] == v1[b, j]).sum() > 1) for b, j in diff),
          f"mesh step ids differ outside exact ties at {diff[:8]}")
    out["burst"] = dict(batch=64, shape=[64, col.n_rows, col.padded_dim, k],
                        dispatches=mflat.counters.scan, scan_launches=shard_launches,
                        values_bit_equal=True, exact_ties=ties, ids_differing_at_ties=diff[:16],
                        shard_rows=[int(x.shape[0]) for x in mcol.shards])
    steps["flat_burst"] = time.perf_counter() - t0

    # (c) filtered and mutated flat scans: the masks ride the step's bad
    #     operand, base and delta are two dispatches a (group, index), each
    #     one launch a shard
    t0 = time.perf_counter()
    attrs = synth_attributes(db.n_rows, seed=0, device=dev)
    pred = quantile_pred(attrs, db.n_rows, 0.1)
    table = churned_table(db, attrs)
    mv = MutationView(table, device=dev)
    for e in (mflat, oflat):
        e.attach_mutations(mv)
        e.attach_filters(attrs)
    qs = wl.queries
    cells = {"flat": [(q, QueryPlan(q.qid, [], [], 0.0, 1.0)) for q in qs],
             "masked": [(replace(q, predicate=pred),
                         QueryPlan(q.qid, [], [], 0.0, 1.0, access_path="masked",
                                   selectivity=0.1)) for q in qs]}
    for label, cpairs in cells.items():
        groups = len(compile_batch(cpairs))
        for e in (mflat, oflat):
            e.counters.reset()
        t1 = time.perf_counter()
        got, d = on_mesh(mflat.search_batch, cpairs)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t1
        want = oflat.search_batch(cpairs)
        swaps = sum(same_topk(oflat, q, a, b, f"mesh {label}: q{q.qid}")
                    for (q, _), a, b in zip(cpairs, got, want))
        mc, oc = mflat.counters.as_dict(), oflat.counters.as_dict()
        check(mc["scan"] == mc["delta"] == groups and oc["scan"] == groups
              and oc["delta"] == 0,
              f"mesh {label}: counters {mc} (mesh), {oc} (one device), {groups} groups")
        check(d["streaming_fused_scan"] == MESH_SHARDS * (mc["scan"] + mc["delta"]),
              f"mesh {label}: {d['streaming_fused_scan']} scan launches for "
              f"{mc['scan'] + mc['delta']} dispatches")
        out[f"mutated_{label}"] = dict(groups=groups, mesh_counters=mc, single_counters=oc,
                                       mesh_launches=d, near_tie_swaps=swaps,
                                       mesh_serve_s=mesh_s,
                                       n_match=mflat._filter_state(pred).n_match
                                       if label == "masked" else None)
    for e in (mflat, oflat):
        e.detach_mutations()
        e.detach_filters()
    del table, mv, attrs
    steps["filtered_mutated"] = time.perf_counter() - t0

    # (d) the distributed rerank against the single-device distance kernel
    t0 = time.perf_counter()
    cand = torch.as_tensor(np.unique(np.random.default_rng(9).choice(
        col.n_rows, RERANK_CANDIDATES, replace=False)), device=dev)
    (rv, ri), d = on_mesh(distributed_rerank, mesh, mcol.shards, cand, qmat[0], k)
    rerank_launches = d["batched_scores"]
    s1 = batched_scores(qmat[:1], col.data[cand])[0]
    best = torch.sort(s1, descending=True, stable=True)
    check(torch.equal(rv, best.values[:k]) and torch.equal(ri, cand[best.indices[:k]]),
          "distributed rerank differs from the single-device distance kernel")
    check(rerank_launches == MESH_SHARDS, f"the rerank made {rerank_launches} launches")
    n_local = int(mcol.shards[0].shape[0])
    owned0 = cand[cand < n_local]
    out["rerank"] = dict(candidates=int(cand.shape[0]), k=k, launches=rerank_launches,
                         bit_equal=True, shard0_owned=int(owned0.shape[0]))
    steps["rerank"] = time.perf_counter() - t0
    torch.cuda.synchronize()

    # (e) the dry-run on the production mesh, shapes only
    t0 = time.perf_counter()
    recs = {rec["variant"]: rec for rec in search_dryrun.run(device="meta")}
    tour = recs["tournament_topk"]
    out["dryrun"] = dict(
        rows=tour["rows"], dim=tour["dim"], queries=tour["queries"], k=tour["k"],
        mesh=tour["mesh"],
        naive_bytes=recs["naive_gather_scores"]["collectives"]["total_bytes"],
        tournament_bytes=tour["collectives"]["total_bytes"],
        columnstore_tournament_bytes=recs["columnstore_tournament"]["collectives"]["total_bytes"],
        naive_over_tournament=tour["naive_over_tournament_bytes"],
        predicted_n_local_over_k=tour["predicted_ratio_n_local_over_k"],
        padded_device_bytes=tour["padded_device_bytes"],
        plan_groups=recs["plan_group_compiler"])
    steps["dryrun"] = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    emit("mesh_path", rows=db.n_rows, shards=MESH_SHARDS, mesh=mesh.shape,
         seconds=seconds, budget_s=MESH_BUDGET_S, step_s=steps, launches=counts,
         resident_shard_bytes=mcs.total_device_bytes(), **out)
    return dict(mesh=mesh, shards=mcol.shards, col=col, owned0=owned0, qmat=qmat, k=k,
                counts=counts)


def phase_mesh_kernel_times(mk: dict, peaks) -> list[dict]:
    """The scan at one shard's shape (the burst's 64 queries over rank 0's
    rows) and the distance kernel at the rows rank 0 owns in the rerank,
    each held against its plain version and timed beside its library call
    and bound; the whole 4-shard step (four launches and the merge) timed
    beside the single-device scan of the column. Launches are the mesh
    phase's."""
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import (check_scores, check_topk,
                                            combined_plain_scores, two_pass_scan)
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.search.distributed import make_search_step
    x, q, k = mk["shards"][0], mk["qmat"], mk["k"]
    col = mk["col"]
    step = make_search_step(mk["mesh"], k, valid_n=col.n_rows)
    step_ms = cuda_ms(lambda: step(mk["shards"], q))
    single_ms = cuda_ms(lambda: streaming_fused_scan(q, col.data, k=k, valid_n=col.n_rows))
    (B, d), n = q.shape, x.shape[0]
    kw = dict(valid_n=n)
    vals, ids = streaming_fused_scan(q, x, k=k, **kw)
    rvals, rids = streaming_fused_scan_ref(q, x, k, **kw)
    err, swaps = check_topk(vals, ids, rvals, rids, combined_plain_scores(q, x, "dot", kw),
                            d, "mesh shard scan")
    v2, i2 = two_pass_scan(q, x, k, "dot", kw)
    check(torch.equal(v2, vals) and torch.equal(i2, ids),
          "two-pass scan differs from the streaming scan (mesh shard)")
    ms = cuda_ms(lambda: streaming_fused_scan(q, x, k=k, **kw))
    plain = cuda_ms(lambda: streaming_fused_scan_ref(q, x, k, **kw))
    lib = cuda_ms(lambda: torch.topk(q @ x.T, k, dim=1))
    nbytes, flops = 4 * (B * d + n * d) + 8 * B * k, 2.0 * B * n * d
    rows = [table_row(
        "streaming_fused_scan[mesh_shard]", "cuda", "src/repro_torch/csrc/streaming.cu",
        "src/repro/kernels/streaming/kernel.py:44", mk["counts"]["streaming_fused_scan"],
        err, ms, plain, lib, bound(nbytes, flops, peaks), use="mesh_shard",
        shape=[B, n, d, k], near_tie_swaps=swaps, two_pass_equal=True,
        library="matmul + topk", achieved_gbps=nbytes / ms / 1e6,
        achieved_tflops=flops / ms / 1e9, mesh_step_ms=step_ms,
        single_device_scan_ms=single_ms)]
    q1, sub = q[:1], x[mk["owned0"]]
    m = sub.shape[0]
    err = check_scores(batched_scores(q1, sub), batched_scores_ref(q1, sub), d,
                       "distance at the mesh rerank's owned rows")
    ms = cuda_ms(lambda: batched_scores(q1, sub))
    plain = cuda_ms(lambda: batched_scores_ref(q1, sub))
    lib = cuda_ms(lambda: q1 @ sub.T)
    nbytes, flops = 4 * (d + m * d + m), 2.0 * m * d
    rows.append(table_row(
        "batched_scores[mesh_rerank]", "cuda", "src/repro_torch/csrc/distance.cu",
        "src/repro/kernels/distance/kernel.py:23", mk["counts"]["batched_scores"], err,
        ms, plain, lib, bound(nbytes, flops, peaks), use="mesh_rerank", shape=[1, m, d],
        library="matmul", achieved_gbps=nbytes / ms / 1e6,
        achieved_tflops=flops / ms / 1e9))
    return rows


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


def same_logits(got, want, what: str, near_tie: bool = False) -> dict:
    """Checks two (B, 1, V) logit tensors agree within the JAX suite's
    prefill-vs-decode tolerance with the same top-1 token; returns the
    numbers. With ``near_tie`` a top-1 token may differ where ``want``
    scores ``got``'s pick within the tolerance's atol of its own best (two
    implementations of one function can order such a near tie either way;
    ``kernels/parity.py``'s rule for top-k ids)."""
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          f"{what}: logits not finite")
    diff = (got - want).abs()
    check(bool((diff <= LOGIT_ATOL + LOGIT_RTOL * want.abs()).all()),
          f"{what}: logits differ beyond rtol {LOGIT_RTOL} / atol {LOGIT_ATOL} "
          f"(max abs diff {diff.max().item():.4g})")
    top2 = want.topk(2, dim=-1).values
    pick = got.argmax(-1)
    swapped = pick != want.argmax(-1)
    short = want.amax(-1) - want.gather(-1, pick[..., None])[..., 0]
    check(not bool(swapped.any()) or (near_tie and bool((short[swapped] <= LOGIT_ATOL).all())),
          f"{what}: top-1 tokens differ (the reference's score of the pick is short "
          f"of its best by {short.flatten().tolist()})")
    out = dict(max_abs_diff=diff.max().item(), top1=want.argmax(-1).flatten().tolist(),
               top1_top2_gap=(top2[..., 0] - top2[..., 1]).flatten().tolist())
    if near_tie:
        out["top1_near_tie_swaps"] = int(swapped.sum())
    return out


def window_kind(q, k, causal: bool, window: int) -> str:
    """Gemma-2's calls: a global or a local (sliding-window) layer."""
    from repro_torch.models.model import NO_WINDOW
    return "global" if window >= NO_WINDOW else "local"


def mask_kind(q, k, causal: bool, window: int) -> str:
    """The other families' calls: causal self attention, an encoder's full
    self attention, or cross attention (queries over another sequence)."""
    if causal:
        return "causal"
    return "full" if q.shape[2] == k.shape[2] else "cross"


class FlashCalls:
    """The q / k / v of chosen flash-attention calls on the model path: the
    first call of each kind (``kind(q, k, causal, window)``: by default
    Gemma-2's local and global layers) in the prefill and in the first
    decode step, and the routes each kind ran. It wraps the kernel wrapper
    that the model's attention calls and holds what it is given (nothing is
    copied inside a timed window: later layers and steps leave those tensors
    and cache slots as they are); ``keep`` then makes compact copies in the
    model's (B, S, H, d) layout, once the timer has stopped. What the model
    computes is unchanged. The kernel is then held against its plain
    version and timed at exactly these inputs."""

    def __init__(self, kind=window_kind):
        self.phase = None
        self.kind = kind
        self.noted: dict[str, dict] = {}
        self.routes: dict[str, set] = {}

    def keep(self) -> None:
        for n in self.noted.values():
            if n.pop("held", False):
                for x in "qkv":
                    n[x] = n[x].transpose(1, 2).clone(memory_format=torch.contiguous_format)

    def attach(self):
        """Wraps ``models.attention.flash_attention``; returns an undo."""
        from repro_torch.models import attention as A
        fn = A.flash_attention

        def noted(q, k, v, causal=True, window=0, softcap=0.0, scale=None):
            key = f"{self.phase}_{self.kind(q, k, causal, window)}"
            if self.phase and key not in self.noted:
                self.noted[key] = dict(q=q, k=k, v=v, causal=causal, window=window,
                                       softcap=softcap, held=True)
            out = fn(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)
            if self.phase:
                self.routes.setdefault(key, set()).add(fn.last_route[0])
            return out

        A.flash_attention = noted

        def undo():
            A.flash_attention = fn
        return undo


def decode_profile(step, watch: tuple[str, ...] = ()) -> dict:
    """One call of ``step`` under torch.profiler: its host wall time, the
    device time summed over its kernels (so the device's busy share of the
    step), the kernels that take the most of it, and for each name in
    ``watch`` the time, calls and share of the kernels whose name holds it."""
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
    watched = {}
    for name in watch:
        hits = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        watched[name] = dict(ms=ms, calls=sum(e.count for e in hits), share=ms / device_ms)
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                                  calls=e.count) for e in top], watched=watched)


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
    # one compile a shape: past dynamo's default limit of 8 (the script times
    # nine shapes) it would run the unfused eager version without a word
    torch._dynamo.config.recompile_limit = max(torch._dynamo.config.recompile_limit, 64)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score_mod if softcap > 0 else None,
                      block_mask=block_mask, enable_gqa=True)


def flash_time(n: dict, key: str, peaks, errs: dict, name: str, launches: int) -> dict:
    """The flash kernel at one noted call ``n``: held against its plain
    version in bf16 and again in float32, timed beside the plain version,
    the library call of the same function and an SDPA call that does less
    work, and bounded at the bf16 tensor-core rate; emits the line and
    returns the kernel-table row ``name``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.parity import check_flash
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
    # SDPA does less work (no softcap, no window; top-left aligned, so the
    # one-row decode call is unmasked, which at the cache's end is the same)
    causal = kw["causal"] and Sq > 1
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
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
    rec = dict(name=name, route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:24",
               launches=launches, max_abs_err=max(err, err32), ms=ms, plain_ms=plain,
               bound_ms=b[0], bound_by=b[1], library_ms=library)
    emit("kernel_time", **dict(rec, route=route), splits=splits, call=key,
         shape=[B, Hq, k.shape[1], Sq, Skv, d],
         causal=kw["causal"], window=kw["window"], softcap=kw["softcap"],
         max_abs_err_bf16=err, max_abs_err_f32=err32,
         plain_mean_abs=mag.mean().item(), plain_max_abs=mag.max().item(),
         library="flex_attention (compiled; softcap score_mod, causal + window "
                 "block mask, enable_gqa)", library_max_abs_err=flex_err,
         library_failed=flex_note, library_less_work_ms=sdpa,
         library_less_work=f"sdpa{' causal' if causal else ''}, no softcap",
         kept_pairs=pairs, kept_kv_rows=rows_kv, flops=flops,
         bytes=nbytes, achieved_tflops=flops / ms / 1e9,
         achieved_gbps=nbytes / ms / 1e6,
         bound_fp32_non_tensor_ms=bound(nbytes, flops, peaks)[0])
    return rec


def phase_flash_times(model: dict, peaks, errs: dict) -> list[dict]:
    rows = []
    for key in ("prefill_global", "prefill_local", "decode_global", "decode_local"):
        rec = flash_time(model["noted"][key], key, peaks, errs, "flash_attention",
                         model["launches"])
        if key == "prefill_global":
            rows.append(dict(rec, max_abs_err=errs["flash_attention"]))
    return rows


# ---- the other families at full width: moe, hybrid, ssm, encdec, vlm ---------------

# (config, prompt tokens): PROMPTS prompts each, DECODE_STEPS greedy steps
FAMILY_RUNS = (("granite-moe-3b-a800m", 2048), ("zamba2-1.2b", 2048),
               ("xlstm-350m", 2048),
               ("whisper-medium", 384),  # its decoder holds 448 positions
               ("qwen2-vl-2b", 2048))
MOE_FALLBACK_LEN = 64  # T = 2 x 65 tokens: drop-free by the capacity floor min(T, 128)
# the families' noted flash calls held and timed as kernel-table rows
FAMILY_FLASH_ROWS = (("granite-moe-3b-a800m", "prefill_causal", "granite_prefill"),
                     ("whisper-medium", "prefill_full", "whisper_encoder"),
                     ("whisper-medium", "prefill_cross", "whisper_cross_prefill"),
                     ("whisper-medium", "decode_cross", "whisper_cross_decode"),
                     ("qwen2-vl-2b", "decode_causal", "qwen2_vl_decode"))
FAMILIES_BUDGET_S = 240.0  # the phase's share of the script's time limit, rows included


def family_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """TokenPipeline tokens, S + 1 a prompt (the prompt and one held out),
    and the family's modality input in bf16 from a generator seeded on
    ``device``: whisper's frames (B, cross_len, d_model), the stubbed conv
    front end's output; qwen2-vl's (B, n_vision_tokens, d_model) vision
    embeddings, the stubbed patch encoder's."""
    from repro_torch.data.tokens import TokenPipeline
    batch = {"tokens": TokenPipeline(cfg.vocab_size, B, S + 1, seed=seed).batch_at(0)}
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = {"encdec": (B, cfg.cross_len, cfg.d_model),
             "vlm": (B, cfg.n_vision_tokens, cfg.d_model)}.get(cfg.family)
    if shape:
        key = "frames" if cfg.family == "encdec" else "vision_embeds"
        batch[key] = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    return batch


def prompt_of(batch: dict, S: int, tokens=None) -> dict:
    """The batch with its first S tokens, or with ``tokens``."""
    return dict(batch, tokens=batch["tokens"][:, :S] if tokens is None else tokens)


def cache_len(cfg, S: int) -> int:
    """Positions a prefill of S tokens fills: qwen2-vl's vision prefix first."""
    return S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


ROUTE_TIE = 5e-3  # router probabilities this close: the k-th and (k+1)-th may swap
X_TOL = 0.05      # router inputs of one position agree to this share of their size


class MoeRouting:
    """Each MoE layer's routing while ``phase`` is set: the (T, top_k) experts
    and weights, the k-th minus (k + 1)-th router probability per token, and
    the router inputs of ``rows`` (all rows while ``rows`` is None), kept on
    the card until read. With ``pin`` (one (rows, experts, weights) per layer,
    in call order) those rows take the given routing. Wraps
    ``models.moe._router``; with no pin what the model computes is
    unchanged."""

    def __init__(self, n_experts: int):
        self.n_experts = n_experts
        self.phase = self.rows = self.pin = None
        self.calls: dict[str, list] = {}

    def attach(self):
        from repro_torch.models import moe as MOE
        fn = MOE._router

        def noted(p, x2d, top_k):
            w, e, aux = fn(p, x2d, top_k)
            if self.phase:
                layer = len(self.calls.setdefault(self.phase, []))
                if self.pin is not None:
                    rows, pe, pw = self.pin[layer]
                    e, w = e.clone(), w.clone()
                    e[rows], w[rows] = pe, pw
                top = torch.softmax(x2d.float() @ p["router"].float(), -1).sort(
                    -1, descending=True).values
                x = x2d if self.rows is None else x2d[self.rows]
                self.calls[self.phase].append(dict(
                    experts=e, weights=w, gap=top[:, top_k - 1] - top[:, top_k],
                    x=x.float()))
            return w, e, aux

        MOE._router = noted

        def undo():
            MOE._router = fn
        return undo

    def dropped(self, phase: str, B: int) -> list:
        """Per layer, the (B, S, top_k) pairs ``moe_sorted`` dropped."""
        from repro_torch.models import moe as MOE
        return [MOE.dropped(c["experts"], self.n_experts).reshape(
                    B, -1, c["experts"].shape[1]).cpu()
                for c in self.calls.get(phase, [])]

    def drop_summary(self, phase: str, B: int) -> dict:
        masks = self.dropped(phase, B)
        if not masks:
            return dict(layers=0)
        return dict(layers=len(masks), tokens_per_layer=masks[0].shape[0] * masks[0].shape[1],
                    dropped_pairs_per_layer=[int(m.sum()) for m in masks],
                    dropped_pairs=int(sum(m.sum() for m in masks)),
                    last_position_dropped_per_row=[int(sum(m[b, -1].sum() for m in masks))
                                                   for b in range(B)])

    def divergence(self, dec: str, full: str, B: int) -> list:
        """Per row, where its last position's MoE first stops matching between
        the decode step (``dec``, row b) and the longer prefill (``full``,
        whose ``rows`` were the rows' last positions): the first layer whose
        experts differ or where the prefill dropped one of them, with both
        sides' k-th / (k + 1)-th gaps, and each layer's router-input
        difference up to it (its max share of the input's size)."""
        drops = self.dropped(full, B)
        out = []
        for b in range(B):
            x_rel, first = [], None
            for li, (cd, cf) in enumerate(zip(self.calls[dec], self.calls[full])):
                xd, xf = cd["x"][b], cf["x"][b]
                x_rel.append(((xd - xf).abs().max() / xf.abs().max()).item())
                t = cf["experts"].shape[0] // B * (b + 1) - 1
                dropped = bool(drops[li][b, -1].any())
                same = set(cd["experts"][b].tolist()) == set(cf["experts"][t].tolist())
                if dropped or not same:
                    first = dict(layer=li, kind="dropped" if dropped else "routed",
                                 gap_decode=cd["gap"][b].item(),
                                 gap_prefill=cf["gap"][t].item())
                    break
            out.append(dict(first=first, router_input_rel_diff=x_rel))
        return out


def check_divergence(div: list, what: str) -> None:
    """Each row's first divergence (``MoeRouting.divergence``) must be a drop
    or a near tie, with the router inputs within X_TOL up to it."""
    for b, d in enumerate(div):
        f = d["first"]
        check(max(d["router_input_rel_diff"]) <= X_TOL,
              f"{what}: row {b}'s router inputs differ by "
              f"{max(d['router_input_rel_diff']):.3g} by the first routing change ({f})")
        check(f is None or f["kind"] == "dropped"
              or min(f["gap_decode"], f["gap_prefill"]) < ROUTE_TIE,
              f"{what}: row {b} routed differently away from a near tie ({f})")


def moe_decode_vs_prefill(cfg, routing, first, full, B: int, run_pinned, run_short) -> dict:
    """An MoE model's decode-vs-prefill check. The held-out position's experts
    are a discrete choice: where the longer prefill drops one of them (the
    stable sort drops each expert's latest tokens; a decode step of B tokens
    never drops) or a near tie of the router (the k-th and (k + 1)-th
    probabilities within ROUTE_TIE) falls the other way, decode and prefill
    compute different functions from that layer on, as in the reference.
    Held: the plain check on both rows; else on the rows whose routing never
    diverged; else, on the rows without a drop at the last position, the
    prefill again with that position's routing pinned to the decode step's
    (``run_pinned``: the same function, so the plain tolerance); where every
    row dropped, the same at a MOE_FALLBACK_LEN-token prompt, drop-free by
    the capacity floor (``run_short``: decode, plain prefill and pinned
    prefill; the plain one's divergence is reported and checked too). Every
    row's first divergence must be a drop or a near tie, with the router
    inputs up to it within X_TOL. The fallbacks take the top-1 token up to a
    near tie of the logits (``same_logits(near_tie=True)``): with random
    weights a flip of the routing anywhere upstream is enough to reorder two
    logits that close."""
    what = f"{cfg.name}: decode vs prefill"
    try:
        return dict(held_on="both rows", **same_logits(first, full, what))
    except SmokeFailure as exc:
        failed = str(exc)
    div = routing.divergence("decode", "prefill_s_plus_1", B)
    check_divergence(div, what)
    clean = [b for b, d in enumerate(div) if d["first"] is None]
    if clean:
        return dict(held_on=f"rows {clean}, whose routing never diverged ({failed})",
                    divergence=div,
                    **same_logits(first[clean], full[clean], f"{what}, rows {clean}",
                                  near_tie=True))
    last_drops = routing.dropped("prefill_s_plus_1", B)
    kept = [b for b in range(B) if not any(bool(m[b, -1].any()) for m in last_drops)]
    if kept:
        pinned = run_pinned(kept)
        return dict(held_on=f"rows {kept} with the last position's routing pinned to the "
                            f"decode step's; every row diverged ({failed})",
                    divergence=div,
                    **same_logits(first[kept], pinned[kept], f"{what}, pinned, rows {kept}",
                                  near_tie=True))
    dec, plain, pinned = run_short()
    short_div = routing.divergence("short_decode", "short_prefill", B)
    check_divergence(short_div, f"{what} at {MOE_FALLBACK_LEN} tokens")
    return dict(held_on=f"a {MOE_FALLBACK_LEN}-token prompt with the last position's "
                        f"routing pinned; both rows dropped at full length ({failed})",
                divergence=div,
                unpinned_at_fallback=dict(
                    max_abs_diff=(dec.float() - plain.float()).abs().max().item(),
                    top1_equal=bool(torch.equal(dec.argmax(-1), plain.argmax(-1))),
                    divergence=short_div),
                **same_logits(dec, pinned, f"{what}, pinned, {MOE_FALLBACK_LEN} tokens",
                              near_tie=True))


def run_family(name: str, S: int, dev) -> dict:
    """One family at its published width and depth: random bf16 parameters,
    a timed prefill of PROMPTS x S tokens, the cache grown, DECODE_STEPS
    greedy steps, then a prefill of the prompt and the first greedy token,
    whose logits the first step's must match. Returns the emitted fields
    and the noted flash calls."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.train.step import make_prefill_step, make_serve_step
    cfg = get_arch(name)
    B = PROMPTS
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, n_active = M.param_count(params), M.active_param_count(cfg, params)
    batch = family_batch(cfg, B, S, seed=0, device=dev)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    calls = FlashCalls(kind=mask_kind)
    routing = MoeRouting(cfg.n_experts)  # records nothing for a model without MoE
    undo = [calls.attach(), routing.attach()]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    P = cache_len(cfg, S)

    def last_rows(n):  # the flat token index of each row's last position
        return [b * n + n - 1 for b in range(B)]

    def set_phase(flash=None, moe=None, rows=None):
        calls.phase = flash
        routing.phase, routing.rows = (moe, rows) if cfg.n_experts else (None, None)

    try:
        set_phase("prefill", "prefill", last_rows(S))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, prompt_of(batch, S))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        set_phase()
        calls.keep()
        check(bool(torch.isfinite(logits).all()), f"{name}: prefill logits not finite")
        cache_bytes = sum(t.numel() * t.element_size() for _, t in M._leaves(cache))
        big = M.grow_cache(cache, P + DECODE_STEPS)
        del cache
        tok = logits.argmax(-1)
        first_tok, step_ms, generated = tok, [], []
        set_phase("decode", "decode")
        torch.cuda.synchronize()
        t_window = time.perf_counter()
        for i in range(DECODE_STEPS):
            t0 = time.perf_counter()
            step_logits, big = serve_step(params, big, tok, P + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            set_phase()
            check(bool(torch.isfinite(step_logits).all()),
                  f"{name}: decode step {i} logits not finite")
            if i == 0:
                first_logits = step_logits
            tok = step_logits.argmax(-1)
            generated.append(tok.flatten().tolist())
        decode_window_ms = (time.perf_counter() - t_window) * 1e3
        calls.keep()
        del big
        full_batch = prompt_of(batch, S, np.concatenate(
            [batch["tokens"][:, :S], first_tok.cpu().numpy()], 1))
        set_phase(None, "prefill_s_plus_1", last_rows(S + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full_logits, _ = prefill_step(params, full_batch)
        torch.cuda.synchronize()
        prefill2_s = time.perf_counter() - t0
        set_phase()
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()["flash_attention"]
        route_launches = dict(flash_attention.route_launches)
        if not cfg.n_experts:
            agree = same_logits(first_logits, full_logits, f"{name}: decode vs prefill")
        else:
            def pinned_prefill(rows, n, full, decode_phase, phase):
                """The prefill ``full`` of n tokens a row with the last position
                of ``rows`` routed as in ``decode_phase``'s step."""
                idx = torch.tensor([last_rows(n)[b] for b in rows], device=dev)
                routing.pin = [(idx, c["experts"][rows], c["weights"][rows])
                               for c in routing.calls[decode_phase]]
                set_phase(None, phase, last_rows(n))
                try:
                    out, _ = prefill_step(params, full)
                finally:
                    routing.pin = None
                    set_phase()
                dropped = routing.dropped(phase, B)
                check(not any(bool(m[b, -1].any()) for m in dropped for b in rows),
                      f"{name}: the pinned prefill dropped a pinned expert")
                return out

            def run_short():
                L = MOE_FALLBACK_LEN
                lg, c = prefill_step(params, prompt_of(batch, L))
                t = lg.argmax(-1)
                set_phase(None, "short_decode")
                dec, _ = serve_step(params, M.grow_cache(c, L + 1), t, L)
                full = prompt_of(batch, L, np.concatenate(
                    [batch["tokens"][:, :L], t.cpu().numpy()], 1))
                set_phase(None, "short_prefill", last_rows(L + 1))
                plain, _ = prefill_step(params, full)
                set_phase()
                return dec, plain, pinned_prefill(list(range(B)), L + 1, full,
                                                  "short_decode", "short_pinned")

            agree = moe_decode_vs_prefill(
                cfg, routing, first_logits, full_logits, B,
                lambda rows: pinned_prefill(rows, S + 1, full_batch, "decode", "pinned"),
                run_short)
            drop_stats = {ph: routing.drop_summary(ph, B)
                          for ph in ("prefill", "prefill_s_plus_1")}
    finally:
        for u in undo:
            u()
    n_text = B * S
    n_pos = B * (P + (cfg.cross_len if cfg.family == "encdec" else 0))
    out = dict(model=cfg.name, family=cfg.family, source=cfg.source, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
               head_dim=cfg.hd, vocab=cfg.vocab_size, param_count=n_params,
               active_param_count=n_active, init_s=init_s, prompts=B, prompt_len=S,
               prefill_positions=n_pos, decode_steps=DECODE_STEPS, prefill_s=prefill_s,
               prefill_tokens_per_s=n_text / prefill_s,
               prefill_positions_per_s=n_pos / prefill_s,
               prefill_s_at_len_plus_1=prefill2_s, decode_window_ms=decode_window_ms,
               decode_ms_per_step=decode_window_ms / DECODE_STEPS,
               decode_ms_per_step_median=statistics.median(step_ms),
               decode_tokens_per_s=B * DECODE_STEPS * 1e3 / decode_window_ms,
               first_tokens=first_tok.flatten().tolist(), generated=generated,
               decode_vs_prefill=agree, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
               flash_attention_launches=launches, flash_route_launches=route_launches,
               flash_routes_by_call={k: sorted(v) for k, v in calls.routes.items()},
               noted_calls={key: dict(q=list(n["q"].shape), k=list(n["k"].shape),
                                      causal=n["causal"])
                            for key, n in calls.noted.items()},
               cache_bytes=cache_bytes, max_memory_allocated_bytes=peak)
    if cfg.n_experts:
        out.update(experts=cfg.n_experts, top_k=cfg.moe_top_k, moe_drops=drop_stats,
                   capacity={ph: MOE._capacity(B * n, cfg.n_experts, cfg.moe_top_k, 1.25)
                             for ph, n in (("prefill", S), ("prefill_s_plus_1", S + 1))})
    if cfg.family == "encdec":
        out.update(frames=cfg.cross_len, encoder_layers=cfg.n_enc_layers)
    if cfg.family == "vlm":
        out.update(vision_tokens=cfg.n_vision_tokens)
    del params
    return dict(fields=out, noted=calls.noted, routes=calls.routes, launches=launches,
                route_launches=route_launches)


def phase_families_path(dev) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before the families")
    t_phase = time.perf_counter()
    runs = {}
    for name, S in FAMILY_RUNS:
        t0 = time.perf_counter()
        run = run_family(name, S, dev)
        gc.collect()
        torch.cuda.empty_cache()
        emit("families_path", **run["fields"], seconds=time.perf_counter() - t0,
             allocated_bytes_after=torch.cuda.memory_allocated())
        fam, rl = run["fields"]["family"], run["route_launches"]
        if fam == "ssm":
            check(run["launches"] == 0, f"{name} has no attention, yet flash launched")
        else:
            check(rl["tensor_core"] > 0 and rl["split_kv"] > 0,
                  f"{name}: flash routes {rl}")
        if fam == "encdec":
            check(run["routes"].get("prefill_cross") == {"tensor_core"}
                  and run["routes"].get("decode_cross") == {"split_kv"},
                  f"whisper's cross attention ran routes {run['routes']}")
        runs[name] = dict(noted=run["noted"], launches=run["launches"])
    emit("families_path_done", seconds=time.perf_counter() - t_phase,
         budget_s=FAMILIES_BUDGET_S)
    return runs


def phase_family_flash_times(runs: dict, peaks, errs: dict) -> list[dict]:
    t0 = time.perf_counter()
    rows = []
    for name, key, label in FAMILY_FLASH_ROWS:
        run = runs[name]
        check(key in run["noted"], f"{name}: no noted flash call {key}")
        rows.append(flash_time(run["noted"][key], f"{name}:{key}", peaks, errs,
                               f"flash_attention[{label}]", run["launches"]))
    emit("family_flash_times_done", seconds=time.perf_counter() - t0)
    return rows


def phase_model_cpu_vs_card() -> None:
    """Gemma-2 and the five other families at ``reduced()``: prefill and one
    decode step on the CPU and on the card, logits within the same
    tolerance, the same top-1 tokens."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step, make_serve_step
    B, S = 2, 96  # S > the reduced gemma2's window of 64: local layers mask
    for name in (MODEL,) + tuple(n for n, _ in FAMILY_RUNS):
        cfg = get_arch(name).reduced()
        batch = family_batch(cfg, B, S, seed=0, device="cpu")
        params = M.init_params(cfg, seed=0, device="cpu")
        prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
        P = cache_len(cfg, S)
        out = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            pre, cache = prefill_step(p, prompt_of(batch, S))
            dec, _ = serve_step(p, M.grow_cache(cache, P + 1), batch["tokens"][:, S:], P)
            out[dev] = (pre, dec)
        # the new families' reduced logits may order a near tie either way
        # (flash on the card, dense attention on the CPU); Gemma-2's as before
        tie = name != MODEL
        emit("model_cpu_vs_card", model=cfg.name, family=cfg.family,
             layers=cfg.n_layers, prompts=B, prompt_len=S, rtol=LOGIT_RTOL,
             atol=LOGIT_ATOL,
             prefill=same_logits(out["cuda"][0], out["cpu"][0], f"{name} reduced prefill",
                                 tie),
             decode=same_logits(out["cuda"][1], out["cpu"][1], f"{name} reduced decode",
                                tie))


# ---- training: the flash backward, the step at full width, the loop ---------------

TRAIN_MODEL = "granite-moe-1b-a400m"  # the reference launcher's default arch
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_PEAK_LR = 8, 2048, 8, 1e-3
TRAIN_BUDGET_S = 240.0  # the three training phases' share of the time limit
# kernel vs plain attention on the card, one step's gradients at 2 layers of
# the full width: per-leaf relative L2. The two differ in the rounding of the
# attention output (the flash kernel takes P in bf16 for P.V) and in the
# backward's summation order
TRAIN_GRAD_REL_L2 = 0.05
# one make_train_step of every family's reduced config on the card and the CPU
TRAIN_FAMILIES = ("gemma2-27b", "granite-moe-1b-a400m", "zamba2-1.2b", "xlstm-350m",
                  "whisper-medium", "qwen2-vl-2b")
# tests/test_torch_train_families.py's bounds for the card against the CPU:
# the loss at tests/test_torch_families.py's bf16 rtol / atol; per leaf, 0.05
# relative L2, 0.25 for the MoE's router near ties and xLSTM's recurrent exp
# gates in bf16
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 0.05, 0.1
CPU_CARD_GRAD_REL_L2 = {"moe": 0.25, "ssm": 0.25}


def leaf_names(tree) -> list[str]:
    """The leaves' names in ``train.optimizer.tree_leaves`` order (the
    checkpoint's: ``layers_attn_wq``)."""
    from repro_torch.train.checkpoint import _leaf_paths
    return [name for name, _ in _leaf_paths(tree)]


def rel_l2(got: torch.Tensor, want: torch.Tensor, chunk: int = 1 << 26) -> float:
    """||got - want|| / ||want|| in float64, a chunk of elements at a time
    (a full-width embedding's gradient is 545M elements)."""
    num = den = 0.0
    for a, b in zip(got.reshape(-1).split(chunk), want.reshape(-1).split(chunk)):
        a, b = a.double(), b.double()
        num += float(torch.sum((a - b) ** 2))
        den += float(torch.sum(b * b))
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def phase_flash_bwd_grid(dev, errs: dict) -> None:
    from repro_torch.kernels.flash_attention.kernel import (ROUTES, flash_attention,
                                                            flash_attention_bwd)
    from repro_torch.kernels.parity import FLASH_BWD_CASES, FLASH_DTYPES, check_flash_bwd_case
    t0 = time.perf_counter()
    routes = set()
    for name in sorted(FLASH_BWD_CASES):
        for label, dtype in FLASH_DTYPES.items():
            res = check_flash_bwd_case(name, dtype, dev)
            route = flash_attention.last_route[0]
            bwd_route = flash_attention_bwd.last_route
            routes.add(route)
            check(bwd_route == ("ffma" if dtype == torch.float32 else "tensor_core"),
                  f"flash bwd {name}/{label} took the {bwd_route} route")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], res["max_abs_err"])
            errs["flash_attention"] = max(errs["flash_attention"], res["out_max_abs_err"])
            emit("flash_bwd_grid", case=name, dtype=label, forward_route=route,
                 backward_route=bwd_route, two_calls_bit_equal=True,
                 serving_forward_bit_equal=True, **res)
    check(routes == set(ROUTES), f"the backward grid's forwards ran routes {sorted(routes)}")
    emit("flash_bwd_grid_done", seconds=time.perf_counter() - t0)


def phase_train_path(dev, peaks) -> dict:
    """granite-moe-1b-a400m at full width and depth: TRAIN_STEPS steps of
    make_train_step on TokenPipeline batches of TRAIN_B x TRAIN_S tokens,
    bf16 grads, remat; then every leaf's gradient, a profiled step, and one
    step's gradients at 2 layers against the plain attention on the card."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, batch_at
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import loss_and_grads, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before training")
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_MODEL)
    check(cfg.remat, f"{cfg.name} trains with remat")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    n_params, active = M.param_count(params), M.active_param_count(cfg, params)
    tcfg = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_B, seq_len=TRAIN_S, peak_lr=TRAIN_PEAK_LR,
                       device=str(dev))
    pipeline = TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=tcfg.seed)
    step = make_train_step(cfg, bf16_grads=True, peak_lr=TRAIN_PEAK_LR, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    emit("train_init", model=cfg.name, source=cfg.source, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
         experts=cfg.n_experts, top_k=cfg.moe_top_k, vocab=cfg.vocab_size,
         param_count=n_params, active_param_count=active, batch=TRAIN_B, seq_len=TRAIN_S,
         bf16_grads=True, remat=cfg.remat, peak_lr=TRAIN_PEAK_LR,
         seconds=time.perf_counter() - t0)
    losses, gnorms, lrs, step_ms = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = batch_at(cfg, tcfg, pipeline, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        lrs.append(float(m["lr"]))
        emit("train_step", step=i, loss=losses[-1], gnorm=gnorms[-1], lr=lrs[-1],
             ms=step_ms[-1])
    counts = launch_counts()
    fwd_routes = dict(flash_attention.route_launches)
    bwd_routes = dict(flash_attention_bwd.route_launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + gnorms), f"losses {losses}, gnorms {gnorms}")
    check(lrs[0] == 0.0 and all(x > 0 for x in lrs[1:]), f"lrs {lrs}")
    check(losses[-1] < losses[1], f"the loss did not fall: {losses}")
    L = cfg.n_layers
    check(counts["flash_attention"] == 2 * L * TRAIN_STEPS,
          f"{counts['flash_attention']} flash forward launches in {TRAIN_STEPS} steps "
          f"(remat: 2 x {L} a step)")
    check(counts["flash_attention_bwd"] == L * TRAIN_STEPS,
          f"{counts['flash_attention_bwd']} flash backward launches in {TRAIN_STEPS} steps")
    check(bwd_routes["tensor_core"] == L * TRAIN_STEPS,
          f"flash backward routes in {TRAIN_STEPS} steps: {bwd_routes}")
    # every leaf's gradient at the trained params, on the next batch
    batch = batch_at(cfg, tcfg, pipeline, TRAIN_STEPS, dev)
    _, grads = loss_and_grads(cfg, params, batch)
    names = leaf_names(params)
    for name, g in zip(names, grads):
        check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
              f"gradient of {name} is not finite or all zero")
    per_layer = {}
    for w in ("wq", "wk", "wv", "wo"):
        g = grads[names.index(f"layers_attn_{w}")]
        norms = [g[i].float().norm().item() for i in range(L)]
        check(all(math.isfinite(x) and x > 0 for x in norms),
              f"layer gradients of {w}: {norms}")
        per_layer[w] = norms
    del grads
    profile = decode_profile(lambda: step(params, opt, batch), watch=("flash_bwd",))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    tokens = TRAIN_B * TRAIN_S
    steady_ms = statistics.median(step_ms[1:])
    attn_flops = 3 * 4.0 * TRAIN_B * cfg.n_heads * cfg.hd * kept_pairs(TRAIN_S, TRAIN_S, True, 0) * L
    flops = 6.0 * active * tokens + attn_flops
    fields = dict(model=cfg.name, steps=TRAIN_STEPS, losses=losses, gnorms=gnorms, lrs=lrs,
                  step_ms=step_ms, steady_step_ms=steady_ms,
                  tokens_per_s=tokens / (steady_ms / 1e3), flops_per_step=flops,
                  bf16_peak_share=flops / (steady_ms / 1e3) / peaks["bf16"],
                  flash_forward_launches=counts["flash_attention"],
                  flash_backward_launches=counts["flash_attention_bwd"],
                  flash_forward_routes=fwd_routes, flash_backward_routes=bwd_routes,
                  max_memory_allocated_bytes=peak, attn_grad_norms_by_layer=per_layer,
                  train_step_profile=profile)

    # 2 layers of the same width: one step's loss and gradients with the
    # kernels against the same with the plain attention (dense, autograd)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = M.init_params(cfg2, seed=1, device=dev)
    batch = batch_at(cfg2, tcfg, pipeline, 0, dev)
    loss_k, g_k = loss_and_grads(cfg2, p2, batch)
    flash = A.attention
    A.attention = A.dense_attention
    try:
        loss_p, g_p = loss_and_grads(cfg2, p2, batch)
    finally:
        A.attention = flash
    errs2 = {}
    for name, a, b in zip(leaf_names(p2), g_k, g_p):
        errs2[name] = rel_l2(a, b)
        check(errs2[name] <= TRAIN_GRAD_REL_L2, f"2-layer {name}: kernel vs plain attention "
              f"gradient rel L2 {errs2[name]:.3g} > {TRAIN_GRAD_REL_L2}")
    check(abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_ATOL
          + TRAIN_LOSS_RTOL * abs(loss_p.item()),
          f"2-layer loss {loss_k.item()} vs plain attention {loss_p.item()}")
    del p2, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_path", **fields, two_layer=dict(loss_kernel=loss_k.item(),
                                                  loss_plain=loss_p.item(),
                                                  grad_rel_l2=errs2,
                                                  bound=TRAIN_GRAD_REL_L2),
         seconds=time.perf_counter() - t_phase)
    return dict(fields, bwd_launches=counts["flash_attention_bwd"])


def phase_train_kernel_time(train: dict, dev, peaks, errs: dict) -> list[dict]:
    """The backward kernel at the training path's attention call (granite:
    q (8, 16, 2048, 64) in the model's strided layout, kv 8 heads, causal,
    bf16): held against its plain version, timed beside it, beside the
    backward of one SDPA call of the same function, and bounded."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.parity import check_flash_bwd, check_grad
    cfg = get_arch(TRAIN_MODEL)
    B, S, Hq, Hkv, d = TRAIN_B, TRAIN_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(0)

    def heads(h):  # the model's (B, S, H, d) tensor seen as (B, H, S, d)
        return torch.randn((B, S, h, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = heads(Hq), heads(Hkv), heads(Hkv)
    dout = torch.randn((B, Hq, S, d), generator=gen, device=dev, dtype=torch.bfloat16)
    res = check_flash_bwd(q, k, v, dout, dict(causal=True, window=0, softcap=0.0),
                          "flash bwd at the granite training call")
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], res["max_abs_err"])
    out, lse = flash_attention_lse(q, k, v)
    bwd_route = flash_attention_bwd.last_route
    check(bwd_route == "tensor_core", f"the training call's backward took {bwd_route}")
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout))
    plain = cuda_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout), reps=3, warmup=1)
    # the library yardstick: the backward of one SDPA call (GQA, causal; the
    # call has no window or softcap, so SDPA computes the same function),
    # held to the plain gradients like the kernel
    try:
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        lib_grads = torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True)
        want = attention_bwd_ref(q, k, v, out, lse, dout)
        lib_err = max(check_grad(a, b, torch.bfloat16, "sdpa backward")
                      for a, b in zip(lib_grads, want))
        del want, lib_grads
        library = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dout,
                                                      retain_graph=True))
        lib_note = None
    except Exception as exc:  # reported in the line; the port does not use it
        library, lib_err, lib_note = None, None, f"{type(exc).__name__}: {exc}"[:300]
    pairs = kept_pairs(S, S, True, 0)
    fwd_flops = 4.0 * B * Hq * d * pairs
    # q, k, v, out, dout and lse read once; dq, dk, dv written once
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel()
                  + dout.numel()) + 4 * lse.numel()
    b = bound(nbytes, 2.5 * fwd_flops, peaks, rate="bf16")
    steps = train["steps"]
    return [table_row("flash_attention_bwd", "cuda", "src/repro_torch/csrc/flash_bwd_tc.cu",
                      "src/repro/models/attention.py:133", train["bwd_launches"],
                      errs["flash_attention_bwd"], ms, plain, library, b,
                      shape=[B, Hq, Hkv, S, S, d], call="granite training (causal, bf16)",
                      backward_route=bwd_route,
                      pre_pass_and_ffma_route_source="src/repro_torch/csrc/flash_bwd.cu",
                      launches_per_step=train["bwd_launches"] // steps,
                      max_abs_err_at_call=res["max_abs_err"], grad_max_abs=res["grad_max_abs"],
                      replaces_note="no TPU kernel: the reference differentiates "
                                    "dense_attention through XLA (jax.vjp)",
                      library="sdpa backward (enable_gqa, is_causal)",
                      library_max_abs_err=lib_err, library_failed=lib_note,
                      kept_pairs=pairs, flops_bound=2.5 * fwd_flops, bytes=nbytes,
                      achieved_tflops_bound_flops=2.5 * fwd_flops / ms / 1e9)]


# ---- sharded training: granite on a (2, 4) debug mesh of the card ----------------

SHARD_MESH, SHARD_MESH_AFTER = (2, 4), (4, 2)  # (data, model); the elastic reshard
SHARD_STEPS = 3
SHARD_BUDGET_S = 120.0  # the phase's share of the script's time limit, rows included
# the sharded loss against one device's at step 0 (the psums re-round bf16
# partial sums)
SHARD_LOSS_RTOL = 1e-2
SHARD_F32_GRAD_REL_L2 = 1e-4  # tests/test_torch_tp_train.py's float32 bounds
SHARD_F32_LOSS_RTOL = 1e-5


class PinnedRoutes:
    """The MoE's routing, recorded in one run and replayed in another (the
    unsharded step's expert choices in the sharded step): in bf16 the
    tensor-parallel psums round the router's input differently from one
    device's (~1e-3 relative), and a token whose k-th and (k + 1)-th experts
    are that close changes experts, which moves every gradient downstream by
    more than the rounding itself. Replayed, the sharded step routes each
    token as the unsharded one did (its weights are its own probabilities
    of those experts), and ``flips`` counts the tokens whose own choice
    differed. Calls are matched in order: each recorded call is replayed as
    ``n_split`` calls, one per data rank, over consecutive token rows. With
    ``pin=False`` a replay only counts the flips and keeps each call's own
    routes."""

    def __init__(self, pin: bool = True):
        self.calls, self.flips, self.replay, self.n_split, self.at = [], [], False, 1, 0
        self.pin = pin

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._mod, self._orig = MOE, MOE._route
        MOE._route = self._route
        return self

    def __exit__(self, *exc):
        self._mod._route = self._orig
        return False

    def _route(self, router, x, k):
        w, e, probs = self._orig(router, x, k)
        if not self.replay:
            self.calls.append(e)
            return w, e, probs
        j, self.at = self.at, self.at + 1
        T = x.shape[0]
        pinned = self.calls[j // self.n_split][(j % self.n_split) * T:][:T].to(e.device)
        self.flips.append(int((e.sort(dim=1).values != pinned.sort(dim=1).values)
                              .any(dim=1).sum()))
        if not self.pin:
            return w, e, probs
        pw = probs.gather(1, pinned)
        return pw / pw.sum(-1, keepdim=True).clamp(min=1e-9), pinned, probs


def log_of(mesh) -> dict:
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(mesh.log.items())}


def phase_sharded_train_path(dev, peaks) -> dict:
    """granite-moe-1b-a400m at full width and depth on ``make_debug_mesh(2,
    4)`` of the card, tp mode with ZeRO-1 moments: SHARD_STEPS sharded steps
    of train_path's seeded f32 master params and 8 x 2,048-token batches
    (each of the 8 ranks runs the flash kernels on its 4 q heads and 2 kv
    heads, both ways), step 0 twice (bit-equal), its loss against one
    device's; then an elastic reshard onto (4, 2) and one step there; and
    at 2 layers of the full width every gradient of the sharded step against
    the unsharded one."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.elastic import check_mesh_fits, reshard_tree
    from repro_torch.distributed.sharding import gather_tree, param_shardings, shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, batch_at
    from repro_torch.train.optimizer import tree_leaves, zero1_shardings
    from repro_torch.train.step import (cast_tree, full_grads, loss_and_grads,
                                        make_sharded_train_step, sharded_adamw_init,
                                        sharded_loss_and_grads)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before sharded training")
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_MODEL)
    L = cfg.n_layers
    tcfg = TrainConfig(steps=SHARD_STEPS, batch=TRAIN_B, seq_len=TRAIN_S,
                       peak_lr=TRAIN_PEAK_LR, device=str(dev))
    pipeline = TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=tcfg.seed)
    params = M.init_params(cfg, seed=0, device=dev)  # train_path's master params
    mesh = make_debug_mesh(*SHARD_MESH)
    check(check_mesh_fits(params, mesh) == [], f"{cfg.name} does not fit {SHARD_MESH}")
    psh = param_shardings(params, mesh)
    placed = shard_tree(params, psh)
    msh = zero1_shardings(psh, params, mesh)
    n_dp, n_tp = SHARD_MESH
    batch0 = batch_at(cfg, tcfg, pipeline, 0, dev)
    with torch.no_grad():
        one_loss = float(M.train_loss(cfg, cast_tree(params, torch.bfloat16), batch0))
    del params
    gc.collect()
    step = make_sharded_train_step(cfg, bf16_grads=True, peak_lr=TRAIN_PEAK_LR,
                                   total_steps=SHARD_STEPS + 1)
    st0 = sharded_adamw_init(placed, msh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms, logs = [], [], [], []
    reset_launch_counts()
    for i in range(SHARD_STEPS):
        batch = batch0 if i == 0 else batch_at(cfg, tcfg, pipeline, i, dev)
        mesh.log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, new_st, m = step(placed, st0, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logs.append(log_of(mesh))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        emit("sharded_train_step", step=i, mesh=list(SHARD_MESH), loss=losses[-1],
             gnorm=gnorms[-1], lr=float(m["lr"]), ms=step_ms[-1], collectives=logs[-1])
        if i == 0:
            counted = launch_counts()
            routes = dict(flash_attention_bwd.route_launches)
            # the repeat of step 0, from the same params, state and batch
            again_p, again_st, again_m = step(placed, st0, batch)
            check(float(again_m["loss"]) == losses[0] and float(again_m["gnorm"]) == gnorms[0],
                  "a repeat of sharded step 0 gave another loss or gnorm")
            for tree_a, tree_b in ((new_p, again_p), (new_st.m, again_st.m),
                                   (new_st.v, again_st.v)):
                for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
                    check(all(torch.equal(x, y) for (_, x), (_, y) in
                              zip(a.distinct(), b.distinct())),
                          "a repeat of sharded step 0 gave other bits")
            del again_p, again_st
            reset_launch_counts()  # the repeat is a check: its launches are not counted
        placed, st0 = new_p, new_st
        del new_p, new_st
    counts = {k: v + counted[k] for k, v in launch_counts().items()}
    bwd_routes = {k: v + routes.get(k, 0)
                  for k, v in flash_attention_bwd.route_launches.items()}
    peak = torch.cuda.max_memory_allocated()
    ranks = n_dp * n_tp
    check(all(math.isfinite(x) for x in losses + gnorms), f"losses {losses}, gnorms {gnorms}")
    rel0 = abs(losses[0] - one_loss) / abs(one_loss)
    check(rel0 <= SHARD_LOSS_RTOL, f"sharded step-0 loss {losses[0]} vs one device's "
          f"{one_loss}: rel {rel0:.3g} > {SHARD_LOSS_RTOL}")
    check(counts["flash_attention"] == 2 * L * ranks * SHARD_STEPS,
          f"{counts['flash_attention']} flash forward launches in {SHARD_STEPS} sharded "
          f"steps (remat: 2 x {L} layers x {ranks} ranks a step)")
    check(counts["flash_attention_bwd"] == L * ranks * SHARD_STEPS,
          f"{counts['flash_attention_bwd']} flash backward launches in {SHARD_STEPS} steps")
    check(bwd_routes.get("tensor_core", 0) >= L * ranks * SHARD_STEPS,
          f"flash backward routes: {bwd_routes}")

    # elastic: the trained state gathered and laid out on (4, 2), one step there
    t0 = time.perf_counter()
    mesh2 = make_debug_mesh(*SHARD_MESH_AFTER)
    full = gather_tree(placed)
    placed2 = reshard_tree(full, mesh2)
    msh2 = zero1_shardings(param_shardings(full, mesh2), full, mesh2)
    st2 = st0._replace(m=shard_tree(gather_tree(st0.m), msh2),
                       v=shard_tree(gather_tree(st0.v), msh2))
    del placed, st0
    batch3 = batch_at(cfg, tcfg, pipeline, SHARD_STEPS, dev)
    with torch.no_grad():
        one3 = float(M.train_loss(cfg, cast_tree(full, torch.bfloat16), batch3))
    del full
    gc.collect()
    reshard_s = time.perf_counter() - t0
    mesh2.log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m2 = step(placed2, st2, batch3)
    torch.cuda.synchronize()
    after_ms = (time.perf_counter() - t0) * 1e3
    loss_after = float(m2["loss"])
    rel3 = abs(loss_after - one3) / abs(one3)
    check(math.isfinite(loss_after) and rel3 <= SHARD_LOSS_RTOL,
          f"after the reshard onto {SHARD_MESH_AFTER}: loss {loss_after} vs one device's "
          f"{one3}")
    emit("sharded_reshard", mesh=list(SHARD_MESH_AFTER), reshard_s=reshard_s,
         loss=loss_after, one_device_loss=one3, rel=rel3, ms=after_ms,
         collectives=log_of(mesh2))
    del placed2, st2, m2
    gc.collect()
    torch.cuda.empty_cache()

    # 2 layers of the full width: every gradient of the sharded step against
    # the unsharded step's. First on the unsharded bf16 step's routes
    # (replayed): in float32 activations (the flash kernels' fp32 routes) the
    # two compute one function, held to SHARD_F32_GRAD_REL_L2 for every leaf;
    # in bf16 (the step's own setting, the tensor-core routes) every leaf but
    # the embedding is held to TRAIN_GRAD_REL_L2. The embedding's bf16
    # gradient is not one function: its index backward accumulates thousands
    # of repeated tokens in bf16 (~0.3 off its float32 value on one device),
    # and the data split groups those sums otherwise; it is held through the
    # float32 comparison. Then in float32 on each side's own routes (the
    # sharded path's global routing and capacity): the loss to
    # SHARD_F32_LOSS_RTOL and, where no token's own routes differ between
    # the two, every gradient to SHARD_F32_GRAD_REL_L2.
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = M.init_params(cfg2, seed=1, device=dev)
    b2 = batch_at(cfg2, tcfg, pipeline, 0, dev)
    mesh3 = make_debug_mesh(*SHARD_MESH)
    placed3 = shard_tree(p2, param_shardings(p2, mesh3))
    names = leaf_names(p2)
    runs2, flips = {}, {}

    def grads_of(key, sharded, act, pins):
        pins.at, pins.n_split = 0, (n_dp if sharded else 1)
        M.ACT_DTYPE = act
        try:
            bf16 = act == torch.bfloat16
            if sharded:
                loss, leaf_tree, grads = sharded_loss_and_grads(cfg2, placed3, b2,
                                                                bf16_grads=bf16)
                g = tree_leaves(full_grads(placed3, leaf_tree, grads))
            else:
                loss, g = loss_and_grads(cfg2, p2, b2, bf16_grads=bf16)
                g = [x.float() for x in g]
        finally:
            M.ACT_DTYPE = torch.bfloat16
        runs2[key] = (float(loss), g)
        if pins.replay:
            check(pins.at == pins.n_split * len(pins.calls),
                  f"{key}: {pins.at} routings replayed {len(pins.calls)} recorded ones")
            flips[key] = sum(pins.flips)
            pins.flips.clear()

    with PinnedRoutes() as pins:
        grads_of("u", False, torch.bfloat16, pins)
        pins.replay = True
        for key, sharded, act in (("s", True, torch.bfloat16), ("u32", False, torch.float32),
                                  ("s32", True, torch.float32)):
            grads_of(key, sharded, act, pins)
    with PinnedRoutes(pin=False) as own:
        grads_of("u32_own", False, torch.float32, own)
        own.replay = True
        grads_of("s32_own", True, torch.float32, own)
    g_u, g_s, g_u32, g_s32 = (runs2[k][1] for k in ("u", "s", "u32", "s32"))
    f32_errs = {n: rel_l2(a, b) for n, a, b in zip(names, g_s32, g_u32)}
    bf16_raw = {n: rel_l2(a, b) for n, a, b in zip(names, g_s, g_u)}
    to_f32 = {n: (rel_l2(a, c), rel_l2(b, c)) for n, a, b, c in zip(names, g_s, g_u, g_u32)}
    own_errs = {n: rel_l2(a, b) for n, a, b in
                zip(names, runs2["s32_own"][1], runs2["u32_own"][1])}
    (l_u, _), (l_s, _) = runs2["u32_own"], runs2["s32_own"]
    own_loss_rel = abs(l_s - l_u) / abs(l_u)
    for n in names:
        check(f32_errs[n] <= SHARD_F32_GRAD_REL_L2, f"2-layer {n} in float32: sharded vs "
              f"unsharded gradient rel L2 {f32_errs[n]:.3g} > {SHARD_F32_GRAD_REL_L2}")
        if n != "embed":
            check(bf16_raw[n] <= TRAIN_GRAD_REL_L2, f"2-layer {n} in bf16: sharded vs "
                  f"unsharded gradient rel L2 {bf16_raw[n]:.3g} > {TRAIN_GRAD_REL_L2}")
        if flips["s32_own"] == 0:
            check(own_errs[n] <= SHARD_F32_GRAD_REL_L2, f"2-layer {n} in float32 on its "
                  f"own routes: sharded vs unsharded gradient rel L2 {own_errs[n]:.3g} > "
                  f"{SHARD_F32_GRAD_REL_L2}")
    check(own_loss_rel <= SHARD_F32_LOSS_RTOL, f"2-layer float32 loss on its own routes: "
          f"sharded {l_s} vs unsharded {l_u}, rel {own_loss_rel:.3g}")
    del p2, placed3, runs2, g_u, g_s, g_u32, g_s32
    gc.collect()
    torch.cuda.empty_cache()
    tokens = TRAIN_B * TRAIN_S
    steady = statistics.median(step_ms[1:])
    fields = dict(model=cfg.name, mesh=list(SHARD_MESH), mode="tp", zero1=True,
                  steps=SHARD_STEPS, losses=losses, gnorms=gnorms, step_ms=step_ms,
                  steady_step_ms=steady, tokens_per_s=tokens / (steady / 1e3),
                  one_device_step0_loss=one_loss, step0_rel=rel0, repeat_bit_equal=True,
                  flash_forward_launches=counts["flash_attention"],
                  flash_backward_launches=counts["flash_attention_bwd"],
                  flash_forward_launches_per_step=counts["flash_attention"] // SHARD_STEPS,
                  flash_backward_launches_per_step=counts["flash_attention_bwd"] // SHARD_STEPS,
                  flash_backward_routes=bwd_routes, collectives_per_step=logs[-1],
                  max_memory_allocated_bytes=peak,
                  two_layer=dict(
                      routes="the unsharded bf16 step's, replayed",
                      tokens_routed_otherwise=flips, f32_grad_rel_l2=f32_errs,
                      f32_bound=SHARD_F32_GRAD_REL_L2,
                      bf16_sharded_vs_unsharded_grad_rel_l2=bf16_raw,
                      bf16_to_f32_grad_rel_l2_sharded_unsharded=to_f32,
                      bf16_bound=TRAIN_GRAD_REL_L2, bf16_bound_skips="embed",
                      own_routes=dict(f32_loss_rel=own_loss_rel, f32_grad_rel_l2=own_errs,
                                      grads_held=flips["s32_own"] == 0)))
    emit("sharded_train_path", **fields, seconds=time.perf_counter() - t_phase,
         budget_s=SHARD_BUDGET_S)
    return dict(fields, fwd_launches=counts["flash_attention"],
                bwd_launches=counts["flash_attention_bwd"])


def phase_sharded_kernel_times(sh: dict, dev, peaks, errs: dict) -> list[dict]:
    """The flash forward (with its lse, as the training step launches it)
    and backward at one tensor-parallel rank's call of sharded_train_path
    (granite on (2, 4): q (4, 4, 2048, 64) in the model's strided layout,
    kv 2 heads, causal, bf16): ``train_flash_rows``."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.tensor_parallel import kv_heads_for
    cfg = get_arch(TRAIN_MODEL)
    n_dp, n_tp = SHARD_MESH
    Hkv = kv_heads_for(0, n_tp, cfg.n_heads, cfg.n_kv_heads)[1]
    steps = sh["steps"]
    return train_flash_rows(
        (TRAIN_B // n_dp, cfg.n_heads // n_tp, Hkv, TRAIN_S, cfg.hd), dev, peaks, errs,
        "tp_shard", "granite sharded training, one tp rank",
        dict(forward=sh["fwd_launches"], backward=sh["bwd_launches"]),
        dict(forward=sh["fwd_launches"] // steps, backward=sh["bwd_launches"] // steps))


def train_flash_rows(shape: tuple, dev, peaks, errs: dict, name: str, call: str,
                     launches: dict, per_step: dict, forward: bool = True,
                     **extra) -> list[dict]:
    """The flash forward with its lse (as a training step launches it) and
    backward at one tensor-parallel rank's training call, ``shape`` = (B,
    q heads, kv heads, S, d): q (B, Hq, S, d) in the model's strided layout
    over Hkv kv heads, causal, bf16. Held against their plain versions
    (``check_flash_bwd``: out, lse, dq, dk, dv), timed beside them and
    beside one SDPA call of the same function, bounded. ``launches`` and
    ``per_step`` give each row's counts from its path's run; ``forward``
    False leaves out the forward's row (its out and lse are checked all the
    same); ``extra`` goes into every row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    from repro_torch.kernels.parity import check_flash_bwd
    B, Hq, Hkv, S, d = shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def heads(h):  # the model's (B, S, H, d) tensor seen as (B, H, S, d)
        return torch.randn((B, S, h, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = heads(Hq), heads(Hkv), heads(Hkv)
    dout = torch.randn((B, Hq, S, d), generator=gen, device=dev, dtype=torch.bfloat16)
    res = check_flash_bwd(q, k, v, dout, dict(causal=True, window=0, softcap=0.0),
                          f"flash at the {call} call")
    errs["flash_attention"] = max(errs["flash_attention"], res["out_max_abs_err"])
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], res["max_abs_err"])
    out, lse = flash_attention_lse(q, k, v)
    pairs = kept_pairs(S, S, True, 0)
    fwd_flops = 4.0 * B * Hq * d * pairs
    dims = [B, Hq, Hkv, S, S, d]
    rows = []
    if forward:
        # q, k, v read once; out and lse written once
        f_bytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
        f_ms = cuda_ms(lambda: flash_attention_lse(q, k, v))
        f_plain = cuda_ms(lambda: attention_lse_ref(q, k, v, causal=True), reps=3, warmup=1)
        f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                               enable_gqa=True))
        rows.append(table_row(
            f"flash_attention[{name}]", "cuda", "src/repro_torch/csrc/flash_tc.cu",
            "src/repro/kernels/flash_attention/kernel.py:24", launches["forward"],
            res["out_max_abs_err"], f_ms, f_plain, f_lib,
            bound(f_bytes, fwd_flops, peaks, rate="bf16"), shape=dims,
            call=f"{call} (causal, bf16, with lse)", launches_per_step=per_step["forward"],
            lse_max_abs_err=res["lse_max_abs_err"], library="sdpa (enable_gqa, is_causal)",
            kept_pairs=pairs, flops=fwd_flops, bytes=f_bytes, **extra))
    # q, k, v, out, dout and lse read once; dq, dk, dv written once
    b_bytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel()
                   + dout.numel()) + 4 * lse.numel()
    b_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout))
    route = flash_attention_bwd.last_route
    check(route == "tensor_core", f"the {call} call's backward took {route}")
    b_plain = cuda_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout), reps=3, warmup=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    b_lib = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dout, retain_graph=True))
    rows.append(table_row(
        f"flash_attention_bwd[{name}]", "cuda", "src/repro_torch/csrc/flash_bwd_tc.cu",
        "src/repro/models/attention.py:133", launches["backward"], res["max_abs_err"], b_ms,
        b_plain, b_lib, bound(b_bytes, 2.5 * fwd_flops, peaks, rate="bf16"), shape=dims,
        call=f"{call} (causal, bf16)", backward_route=route,
        launches_per_step=per_step["backward"],
        grad_max_abs_errs={n: res[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv")},
        forward_out_max_abs_err=res["out_max_abs_err"],
        lse_max_abs_err=res["lse_max_abs_err"],
        replaces_note="no TPU kernel: the reference differentiates "
                      "dense_attention through XLA (jax.vjp)",
        library="sdpa backward (enable_gqa, is_causal)",
        kept_pairs=pairs, flops_bound=2.5 * fwd_flops, bytes=b_bytes, **extra))
    return rows


def phase_train_loop(dev) -> None:
    """``train()`` at granite-moe-1b-a400m ``reduced()`` with the reference
    example's settings, clean and with one failure injected at step 30."""
    import shutil
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.loop import TrainConfig, train
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_MODEL).reduced()
    root = ROOT / "build" / "train_loop"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=60, batch=8, seq_len=128, ckpt_every=10, peak_lr=1e-3, device=str(dev))
    reset_launch_counts()
    clean = train(cfg, TrainConfig(ckpt_dir=str(root / "clean"), **kw))
    counts = launch_counts()
    # a kernel failure must not hide behind the loop's catch-all retry
    check(clean.restarts == 0 and clean.final_step == 60,
          f"clean run: {clean.restarts} restarts, final step {clean.final_step}")
    check(counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0,
          f"the loop's launches {counts}")
    tripped = []

    def fail_at_30(step):
        if step == 30 and not tripped:
            tripped.append(step)
            return True
        return False

    failed = train(cfg, TrainConfig(ckpt_dir=str(root / "failed"), **kw),
                   fail_injector=fail_at_30)
    shutil.rmtree(root, ignore_errors=True)
    check(failed.restarts == 1 and failed.final_step == 60,
          f"failed run: {failed.restarts} restarts, final step {failed.final_step}")
    # the checkpoint of step 30 restored: the run goes on at step 30
    check(failed.losses[30] == clean.losses[30],
          f"loss after the restore {failed.losses[30]!r} != the clean run's "
          f"{clean.losses[30]!r}")
    check(failed.losses[-1] < failed.losses[0], f"losses {failed.losses[0]} -> "
          f"{failed.losses[-1]}")
    emit("train_loop", model=cfg.name, steps=60, batch=8, seq_len=128, ckpt_every=10,
         clean_restarts=clean.restarts, failed_restarts=failed.restarts,
         loss_after_restore=failed.losses[30], clean_loss_at_30=clean.losses[30],
         all_losses_bit_equal=failed.losses == clean.losses,
         first_loss=failed.losses[0], last_loss=failed.losses[-1],
         flash_launches=counts["flash_attention"],
         flash_bwd_launches=counts["flash_attention_bwd"],
         seconds=time.perf_counter() - t0)


def phase_train_cpu_vs_card() -> None:
    """One make_train_step of each family's ``reduced()`` config on the card
    and on the CPU from the same weights and AdamW state: loss within the
    bf16 tolerance, gnorm within 5%, the same lr, every leaf's gradient
    within ``CPU_CARD_GRAD_REL_L2``; on the card every flash forward has its
    backward."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import loss_and_grads, make_train_step
    t0 = time.perf_counter()
    B, S = 2, 96
    for name in TRAIN_FAMILIES:
        cfg = get_arch(name).reduced()
        batch = prompt_of(family_batch(cfg, B, S, seed=0, device="cpu"), S)
        params = M.init_params(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, peak_lr=1e-3, total_steps=100)
        out = {}
        for dev in ("cpu", "cuda"):
            tree = _tree_to(params, dev)
            st = adamw_init(tree)
            reset_launch_counts()
            _, grads = loss_and_grads(cfg, tree, batch)
            _, _, m = step(tree, st._replace(step=st.step + 5), batch)
            out[dev] = ({k: float(v) for k, v in m.items()}, [g.float().cpu() for g in grads],
                        launch_counts())
        (mc, g_cpu, _), (mg, g_card, counts) = out["cpu"], out["cuda"]
        check(abs(mg["loss"] - mc["loss"]) <= TRAIN_LOSS_ATOL + TRAIN_LOSS_RTOL * abs(mc["loss"]),
              f"{name}: card loss {mg['loss']} vs CPU {mc['loss']}")
        check(abs(mg["gnorm"] - mc["gnorm"]) <= 0.05 * mc["gnorm"],
              f"{name}: card gnorm {mg['gnorm']} vs CPU {mc['gnorm']}")
        check(mg["lr"] == mc["lr"], f"{name}: lr {mg['lr']} vs {mc['lr']}")
        bound_ = CPU_CARD_GRAD_REL_L2.get(cfg.family, 0.05)
        errs = {n: rel_l2(a, b) for n, a, b in zip(leaf_names(params), g_card, g_cpu)}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= bound_, f"{name}: {worst} gradient rel L2 {errs[worst]:.3g} "
              f"> {bound_}")
        if cfg.family == "ssm":
            check(counts["flash_attention"] == 0, f"{name}: flash launched {counts}")
        else:
            check(counts["flash_attention"] > 0
                  and counts["flash_attention_bwd"] == counts["flash_attention"],
                  f"{name}: launches {counts}")
        emit("train_cpu_vs_card", model=cfg.name, family=cfg.family, layers=cfg.n_layers,
             batch=B, seq_len=S, card=mg, cpu=mc, grad_rel_l2_worst=[worst, errs[worst]],
             grad_bound=bound_, launches=counts)
    emit("train_cpu_vs_card_done", seconds=time.perf_counter() - t0)


# ---- serving on the mesh, the scan sweep and the dry-run ----------------------------

SERVE_MODEL = "granite-moe-3b-a800m"  # FAMILY_RUNS' MoE, which families_path serves on one card
SERVE_MESH = (2, 4)  # (data, model): each rank holds 6 of the 24 q heads and 2 of the 8 kv
SERVE_S = 2048       # PROMPTS x SERVE_S prompt tokens, then DECODE_STEPS greedy steps
SERVE_LONG = 32768   # the shard_seq decode's cache: decode_32k's length, cut from
LONG_500K = 524288   # long_500k's (the long-context layout's own shape) by the time limit
SERVE_BUDGET_S = 60.0  # the three new phases' share of the script's time limit


def phase_sharded_serve_path(dev, peaks) -> dict:
    """granite-moe-3b-a800m at full width and depth served on
    ``make_debug_mesh(2, 4)`` of the card through ``make_prefill_step`` /
    ``make_serve_step`` under ``use_mesh``: a prefill of PROMPTS x SERVE_S
    tokens (each rank's attention in the flash kernel on its heads, the
    cache's sequence split over the 4 model ranks by an all-to-all), the
    cache grown to SERVE_S + DECODE_STEPS positions (a multiple of 4), then
    DECODE_STEPS decode steps (flash-decoding: each sequence shard through
    the kernel's split-KV route with its lse, combined by a pmax and two
    psums). One device's run of the same steps comes first: its MoE routes
    are replayed on the mesh (``PinnedRoutes``: the tensor-parallel psums
    round the router's input differently) and its greedy tokens fed to
    both; every logit row is held to families_path's tolerance and near-tie
    rule, and a repeat of the prefill and the first step is bit-equal. Then
    one ``shard_seq`` decode at batch 1 over a SERVE_LONG cache whose
    sequence spreads over all 8 ranks, against one device's."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import (cache_shardings, param_shardings,
                                                  shard_tree, use_mesh)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step, make_serve_step
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before sharded serving")
    t_phase = time.perf_counter()
    cfg = get_arch(SERVE_MODEL)
    B, S, n = PROMPTS, SERVE_S, DECODE_STEPS
    n_dp, n_tp = SERVE_MESH
    L = S + n
    check(L % n_tp == 0, f"cache of {L} does not split over {n_tp} model ranks")
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    prompt = prompt_of(family_batch(cfg, B, S, seed=0, device=dev), S)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    routes = PinnedRoutes()
    with routes, torch.no_grad():
        want, cache = prefill_step(params, prompt)
        cache = M.grow_cache(cache, L)
        wants, toks = [want], [want.argmax(-1)]
        for i in range(n):
            logits, cache = serve_step(params, cache, toks[-1], S + i)
            wants.append(logits)
            toks.append(logits.argmax(-1))
    del cache
    mesh = make_debug_mesh(*SERVE_MESH)
    placed = shard_tree(params, param_shardings(params, mesh))

    def mesh_run(steps: int) -> dict:
        routes.replay, routes.at, routes.n_split, routes.flips = True, 0, n_dp, []
        out = dict(logits=[], step_ms=[])
        with routes, use_mesh(mesh), torch.no_grad():
            reset_launch_counts()
            mesh.log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, c = prefill_step(placed, prompt)
            torch.cuda.synchronize()
            out.update(prefill_s=time.perf_counter() - t0, prefill_collectives=log_of(mesh),
                       prefill_launches=launch_counts()["flash_attention"],
                       prefill_routes=dict(flash_attention.route_launches))
            out["spec_k"] = [str(e) for e in c["k"].spec]
            c = M.grow_cache(c, L)
            out["logits"].append(got)
            reset_launch_counts()
            mesh.log.clear()
            torch.cuda.synchronize()
            t_win = time.perf_counter()
            for i in range(steps):
                t0 = time.perf_counter()
                got, c = serve_step(placed, c, toks[i], S + i)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["logits"].append(got)
            out.update(decode_window_ms=(time.perf_counter() - t_win) * 1e3,
                       decode_collectives=log_of(mesh),
                       decode_launches=launch_counts()["flash_attention"],
                       decode_routes=dict(flash_attention.route_launches),
                       route_flips=sum(routes.flips))
        return out

    torch.cuda.reset_peak_memory_stats()
    run = mesh_run(n)
    peak = torch.cuda.max_memory_allocated()
    agree = [same_logits(g, w, f"sharded serving, {'prefill' if i == 0 else f'step {i - 1}'}",
                         near_tie=True)
             for i, (g, w) in enumerate(zip(run["logits"], wants))]
    check(run["spec_k"][2] == "model", f"the prefill cache's k is placed {run['spec_k']}")
    layers = cfg.n_layers
    check(run["prefill_routes"]["tensor_core"] == layers * n_dp * n_tp,
          f"prefill flash routes {run['prefill_routes']}")
    check(run["decode_routes"]["split_kv"] == n * layers * n_dp * n_tp,
          f"decode flash routes {run['decode_routes']} (one split-KV launch a shard)")
    again = mesh_run(1)
    check(all(torch.equal(a, b) for a, b in zip(again["logits"], run["logits"])),
          "a repeat of the sharded prefill and first step is not bit-equal")
    del again

    # long context: batch 1, the cache's sequence over all 8 ranks (shard_seq)
    gen = torch.Generator(device=dev).manual_seed(3)
    long_cache = M.make_cache(cfg, 1, SERVE_LONG, device=dev)
    for t in (long_cache["k"], long_cache["v"]):
        t.normal_(generator=gen)
    placed_long = shard_tree({k: t.clone() for k, t in long_cache.items()},
                             cache_shardings(long_cache, mesh, shard_seq=True))
    long_spec = [str(e) for e in placed_long["k"].spec]
    check(tuple(placed_long["k"].spec)[2] == ("data", "model"),
          f"the long cache is placed {long_spec}")
    tok1, pos = toks[0][:1], SERVE_LONG - 1
    long_routes = PinnedRoutes()
    with long_routes, torch.no_grad():
        want_long, _ = serve_step(params, long_cache, tok1, pos)
    del long_cache
    long_routes.replay, long_routes.n_split = True, 1  # batch 1: computed once, as data rank 0
    with long_routes, use_mesh(mesh), torch.no_grad():
        reset_launch_counts()
        mesh.log.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_long, _ = serve_step(placed, placed_long, tok1, pos)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        long_routes_by = dict(flash_attention.route_launches)
        long_log = log_of(mesh)
    check(long_routes_by["split_kv"] == layers * n_dp * n_tp,
          f"shard_seq decode flash routes {long_routes_by} (one a shard)")
    long_agree = same_logits(got_long, want_long, "shard_seq decode", near_tie=True)
    del placed_long, placed, params
    gc.collect()
    torch.cuda.empty_cache()
    fields = dict(model=cfg.name, mesh=list(SERVE_MESH), layers=layers, d_model=cfg.d_model,
                  heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, heads_per_rank=cfg.n_heads // n_tp,
                  experts=cfg.n_experts, top_k=cfg.moe_top_k, prompts=B, prompt_len=S,
                  cache_len=L, cache_spec_k=run["spec_k"], decode_steps=n,
                  prefill_s=run["prefill_s"], prefill_tokens_per_s=B * S / run["prefill_s"],
                  decode_window_ms=run["decode_window_ms"],
                  decode_ms_per_step=run["decode_window_ms"] / n,
                  decode_ms_per_step_median=statistics.median(run["step_ms"]),
                  prefill_collectives=run["prefill_collectives"],
                  decode_collectives_16_steps=run["decode_collectives"],
                  prefill_flash_launches=run["prefill_launches"],
                  prefill_flash_routes=run["prefill_routes"],
                  decode_flash_launches=run["decode_launches"],
                  decode_flash_routes=run["decode_routes"],
                  moe_route_flips_replayed=run["route_flips"],
                  logits_vs_one_device=agree, repeat_bit_equal=True,
                  rtol=LOGIT_RTOL, atol=LOGIT_ATOL, max_memory_allocated_bytes=peak,
                  long_cache_len=SERVE_LONG, long_cache_len_uncut=LONG_500K,
                  long_cache_spec_k=long_spec,
                  long_decode_ms=long_ms, long_decode_flash_routes=long_routes_by,
                  long_decode_collectives=long_log, long_vs_one_device=long_agree,
                  long_moe_route_flips_replayed=sum(long_routes.flips),
                  seconds=time.perf_counter() - t_phase)
    emit("scale_cut", what="shard_seq decode cache", cache_len=SERVE_LONG,
         long_500k_len=LONG_500K, why="the time limit: a 524,288-position cache of 32 "
         "layers would be 34 GB to fill and compare on one card")
    emit("sharded_serve_path", **fields)
    return dict(fields=fields, launches=dict(prefill=run["prefill_launches"],
                                             decode=run["decode_launches"]))


def phase_sharded_serve_kernel_times(sv: dict, dev, peaks, errs: dict) -> list[dict]:
    """The flash kernel at sharded_serve_path's two calls (granite-moe-3b's
    one model rank's prefill, q (1, 6, 2048, 64) of one data rank in the
    model's strided layout, kv 2 heads, causal; one sequence shard's decode
    with its lse, q (1, 24, 1, 64): every head, gathered, over its
    516-position slice of the 2,064 kv positions of 8 heads):
    ``mesh_flash_rows``."""
    from repro_torch.configs.base import get_arch
    return mesh_flash_rows(get_arch(SERVE_MODEL), SERVE_MESH, SERVE_S, sv["launches"], dev,
                           peaks, errs, ("tp_prefill", "seq_shard_decode"), "granite-moe-3b")


def mesh_flash_rows(cfg, mesh_shape, S: int, launches: dict, dev, peaks, errs: dict,
                    names: tuple, label: str, prefills: tuple | None = None) -> list[dict]:
    """The flash kernel at a mesh-served model's calls, held against its
    plain version, timed beside it and one SDPA call of the same function,
    bounded: a model rank's prefill call (its q and kv heads of one data
    rank's PROMPTS / n_dp rows, S tokens, causal, bf16, in the model's
    strided layout) under ``names[0]`` and one sequence shard's decode call
    with its lse (every q head, gathered, over its (S + DECODE_STEPS) /
    n_tp slice of the cache) under ``names[1]``. ``prefills`` = ((row name,
    q heads, kv heads, that call's launches in the path's prefill), ...)
    gives one prefill row each instead, where the ranks' calls differ; an
    even split's one call (n_heads / n_tp over n_kv_heads / n_tp) by
    default."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_lse
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref, attention_ref
    from repro_torch.kernels.parity import check_flash
    n_dp, n_tp = mesh_shape
    d, b = cfg.hd, PROMPTS // n_dp
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_heads(batch, s, h):  # the model's (B, S, H, d) tensor seen as (B, H, S, d)
        return torch.randn((batch, s, h, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    rows = []
    # prefill: a model rank's heads of one data rank's rows
    for name, Hq, Hkv, n_call in prefills or (
            (names[0], cfg.n_heads // n_tp, cfg.n_kv_heads // n_tp, None),):
        q, k, v = rand_heads(b, S, Hq), rand_heads(b, S, Hkv), rand_heads(b, S, Hkv)
        out = flash_attention(q, k, v)
        route = flash_attention.last_route[0]
        check(route == "tensor_core", f"the {label} sharded prefill call took {route}")
        err = check_flash(out, attention_ref(q, k, v),
                          f"flash at the {label} sharded prefill call {Hq} q / {Hkv} kv")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        pairs = kept_pairs(S, S, True, 0)
        flops = 4.0 * b * Hq * d * pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
        more = {} if n_call is None else dict(launches_of_this_call=n_call)
        rows.append(table_row(
            f"flash_attention[{name}]", "cuda", "src/repro_torch/csrc/flash_tc.cu",
            "src/repro/kernels/flash_attention/kernel.py:24", launches["prefill"], err,
            cuda_ms(lambda: flash_attention(q, k, v)),
            cuda_ms(lambda: attention_ref(q, k, v), reps=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=True)),
            bound(nbytes, flops, peaks, rate="bf16"), shape=[b, Hq, Hkv, S, S, d],
            call=f"{label} sharded prefill, one model rank (causal, bf16)", flash_route=route,
            library="sdpa (enable_gqa, is_causal)", kept_pairs=pairs, flops=flops,
            bytes=nbytes, **more))
    # decode: one sequence shard's slice, every q head (gathered), with lse
    Hq, Hkv, n = cfg.n_heads, cfg.n_kv_heads, (S + DECODE_STEPS) // n_tp
    q, k, v = rand_heads(b, 1, Hq), rand_heads(b, n, Hkv), rand_heads(b, n, Hkv)
    out, lse = flash_attention_lse(q, k, v, causal=False)
    route = flash_attention.last_route[0]
    check(route == "split_kv", f"the {label} sharded decode call took {route}")
    want, want_lse = attention_lse_ref(q, k, v, causal=False)
    err = check_flash(out, want, f"flash at the {label} sharded decode call")
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= 1e-3, f"{label} sharded decode call: lse differs by {lse_err:.3g}")
    errs["flash_attention"] = max(errs["flash_attention"], err)
    flops = 4.0 * b * Hq * d * n
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel()
    rows.append(table_row(
        f"flash_attention[{names[1]}]", "cuda", "src/repro_torch/csrc/flash_split.cu",
        "src/repro/kernels/flash_attention/kernel.py:24", launches["decode"], err,
        cuda_ms(lambda: flash_attention_lse(q, k, v, causal=False)),
        cuda_ms(lambda: attention_lse_ref(q, k, v, causal=False), reps=3, warmup=1),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)),
        bound(nbytes, flops, peaks, rate="bf16"), shape=[b, Hq, Hkv, 1, n, d],
        call=f"{label} sharded decode, one sequence shard (every head, with lse)",
        flash_route=route, splits=flash_attention.last_route[1], lse_max_abs_err=lse_err,
        library="sdpa (enable_gqa; no lse)", flops=flops, bytes=nbytes))
    return rows


# ---- the Mamba-2 and xLSTM blocks split by head on a (2, 4) mesh of the card ---------

# (config, prompt / training S). xlstm's S is cut (printed): its sLSTM loops
# over time on the host, in the prefill, the remat's two forwards and the
# backward; 256 keeps the phase near its budget (at 512 it took 71.0 s of
# its 60 and the script 1,027.9 s on an NVIDIA H100 80GB HBM3 at 700 W)
SSM_RUNS = (("zamba2-1.2b", 2048), ("xlstm-350m", 256))
# the activations the serving check runs in. xlstm-350m's random bf16
# recurrences are chaotic at 24 layers: one device's own bf16 prefill is
# 0.24 mean / 1.5 max abs from its float32 one, and any other grouping of
# the same products (a batch split over the data ranks alone: 0.61 max)
# moves its bf16 logits past sharded_serve_path's bounds (a CPU run of
# 2 x 128 tokens). So its mesh is held to one device in float32
# activations (bf16 weights), where both compute one function, and in
# bf16 no farther from that float32 run than one device's bf16 run is
SSM_ACT = {"zamba2-1.2b": torch.bfloat16, "xlstm-350m": torch.float32}
SSM_BF16_DRIFT = 1.5  # the mesh's bf16 drift from float32 over one device's, at most
SSM_S_UNCUT = 2048  # families_path's prompt length
SSM_MESH = (2, 4)   # (data, model): zamba2 16 SSM heads a rank, xlstm 1 mLSTM head
SSM_BUDGET_S = 60.0  # the phase's share of the script's time limit, rows included
SSM_PEAK_LIMIT = 70 * 10 ** 9  # zamba2's training peak past this would cut its S to 1,024
SSM_SPLIT = ("in_proj", "out_proj", "up_proj", "q", "k", "v", "down_proj", "w_in")


def gathered_block_bytes(cfg) -> int:
    """The bytes one forward of a data rank all-gathered for its Mamba-2 /
    xLSTM blocks when each gathered its split weights whole (bf16): the
    weights of each layer, times the layers."""
    D = cfg.d_model
    if cfg.family == "hybrid":
        di, N = cfg.ssm_expand * D, cfg.ssm_state
        return 2 * (D * (2 * di + 2 * N + di // cfg.ssm_headdim) + di * D) * cfg.n_layers
    di = int(cfg.proj_factor * D)
    mlstm = 2 * (D * 2 * di + 3 * di * di + di * D)
    slstm = 2 * (D * 4 * D + D * D)
    n_super = cfg.n_layers // cfg.slstm_every
    return n_super * ((cfg.slstm_every - 1) * mlstm + slstm)


class WeightWatch:
    """Notes the trailing two dims of every tensor a collective over
    ``model`` delivers (``all_gather_dim``, ``tensor_parallel.take``,
    ``ShardCtx.full``; 1-D ones from ``take`` only, a norm's scale having a
    bias's shape) while it is entered; ``whole(params)`` is what of them
    equals a whole split weight of the Mamba-2 / xLSTM blocks."""

    def __init__(self):
        self.shapes = set()

    def __enter__(self):
        from repro_torch.distributed import collectives as C
        from repro_torch.distributed import tensor_parallel as TP
        self.C, self.TP = C, TP
        self.saved = C.all_gather_dim, TP.take, TP.ShardCtx.full
        gather, take, full = self.saved

        def note(out, one_d=False):
            for t in (out if isinstance(out, list) else [out]):
                if t is not None and (t.ndim >= 2 or one_d):
                    self.shapes.add(tuple(t.shape[-2:]))
            return out
        C.all_gather_dim = lambda *a, **kw: note(gather(*a, **kw)) if a[2] == "model" \
            else gather(*a, **kw)
        TP.take = lambda *a, **kw: note(take(*a, **kw), one_d=True)
        TP.ShardCtx.full = lambda ctx, leaf, d: note(full(ctx, leaf, d))
        return self

    def __exit__(self, *exc):
        self.C.all_gather_dim, self.TP.take, self.TP.ShardCtx.full = self.saved
        return False

    def whole(self, params) -> list:
        from repro_torch.models import model as M
        split = {tuple(t.shape[-2:]) for path, t in M._leaves(params)
                 if path[-1] in SSM_SPLIT and path[0] != "shared_attn"}
        return sorted(self.shapes & split)


def run_sharded_ssm(name: str, S: int, dev) -> dict:
    """One model of phase ``sharded_ssm_path`` (see its docstring)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import param_shardings, shard_tree, use_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.step import (cast_tree, make_prefill_step, make_serve_step,
                                        make_sharded_train_step, sharded_adamw_init)
    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_arch(name), remat=True)
    B, n = PROMPTS, DECODE_STEPS
    n_dp, n_tp = SSM_MESH
    L = S + n
    check(L % n_tp == 0, f"cache of {L} does not split over {n_tp} model ranks")
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    batch = family_batch(cfg, B, S, seed=0, device=dev)
    prompt = prompt_of(batch, S)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    act = SSM_ACT[name]
    M.ACT_DTYPE = act
    with torch.no_grad():
        want, cache = prefill_step(params, prompt)
        cache = M.grow_cache(cache, L)
        wants, toks = [want], [want.argmax(-1)]
        for i in range(n):
            logits, cache = serve_step(params, cache, toks[-1], S + i)
            wants.append(logits)
            toks.append(logits.argmax(-1))
    del cache
    mesh = make_debug_mesh(*SSM_MESH)
    psh = param_shardings(params, mesh)
    placed = shard_tree(params, psh)

    def mesh_run(steps: int) -> dict:
        out = dict(logits=[], step_ms=[])
        with use_mesh(mesh), torch.no_grad():
            reset_launch_counts()
            mesh.log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, c = prefill_step(placed, prompt)
            torch.cuda.synchronize()
            out.update(prefill_s=time.perf_counter() - t0, prefill_collectives=log_of(mesh),
                       prefill_launches=launch_counts()["flash_attention"],
                       prefill_routes=dict(flash_attention.route_launches))
            c = M.grow_cache(c, L)
            out["logits"].append(got)
            reset_launch_counts()
            mesh.log.clear()
            torch.cuda.synchronize()
            t_win = time.perf_counter()
            for i in range(steps):
                t0 = time.perf_counter()
                got, c = serve_step(placed, c, toks[i], S + i)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["logits"].append(got)
            out.update(decode_window_ms=(time.perf_counter() - t_win) * 1e3,
                       decode_collectives=log_of(mesh),
                       decode_launches=launch_counts()["flash_attention"],
                       decode_routes=dict(flash_attention.route_launches))
        return out

    torch.cuda.reset_peak_memory_stats()
    with WeightWatch() as watch:
        run = mesh_run(n)
    serve_peak = torch.cuda.max_memory_allocated()
    agree = [same_logits(g, w, f"{name} split by head, "
                         f"{'prefill' if i == 0 else f'step {i - 1}'}", near_tie=True)
             for i, (g, w) in enumerate(zip(run["logits"], wants))]
    again = mesh_run(1)
    check(all(torch.equal(a, b) for a, b in zip(again["logits"], run["logits"])),
          f"{name}: a repeat of the prefill and first step split by head is not bit-equal")
    del again
    drift = None
    if act != torch.bfloat16:  # the bf16 prefills' drift from one device's float32 one
        M.ACT_DTYPE = torch.bfloat16
        with torch.no_grad():
            one16, _ = prefill_step(params, prompt)
            with use_mesh(mesh):
                mesh16, _ = prefill_step(placed, prompt)
        drift = dict(one_device=(one16.float() - wants[0]).abs().mean().item(),
                     mesh=(mesh16.float() - wants[0]).abs().mean().item(),
                     mesh_vs_one_device_max=(mesh16.float() - one16.float()).abs().max().item())
        check(drift["mesh"] <= SSM_BF16_DRIFT * drift["one_device"],
              f"{name}: the mesh's bf16 prefill drifts {drift['mesh']:.4g} from float32, "
              f"one device's {drift['one_device']:.4g}")
        del one16, mesh16
    M.ACT_DTYPE = torch.bfloat16
    del wants
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        check(run["prefill_routes"].get("tensor_core", 0) == G * n_dp * n_tp,
              f"{name} prefill flash routes {run['prefill_routes']}")
        check(run["decode_routes"].get("split_kv", 0) == n * G * n_dp * n_tp,
              f"{name} decode flash routes {run['decode_routes']}")
    else:
        check(run["prefill_launches"] == 0 and run["decode_launches"] == 0,
              f"{name} launched flash attention")

    # one tp training step at 2 x S (bf16 grads, remat) from f32 masters of
    # the same weights, its loss against one device's, and its repeat
    tbatch = {"tokens": batch["tokens"][:, :S]}
    with torch.no_grad():
        one_loss = float(M.train_loss(cfg, params, tbatch))
    master = shard_tree(cast_tree(params, torch.float32), psh)
    del placed, params
    gc.collect()
    torch.cuda.empty_cache()
    step = make_sharded_train_step(cfg, bf16_grads=True, peak_lr=TRAIN_PEAK_LR, total_steps=2)
    st = sharded_adamw_init(master, psh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    mesh.log.clear()
    with WeightWatch() as twatch:
        t0 = time.perf_counter()
        new_p, new_st, m = step(master, st, tbatch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    train_log = log_of(mesh)
    train_launches = dict(launch_counts())
    train_peak = torch.cuda.max_memory_allocated()
    check(train_peak <= SSM_PEAK_LIMIT, f"{name}: training peak {train_peak} bytes")
    loss, gnorm = float(m["loss"]), float(m["gnorm"])
    again_p, _, again_m = step(master, st, tbatch)
    check(float(again_m["loss"]) == loss and float(again_m["gnorm"]) == gnorm,
          f"{name}: a repeat of the tp training step gave another loss or gnorm")
    for a, b in zip(tree_leaves(new_p), tree_leaves(again_p)):
        check(all(torch.equal(x, y) for (_, x), (_, y) in zip(a.distinct(), b.distinct())),
              f"{name}: a repeat of the tp training step gave other bits")
    rel = abs(loss - one_loss) / abs(one_loss)
    check(math.isfinite(loss) and math.isfinite(gnorm) and rel <= SHARD_LOSS_RTOL,
          f"{name}: tp step-0 loss {loss} vs one device's {one_loss}: rel {rel:.3g}")
    whole = watch.whole(master) + twatch.whole(master)
    check(not whole, f"{name}: whole split weights delivered by a collective: {whole}")
    del master, st, new_p, new_st, again_p
    gc.collect()
    torch.cuda.empty_cache()
    gathered = gathered_block_bytes(cfg)
    return dict(model=name, mesh=list(SSM_MESH), layers=cfg.n_layers, d_model=cfg.d_model,
                heads=cfg.n_heads, prompts=B, prompt_len=S, decode_steps=n,
                serve_activations=str(act).removeprefix("torch."), bf16_prefill_drift=drift,
                prefill_s=run["prefill_s"], decode_ms_per_step=run["decode_window_ms"] / n,
                decode_ms_per_step_median=statistics.median(run["step_ms"]),
                prefill_collectives=run["prefill_collectives"],
                decode_collectives_per_step={k: {kk: vv / n for kk, vv in v.items()}
                                             for k, v in run["decode_collectives"].items()},
                train_step_collectives=train_log,
                gathered_path_all_gather_bytes=dict(
                    prefill=gathered, decode_step=gathered, train_step_remat=2 * gathered),
                whole_weights_delivered=whole, logits_vs_one_device=agree,
                repeat_bit_equal=True, max_memory_allocated_bytes=dict(
                    serve=serve_peak, train=train_peak),
                prefill_flash_launches=run["prefill_launches"],
                prefill_flash_routes=run["prefill_routes"],
                decode_flash_launches=run["decode_launches"],
                decode_flash_routes=run["decode_routes"], train_step_ms=step_ms,
                train_loss=loss, train_gnorm=gnorm, one_device_loss=one_loss, train_rel=rel,
                train_launches=train_launches, seconds=time.perf_counter() - t_model)


def phase_sharded_ssm_path(dev) -> dict:
    """zamba2-1.2b and xlstm-350m at full width and depth, random bf16
    weights from a seed, their Mamba-2 / xLSTM blocks split by head over
    the 4 model ranks of ``make_debug_mesh(2, 4)`` of the card (tp mode),
    each freed before the next (``run_sharded_ssm``): a prefill of 2 x S
    and 16 greedy decode steps against one device's run on the card
    (sharded_serve_path's bounds), a repeat of the prefill and first step
    bit-equal; one tp training step (bf16 grads, remat) at 2 x S, its loss
    within SHARD_LOSS_RTOL of one device's, a repeat bit-equal; no
    collective delivers a whole split weight of those blocks. Flash launch
    counts are zeroed before each mesh run and read after it."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before the SSM blocks split by head")
    t_phase = time.perf_counter()
    out = {}
    for name, S in SSM_RUNS:
        if S < SSM_S_UNCUT:
            emit("scale_cut", what=f"{name} split by head: prompt and training tokens",
                 seq_len=S, seq_len_uncut=SSM_S_UNCUT,
                 why="its sLSTM loops over time on the host: 2 x S steps a layer, "
                     "again in the training step's remat and backward; the phase's "
                     "budget")
        out[name] = run_sharded_ssm(name, S, dev)
        emit("sharded_ssm_path", **out[name])
    emit("sharded_ssm_path_done", seconds=time.perf_counter() - t_phase, budget_s=SSM_BUDGET_S)
    z = out["zamba2-1.2b"]
    return dict(runs=out, launches=dict(prefill=z["prefill_flash_launches"],
                                        decode=z["decode_flash_launches"]))


def phase_sharded_ssm_kernel_times(ssm: dict, dev, peaks, errs: dict) -> list[dict]:
    """The flash kernel at zamba2-1.2b's two calls of sharded_ssm_path (its
    shared attention: one model rank's prefill, q (1, 8, 2048, 64) with 8
    kv heads, causal; one sequence shard's decode with lse, q (1, 32, 1,
    64) over 516 of the 2,064 positions): ``mesh_flash_rows``."""
    from repro_torch.configs.base import get_arch
    return mesh_flash_rows(get_arch("zamba2-1.2b"), SSM_MESH, dict(SSM_RUNS)["zamba2-1.2b"],
                           ssm["launches"], dev, peaks, errs,
                           ("zamba2_tp_prefill", "zamba2_tp_decode"), "zamba2-1.2b")


# ---- attention's q heads split unevenly over 16 model ranks of the card -------

UNEVEN_MODEL = "qwen2-7b"  # 28 q / 4 kv heads: 2 a rank on ranks 0-13, none on 14-15
UNEVEN_MESH = (1, 16)      # (data, model): the production mesh's 16 model ranks
UNEVEN_S = 2048            # PROMPTS x UNEVEN_S prompt tokens, then DECODE_STEPS greedy steps
UNEVEN_TRAIN_LAYERS = 2    # the training step's depth, cut from 28 (printed as scale_cut)
UNEVEN_BUDGET_S = 75.0     # the phase's share of the script's time limit
UNEVEN_PEAK_LIMIT = 70 * 10 ** 9
UNEVEN_STRADDLER = 3       # ranks 3 and 10 straddle the kv groups of 7: heads 6-7 read kv 0-1
# the tp training step's gnorm against one device's (bf16 gradients): read
# 3.4e-4 off on an NVIDIA H100 80GB HBM3 at 700 W (the psums re-round bf16
# partial sums); about 9x room
UNEVEN_GNORM_RTOL = 3e-3


class QMoveWatch(WeightWatch):
    """``WeightWatch``, and the bytes data rank 0's attention layers moved
    between model ranks as ``wq`` / ``bq`` columns and ``wo`` rows or as
    the products that stand in for them (the ``Mesh.log`` records of
    ``models.model._q_tp`` and ``_wo_tp``, ``wo``'s psum left out);
    ``whole_q`` is what of the noted shapes is a whole ``wq`` / ``bq`` /
    ``wo``."""

    MOVES = ("collective-permute", "all-gather")

    def __init__(self, mesh):
        super().__init__()
        self.mesh, self.moved = mesh, {"wq": 0, "wo": 0}

    def __enter__(self):
        from repro_torch.models import model as M
        super().__enter__()
        self.M, self.saved_q = M, (M._q_tp, M._wo_tp)

        def counted(key, fn):
            def run(*a, **kw):
                before = {k: self.mesh.log.get(k, (0, 0))[1] for k in self.MOVES}
                out = fn(*a, **kw)
                self.moved[key] += sum(self.mesh.log.get(k, (0, 0))[1] - before[k]
                                       for k in self.MOVES)
                return out
            return run
        M._q_tp, M._wo_tp = counted("wq", M._q_tp), counted("wo", M._wo_tp)
        return self

    def __exit__(self, *exc):
        self.M._q_tp, self.M._wo_tp = self.saved_q
        return super().__exit__(*exc)

    def take_moved(self) -> dict:
        out, self.moved = self.moved, {"wq": 0, "wo": 0}
        return out

    def whole_q(self, cfg) -> list:
        cols = cfg.n_heads * cfg.hd
        return sorted(self.shapes & {(cfg.d_model, cols), (cols, cfg.d_model), (cols,)})


def phase_uneven_tp_path(dev, peaks) -> dict:
    """qwen2-7b at full width and depth (28 layers, 28 q / 4 kv heads of
    128, random bf16 weights from a seed) served on ``make_debug_mesh(1,
    16)`` of the card, the production mesh's 16 model ranks, through
    ``make_prefill_step`` / ``make_serve_step`` under ``use_mesh``: each
    rank owns ``head_range``'s 2 q heads (ranks 14-15 none; ranks 3 and 10
    straddle the kv groups of 7), its ``wq`` columns and ``wo`` rows outside
    its own block of 224 moved as weights or as products (whichever is fewer
    bytes), attention once per ``attn_calls`` entry. A prefill of PROMPTS x
    UNEVEN_S tokens and DECODE_STEPS greedy decode steps over the
    sequence-split cache against one device's run on the card
    (sharded_serve_path's tolerance and near-tie rule), a repeat of the
    prefill and first step bit-equal; one tp training step (bf16 grads,
    remat) at 2 x UNEVEN_S with the depth cut to UNEVEN_TRAIN_LAYERS, a
    repeat bit-equal, its loss within SHARD_LOSS_RTOL and its gnorm within
    UNEVEN_GNORM_RTOL of one device's, and every gradient of the sharded
    forward and backward against one device's: in bf16 on the step's
    routes to TRAIN_GRAD_REL_L2, in float32 to SHARD_F32_GRAD_REL_L2; no
    collective delivers a whole ``wq`` / ``bq`` / ``wo``; flash launches by
    route, collectives by kind, the ``wq`` / ``wo`` bytes moved against the
    whole weights', prefill s, decode ms a step, step s and peak memory."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import param_shardings, shard_tree, use_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.step import (cast_tree, full_grads, loss_and_grads,
                                        make_prefill_step, make_serve_step,
                                        make_sharded_train_step, sharded_adamw_init,
                                        sharded_loss_and_grads)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    check(left < 1 << 30, f"{left} bytes still allocated before the uneven head split")
    t_phase = time.perf_counter()
    cfg = get_arch(UNEVEN_MODEL)
    B, S, n = PROMPTS, UNEVEN_S, DECODE_STEPS
    n_dp, n_tp = UNEVEN_MESH
    Hq, Hkv, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    heads = [TP.head_range(Hq, n_tp, m) for m in range(n_tp)]
    calls = sum(len(TP.attn_calls(m, n_tp, Hq, Hkv)) for m in range(n_tp))
    check(Hq % n_tp != 0 and heads[-1][1] == heads[-1][0], f"{cfg.name}'s heads {heads}")
    check(len(TP.q_runs(UNEVEN_STRADDLER, n_tp, Hq, Hkv)) == 2,
          f"rank {UNEVEN_STRADDLER} does not straddle a kv group")
    L = S + n
    check(L % n_tp == 0, f"cache of {L} does not split over {n_tp} model ranks")
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    batch = family_batch(cfg, B, S, seed=0, device=dev)
    prompt = prompt_of(batch, S)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    with torch.no_grad():
        want, cache = prefill_step(params, prompt)
        cache = M.grow_cache(cache, L)
        wants, toks = [want], [want.argmax(-1)]
        for i in range(n):
            logits, cache = serve_step(params, cache, toks[-1], S + i)
            wants.append(logits)
            toks.append(logits.argmax(-1))
    del cache
    mesh = make_debug_mesh(*UNEVEN_MESH)
    psh = param_shardings(params, mesh)
    placed = shard_tree(params, psh)
    watch = QMoveWatch(mesh)

    def mesh_run(steps: int) -> dict:
        out = dict(logits=[], step_ms=[])
        with use_mesh(mesh), torch.no_grad(), watch:
            reset_launch_counts()
            mesh.log.clear()
            watch.take_moved()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, c = prefill_step(placed, prompt)
            torch.cuda.synchronize()
            out.update(prefill_s=time.perf_counter() - t0, prefill_collectives=log_of(mesh),
                       prefill_launches=launch_counts()["flash_attention"],
                       prefill_routes=dict(flash_attention.route_launches),
                       prefill_moved=watch.take_moved())
            out["spec_k"] = [str(e) for e in c["k"].spec]
            c = M.grow_cache(c, L)
            out["logits"].append(got)
            reset_launch_counts()
            mesh.log.clear()
            torch.cuda.synchronize()
            t_win = time.perf_counter()
            for i in range(steps):
                t0 = time.perf_counter()
                got, c = serve_step(placed, c, toks[i], S + i)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                out["logits"].append(got)
            out.update(decode_window_ms=(time.perf_counter() - t_win) * 1e3,
                       decode_collectives=log_of(mesh),
                       decode_launches=launch_counts()["flash_attention"],
                       decode_routes=dict(flash_attention.route_launches),
                       decode_moved=watch.take_moved())
        return out

    torch.cuda.reset_peak_memory_stats()
    run = mesh_run(n)
    serve_peak = torch.cuda.max_memory_allocated()
    agree = [same_logits(g, w, f"{cfg.name} on {n_tp} model ranks, "
                         f"{'prefill' if i == 0 else f'step {i - 1}'}", near_tie=True)
             for i, (g, w) in enumerate(zip(run["logits"], wants))]
    check(run["spec_k"][2] == "model", f"the prefill cache's k is placed {run['spec_k']}")
    layers = cfg.n_layers
    check(run["prefill_routes"]["tensor_core"] == layers * n_dp * calls,
          f"prefill flash routes {run['prefill_routes']} ({calls} calls a layer)")
    check(run["decode_routes"]["split_kv"] == n * layers * n_dp * n_tp,
          f"decode flash routes {run['decode_routes']} (one split-KV launch a shard)")
    again = mesh_run(1)
    check(all(torch.equal(a, b) for a, b in zip(again["logits"], run["logits"])),
          f"{cfg.name}: a repeat of the prefill and first step on {n_tp} ranks is not "
          f"bit-equal")
    del again, wants
    # what gathering them whole would move a layer: each rank the whole wq and
    # bq (the all-gather's result) and the whole wo
    whole_bytes = layers * 2 * (2 * D * Hq * hd + Hq * hd)
    check(run["prefill_moved"]["wq"] + run["prefill_moved"]["wo"] < whole_bytes,
          f"the prefill moved {run['prefill_moved']} bytes of wq / wo, whole: {whole_bytes}")

    # one tp training step at 2 x S, the depth cut, from f32 masters
    tcfg = dataclasses.replace(cfg, n_layers=UNEVEN_TRAIN_LAYERS)
    del placed, params
    gc.collect()
    torch.cuda.empty_cache()
    tparams = M.init_params(tcfg, seed=0, dtype=torch.bfloat16, device=dev)
    tbatch = {"tokens": batch["tokens"][:, :S]}
    tpsh = param_shardings(tparams, mesh)
    master = shard_tree(cast_tree(tparams, torch.float32), tpsh)
    step = make_sharded_train_step(tcfg, bf16_grads=True, peak_lr=TRAIN_PEAK_LR, total_steps=2)
    st = sharded_adamw_init(master, tpsh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    mesh.log.clear()
    with watch:
        watch.take_moved()
        t0 = time.perf_counter()
        new_p, new_st, m = step(master, st, tbatch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        train_moved = watch.take_moved()
    train_log = log_of(mesh)
    train_launches = dict(launch_counts())
    train_routes = dict(forward=dict(flash_attention.route_launches),
                        backward=dict(flash_attention_bwd.route_launches))
    train_peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(m["loss"]), float(m["gnorm"])
    again_p, _, again_m = step(master, st, tbatch)
    check(float(again_m["loss"]) == loss and float(again_m["gnorm"]) == gnorm,
          f"{cfg.name}: a repeat of the tp training step gave another loss or gnorm")
    for a, b in zip(tree_leaves(new_p), tree_leaves(again_p)):
        check(all(torch.equal(x, y) for (_, x), (_, y) in zip(a.distinct(), b.distinct())),
              f"{cfg.name}: a repeat of the tp training step gave other bits")
    check(train_routes["backward"].get("tensor_core", 0) == UNEVEN_TRAIN_LAYERS * calls,
          f"training flash backward routes {train_routes['backward']}")
    whole = watch.whole_q(cfg)
    check(not whole, f"{cfg.name}: whole wq / bq / wo delivered by a collective: {whole}")
    del st, new_p, new_st, again_p
    gc.collect()
    torch.cuda.empty_cache()

    # the step against one device's step of the same function (the step's
    # bf16 casts of its masters are tparams' bits): its loss and gnorm, and
    # every gradient of the sharded forward and backward (the uneven runs'
    # flash calls, k / v sliced per call) against the unsharded ones, in
    # bf16 on the step's routes (tensor-core flash) and in float32 (the
    # fp32 routes, where the two compute one function)
    torch.cuda.reset_peak_memory_stats()
    names = leaf_names(tparams)

    def grads(sharded: bool, bf16: bool):
        if sharded:
            l, leaf_tree, g = sharded_loss_and_grads(tcfg, master, tbatch, bf16_grads=bf16)
            return float(l), tree_leaves(full_grads(master, leaf_tree, g))
        l, g = loss_and_grads(tcfg, tparams if bf16 else cast_tree(tparams, torch.float32),
                              tbatch, bf16_grads=bf16)
        return float(l), g

    one_loss, g_one = grads(False, True)
    one_gnorm = math.sqrt(sum(float(torch.sum(g.float() ** 2)) for g in g_one))
    _, g_s = grads(True, True)
    bf16_errs = {n: rel_l2(a, b) for n, a, b in zip(names, g_s, g_one)}
    del g_one, g_s
    M.ACT_DTYPE = torch.float32
    try:
        s32_loss, g_s = grads(True, False)
        u32_loss, g_one = grads(False, False)
    finally:
        M.ACT_DTYPE = torch.bfloat16
    f32_errs = {n: rel_l2(a, b) for n, a, b in zip(names, g_s, g_one)}
    del g_one, g_s
    grad_peak = torch.cuda.max_memory_allocated()
    rel = abs(loss - one_loss) / abs(one_loss)
    gnorm_rel = abs(gnorm - one_gnorm) / one_gnorm
    f32_loss_rel = abs(s32_loss - u32_loss) / abs(u32_loss)
    check(math.isfinite(loss) and math.isfinite(gnorm) and rel <= SHARD_LOSS_RTOL,
          f"{cfg.name}: tp step-0 loss {loss} vs one device's {one_loss}: rel {rel:.3g}")
    check(gnorm_rel <= UNEVEN_GNORM_RTOL, f"{cfg.name}: tp step-0 gnorm {gnorm} vs one "
          f"device's {one_gnorm}: rel {gnorm_rel:.3g} > {UNEVEN_GNORM_RTOL}")
    check(f32_loss_rel <= SHARD_F32_LOSS_RTOL, f"{cfg.name} in float32: tp loss {s32_loss} "
          f"vs one device's {u32_loss}: rel {f32_loss_rel:.3g}")
    for leaf in names:
        check(bf16_errs[leaf] <= TRAIN_GRAD_REL_L2, f"{cfg.name} {leaf} in bf16: tp vs one "
              f"device's gradient rel L2 {bf16_errs[leaf]:.3g} > {TRAIN_GRAD_REL_L2}")
        check(f32_errs[leaf] <= SHARD_F32_GRAD_REL_L2, f"{cfg.name} {leaf} in float32: tp vs "
              f"one device's gradient rel L2 {f32_errs[leaf]:.3g} > {SHARD_F32_GRAD_REL_L2}")
    peak = max(serve_peak, train_peak, grad_peak)
    check(peak <= UNEVEN_PEAK_LIMIT, f"{cfg.name} on {n_tp} ranks: peak {peak} bytes")
    del master, tparams
    gc.collect()
    torch.cuda.empty_cache()
    fields = dict(
        model=cfg.name, mesh=list(UNEVEN_MESH), layers=layers, d_model=D, heads=Hq,
        kv_heads=Hkv, head_ranges=[list(h) for h in heads],
        straddler=dict(rank=UNEVEN_STRADDLER,
                       runs=TP.q_runs(UNEVEN_STRADDLER, n_tp, Hq, Hkv),
                       calls=len(TP.attn_calls(UNEVEN_STRADDLER, n_tp, Hq, Hkv))),
        attention_calls_a_layer=calls, prompts=B, prompt_len=S, cache_len=L,
        cache_spec_k=run["spec_k"], decode_steps=n, prefill_s=run["prefill_s"],
        prefill_tokens_per_s=B * S / run["prefill_s"],
        decode_window_ms=run["decode_window_ms"], decode_ms_per_step=run["decode_window_ms"] / n,
        decode_ms_per_step_median=statistics.median(run["step_ms"]),
        prefill_collectives=run["prefill_collectives"],
        decode_collectives_16_steps=run["decode_collectives"],
        q_weight_bytes_moved=dict(prefill=run["prefill_moved"],
                                  decode_step={k: v / n for k, v in run["decode_moved"].items()},
                                  train_step=train_moved),
        q_weight_bytes_whole=dict(  # the training forward runs twice under remat
            prefill=whole_bytes, decode_step=whole_bytes,
            train_step=(2 if cfg.remat else 1) * UNEVEN_TRAIN_LAYERS * whole_bytes // layers),
        whole_weights_delivered=whole,
        prefill_flash_launches=run["prefill_launches"],
        prefill_flash_routes=run["prefill_routes"],
        decode_flash_launches=run["decode_launches"], decode_flash_routes=run["decode_routes"],
        logits_vs_one_device=agree, repeat_bit_equal=True, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
        train_layers=UNEVEN_TRAIN_LAYERS, train_step_s=step_s, train_loss=loss,
        train_gnorm=gnorm, one_device_loss=one_loss, train_rel=rel,
        one_device_gnorm=one_gnorm, gnorm_rel=gnorm_rel, gnorm_rtol=UNEVEN_GNORM_RTOL,
        bf16_grad_rel_l2=bf16_errs, bf16_bound=TRAIN_GRAD_REL_L2,
        f32_grad_rel_l2=f32_errs, f32_bound=SHARD_F32_GRAD_REL_L2,
        f32_loss_rel=f32_loss_rel, train_step_collectives=train_log,
        train_flash_launches=train_launches, train_flash_routes=train_routes,
        max_memory_allocated_bytes=dict(serve=serve_peak, train=train_peak,
                                        grad_checks=grad_peak),
        seconds=time.perf_counter() - t_phase, budget_s=UNEVEN_BUDGET_S)
    emit("scale_cut", what=f"{cfg.name} on {n_tp} model ranks: the training step's layers",
         layers=UNEVEN_TRAIN_LAYERS, layers_uncut=layers,
         why="the phase's budget; every layer has the same head layout")
    emit("uneven_tp_path", **fields)
    return dict(fields=fields, launches=dict(prefill=run["prefill_launches"],
                                             decode=run["decode_launches"]),
                train_launches=train_launches)


def phase_uneven_tp_kernel_times(uneven: dict, dev, peaks, errs: dict) -> list[dict]:
    """The flash kernels at each of uneven_tp_path's call shapes. Prefill
    (``mesh_flash_rows``): the 2 q heads over 1 kv head that 12 of the 14
    ranks with heads launch, and the straddling ranks' (3 and 10) 2 q heads
    over the 2 kv heads they read (group 1: their runs have one length, so
    one call), q (2, 2, 2048, 128), causal; and one sequence shard's decode
    call with its lse (q (2, 28, 1, 128): every head, gathered, over its
    129-position slice of the 2,064 kv positions of 4 heads). Training
    (``train_flash_rows``, the backward's rows): the same two head shapes
    at the step's B 2, S 2,048, each backward against ``attention_bwd_ref``
    and its forward's out and lse against ``attention_lse_ref``. Each row's
    ``launches`` is the kernel's count in the path's run;
    ``launches_of_this_call`` is that call's share by the head layout."""
    from collections import Counter
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import tensor_parallel as TP
    cfg = get_arch(UNEVEN_MODEL)
    n_dp, n_tp = UNEVEN_MESH
    shapes = Counter((hq.stop - hq.start, hk.stop - hk.start) for m in range(n_tp)
                     for hq, hk in TP.attn_calls(m, n_tp, cfg.n_heads, cfg.n_kv_heads))
    check(sorted(shapes.items()) == [((2, 1), 12), ((2, 2), 2)],
          f"{cfg.name}'s flash calls a layer by (q, kv) heads: {dict(shapes)}")
    tag = {(2, 1): "uneven_tp", (2, 2): "uneven_tp_straddle"}
    prefills = tuple((f"{tag[hs]}_prefill", *hs, cfg.n_layers * n_dp * c)
                     for hs, c in sorted(shapes.items()))
    rows = mesh_flash_rows(cfg, UNEVEN_MESH, UNEVEN_S, uneven["launches"], dev, peaks, errs,
                           (None, "uneven_tp_decode"), "qwen2-7b", prefills=prefills)
    bwd = uneven["train_launches"]["flash_attention_bwd"]
    for (hq, hk), c in sorted(shapes.items()):
        n_call = UNEVEN_TRAIN_LAYERS * n_dp * c
        rows += train_flash_rows(
            (PROMPTS // n_dp, hq, hk, UNEVEN_S, cfg.hd), dev, peaks, errs, f"{tag[hq, hk]}_train",
            f"qwen2-7b uneven tp training, {hq} q / {hk} kv heads",
            dict(backward=bwd), dict(backward=bwd), forward=False,
            launches_of_this_call=n_call)
    return rows


def phase_scan_sweep(dev, peaks, errs: dict) -> list[dict]:
    """``launch.roofline.streaming_vs_twopass(measure=True)`` on the card:
    the modeled bytes of the streaming and two-pass scans and both measured
    per table size N (B 128, d 128, k 16, every 64th row dead), the two
    bit-equal at each N, and the sweep's acceptance (at the largest N the
    two-pass score block exceeds the L2 and moves >= 2x the bytes). Launch
    counts are zeroed before and read after. Then the three kernels at the
    largest N, each against its plain version, timed beside it, one library
    call and the bound."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ops import _mask_rows
    from repro_torch.kernels.distance.ref import batched_scores_ref
    from repro_torch.kernels.parity import check_scores, check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.kernels.topk.kernel import topk_scores
    from repro_torch.kernels.topk.ref import topk_ref
    from repro_torch.launch.roofline import L2_BYTES, streaming_vs_twopass
    t0 = time.perf_counter()
    reset_launch_counts()
    sweep = streaming_vs_twopass(measure=True, device=dev)
    counts = launch_counts()
    for name in ("streaming_fused_scan", "batched_scores", "topk_scores"):
        check(counts[name] > 0, f"the scan sweep launched no {name}")
    check(all(r["measured"]["equal"] for r in sweep["sweep"]),
          "the two-pass scan differs from the streaming scan in the sweep")
    check(sweep["acceptance"]["ok"], f"scan sweep acceptance: {sweep['acceptance']}")
    emit("scan_sweep", B=sweep["B"], d=sweep["d"], k=sweep["k"], masked=sweep["masked"],
         l2_bytes=L2_BYTES, vmem_bytes=sweep["vmem_bytes"], acceptance=sweep["acceptance"],
         launches=counts, seconds=time.perf_counter() - t0,
         sweep=[{key: r[key] for key in ("n", "twopass_bytes", "streaming_bytes",
                                         "score_block_bytes", "hbm_ratio", "exceeds_vmem")}
                | {"streaming_ms": r["measured"]["streaming_ms"],
                   "twopass_ms": r["measured"]["twopass_ms"]} for r in sweep["sweep"]])
    # the largest N's operands, as _measure_scan_pair makes them
    B, d, k, N = sweep["B"], sweep["d"], sweep["k"], sweep["sweep"][-1]["n"]
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32), device=dev)
    db = torch.as_tensor(rng.standard_normal((N, d)).astype(np.float32), device=dev)
    dead = np.zeros(N, dtype=bool)
    dead[:: max(N // 64, 1)] = True
    kw = dict(valid_n=N - 1, dead_mask=torch.as_tensor(dead, device=dev))
    rows = []
    vals, ids = streaming_fused_scan(q, db, k=k, **kw)
    rvals, rids = streaming_fused_scan_ref(q, db, k, **kw)
    full = combined_plain_scores(q, db, "dot", kw)
    e, swaps = check_topk(vals, ids, rvals, rids, full, d, f"streaming at the sweep's N={N}")
    errs["streaming_fused_scan"] = max(errs["streaming_fused_scan"], e)
    nbytes, flops = 4 * (B * d + N * d) + N + 8 * B * k, 2.0 * B * N * d
    rows.append(table_row(
        "streaming_fused_scan[scan_sweep]", "cuda", "src/repro_torch/csrc/streaming.cu",
        "src/repro/kernels/streaming/kernel.py:44", counts["streaming_fused_scan"], e,
        cuda_ms(lambda: streaming_fused_scan(q, db, k=k, **kw)),
        cuda_ms(lambda: streaming_fused_scan_ref(q, db, k, **kw)),
        cuda_ms(lambda: torch.topk(_mask_rows(q @ db.T, N - 1, kw["dead_mask"]), k, dim=1)),
        bound(nbytes, flops, peaks), shape=[B, N, d, k], near_tie_swaps=swaps,
        library="matmul + mask + torch.topk"))
    scores = batched_scores(q, db)
    de = check_scores(scores, batched_scores_ref(q, db), d, f"distance at the sweep's N={N}")
    errs["batched_scores"] = max(errs["batched_scores"], de)
    nbytes = 4 * (B * d + N * d + B * N)
    rows.append(table_row(
        "batched_scores[scan_sweep]", "cuda", "src/repro_torch/csrc/distance.cu",
        "src/repro/kernels/distance/kernel.py:23", counts["batched_scores"], de,
        cuda_ms(lambda: batched_scores(q, db)), cuda_ms(lambda: batched_scores_ref(q, db)),
        cuda_ms(lambda: q @ db.T), bound(nbytes, flops, peaks), shape=[B, N, d],
        library="matmul"))
    masked = _mask_rows(scores, N - 1, kw["dead_mask"])
    tv, ti = topk_scores(masked, k)
    tr, tri = topk_ref(masked, k)
    check(torch.equal(tv, tr) and torch.equal(ti, tri), f"top-k differs at the sweep's N={N}")
    nbytes = 4 * B * N + 8 * B * k
    rows.append(table_row(
        "topk_scores[scan_sweep]", "cuda", "src/repro_torch/csrc/topk.cu",
        "src/repro/kernels/topk/kernel.py:42", counts["topk_scores"], 0.0,
        cuda_ms(lambda: topk_scores(masked, k)), cuda_ms(lambda: topk_ref(masked, k)),
        cuda_ms(lambda: torch.topk(masked, k, dim=1)), bound(nbytes, 0.0, peaks),
        shape=[B, N, k], library="torch.topk"))
    return rows


def phase_dryrun() -> None:
    """``launch.dryrun.run_cell`` on the meta 16 x 16 mesh for
    granite-moe-1b-a400m's decode_32k and prefill_32k cells (rank 0's
    counted FLOPs, bytes, memory, collectives and roofline, with the
    seconds to place and to count), then the counting pass over train_path's
    step on one device (granite-moe-1b-a400m, TRAIN_B x TRAIN_S, remat) on
    meta, its FLOPs beside train_path's analytic ``flops_per_step``."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.dryrun import abstract_params, count_step, run_cell
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step
    t0 = time.perf_counter()
    for shape in ("decode_32k", "prefill_32k"):
        rec = run_cell(TRAIN_MODEL, shape, False)
        check(rec["status"] == "ok", f"dry-run {TRAIN_MODEL} {shape}: {rec}")
        emit("dryrun_cell", arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
             status=rec["status"], lower_s=rec["lower_s"], count_s=rec["count_s"],
             cost=rec["cost"], memory=rec["memory"],
             collective_bytes=rec["collectives"]["total_bytes"],
             roofline={key: rec["roofline"][key] for key in
                       ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                        "useful_flops_ratio", "roofline_fraction")})
    cfg = get_arch(TRAIN_MODEL)
    params = abstract_params(cfg)
    batch = {"tokens": torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32, device="meta")}
    t1 = time.perf_counter()
    _, count = count_step(make_train_step(cfg), (params, adamw_init(params), batch), grad=True)
    count_s = time.perf_counter() - t1
    active = M.active_param_count(cfg, params)
    attn = 3 * 4.0 * TRAIN_B * cfg.n_heads * cfg.hd * kept_pairs(TRAIN_S, TRAIN_S, True, 0) \
        * cfg.n_layers
    analytic = 6.0 * active * TRAIN_B * TRAIN_S + attn
    check(math.isfinite(count["flops"]) and count["flops"] > 0, "counted train flops")
    emit("dryrun_train_count", model=cfg.name, batch=TRAIN_B, seq_len=TRAIN_S,
         remat=cfg.remat, counted_flops=count["flops"], counted_flash_flops=count["flash_flops"],
         counted_bytes=count["bytes"], analytic_flops_per_step=analytic,
         counted_over_analytic=count["flops"] / analytic, count_s=count_s,
         seconds=time.perf_counter() - t0)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=MAIN_ROWS,
                    help="rows of the main-path database (cut from the paper's "
                         "1,000,000 to keep the script in half its time limit; "
                         "the cut is printed)")
    ap.add_argument("--online-queries", type=int, default=ONLINE_QUERIES_CUT,
                    help="arrivals of the online path's traces (cut from 96 to make "
                         "room for the sharded training and serving phases; the cut "
                         "is printed)")
    ap.add_argument("--graph-rows", type=int, default=GRAPH_ROWS,
                    help="rows of the graph path's quickstart database (cut from "
                         "100,000 to make room for the mesh path; the cut is printed)")
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
                                    "flash_bwd", "flash")))
    peaks = card_peaks(card)
    errs = {"streaming_fused_scan": 0.0, "batched_scores": 0.0, "topk_scores": 0.0,
            "flash_attention": 0.0, "flash_attention_bwd": 0.0}
    try:
        phase_kernel_grid(dev, errs)
        phase_flash_grid(dev, errs)
        phase_flash_bwd_grid(dev, errs)
        if args.rows != MAIN_ROWS_UNCUT:
            emit("scale_cut", rows=args.rows, paper_rows=MAIN_ROWS_UNCUT,
                 why="half the time limit on a slow host (the host-bound MINT "
                     "phases scale with the rows)")
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
        del at
        gc.collect()
        mesh = phase_mesh_path(main_path, dev)
        rows += phase_mesh_kernel_times(mesh, peaks)
        del main_path, mesh  # the model needs the card's memory
        gc.collect()
        phase_cpu_vs_card()
        if args.graph_rows < GRAPH_ROWS_UNCUT:
            emit("scale_cut", graph_rows=args.graph_rows, graph_rows_uncut=GRAPH_ROWS_UNCUT,
                 why="room for mesh_path in the time limit (host-numpy kNN pools)")
        phase_graph_path(dev, args.graph_rows)
        model = phase_model_path(dev)
        del model["params"]
        rows += phase_flash_times(model, peaks, errs)
        del model
        families = phase_families_path(dev)
        rows += phase_family_flash_times(families, peaks, errs)
        del families
        phase_model_cpu_vs_card()
        t_train = time.perf_counter()
        train = phase_train_path(dev, peaks)
        rows += phase_train_kernel_time(train, dev, peaks, errs)
        phase_train_loop(dev)
        phase_train_cpu_vs_card()
        emit("train_phases_done", seconds=time.perf_counter() - t_train,
             budget_s=TRAIN_BUDGET_S)
        sharded = phase_sharded_train_path(dev, peaks)
        rows += phase_sharded_kernel_times(sharded, dev, peaks, errs)
        del sharded
        gc.collect()
        t_new = time.perf_counter()
        serve = phase_sharded_serve_path(dev, peaks)
        rows += phase_sharded_serve_kernel_times(serve, dev, peaks, errs)
        del serve
        ssm = phase_sharded_ssm_path(dev)
        rows += phase_sharded_ssm_kernel_times(ssm, dev, peaks, errs)
        del ssm
        uneven = phase_uneven_tp_path(dev, peaks)
        rows += phase_uneven_tp_kernel_times(uneven, dev, peaks, errs)
        del uneven
        rows += phase_scan_sweep(dev, peaks, errs)
        phase_dryrun()
        emit("serve_sweep_dryrun_done", seconds=time.perf_counter() - t_new,
             budget_s=SERVE_BUDGET_S)
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
