"""Batched plan executor — the single execution path for MINT plans.

Runs compiled plan groups (``serve.compiler``) over the device-resident
column store (``serve.columnstore``):

  - flat scans: ONE scan dispatch per (group, index) over the padded
    resident matrix — the one-pass streaming kernel by default, the
    two-pass distance + top-k kernels with ``streaming=False`` (or env
    ``REPRO_TWOPASS_SCAN=1``); both return identical (values, ids);
  - IVF: ONE batched centroid-scoring dispatch per (group, index) followed
    by a single gathered-row scoring pass over the padded probe union;
  - graph kinds (hnsw / diskann): per-query host walks (graph walks don't
    batch; ``counters.fallback``), but the rerank below still batches;
  - rerank: ONE distance-kernel dispatch per group over the candidate
    union, skipped on the single-exact-vid fast path — the same rule
    ``planner._plan_cost`` uses, so executed cost matches planned cost
    structurally. The union is built on the device as a row-membership
    mask and each query's top k is taken by the top-k kernel, so only
    (B, k) ids come back; a mutated table's stable-id union stays on the
    host.

ek buckets pad *dispatch shapes* only; each query slices its own exact ek
from the best-first results, so batched top-k ids are identical to the
per-query paths. Cost/recall accounting follows ``core.tuner.execute_plan``
exactly: cost = Σ dim(x)·numDist + dim(q)·Σ ek (Eq. 4-6, duplicates
counted), with wall time amortized over the group batch.

Mutations: with an ``ingest.MutationView`` attached, execution serves the
LIVE table instead of the frozen snapshot —

  - base scans thread the tombstone bitmap into the scan kernel's row mask
    (deleted rows can never win a top-k slot);
  - every index additionally brute-force scans the per-vid DELTA segment
    and merges base + delta candidates by partial score with the canonical
    (score desc, stable id asc) order — exactly the candidate list an
    index of the same kind would produce over a from-scratch rebuild
    whenever its candidate generation is exact (flat always; ANN kinds at
    exhaustive depth). On the streaming path a flat base + delta pair is
    ONE streaming-scan launch (the kernel's second row source); graph/IVF
    kinds and the two-pass path keep a separate delta dispatch;
  - all returned ids are STABLE item ids (``view.translate``), and the
    rerank gathers each union id from whichever side — base column or
    delta segment — physically holds it;
  - recall ground truth comes from ``view.ground_truth`` (exact top-k over
    live rows), not the frozen base.

Filtered search: with an ``filter.AttributeStore`` attached
(``attach_filters``), queries may carry a predicate and their plan an
access path —

  - ``pre``    gather exactly the matching live rows and score only those
               (one distance dispatch per side; wins at low selectivity);
  - ``masked`` full scan with the predicate's keep bitmap composed into
               the kernels' row masks (keep ∧ ¬dead in-register on the
               streaming path);
  - ``post``   the normal index probe at 1/selectivity-inflated eks with
               non-matching candidates score-killed before selection (flat
               specs push the keep mask into the kernel instead — exact at
               any depth, no escalation loop).

All three return the exact filtered top-k whenever their candidate
generation is exact, matching the unfiltered contract. Predicates with
ZERO live matches return empty results without launching any kernel.
Plan groups are predicate-uniform (``GroupKey.pred``), so the keep bitmap
is one shared (N,) operand per launch.

``cache_probe`` is the semantic cache's batched L2 probe: the streaming
scan at ``metric="l2"``, ``k=1`` over the cache's resident matrix.

Staged batches (DESIGN.md §10): ``stage_batch`` compiles a micro-batch and
enqueues its padded query uploads from pinned host buffers on the engine's
side stream, behind an event; ``search_batch(staged=...)`` on a worker
makes its own stream wait on that event, so the next batch's uploads
overlap the current batch's kernels and the submitting thread never blocks
on a pageable copy. The staged bytes are the ones the unstaged path
uploads, so results are bit-identical.

Mesh serving: with a ``launch.mesh.Mesh`` the column store holds each
column as per-rank row blocks and every flat scan is the distributed
tournament step (``search.distributed.make_search_step``): each shard runs
the streaming scan and only per-shard top-k candidates are merged, one
``scan`` dispatch however many shards. Tombstones and predicates ride its
sharded ``bad`` operand; a mutated table takes a masked base scan plus a
separate delta scan (the merged one-launch scan is single-device). Paths
that read whole rows (IVF probes, pre-filter gathers, the rerank) read each
from the shard that owns it (``_take``); none reads a whole-column tensor,
so a mesh over one repeated device runs the code a mesh of cards runs.
Queries and results stay on the mesh's home device.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.types import IndexSpec, Query, QueryPlan, Workload
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.distributed.collectives import take_rows
from repro_torch.distributed.sharding import row_sharding
from repro_torch.index.base import exact_topk
from repro_torch.kernels.common import NEG_INF, resolve_device
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ops import fused_scan
from repro_torch.kernels.streaming.ops import delta_id_offset, streaming_fused_scan
from repro_torch.kernels.topk.kernel import topk_scores
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import modeled_scan_bytes
from repro_torch.obs import NULL_OBSERVER
from repro_torch.search.distributed import make_search_step
from repro_torch.serve.columnstore import ColumnStore, DeviceColumn
from repro_torch.serve.compiler import PlanGroup, compile_batch

# the (B, R, d) gathered rows of one IVF scoring pass are cut into query
# slices of at most this many bytes, so a 64-query burst over a deep probe
# union does not hold every gathered row at once
_GATHER_BYTES = 1 << 30

# scores below this are masked tombstones / padding — never real candidates
_DEAD_CUT = NEG_INF / 2


@dataclass
class StagedBatch:
    """Pre-staged device state for one micro-batch.

    ``stage_batch`` compiles the plan groups and enqueues every padded
    query upload the batch will need WITHOUT running any kernel. On the
    card each upload is a ``non_blocking`` copy from a pinned host buffer
    on the engine's side stream, and ``ready`` is an event recorded after
    the last one; the executing stream waits on it before the first
    kernel. ``pinned`` keeps the host sources alive until then. qmats are
    advisory: execution revalidates each against the live column store's
    padded width and recomputes on mismatch (a store swap may land between
    staging and execution)."""

    n: int                                   # batch size staged for
    groups: list[PlanGroup]
    qmats: dict[tuple, torch.Tensor]         # (group_idx, slot) -> device qmat
    ready: object = None                     # torch.cuda.Event on the card
    pinned: list = field(default_factory=list)


@dataclass
class DispatchCounters:
    """Kernel-dispatch accounting: ``scan`` counts ONE per (group, index)
    batched dispatch (flat scan or IVF probe — a streaming base+delta
    merged launch is one ``scan``, its delta rides for free), ``delta``
    one per SEPARATE delta-segment dispatch (two-pass flat scans and
    graph/IVF kinds), ``rerank`` one per group needing the union rerank,
    ``fallback`` one per per-query graph search that could not be
    batched."""

    scan: int = 0
    delta: int = 0
    rerank: int = 0
    fallback: int = 0

    def reset(self) -> None:
        self.scan = self.delta = self.rerank = self.fallback = 0

    def as_dict(self) -> dict:
        return {"scan": self.scan, "delta": self.delta,
                "rerank": self.rerank, "fallback": self.fallback}


@dataclass
class _FilterState:
    """Evaluated predicate bitmaps for the CURRENT table state, cached per
    (predicate, attribute version, table version, base rows). ``base_keep``
    / ``delta_keep`` are host bool bitmaps over base / delta PHYSICAL rows
    (the delta bitmap follows the table's global delta-row order, which
    every vid's delta column shares); device copies are built once per
    padded length for the kernel keep-mask operands."""

    pred: object
    base_keep: np.ndarray
    delta_keep: np.ndarray | None
    n_match: int        # live rows matching (base + delta)
    n_match_base: int   # live BASE rows matching
    device: torch.device
    _dev: dict = field(default_factory=dict)

    def _padded(self, side: str, keep: np.ndarray | None,
                padded_n: int) -> torch.Tensor:
        key = (side, padded_n)
        if key not in self._dev:
            m = np.zeros(padded_n, dtype=bool)
            if keep is not None:
                m[: keep.shape[0]] = keep
            self._dev[key] = torch.as_tensor(m, device=self.device)
        return self._dev[key]

    def base_keep_dev(self, padded_n: int) -> torch.Tensor:
        return self._padded("base", self.base_keep, padded_n)

    def delta_keep_dev(self, padded_n: int) -> torch.Tensor:
        return self._padded("delta", self.delta_keep, padded_n)


def _gather_scores(take, rows: torch.Tensor, qmat: torch.Tensor) -> torch.Tensor:
    """Per-query gathered-row scoring: (B, R) int64 row ids, (B, d) ->
    (B, R); ``take`` maps an id tensor to its (..., d) rows. Plain PyTorch:
    the reference computes this outside any Pallas kernel."""
    B, R = rows.shape
    step = max(1, _GATHER_BYTES // max(R * qmat.shape[1] * 4, 1))
    return torch.cat([torch.einsum("brd,bd->br", take(rows[i:i + step]),
                                   qmat[i:i + step])
                      for i in range(0, B, step)])


def _f32_on(x, device: torch.device, name: str) -> torch.Tensor:
    """A float32 tensor on ``device``: a tensor already there is taken as it
    is (no copy), numpy is uploaded once; a tensor elsewhere or of another
    dtype raises rather than cross the bus unasked."""
    if isinstance(x, torch.Tensor):
        on = x.device.type == device.type and device.index in (None, x.device.index)
        if not on or x.dtype != torch.float32:
            raise ValueError(f"{name}: {x.dtype} tensor on {x.device}, expected "
                             f"torch.float32 on {device}")
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def cache_probe_scan(qmat, mat, valid_n: int, device=None, mat_sq=None):
    """Batched semantic-cache probe: ONE brute-force L2 dispatch of (B, d)
    query vectors against the cache's (C, d) query matrix — the streaming
    scan at ``metric="l2"``, ``k=1`` on the card, its plain version on the
    CPU. ``mat`` may be the cache's resident float32 tensor on ``device``
    (scanned in place) or host numpy; ``mat_sq``, its squared row norms kept
    beside it, spares the kernel that reduction. Returns host (vals, ids)
    with vals = -(squared L2); rows at or past ``valid_n`` are masked."""
    device = resolve_device(device)
    q = _f32_on(qmat, device, "qmat")
    m = _f32_on(mat, device, "mat")
    vals, ids = streaming_fused_scan(q, m, k=1, metric="l2", valid_n=int(valid_n),
                                     db_sq=mat_sq)
    return vals.cpu().numpy(), ids.cpu().numpy()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _StageClock:
    """One engine step's span and its stages, built only for an enabled
    observer. ``lap(name)`` ends a stage where the last one ended, so the
    stages tile the step; ``close(name, **attrs)`` hangs the step's span,
    its stages inside, under the current span (the group's). Every stage
    that touches the device ends in a copy to the host or, where its result
    stays on the device, a synchronisation of the stream, so a stage times
    the work, not its enqueue."""

    __slots__ = ("obs", "t0", "t", "laps")

    def __init__(self, obs):
        self.obs = obs
        self.t0 = self.t = obs.now()
        self.laps: list[tuple[str, float, float]] = []

    def lap(self, name: str) -> None:
        t = self.obs.now()
        self.laps.append((name, self.t, t))
        self.t = t

    def close(self, name: str, **attrs) -> None:
        obs = self.obs
        step = obs.span_at(name, self.t0, obs.now(), parent=obs.current(), **attrs)
        for stage, t0, t1 in self.laps:
            obs.span_at(stage, t0, t1, parent=step)


class BatchEngine:
    """Executes batches of (query, plan) pairs as compiled plan groups.

    ``store`` (an ``index.registry.IndexStore``) supplies materialized
    indexes; without one, every planned index is served as a device flat
    scan at its ek (the pure fused-kernel serving form). ``mesh`` switches
    flat scans to the distributed tournament step over row-sharded columns.
    """

    def __init__(self, db: MultiVectorDatabase, store=None,
                 cstore: ColumnStore | None = None, mesh=None,
                 axis: str = "data", streaming: bool | None = None,
                 observer=None, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.db = db
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.store = store
        self.mesh = mesh if mesh is not None else (cstore.mesh if cstore else None)
        self.axis = axis
        if cstore is not None:
            if cstore.mesh is not self.mesh:
                raise ValueError("the column store's mesh is not the engine's")
            self.device = cstore.torch_device
        elif self.mesh is not None:
            self.device = self.mesh.home
        elif store is not None and device is None:
            self.device = store.device
        else:
            self.device = resolve_device(device)
        self.cstore = cstore or ColumnStore(db, mesh=self.mesh, axis=axis,
                                            device=None if self.mesh else self.device)
        # single-launch streaming scan is the default; the two-pass path is
        # the reference oracle (streaming=False / REPRO_TWOPASS_SCAN=1)
        if streaming is None:
            streaming = os.environ.get("REPRO_TWOPASS_SCAN", "0") != "1"
        self.streaming = streaming
        self.counters = DispatchCounters()
        # groups whose rerank union was built on the device (``_device_rerank``)
        self.device_unions = 0
        self.mview = None  # ingest.MutationView when mutations flow
        # filtered search (attach_filters): attribute store + optional
        # selectivity estimator, and the per-predicate bitmap cache
        self.attrs = None
        self.selest = None
        self._filter_cache: dict[tuple, _FilterState] = {}
        self._stage_stream = None  # side CUDA stream of stage_batch, lazily

    # ---- public API -------------------------------------------------------

    def swap_store(self, store, cstore: ColumnStore | None = None,
                   db: MultiVectorDatabase | None = None) -> None:
        """Replace the index store (and optionally the column store and
        database, when the underlying table itself changed — e.g. a
        compaction folded delta segments into a new base)."""
        if cstore is not None and cstore.torch_device != self.device:
            raise ValueError(f"column store on {cstore.torch_device}, engine on "
                             f"{self.device}")
        if cstore is not None and cstore.mesh is not self.mesh:
            raise ValueError("the column store's mesh is not the engine's")
        self.store = store
        if cstore is not None:
            self.cstore = cstore
        if db is not None:
            self.db = db

    def attach_filters(self, attrs, selectivity=None) -> None:
        """Attach a ``filter.AttributeStore`` (and optionally a
        ``SelectivityEstimator``): queries carrying a ``predicate`` are
        served over exactly the live rows matching it. Without this call a
        filtered query raises — predicates are never silently ignored."""
        self.attrs = attrs
        self.selest = selectivity
        self._filter_cache.clear()

    def detach_filters(self) -> None:
        self.attrs = None
        self.selest = None
        self._filter_cache.clear()

    def attach_mutations(self, view) -> None:
        """Attach an ``ingest.MutationView`` (on this engine's device):
        scans mask tombstoned rows, delta segments are scanned and merged,
        and returned ids are STABLE item ids (identical to base physical
        rows until the first compaction rebases the table)."""
        if view.device != self.device:
            raise ValueError(f"mutation view on {view.device}, engine on "
                             f"{self.device}")
        self.mview = view

    def detach_mutations(self) -> None:
        self.mview = None

    def _mv(self):
        """The active mutation view, or None when the attached table is
        still bit-identical to the frozen snapshot (fast path)."""
        mv = self.mview
        return mv if mv is not None and mv.mutated() else None

    def stage_batch(self, pairs: list[tuple[Query, QueryPlan]]) -> StagedBatch:
        """Compile the batch and enqueue its host→device query uploads now
        (async flush pipelining). Pure staging: no kernel runs, no counter
        moves, no serving state changes — safe to call from the submitting
        thread while a worker executes the previous batch."""
        groups = compile_batch(pairs)
        host: dict[tuple, np.ndarray] = {}
        for gi, group in enumerate(groups):
            items = group.items
            if not group.specs:
                col = self.cstore.device(group.key.vid)
                host[(gi, -1)] = col.pad_host(
                    np.stack([it.query.concat() for it in items]))
                continue
            for j, spec in enumerate(group.specs):
                kind = spec.kind if self.store is not None else "flat"
                if kind in ("flat", "ivf"):
                    col = self.cstore.device(spec.vid)
                    host[(gi, j)] = col.pad_host(
                        np.stack([it.query.concat(spec.vid) for it in items]))
            if not group.single_exact:
                col = self.cstore.device(group.key.vid)
                host[(gi, "rerank")] = col.pad_host(
                    np.stack([it.query.concat() for it in items]))
        if self.device.type != "cuda":
            return StagedBatch(n=len(pairs), groups=groups, qmats={
                key: torch.as_tensor(arr, device=self.device)
                for key, arr in host.items()})
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        qmats, pinned = {}, []
        with torch.cuda.stream(self._stage_stream):
            for key, arr in host.items():
                src = torch.from_numpy(arr).pin_memory()
                dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                dst.copy_(src, non_blocking=True)
                qmats[key] = dst
                pinned.append(src)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return StagedBatch(n=len(pairs), groups=groups, qmats=qmats,
                           ready=ready, pinned=pinned)

    def _staged_groups(self, pairs, staged: StagedBatch | None):
        """(groups, per-group staged-qmat dicts) — falling back to a fresh
        compile when the staged batch doesn't match the pairs. On the card
        the executing thread's stream waits on the staging event, and each
        staged tensor is recorded on that stream so the caching allocator
        cannot hand its memory out before the kernels that read it end."""
        if staged is not None and staged.n == len(pairs):
            if staged.ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(staged.ready)
                for qmat in staged.qmats.values():
                    qmat.record_stream(stream)
            sqs = [{} for _ in staged.groups]
            for (gi, slot), qmat in staged.qmats.items():
                sqs[gi][slot] = qmat
            return staged.groups, sqs
        groups = compile_batch(pairs)
        return groups, [None] * len(groups)

    @staticmethod
    def _staged_qmat(sq, slot, col: DeviceColumn):
        """A staged qmat for this slot, if it still matches the live column
        store's padded width (a swap between staging and execution changes
        ``cstore``; values are recomputed then)."""
        if sq is None:
            return None
        qmat = sq.get(slot)
        if qmat is not None and qmat.shape[1] == col.padded_dim:
            return qmat
        return None

    def cache_probe(self, qmat, mat, valid_n, mat_sq=None):
        """Semantic-cache probe hook: one batched L2 dispatch of query
        vectors against the cache's query matrix on this engine's device
        (``cache_probe_scan``)."""
        return cache_probe_scan(qmat, mat, valid_n, device=self.device,
                                mat_sq=mat_sq)

    def ground_truth(self, query: Query) -> np.ndarray:
        """Exact top-k ids for one query against the LIVE serving state —
        the same oracle ``execute_batch`` uses per plan group (filtered /
        mutated / frozen branches)."""
        pred = getattr(query, "predicate", None)
        if pred is not None:
            return self._filtered_ground_truth(query, pred)
        mv = self._mv()
        if mv is not None:
            return mv.ground_truth(query)
        ids, _ = exact_topk(self.cstore.host(query.vid), query.concat(),
                            query.k)
        return ids

    def search_batch(self, pairs: list[tuple[Query, QueryPlan]],
                     staged: StagedBatch | None = None) -> list[np.ndarray]:
        """Serving form: top-k ids per query, in batch order."""
        out: list[np.ndarray | None] = [None] * len(pairs)
        groups, sqs = self._staged_groups(pairs, staged)
        for group, sq in zip(groups, sqs):
            ids_list, _, _, _ = self._observed_group(group, sq)
            for item, ids in zip(group.items, ids_list):
                out[item.pos] = ids
        return out  # type: ignore[return-value]

    def execute_batch(self, pairs: list[tuple[Query, QueryPlan]],
                      gt_cache: dict[int, np.ndarray] | None = None,
                      staged: StagedBatch | None = None) -> list:
        """Measurement form: ``ExecutionMetrics`` per query, batch order."""
        from repro_torch.core.tuner import ExecutionMetrics  # metrics stay in core
        out = [None] * len(pairs)
        groups, sqs = self._staged_groups(pairs, staged)
        for group, sq in zip(groups, sqs):
            t0 = time.perf_counter()
            ids_list, costs, ndists, eks_maps = self._observed_group(group, sq)
            wall = (time.perf_counter() - t0) * 1e3 / max(group.batch, 1)
            gts = self._group_ground_truth(group, gt_cache)
            for item, ids, cost, nd, eks, gt in zip(
                    group.items, ids_list, costs, ndists, eks_maps, gts):
                gtset = set(int(i) for i in gt)
                if gtset:
                    rec = len(gtset & set(int(i) for i in ids)) / len(gtset)
                else:  # empty oracle (zero-match predicate): empty is exact
                    rec = 1.0 if len(ids) == 0 else 0.0
                out[item.pos] = ExecutionMetrics(
                    item.query.qid, cost, wall, rec, nd, eks, ids=ids)
        return out

    def execute_workload(self, workload: Workload, result,
                         gt_cache: dict[int, np.ndarray] | None = None):
        from repro_torch.core.tuner import WorkloadMetrics
        pairs = [(q, result.plans[q.qid]) for q, _ in workload]
        metrics = self.execute_batch(pairs, gt_cache=gt_cache)
        wc = sum(p * m.cost for (_, p), m in zip(workload, metrics))
        ww = sum(p * m.wall_ms for (_, p), m in zip(workload, metrics))
        recalls = [m.recall for m in metrics]
        return WorkloadMetrics(
            per_query=metrics, weighted_cost=float(wc), weighted_wall_ms=float(ww),
            min_recall=min(recalls), mean_recall=float(np.mean(recalls)),
            storage=result.storage)

    def execute_plan_single(self, query: Query, plan: QueryPlan):
        """One-query convenience: (ids, cost)."""
        ids_list, costs, _, _ = self._run_group(
            compile_batch([(query, plan)])[0])
        return ids_list[0], costs[0]

    # ---- group execution --------------------------------------------------

    def _observed_group(self, group: PlanGroup, sq: dict | None = None):
        """``_run_group`` wrapped in a ``plan_group`` span carrying the plan
        signature, index kinds, batch size and modeled bytes; the span's
        parent accumulates the group bytes. The span ends after the group's
        results reached the host (every group ends in a ``.cpu()``), so it
        times the device work, not only its enqueue."""
        if not self.obs.enabled:
            return self._run_group(group, sq)
        attrs = self._group_attrs(group)
        with self.obs.span("plan_group", **attrs):
            out = self._run_group(group, sq)
        self.obs.counter("plan_groups")
        parent = self.obs.current()
        if parent is not None:
            parent.attrs["hbm_bytes_modeled"] = \
                parent.attrs.get("hbm_bytes_modeled", 0.0) + \
                attrs["hbm_bytes_modeled"]
        return out

    def _group_attrs(self, group: PlanGroup) -> dict:
        """Host-metadata-only attribution (never touches device state)."""
        B = len(group.items)
        N = int(self.db.n_rows)
        side = "streaming_bytes" if self.streaming else "twopass_bytes"
        kinds: list[str] = []
        plansig: list[tuple] = []
        hbm = 0.0
        if not group.specs:  # flat plan: one scan of the concat column
            kinds.append("flat")
            plansig.append(("flat", group.key.vid, group.max_k))
            d = int(self.db.dim(group.key.vid))
            hbm += modeled_scan_bytes(B, N, d, min(group.max_k, N))[side]
        for spec, bucket in zip(group.specs, group.buckets):
            kind = spec.kind if self.store is not None else "flat"
            kinds.append(kind)
            plansig.append((kind, spec.vid, int(bucket)))
            d = int(self.db.dim(spec.vid))
            k_eff = min(int(bucket), N)
            m = modeled_scan_bytes(B, N, d, k_eff)
            if kind == "flat":
                hbm += m[side]
            elif kind == "ivf":
                hbm += m["streaming_bytes"]
            else:  # graph walks gather per-visit candidate blocks
                hbm += float(B * k_eff * d * 4)
        return {"plan_sig": tuple(plansig), "index_kinds": tuple(kinds),
                "access": group.key.access, "batch": B, "rows": N,
                "hbm_bytes_modeled": float(hbm)}

    def _qmat(self, col: DeviceColumn, items, vid=None, sq=None,
              slot=None) -> torch.Tensor:
        """The group's padded (B, padded_dim) queries on the device: the
        staged upload for ``slot`` when one is valid, else a fresh one."""
        qmat = self._staged_qmat(sq, slot, col)
        if qmat is not None:
            return qmat
        return col.pad_queries(np.stack([it.query.concat(vid) for it in items]))

    def _run_group(self, group: PlanGroup, sq: dict | None = None):
        if group.key.pred is not None:
            return self._run_group_filtered(group, sq)
        specs, buckets = group.specs, group.buckets
        items = group.items
        B = len(items)
        costs = [0.0] * B
        ndists = [0] * B
        eks_maps: list[dict] = [{} for _ in range(B)]
        mv = self._mv()

        if not specs:  # flat-scan fallback group (no useful index / all ek=0)
            st = _StageClock(self.obs) if self.obs.enabled else None
            col = self.cstore.device(group.key.vid)
            qmat = self._qmat(col, items, sq=sq, slot=-1)
            out_ids = []
            if mv is None:
                ids = self._flat_scan(col, qmat, min(group.max_k, col.n_rows))
                for i, it in enumerate(items):
                    out_ids.append(ids[i, : min(it.query.k, col.n_rows)])
                    costs[i] = float(it.query.dim() * col.n_rows)
                    ndists[i] = col.n_rows
            else:
                # mutated table: base + delta merged exactly — ONE streaming
                # launch when available, else masked base scan + delta scan
                bs, bids, ds, dids, n_delta = self._scan_mv(
                    mv, col, qmat, group.key.vid, items, group.max_k)
                for i, it in enumerate(items):
                    k_i = min(it.query.k, mv.n_live)
                    out_ids.append(self._merge_scored(
                        bs[i], bids[i],
                        None if ds is None else ds[i],
                        None if ds is None else dids[i], k_i))
                    costs[i] = float(it.query.dim() * (col.n_rows + n_delta))
                    ndists[i] = col.n_rows + n_delta
            if st is not None:
                st.close("flat_scan", index=IndexSpec(group.key.vid, "flat").name)
            return out_ids, costs, ndists, eks_maps

        cand: list[list[np.ndarray]] = [[np.empty(0, np.int64)] * len(specs)
                                        for _ in range(B)]
        for j, (spec, bucket) in enumerate(zip(specs, buckets)):
            kind = spec.kind if self.store is not None else "flat"
            for i, it in enumerate(items):
                eks_maps[i][spec.name] = it.eks[j]
            # with mutations, every branch produces best-first SCORED
            # candidates (stable ids) instead of writing cand directly;
            # the delta merge below finalizes cand[i][j]. A streaming flat
            # scan folds the delta into its own launch (delta_merged).
            scored: list | None = [None] * B if mv is not None else None
            delta_merged = False
            if kind == "ivf":
                self._ivf_scan(group, spec, j, cand, costs, ndists,
                               mv=mv, scored=scored, sq=sq)
            elif kind == "flat":
                st = _StageClock(self.obs) if self.obs.enabled else None
                col = self.cstore.device(spec.vid)
                qmat = self._qmat(col, items, spec.vid, sq=sq, slot=j)
                if mv is None:
                    ids = self._flat_scan(col, qmat, min(bucket, col.n_rows))
                    for i, it in enumerate(items):
                        cand[i][j] = ids[i, : min(it.eks[j], col.n_rows)]
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                elif self.streaming and self.mesh is None:
                    # base + delta in ONE launch (kernel second source)
                    s, stable, n_dj = self._merged_scan_mv(
                        mv, col, qmat, spec.vid, bucket)
                    for i, it in enumerate(items):
                        scored[i] = (stable[i], s[i])
                        costs[i] += float(col.dim * (col.n_rows + n_dj))
                        ndists[i] += col.n_rows + n_dj
                    delta_merged = True
                else:
                    s, stable = self._base_scan_mv(
                        mv, col, qmat, min(bucket, col.n_rows))
                    for i, it in enumerate(items):
                        scored[i] = (stable[i], s[i])
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                if st is not None:
                    st.close("flat_scan", index=spec.name)
            else:  # graph kinds: sequential walks — per-query fallback
                idx = self.store.get(spec)
                for i, it in enumerate(items):
                    res = idx.search(it.query.concat(spec.vid), it.eks[j])
                    if mv is None:
                        cand[i][j] = res.ids
                    else:  # drop tombstoned walk results, go stable
                        alive = mv.table.base_alive[res.ids]
                        scored[i] = (mv.translate(res.ids[alive]),
                                     res.scores[alive])
                    costs[i] += float(idx.dim * res.num_dist)
                    ndists[i] += res.num_dist
                    self.counters.fallback += 1
            if mv is not None:
                self._finish_scored(mv, spec, items, bucket, j, scored, cand,
                                    costs, ndists, delta_merged)

        if group.single_exact:  # scan output is the full-score order already
            out_ids = [cand[i][0][: items[i].query.k] for i in range(B)]
            return out_ids, costs, ndists, eks_maps

        out_ids = self._rerank(group, cand, mv=mv, sq=sq)
        for i, it in enumerate(items):
            total_ek = int(sum(it.eks))  # duplicates counted — Eq. 6
            costs[i] += float(it.query.dim() * total_ek)
            ndists[i] += total_ek
        return out_ids, costs, ndists, eks_maps

    def _finish_scored(self, mv, spec, items, bucket, j, scored, cand, costs,
                       ndists, delta_merged, fstate=None) -> None:
        """Finalize cand[i][j] from each query's scored (stable ids, scores):
        a one-launch scan already holds the delta; every other branch merges
        a separate delta-segment scan in, charging its rows."""
        if delta_merged:
            for i, it in enumerate(items):
                sids, s = scored[i]
                cand[i][j] = self._merge_scored(s, sids, None, None, it.eks[j])
            return
        ds, dids, n_delta = (self._delta_scan(mv, spec.vid, items, bucket,
                                              fstate=fstate)
                             if mv is not None else (None, None, 0))
        for i, it in enumerate(items):
            sids, s = scored[i]
            cand[i][j] = self._merge_scored(
                s, sids, None if ds is None else ds[i],
                None if ds is None else dids[i], it.eks[j])
            if n_delta:
                d = self.db.dim(spec.vid)
                costs[i] += float(d * n_delta)
                ndists[i] += n_delta

    def _scan_mv(self, mv, col, qmat, vid, items, depth, fstate=None):
        """Scored base + delta candidates of a flat fallback scan: ONE
        merged launch on the streaming path -> (s, ids, None, None,
        n_delta), else (two-pass, or a mesh) a masked base scan and a
        separate delta scan -> (bs, bids, ds, dids, n_delta)."""
        if self.streaming and self.mesh is None:
            s, ids, n_delta = self._merged_scan_mv(mv, col, qmat, vid, depth,
                                                   fstate=fstate)
            return s, ids, None, None, n_delta
        bs, bids = self._base_scan_mv(mv, col, qmat, min(depth, col.n_rows),
                                      fstate=fstate)
        ds, dids, n_delta = self._delta_scan(mv, vid, items, depth, fstate=fstate)
        return bs, bids, ds, dids, n_delta

    # ---- filtered execution -----------------------------------------------

    def _filter_state(self, pred) -> _FilterState:
        """Evaluate (or fetch) the predicate's bitmaps for the current
        table state. Keyed by (pred, attribute version, table version,
        base rows), so attribute writes, mutations, compaction rebases and
        store swaps all invalidate naturally."""
        attrs = self.attrs
        mv = self._mv()
        tver = -1 if mv is None else mv.table.version
        key = (pred, attrs.version, tver, self.db.n_rows)
        st = self._filter_cache.get(key)
        if st is not None:
            return st
        if mv is None:
            base_keep = attrs.bitmap(pred, np.arange(self.db.n_rows))
            delta_keep = None
            n_match_base = int(base_keep.sum())
            n_match = n_match_base
        else:
            t = mv.table
            base_keep = attrs.bitmap(pred, t.base_ids)
            n_match_base = int((base_keep & t.base_alive).sum())
            n_match = n_match_base
            delta_keep = None
            if t.n_delta:
                delta_keep = attrs.bitmap(pred, t.delta_ids_arr())
                n_match += int((delta_keep & t.delta_alive_arr()).sum())
        st = _FilterState(pred, base_keep, delta_keep, n_match, n_match_base,
                          self.device)
        if len(self._filter_cache) > 128:
            self._filter_cache.clear()
        self._filter_cache[key] = st
        return st

    def _run_group_filtered(self, group: PlanGroup, sq: dict | None = None):
        if self.attrs is None:
            raise ValueError(
                "query carries a predicate but no AttributeStore is "
                "attached (BatchEngine.attach_filters) — refusing to "
                "silently ignore the filter")
        fs = self._filter_state(group.key.pred)
        B = len(group.items)
        if fs.n_match == 0:
            # zero-match guard: empty top-k, NO kernel launch (an
            # all-masked launch surfaces NEG_INF sentinels as hits).
            # Covers every access path and index kind — the bitmap is the
            # only work done.
            return ([np.empty(0, np.int64) for _ in range(B)],
                    [0.0] * B, [0] * B, [{} for _ in range(B)])
        if group.key.access == "pre":
            return self._prefilter_group(group, fs, sq)
        return self._masked_group(group, fs, sq)

    def _gathered_scores(self, col: DeviceColumn, qmat: torch.Tensor,
                         phys) -> torch.Tensor:
        """Distance-kernel scores of ``qmat`` against the gathered rows
        ``phys`` (host ids, or an id tensor on the device) of ``col`` ->
        (B, len(phys)), left on the device."""
        if not isinstance(phys, torch.Tensor):
            phys = torch.as_tensor(phys.astype(np.int64), device=self.device)
        return self._batched_scores(qmat, self._take(col, phys))

    def _prefilter_group(self, group: PlanGroup, fs: _FilterState,
                         sq: dict | None = None):
        """Pre-filter access path: gather exactly the matching LIVE rows
        (base side + delta side) and score only those — cost
        dim(q)·|match|, no index involved. Exact by construction: the
        candidate set IS the filtered row set."""
        items = group.items
        B = len(items)
        costs = [0.0] * B
        ndists = [0] * B
        eks_maps: list[dict] = [{} for _ in range(B)]
        vid = group.key.vid
        col = self.cstore.device(vid)
        qmat = self._qmat(col, items, sq=sq, slot=-1)
        mv = self._mv()
        parts_s: list[np.ndarray] = []
        parts_ids: list[np.ndarray] = []
        if mv is None:
            bphys = np.nonzero(fs.base_keep)[0]
            if bphys.size:
                parts_s.append(_host(self._gathered_scores(col, qmat, bphys)))
                parts_ids.append(bphys.astype(np.int64))
                self.counters.scan += 1
        else:
            t = mv.table
            bphys = np.nonzero(fs.base_keep & t.base_alive)[0]
            if bphys.size:
                parts_s.append(_host(self._gathered_scores(col, qmat, bphys)))
                parts_ids.append(mv.translate(bphys))
                self.counters.scan += 1
            if fs.delta_keep is not None:
                dphys = np.nonzero(fs.delta_keep & t.delta_alive_arr())[0]
                if dphys.size:
                    dcol = mv.delta(vid)
                    qd = self._qmat(dcol.col, items)
                    parts_s.append(_host(self._gathered_scores(dcol.col, qd, dphys)))
                    parts_ids.append(dcol.ids[dphys])
                    self.counters.delta += 1
        scores = np.concatenate(parts_s, axis=1)
        stable = np.concatenate(parts_ids)
        m = int(stable.shape[0])
        out_ids = []
        for i, it in enumerate(items):
            s = scores[i]
            order = np.lexsort((stable, -s))[: min(it.query.k, m)]
            out_ids.append(stable[order].astype(np.int64))
            costs[i] = float(it.query.dim() * m)
            ndists[i] = m
        return out_ids, costs, ndists, eks_maps

    def _masked_group(self, group: PlanGroup, fs: _FilterState,
                      sq: dict | None = None):
        """Masked / post-filter access paths. Flat scans (including the
        no-spec fallback) push the keep bitmap into the kernel row mask
        (keep ∧ ¬dead in-register), so they are exact at any depth ≥ k —
        the "post" access differs only in planned dispatch depth. IVF
        probes score-kill non-matching rows before selection; graph walks
        filter their results; delta segments are keep-masked the same way
        as the base."""
        specs, buckets = group.specs, group.buckets
        items = group.items
        B = len(items)
        costs = [0.0] * B
        ndists = [0] * B
        eks_maps: list[dict] = [{} for _ in range(B)]
        mv = self._mv()

        if not specs:  # keep-masked flat fallback scan
            st = _StageClock(self.obs) if self.obs.enabled else None
            col = self.cstore.device(group.key.vid)
            qmat = self._qmat(col, items, sq=sq, slot=-1)
            out_ids = []
            if mv is None:
                s, ids = self._filtered_flat_scan(
                    col, qmat, min(group.max_k, col.n_rows), fs)
                for i, it in enumerate(items):
                    out_ids.append(self._merge_scored(
                        s[i], ids[i].astype(np.int64), None, None,
                        min(it.query.k, fs.n_match)))
                    costs[i] = float(it.query.dim() * col.n_rows)
                    ndists[i] = col.n_rows
            else:
                bs, bids, ds, dids, n_delta = self._scan_mv(
                    mv, col, qmat, group.key.vid, items, group.max_k, fstate=fs)
                for i, it in enumerate(items):
                    k_i = min(it.query.k, fs.n_match)
                    out_ids.append(self._merge_scored(
                        bs[i], bids[i],
                        None if ds is None else ds[i],
                        None if ds is None else dids[i], k_i))
                    costs[i] = float(it.query.dim() * (col.n_rows + n_delta))
                    ndists[i] = col.n_rows + n_delta
            if st is not None:
                st.close("flat_scan", index=IndexSpec(group.key.vid, "flat").name)
            return out_ids, costs, ndists, eks_maps

        cand: list[list[np.ndarray]] = [[np.empty(0, np.int64)] * len(specs)
                                        for _ in range(B)]
        for j, (spec, bucket) in enumerate(zip(specs, buckets)):
            kind = spec.kind if self.store is not None else "flat"
            for i, it in enumerate(items):
                eks_maps[i][spec.name] = it.eks[j]
            # every branch yields best-first (stable ids, scores) of
            # MATCHING candidates only; the delta merge finalizes cand
            scored: list = [None] * B
            delta_merged = False
            if kind == "ivf":
                self._ivf_scan(group, spec, j, cand, costs, ndists,
                               mv=mv, scored=scored, sq=sq, fstate=fs)
            elif kind == "flat":
                st = _StageClock(self.obs) if self.obs.enabled else None
                col = self.cstore.device(spec.vid)
                qmat = self._qmat(col, items, spec.vid, sq=sq, slot=j)
                if mv is None:
                    s, ids = self._filtered_flat_scan(
                        col, qmat, min(bucket, col.n_rows), fs)
                    for i, it in enumerate(items):
                        scored[i] = (ids[i].astype(np.int64), s[i])
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                elif self.streaming and self.mesh is None:
                    s, stable, n_dj = self._merged_scan_mv(
                        mv, col, qmat, spec.vid, bucket, fstate=fs)
                    for i, it in enumerate(items):
                        scored[i] = (stable[i], s[i])
                        costs[i] += float(col.dim * (col.n_rows + n_dj))
                        ndists[i] += col.n_rows + n_dj
                    delta_merged = True
                else:
                    s, stable = self._base_scan_mv(
                        mv, col, qmat, min(bucket, col.n_rows), fstate=fs)
                    for i, it in enumerate(items):
                        scored[i] = (stable[i], s[i])
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                if st is not None:
                    st.close("flat_scan", index=spec.name)
            else:  # graph kinds: walk, then drop non-matching/dead results
                idx = self.store.get(spec)
                for i, it in enumerate(items):
                    res = idx.search(it.query.concat(spec.vid), it.eks[j])
                    ok = fs.base_keep[res.ids]
                    if mv is not None:
                        ok = ok & mv.table.base_alive[res.ids]
                    rows = res.ids[ok]
                    stable = (mv.translate(rows) if mv is not None
                              else rows.astype(np.int64))
                    scored[i] = (stable, res.scores[ok])
                    costs[i] += float(idx.dim * res.num_dist)
                    ndists[i] += res.num_dist
                    self.counters.fallback += 1
            self._finish_scored(mv, spec, items, bucket, j, scored, cand,
                                costs, ndists, delta_merged, fstate=fs)

        if group.single_exact:
            out_ids = [cand[i][0][: items[i].query.k] for i in range(B)]
            return out_ids, costs, ndists, eks_maps

        out_ids = self._rerank(group, cand, mv=mv, sq=sq)
        for i, it in enumerate(items):
            total_ek = int(sum(it.eks))
            costs[i] += float(it.query.dim() * total_ek)
            ndists[i] += total_ek
        return out_ids, costs, ndists, eks_maps

    def _filtered_flat_scan(self, col: DeviceColumn, qmat: torch.Tensor,
                            depth: int, fs: _FilterState
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Keep-masked flat scan over an unmutated base: the kernels get the
        device keep bitmap. Returns (scores, physical ids), best-first."""
        return self._flat_scan_scored(
            col, qmat, depth,
            keep_mask=fs.base_keep_dev(col.padded_rows))

    def _filtered_ground_truth(self, query: Query, pred) -> np.ndarray:
        """Brute-force oracle: exact top-k over exactly the live rows
        matching the predicate (canonical score desc, stable id asc
        order) — the bit-identity target for every access path."""
        fs = self._filter_state(pred)
        mv = self._mv()
        qvec = query.concat()
        if mv is None:
            data = self.cstore.host(query.vid)
            rows = np.nonzero(fs.base_keep)[0]
            s = data[rows] @ qvec
            order = np.lexsort((rows, -s))
            return rows[order][: min(query.k, rows.size)].astype(np.int64)
        t = mv.table
        ids_parts: list[np.ndarray] = []
        s_parts: list[np.ndarray] = []
        bphys = np.nonzero(fs.base_keep & t.base_alive)[0]
        if bphys.size:
            base = t.base.concat(query.vid)
            ids_parts.append(mv.translate(bphys))
            s_parts.append(base[bphys] @ qvec)
        if fs.delta_keep is not None:
            dphys = np.nonzero(fs.delta_keep & t.delta_alive_arr())[0]
            if dphys.size:
                dmat = t.delta_concat(query.vid)
                ids_parts.append(t.delta_ids_arr()[dphys])
                s_parts.append(dmat[dphys] @ qvec)
        if not ids_parts:
            return np.empty(0, np.int64)
        ids = np.concatenate(ids_parts)
        s = np.concatenate(s_parts)
        order = np.lexsort((ids, -s))
        return ids[order][: min(query.k, ids.size)].astype(np.int64)

    # ---- dispatches ---------------------------------------------------------

    def _batched_scores(self, qmat: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
        """One batched scoring dispatch (the distance kernel on the card, its
        plain version on the CPU) -> (B, N) scores, left on the device."""
        return batched_scores(qmat, sub)

    def _flat_scan(self, col: DeviceColumn, qmat: torch.Tensor, k: int) -> np.ndarray:
        return self._flat_scan_scored(col, qmat, k)[1]

    def _shards(self, col: DeviceColumn) -> list[torch.Tensor]:
        """``col``'s per-rank row blocks: a mesh column's own, or those of a
        single-device one (a delta segment), cut once per layout and kept
        with the column (a new table version brings a new column)."""
        if col.shards is not None:
            return col.shards
        return col.cut(row_sharding(self.mesh, self.axis))

    def _take(self, col: DeviceColumn, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (any shape) of ``col`` -> (*ids.shape, padded_dim) on
        the engine's device; under a mesh each row comes from its owner."""
        if self.mesh is None:
            return col.data[ids]
        return take_rows(self._shards(col), ids, self.device)

    def _flat_scan_scored(self, col: DeviceColumn, qmat: torch.Tensor, k: int,
                          dead_mask=None, keep_mask=None,
                          counter: str = "scan"
                          ) -> tuple[np.ndarray, np.ndarray]:
        """One batched flat dispatch -> host (scores, ids), best-first. The
        tombstone ``dead_mask`` and the predicate ``keep_mask`` are threaded
        into the kernel row mask — and, under a mesh, composed into the
        distributed step's sharded ``bad`` operand — so masked rows come back
        at NEG_INF (id 0) and are dropped by the merge on every path."""
        setattr(self.counters, counter, getattr(self.counters, counter) + 1)
        if self.mesh is not None:
            bad = None
            if dead_mask is not None or keep_mask is not None:
                # tombstones OR not-kept: the reference's max(dead, 1 - keep)
                # over {0, 1}, one (padded rows,) bool row bitmap
                bad = torch.zeros(col.padded_rows, dtype=torch.bool, device=self.device)
                if dead_mask is not None:
                    bad |= dead_mask.to(torch.bool)
                if keep_mask is not None:
                    bad |= ~keep_mask.to(torch.bool)
            step = make_search_step(self.mesh, k=k, axis=self.axis,
                                    valid_n=col.n_rows, masked=bad is not None)
            shards = self._shards(col)
            vals, ids = step(shards, qmat, bad) if bad is not None else step(shards, qmat)
        elif self.streaming:
            vals, ids = streaming_fused_scan(
                qmat, col.data, k=min(k, col.n_rows), valid_n=col.n_rows,
                dead_mask=dead_mask, keep_mask=keep_mask)
        else:
            vals, ids = fused_scan(qmat, col.data, k=k, valid_n=col.n_rows,
                                   dead_mask=dead_mask, keep_mask=keep_mask)
        return _host(vals), _host(ids)

    # ---- mutation-aware scanning (ingest) ---------------------------------

    def _base_scan_mv(self, mv, col: DeviceColumn, qmat: torch.Tensor,
                      depth: int, fstate: _FilterState | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Masked base scan under mutations -> (scores, STABLE ids).
        Tombstones ∪ non-matching rows ride the kernel row mask, so every
        path returns the exact alive (and matching) top-``depth``."""
        dead = mv.base_dead_mask(col.padded_rows)
        keep = None if fstate is None else fstate.base_keep_dev(col.padded_rows)
        s, ids = self._flat_scan_scored(col, qmat, min(depth, col.n_rows),
                                        dead_mask=dead, keep_mask=keep)
        return s, mv.translate(ids)

    def _delta_scan(self, mv, vid, items, depth: int,
                    fstate: _FilterState | None = None):
        """Brute-force delta-segment scan for one (group, index): one
        batched dispatch over the padded delta matrix -> (scores, STABLE
        ids, n_delta_rows); (None, None, 0) when the table has no delta.
        Tombstone and predicate masks ride the dispatch."""
        dcol = mv.delta(vid)
        if dcol is None:
            return None, None, 0
        qmat = self._qmat(dcol.col, items, vid)
        k_eff = min(depth, dcol.n_rows)
        keep = None
        if fstate is not None:
            keep = fstate.delta_keep_dev(dcol.col.padded_rows)
        s, ids = self._flat_scan_scored(dcol.col, qmat, k_eff,
                                        dead_mask=dcol.dead_mask,
                                        keep_mask=keep, counter="delta")
        return s, dcol.ids[ids], dcol.n_rows

    def _merged_scan_mv(self, mv, col: DeviceColumn, qmat: torch.Tensor,
                        vid, depth: int, fstate: _FilterState | None = None):
        """ONE streaming-scan launch over base + delta: the delta segment
        rides the kernel's second row source, tombstones (and the
        predicate's keep bitmap) on both sides are masked in-register, and
        the merged best-first candidates come back without a score matrix
        or a separate delta dispatch. Returns (scores, STABLE ids,
        n_delta_rows) with the same contract as a ``_base_scan_mv`` +
        ``_delta_scan`` pair already merged; callers finalize with
        ``_merge_scored``. Requires the streaming path and no mesh."""
        dcol = mv.delta(vid)
        base_pad_rows = col.padded_rows
        dead = mv.base_dead_mask(base_pad_rows)
        bkeep = None if fstate is None else fstate.base_keep_dev(base_pad_rows)
        if dcol is None:  # no delta rows: plain masked base scan
            s, ids = self._flat_scan_scored(col, qmat, min(depth, col.n_rows),
                                            dead_mask=dead, keep_mask=bkeep)
            return s, mv.translate(ids), 0
        dkeep = (None if fstate is None
                 else fstate.delta_keep_dev(dcol.col.padded_rows))
        self.counters.scan += 1
        k_eff = min(depth, col.n_rows + dcol.n_rows)
        vals, ids = streaming_fused_scan(
            qmat, col.data, k=k_eff, valid_n=col.n_rows, dead_mask=dead,
            delta=dcol.col.data, delta_valid_n=dcol.n_rows,
            delta_dead_mask=dcol.dead_mask, keep_mask=bkeep,
            delta_keep_mask=dkeep)
        vals, ids = _host(vals), _host(ids)
        # combined-physical ids -> stable: the kernel numbers delta rows
        # after the base rows rounded up to its id block; the column store
        # pads rows to a multiple of that block, so the two rules agree
        if delta_id_offset(base_pad_rows) != base_pad_rows:
            raise RuntimeError(
                f"base column of {base_pad_rows} padded rows is not a multiple "
                "of the scan's delta id block: merged ids would be misread")
        stable = np.empty(ids.shape, dtype=np.int64)
        on_base = ids < base_pad_rows
        stable[on_base] = mv.translate(ids[on_base])
        stable[~on_base] = dcol.ids[ids[~on_base] - base_pad_rows]
        return vals, stable, dcol.n_rows

    @staticmethod
    def _merge_scored(s_base, ids_base, s_delta, ids_delta, k: int) -> np.ndarray:
        """Best-first merge of scored candidate lists in the canonical
        rebuild order — score desc, stable id asc (a materialized rebuild
        lays rows out by ascending stable id, so its scan breaks ties the
        same way). Masked tombstones/padding (NEG_INF) are dropped."""
        if s_delta is not None:
            s = np.concatenate([s_base, s_delta])
            ids = np.concatenate([ids_base, ids_delta])
        else:
            s, ids = s_base, ids_base
        keep = s > _DEAD_CUT
        s, ids = s[keep], ids[keep]
        order = np.lexsort((ids, -s))[:k]
        return ids[order].astype(np.int64)

    def _ivf_scan(self, group: PlanGroup, spec, j: int, cand, costs, ndists,
                  mv=None, scored=None, sq: dict | None = None,
                  fstate: _FilterState | None = None):
        """Batched IVF probe: one centroid-scoring dispatch for the whole
        group, then one gathered-row scoring pass over the padded probe
        union. Per-query nprobe / top-ek use each query's ACTUAL ek so the
        results match ``IVFFlatIndex.search`` exactly. Under mutations
        (``mv``), tombstoned rows are score-killed before selection and the
        surviving candidates land in ``scored`` as (stable ids, scores) for
        the delta merge; under a predicate (``fstate``) non-matching probe
        rows are score-killed the same way.

        Observed, the scan is an ``ivf_scan`` span (the index, and the
        lists, rows and ek summed over the group's queries) holding its
        stages: ``ivf_centroids`` (centroid scoring and its copy back),
        ``ivf_probe`` (each query's lists and probed rows, on the host),
        ``ivf_gather`` (the probed rows' scores and their copy back) and
        ``ivf_select`` (each query's top ek, on the host)."""
        st = _StageClock(self.obs) if self.obs.enabled else None
        idx = self.store.get(spec)
        items = group.items
        col = self.cstore.device(spec.vid)
        qmat = self._qmat(col, items, spec.vid, sq=sq, slot=j)
        cent = np.asarray(idx.centroids, dtype=np.float32)
        if col.padded_dim != cent.shape[1]:
            cent = np.pad(cent, ((0, 0), (0, col.padded_dim - cent.shape[1])))
        csims = _host(self._batched_scores(qmat, torch.as_tensor(cent, device=self.device)))
        self.counters.scan += 1
        if st is not None:
            st.lap("ivf_centroids")

        rows_list = []
        for i, it in enumerate(items):
            nprobe = idx._nprobe_for(it.eks[j])
            probe = np.argsort(-csims[i], kind="stable")[:nprobe]
            rows = np.concatenate([
                idx.row_ids[idx.offsets[p]:idx.offsets[p + 1]] for p in probe
            ]) if nprobe else np.empty(0, dtype=np.int64)
            rows_list.append(rows)
            costs[i] += float(idx.dim * (idx.n_lists + rows.shape[0]))
            ndists[i] += idx.n_lists + int(rows.shape[0])

        R = max(max((r.shape[0] for r in rows_list), default=1), 1)
        rows_mat = np.zeros((len(items), R), dtype=np.int64)
        for i, rows in enumerate(rows_list):
            rows_mat[i, : rows.shape[0]] = rows
        if st is not None:
            st.lap("ivf_probe")
        scores = _host(_gather_scores(
            lambda ids: self._take(col, ids),
            torch.as_tensor(rows_mat, device=self.device), qmat))
        if st is not None:
            st.lap("ivf_gather")
        for i, (it, rows) in enumerate(zip(items, rows_list)):
            if rows.shape[0] == 0:
                if scored is not None:
                    scored[i] = (np.empty(0, np.int64), np.empty(0, np.float32))
                else:
                    cand[i][j] = np.empty(0, np.int64)
                continue
            s = scores[i, : rows.shape[0]]
            ok = None
            if mv is not None:  # tombstones: dead probe rows never rank
                ok = mv.table.base_alive[rows]
            if fstate is not None:  # predicate: non-matching rows neither
                keep_rows = fstate.base_keep[rows]
                ok = keep_rows if ok is None else ok & keep_rows
            if ok is not None:
                s = np.where(ok, s, NEG_INF).astype(np.float32)
            ek = min(it.eks[j], rows.shape[0])
            part = np.argpartition(-s, ek - 1)[:ek]
            order = np.argsort(-s[part], kind="stable")
            sel = part[order]
            if scored is not None:
                keep = s[sel] > _DEAD_CUT
                srows = rows[sel][keep]
                stable = (mv.translate(srows) if mv is not None
                          else srows.astype(np.int64))
                scored[i] = (stable, s[sel][keep])
            else:
                cand[i][j] = rows[sel]
        if st is not None:
            st.lap("ivf_select")
            st.close("ivf_scan", index=spec.name,
                     lists=sum(idx._nprobe_for(it.eks[j]) for it in items),
                     rows=sum(int(r.shape[0]) for r in rows_list),
                     ek=sum(min(it.eks[j], int(r.shape[0]))
                            for it, r in zip(items, rows_list)))

    def _rerank(self, group: PlanGroup, cand, mv=None,
                sq: dict | None = None) -> list[np.ndarray]:
        """Full-score rerank over each query's candidate union, batched as
        ONE distance-kernel dispatch over the group-wide union; each query
        keeps its best k by score, equal scores by ascending id. An
        unmutated table's union is built and ordered on the device
        (``_device_rerank``); a mutated table's holds stable ids that span
        base and delta, and is built and ordered on the host
        (``_host_rerank``).

        Observed, the rerank is a ``rerank`` span (the group's union,
        ``cand``, its candidates counted before de-duplication, and
        ``union_on``, ``"device"`` or ``"host"``) holding its stages
        ``rerank_union``, ``rerank_score`` and ``rerank_order``."""
        st = _StageClock(self.obs) if self.obs.enabled else None
        if mv is None:
            out, n_union = self._device_rerank(group, cand, st, sq)
        else:
            out, n_union = self._host_rerank(group, cand, mv, st, sq)
        if st is not None:
            st.close("rerank", batch=len(group.items), union=n_union,
                     cand=sum(int(c.shape[0]) for row in cand for c in row),
                     union_on="device" if mv is None else "host")
        return out

    def _device_rerank(self, group: PlanGroup, cand, st, sq
                       ) -> tuple[list[np.ndarray], int]:
        """The rerank of base row ids, on the device: the group's candidates
        go up in one copy and are scattered into a (B, rows) membership
        mask, where duplicates across indexes collapse without a sort; the
        group's union is the mask's nonzero columns, in ascending id order.
        Each query's scores over that union, its non-members masked, are
        ordered by the top-k kernel (ties by ascending position, so by
        ascending id), and only the (B, k) ids come back.

        Stages: ``rerank_union`` (the upload, the scatter and the
        ``nonzero``, which waits for them), ``rerank_score`` (the union's
        rows and their scores) and ``rerank_order`` (mask, top-k, the copy
        back). Returns (each query's ids, the union's size)."""
        items = group.items
        B = len(items)
        col = self.cstore.device(group.key.vid)
        N = col.n_rows
        total = sum(int(c.shape[0]) for row in cand for c in row)
        if total == 0:
            if st is not None:
                st.lap("rerank_union")
            return [np.empty(0, np.int64) for _ in items], 0
        # query i's ids as flat positions i * N + id of the row-major mask
        flat = np.empty(total, np.int32 if B * N < 2 ** 31 else np.int64)
        o = 0
        for i, row in enumerate(cand):
            for c in row:
                np.add(c, np.int64(i * N), out=flat[o:o + c.shape[0]],
                       casting="unsafe")
                o += c.shape[0]
        mask = torch.zeros(B * N, dtype=torch.bool, device=self.device)
        mask[torch.from_numpy(flat).to(self.device)] = True
        mask = mask.view(B, N)
        gunion = (mask[0] if B == 1 else mask.any(0)).nonzero().squeeze(1)
        if st is not None:
            st.lap("rerank_union")
        qmat = self._qmat(col, items, sq=sq, slot="rerank")
        scores = self._gathered_scores(col, qmat, gunion)
        self.counters.rerank += 1
        self.device_unions += 1
        if st is not None:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            st.lap("rerank_score")
        if B > 1:  # the group's union is wider than a query's own
            scores = torch.where(mask[:, gunion], scores, NEG_INF)
        vals, pos = topk_scores(scores, group.max_k)
        rows = _host(torch.where(vals > _DEAD_CUT, gunion[pos.long()], -1))
        out = []
        for i, it in enumerate(items):
            r = rows[i, : it.query.k]
            out.append(r[r >= 0])  # a union shorter than k leaves empty slots
        if st is not None:
            st.lap("rerank_order")
        return out, int(gunion.shape[0])

    def _host_rerank(self, group: PlanGroup, cand, mv, st, sq
                     ) -> tuple[list[np.ndarray], int]:
        """The rerank of a mutated table's stable ids, on the host: each
        query's sorted union and the group's, one scoring dispatch whose
        ids are gathered from whichever side (base column / delta segment)
        physically stores them, and each query's stable argsort of its own
        scores. Stages as ``_device_rerank``'s; ``rerank_union`` and
        ``rerank_order`` are host numpy, ``rerank_score`` ends in the
        scores' copy back. Returns (each query's ids, the union's size)."""
        items = group.items
        unions = []
        for i in range(len(items)):
            parts = [c for c in cand[i] if c.shape[0]]
            unions.append(np.unique(np.concatenate(parts)) if parts
                          else np.empty(0, np.int64))
        nonempty = [u for u in unions if u.shape[0]]
        if not nonempty:
            if st is not None:
                st.lap("rerank_union")
            return [np.empty(0, np.int64) for _ in items], 0
        gunion = np.unique(np.concatenate(nonempty))
        if st is not None:
            st.lap("rerank_union")
        col = self.cstore.device(group.key.vid)
        qmat = self._qmat(col, items, sq=sq, slot="rerank")
        scores = self._mv_union_scores(mv, group, col, qmat, gunion)
        self.counters.rerank += 1
        if st is not None:
            st.lap("rerank_score")
        out = []
        for i, it in enumerate(items):
            if unions[i].shape[0] == 0:
                out.append(np.empty(0, np.int64))
                continue
            pos = np.searchsorted(gunion, unions[i])
            s = scores[i, pos]
            top = np.argsort(-s, kind="stable")[: it.query.k]
            out.append(unions[i][top])
        if st is not None:
            st.lap("rerank_order")
        return out, int(gunion.shape[0])

    def _mv_union_scores(self, mv, group: PlanGroup, col: DeviceColumn,
                         qmat: torch.Tensor, gunion: np.ndarray) -> np.ndarray:
        """Rerank scores for a STABLE-id union: base-located ids gather
        from the resident base column (one dispatch), delta-located from
        the delta segment (one more). Score values equal a rebuild's single
        gather — each row's dot product only sees its own (identically
        padded) values."""
        is_delta, phys = mv.locate(gunion)
        out = np.empty((qmat.shape[0], gunion.shape[0]), dtype=np.float32)
        bpos = np.nonzero(~is_delta)[0]
        if bpos.size:
            out[:, bpos] = _host(self._gathered_scores(col, qmat, phys[bpos]))
        dpos = np.nonzero(is_delta)[0]
        if dpos.size:
            dcol = mv.delta(group.key.vid)
            qd = self._qmat(dcol.col, group.items)
            out[:, dpos] = _host(self._gathered_scores(dcol.col, qd, phys[dpos]))
        return out

    def _group_ground_truth(self, group: PlanGroup, gt_cache):
        items = group.items
        missing = [i for i, it in enumerate(items)
                   if gt_cache is None or it.query.qid not in gt_cache]
        gts: list[np.ndarray | None] = [
            None if gt_cache is None else gt_cache.get(it.query.qid)
            for it in items]
        if missing:
            if group.key.pred is not None:  # filtered oracle, stable ids
                for i in missing:
                    gts[i] = self._filtered_ground_truth(items[i].query,
                                                         group.key.pred)
                return gts
            mv = self._mv()
            if mv is not None:  # oracle over the LIVE table, stable ids
                for i in missing:
                    gts[i] = mv.ground_truth(items[i].query)
                return gts
            data = self.cstore.host(group.key.vid)
            for i in missing:
                q = items[i].query
                gts[i], _ = exact_topk(data, q.concat(), q.k)
        return gts
