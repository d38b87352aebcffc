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
  - rerank: ONE distance-kernel dispatch per group over the padded
    candidate union, skipped on the single-exact-vid fast path — the same
    rule ``planner._plan_cost`` uses, so executed cost matches planned cost
    structurally.

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
scan at ``metric="l2"``, ``k=1`` over the cache matrix.

One device serves; mesh serving and staged (async) batches raise
``NotImplementedError`` until their slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.types import Query, QueryPlan, Workload
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.base import exact_topk
from repro_torch.kernels.common import NEG_INF, resolve_device
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ops import fused_scan
from repro_torch.kernels.streaming.ops import delta_id_offset, streaming_fused_scan
from repro_torch.launch.roofline import modeled_scan_bytes
from repro_torch.obs import NULL_OBSERVER
from repro_torch.serve.columnstore import ColumnStore, DeviceColumn
from repro_torch.serve.compiler import PlanGroup, compile_batch

# the (B, R, d) gathered rows of one IVF scoring pass are cut into query
# slices of at most this many bytes, so a 64-query burst over a deep probe
# union does not hold every gathered row at once
_GATHER_BYTES = 1 << 30

# scores below this are masked tombstones / padding — never real candidates
_DEAD_CUT = NEG_INF / 2


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1); the port serves "
        "from one device, batch by batch")


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


def _gather_scores(data: torch.Tensor, rows: torch.Tensor,
                   qmat: torch.Tensor) -> torch.Tensor:
    """Per-query gathered-row scoring: (N, d), (B, R) int64, (B, d) -> (B, R).
    Plain PyTorch: the reference computes this outside any Pallas kernel."""
    B, R = rows.shape
    step = max(1, _GATHER_BYTES // max(R * data.shape[1] * 4, 1))
    return torch.cat([torch.einsum("brd,bd->br", data[rows[i:i + step]],
                                   qmat[i:i + step])
                      for i in range(0, B, step)])


def cache_probe_scan(qmat, mat, valid_n: int, device=None):
    """Batched semantic-cache probe: ONE brute-force L2 dispatch of (B, d)
    query vectors against the cache's (C, d) query matrix — the streaming
    scan at ``metric="l2"``, ``k=1`` on the card, its plain version on the
    CPU. Returns host (vals, ids) with vals = -(squared L2); rows at or
    past ``valid_n`` are masked."""
    device = resolve_device(device)
    q = torch.as_tensor(np.asarray(qmat, dtype=np.float32), device=device)
    m = torch.as_tensor(np.asarray(mat, dtype=np.float32), device=device)
    vals, ids = streaming_fused_scan(q, m, k=1, metric="l2", valid_n=int(valid_n))
    return vals.cpu().numpy(), ids.cpu().numpy()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class BatchEngine:
    """Executes batches of (query, plan) pairs as compiled plan groups.

    ``store`` (an ``index.registry.IndexStore``) supplies materialized
    indexes; without one, every planned index is served as a device flat
    scan at its ek (the pure fused-kernel serving form).
    """

    def __init__(self, db: MultiVectorDatabase, store=None,
                 cstore: ColumnStore | None = None, mesh=None,
                 axis: str = "data", streaming: bool | None = None,
                 observer=None, device=None):
        if mesh is not None:
            raise _not_ported("mesh serving")
        self.db = db
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.store = store
        self.axis = axis
        if cstore is not None:
            self.device = cstore.torch_device
        elif store is not None and device is None:
            self.device = store.device
        else:
            self.device = resolve_device(device)
        self.cstore = cstore or ColumnStore(db, axis=axis, device=self.device)
        # single-launch streaming scan is the default; the two-pass path is
        # the reference oracle (streaming=False / REPRO_TWOPASS_SCAN=1)
        if streaming is None:
            streaming = os.environ.get("REPRO_TWOPASS_SCAN", "0") != "1"
        self.streaming = streaming
        self.counters = DispatchCounters()
        self.mview = None  # ingest.MutationView when mutations flow
        # filtered search (attach_filters): attribute store + optional
        # selectivity estimator, and the per-predicate bitmap cache
        self.attrs = None
        self.selest = None
        self._filter_cache: dict[tuple, _FilterState] = {}

    # ---- public API -------------------------------------------------------

    def swap_store(self, store, cstore: ColumnStore | None = None,
                   db: MultiVectorDatabase | None = None) -> None:
        """Replace the index store (and optionally the column store and
        database, when the underlying table itself changed — e.g. a
        compaction folded delta segments into a new base)."""
        if cstore is not None and cstore.torch_device != self.device:
            raise ValueError(f"column store on {cstore.torch_device}, engine on "
                             f"{self.device}")
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

    def stage_batch(self, pairs):
        raise _not_ported("staged batches (stage_batch)")

    def cache_probe(self, qmat, mat, valid_n):
        """Semantic-cache probe hook: one batched L2 dispatch of query
        vectors against the cache's query matrix on this engine's device
        (``cache_probe_scan``)."""
        return cache_probe_scan(qmat, mat, valid_n, device=self.device)

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

    def _groups(self, pairs, staged):
        if staged is not None:
            raise _not_ported("staged batches (stage_batch)")
        return compile_batch(pairs)

    def search_batch(self, pairs: list[tuple[Query, QueryPlan]],
                     staged=None) -> list[np.ndarray]:
        """Serving form: top-k ids per query, in batch order."""
        out: list[np.ndarray | None] = [None] * len(pairs)
        for group in self._groups(pairs, staged):
            ids_list, _, _, _ = self._observed_group(group)
            for item, ids in zip(group.items, ids_list):
                out[item.pos] = ids
        return out  # type: ignore[return-value]

    def execute_batch(self, pairs: list[tuple[Query, QueryPlan]],
                      gt_cache: dict[int, np.ndarray] | None = None,
                      staged=None) -> list:
        """Measurement form: ``ExecutionMetrics`` per query, batch order."""
        from repro_torch.core.tuner import ExecutionMetrics  # metrics stay in core
        out = [None] * len(pairs)
        for group in self._groups(pairs, staged):
            t0 = time.time()
            ids_list, costs, ndists, eks_maps = self._observed_group(group)
            gts = self._group_ground_truth(group, gt_cache)
            wall = (time.time() - t0) * 1e3 / max(group.batch, 1)
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

    def _observed_group(self, group: PlanGroup):
        """``_run_group`` wrapped in a ``plan_group`` span carrying the plan
        signature, index kinds, batch size and modeled bytes; the span's
        parent accumulates the group bytes."""
        if not self.obs.enabled:
            return self._run_group(group)
        attrs = self._group_attrs(group)
        with self.obs.span("plan_group", **attrs):
            out = self._run_group(group)
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

    def _qmat(self, col: DeviceColumn, items, vid=None) -> torch.Tensor:
        return col.pad_queries(np.stack([it.query.concat(vid) for it in items]))

    def _run_group(self, group: PlanGroup):
        if group.key.pred is not None:
            return self._run_group_filtered(group)
        specs, buckets = group.specs, group.buckets
        items = group.items
        B = len(items)
        costs = [0.0] * B
        ndists = [0] * B
        eks_maps: list[dict] = [{} for _ in range(B)]
        mv = self._mv()

        if not specs:  # flat-scan fallback group (no useful index / all ek=0)
            col = self.cstore.device(group.key.vid)
            qmat = self._qmat(col, items)
            if mv is None:
                ids = self._flat_scan(col, qmat, min(group.max_k, col.n_rows))
                out_ids = []
                for i, it in enumerate(items):
                    out_ids.append(ids[i, : min(it.query.k, col.n_rows)])
                    costs[i] = float(it.query.dim() * col.n_rows)
                    ndists[i] = col.n_rows
                return out_ids, costs, ndists, eks_maps
            # mutated table: base + delta merged exactly — ONE streaming
            # launch when available, else masked base scan + delta scan
            bs, bids, ds, dids, n_delta = self._scan_mv(
                mv, col, qmat, group.key.vid, items, group.max_k)
            out_ids = []
            for i, it in enumerate(items):
                k_i = min(it.query.k, mv.n_live)
                out_ids.append(self._merge_scored(
                    bs[i], bids[i],
                    None if ds is None else ds[i],
                    None if ds is None else dids[i], k_i))
                costs[i] = float(it.query.dim() * (col.n_rows + n_delta))
                ndists[i] = col.n_rows + n_delta
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
                               mv=mv, scored=scored)
            elif kind == "flat":
                col = self.cstore.device(spec.vid)
                qmat = self._qmat(col, items, spec.vid)
                if mv is None:
                    ids = self._flat_scan(col, qmat, min(bucket, col.n_rows))
                    for i, it in enumerate(items):
                        cand[i][j] = ids[i, : min(it.eks[j], col.n_rows)]
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                elif self.streaming:
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

        out_ids = self._rerank(group, cand, mv=mv)
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
        n_delta), else a masked base scan and a separate delta scan ->
        (bs, bids, ds, dids, n_delta)."""
        if self.streaming:
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

    def _run_group_filtered(self, group: PlanGroup):
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
            return self._prefilter_group(group, fs)
        return self._masked_group(group, fs)

    def _gathered_scores(self, col: DeviceColumn, qmat: torch.Tensor,
                         phys: np.ndarray) -> np.ndarray:
        """Distance-kernel scores of ``qmat`` against the gathered rows
        ``phys`` of ``col`` -> host (B, len(phys))."""
        sub = col.data[torch.as_tensor(phys.astype(np.int64), device=self.device)]
        return self._batched_scores(qmat, sub)

    def _prefilter_group(self, group: PlanGroup, fs: _FilterState):
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
        qmat = self._qmat(col, items)
        mv = self._mv()
        parts_s: list[np.ndarray] = []
        parts_ids: list[np.ndarray] = []
        if mv is None:
            bphys = np.nonzero(fs.base_keep)[0]
            if bphys.size:
                parts_s.append(self._gathered_scores(col, qmat, bphys))
                parts_ids.append(bphys.astype(np.int64))
                self.counters.scan += 1
        else:
            t = mv.table
            bphys = np.nonzero(fs.base_keep & t.base_alive)[0]
            if bphys.size:
                parts_s.append(self._gathered_scores(col, qmat, bphys))
                parts_ids.append(mv.translate(bphys))
                self.counters.scan += 1
            if fs.delta_keep is not None:
                dphys = np.nonzero(fs.delta_keep & t.delta_alive_arr())[0]
                if dphys.size:
                    dcol = mv.delta(vid)
                    qd = self._qmat(dcol.col, items)
                    parts_s.append(self._gathered_scores(dcol.col, qd, dphys))
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

    def _masked_group(self, group: PlanGroup, fs: _FilterState):
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
            col = self.cstore.device(group.key.vid)
            qmat = self._qmat(col, items)
            if mv is None:
                s, ids = self._filtered_flat_scan(
                    col, qmat, min(group.max_k, col.n_rows), fs)
                out_ids = []
                for i, it in enumerate(items):
                    out_ids.append(self._merge_scored(
                        s[i], ids[i].astype(np.int64), None, None,
                        min(it.query.k, fs.n_match)))
                    costs[i] = float(it.query.dim() * col.n_rows)
                    ndists[i] = col.n_rows
                return out_ids, costs, ndists, eks_maps
            bs, bids, ds, dids, n_delta = self._scan_mv(
                mv, col, qmat, group.key.vid, items, group.max_k, fstate=fs)
            out_ids = []
            for i, it in enumerate(items):
                k_i = min(it.query.k, fs.n_match)
                out_ids.append(self._merge_scored(
                    bs[i], bids[i],
                    None if ds is None else ds[i],
                    None if ds is None else dids[i], k_i))
                costs[i] = float(it.query.dim() * (col.n_rows + n_delta))
                ndists[i] = col.n_rows + n_delta
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
                               mv=mv, scored=scored, fstate=fs)
            elif kind == "flat":
                col = self.cstore.device(spec.vid)
                qmat = self._qmat(col, items, spec.vid)
                if mv is None:
                    s, ids = self._filtered_flat_scan(
                        col, qmat, min(bucket, col.n_rows), fs)
                    for i, it in enumerate(items):
                        scored[i] = (ids[i].astype(np.int64), s[i])
                        costs[i] += float(col.dim * col.n_rows)
                        ndists[i] += col.n_rows
                elif self.streaming:
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

        out_ids = self._rerank(group, cand, mv=mv)
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
            keep_mask=fs.base_keep_dev(int(col.data.shape[0])))

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

    def _batched_scores(self, qmat: torch.Tensor, sub: torch.Tensor) -> np.ndarray:
        """One batched scoring dispatch (the distance kernel on the card, its
        plain version on the CPU) -> host (B, N) scores."""
        return _host(batched_scores(qmat, sub))

    def _flat_scan(self, col: DeviceColumn, qmat: torch.Tensor, k: int) -> np.ndarray:
        return self._flat_scan_scored(col, qmat, k)[1]

    def _flat_scan_scored(self, col: DeviceColumn, qmat: torch.Tensor, k: int,
                          dead_mask=None, keep_mask=None,
                          counter: str = "scan"
                          ) -> tuple[np.ndarray, np.ndarray]:
        """One batched flat dispatch -> host (scores, ids), best-first. The
        tombstone ``dead_mask`` and the predicate ``keep_mask`` are threaded
        into the kernel row mask, so masked rows come back at NEG_INF (id 0)
        and are dropped by the merge on every path."""
        setattr(self.counters, counter, getattr(self.counters, counter) + 1)
        if self.streaming:
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
        dead = mv.base_dead_mask(int(col.data.shape[0]))
        keep = (None if fstate is None
                else fstate.base_keep_dev(int(col.data.shape[0])))
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
            keep = fstate.delta_keep_dev(int(dcol.col.data.shape[0]))
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
        ``_merge_scored``. Requires the streaming path."""
        dcol = mv.delta(vid)
        base_pad_rows = int(col.data.shape[0])
        dead = mv.base_dead_mask(base_pad_rows)
        bkeep = None if fstate is None else fstate.base_keep_dev(base_pad_rows)
        if dcol is None:  # no delta rows: plain masked base scan
            s, ids = self._flat_scan_scored(col, qmat, min(depth, col.n_rows),
                                            dead_mask=dead, keep_mask=bkeep)
            return s, mv.translate(ids), 0
        dkeep = (None if fstate is None
                 else fstate.delta_keep_dev(int(dcol.col.data.shape[0])))
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
                  mv=None, scored=None, fstate: _FilterState | None = None):
        """Batched IVF probe: one centroid-scoring dispatch for the whole
        group, then one gathered-row scoring pass over the padded probe
        union. Per-query nprobe / top-ek use each query's ACTUAL ek so the
        results match ``IVFFlatIndex.search`` exactly. Under mutations
        (``mv``), tombstoned rows are score-killed before selection and the
        surviving candidates land in ``scored`` as (stable ids, scores) for
        the delta merge; under a predicate (``fstate``) non-matching probe
        rows are score-killed the same way."""
        idx = self.store.get(spec)
        items = group.items
        col = self.cstore.device(spec.vid)
        qmat = self._qmat(col, items, spec.vid)
        cent = np.asarray(idx.centroids, dtype=np.float32)
        if col.padded_dim != cent.shape[1]:
            cent = np.pad(cent, ((0, 0), (0, col.padded_dim - cent.shape[1])))
        csims = self._batched_scores(qmat, torch.as_tensor(cent, device=self.device))
        self.counters.scan += 1

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
        scores = _host(_gather_scores(
            col.data, torch.as_tensor(rows_mat, device=self.device), qmat))
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

    def _rerank(self, group: PlanGroup, cand, mv=None) -> list[np.ndarray]:
        """Full-score rerank over each query's candidate union, batched as
        ONE distance-kernel dispatch over the group-wide union; per-query
        selection slices its own candidates (sorted ids + stable ordering —
        the same tie-breaking as the per-query numpy path). Under mutations
        the union holds stable ids and each is gathered from whichever side
        (base column / delta segment) physically stores it."""
        items = group.items
        col = self.cstore.device(group.key.vid)
        unions = []
        for i in range(len(items)):
            parts = [c for c in cand[i] if c.shape[0]]
            unions.append(np.unique(np.concatenate(parts)) if parts
                          else np.empty(0, np.int64))
        nonempty = [u for u in unions if u.shape[0]]
        if not nonempty:
            return [np.empty(0, np.int64) for _ in items]
        t_r0 = time.perf_counter() if self.obs.enabled else 0.0
        gunion = np.unique(np.concatenate(nonempty))
        qmat = self._qmat(col, items)
        if mv is None:
            scores = self._gathered_scores(col, qmat, gunion)
        else:
            scores = self._mv_union_scores(mv, group, col, qmat, gunion)
        self.counters.rerank += 1
        if self.obs.enabled:
            self.obs.span_at("rerank", t_r0, time.perf_counter(),
                             parent=self.obs.current(), batch=len(items),
                             union=int(gunion.shape[0]))
        out = []
        for i, it in enumerate(items):
            if unions[i].shape[0] == 0:
                out.append(np.empty(0, np.int64))
                continue
            pos = np.searchsorted(gunion, unions[i])
            s = scores[i, pos]
            top = np.argsort(-s, kind="stable")[: it.query.k]
            out.append(unions[i][top])
        return out

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
            out[:, bpos] = self._gathered_scores(col, qmat, phys[bpos])
        dpos = np.nonzero(is_delta)[0]
        if dpos.size:
            dcol = mv.delta(group.key.vid)
            qd = self._qmat(dcol.col, group.items)
            out[:, dpos] = self._gathered_scores(dcol.col, qd, phys[dpos])
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
