"""Batched plan executor — the single execution path for MINT plans.

Runs compiled plan groups (``serve.compiler``) over the device-resident
column store (``serve.columnstore``):

  - flat scans: ONE scan dispatch per (group, index) over the padded
    resident matrix — the one-pass streaming kernel by default, the
    two-pass distance + top-k kernels with ``streaming=False`` (or env
    ``REPRO_TWOPASS_SCAN=1``); both return identical (values, ids);
  - IVF: ONE batched centroid-scoring dispatch per (group, index) followed
    by a single gathered-row scoring pass over the padded probe union;
  - rerank: ONE distance-kernel dispatch per group over the padded
    candidate union, skipped on the single-exact-vid fast path — the same
    rule ``planner._plan_cost`` uses, so executed cost matches planned cost
    structurally.

ek buckets pad *dispatch shapes* only; each query slices its own exact ek
from the best-first results, so batched top-k ids are identical to the
per-query paths. Cost/recall accounting follows ``core.tuner.execute_plan``
exactly: cost = Σ dim(x)·numDist + dim(q)·Σ ek (Eq. 4-6, duplicates
counted), with wall time amortized over the group batch.

This slice serves the unfiltered, unmutated table on one device, with the
flat and IVF index kinds. Predicates, mutations, staged (async) batches and
the semantic-cache probe raise ``NotImplementedError`` until their slices
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.types import Query, QueryPlan, Workload
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.base import exact_topk
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ops import fused_scan
from repro_torch.kernels.streaming.ops import streaming_fused_scan
from repro_torch.launch.roofline import modeled_scan_bytes
from repro_torch.obs import NULL_OBSERVER
from repro_torch.serve.columnstore import ColumnStore, DeviceColumn
from repro_torch.serve.compiler import PlanGroup, compile_batch

# the (B, R, d) gathered rows of one IVF scoring pass are cut into query
# slices of at most this many bytes, so a 64-query burst over a deep probe
# union does not hold every gathered row at once
_GATHER_BYTES = 1 << 30


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1); this slice serves "
        "the unfiltered, unmutated table on one device")


@dataclass
class DispatchCounters:
    """Kernel-dispatch accounting: ``scan`` counts ONE per (group, index)
    batched dispatch (flat scan or IVF probe), ``delta`` one per separate
    delta-segment dispatch, ``rerank`` one per group needing the union
    rerank, ``fallback`` one per per-query graph search that could not be
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


def _gather_scores(data: torch.Tensor, rows: torch.Tensor,
                   qmat: torch.Tensor) -> torch.Tensor:
    """Per-query gathered-row scoring: (N, d), (B, R) int64, (B, d) -> (B, R).
    Plain PyTorch: the reference computes this outside any Pallas kernel."""
    B, R = rows.shape
    step = max(1, _GATHER_BYTES // max(R * data.shape[1] * 4, 1))
    return torch.cat([torch.einsum("brd,bd->br", data[rows[i:i + step]],
                                   qmat[i:i + step])
                      for i in range(0, B, step)])


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

    # ---- public API -------------------------------------------------------

    def attach_filters(self, attrs, selectivity=None) -> None:
        raise _not_ported("filtered search (attach_filters)")

    def attach_mutations(self, view) -> None:
        raise _not_ported("mutation-aware serving (attach_mutations)")

    def stage_batch(self, pairs):
        raise _not_ported("staged batches (stage_batch)")

    def cache_probe(self, qmat, mat, valid_n):
        raise _not_ported("the semantic-cache probe (cache_probe)")

    def ground_truth(self, query: Query) -> np.ndarray:
        """Exact top-k ids for one query against the serving table."""
        if getattr(query, "predicate", None) is not None:
            raise _not_ported("filtered search")
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
                else:
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
            m = modeled_scan_bytes(B, N, d, min(int(bucket), N))
            hbm += m[side] if kind == "flat" else m["streaming_bytes"]
        return {"plan_sig": tuple(plansig), "index_kinds": tuple(kinds),
                "access": group.key.access, "batch": B, "rows": N,
                "hbm_bytes_modeled": float(hbm)}

    def _run_group(self, group: PlanGroup):
        if group.key.pred is not None:
            raise _not_ported("filtered search")
        specs, buckets = group.specs, group.buckets
        items = group.items
        B = len(items)
        costs = [0.0] * B
        ndists = [0] * B
        eks_maps: list[dict] = [{} for _ in range(B)]

        if not specs:  # flat-scan fallback group (no useful index / all ek=0)
            col = self.cstore.device(group.key.vid)
            qmat = col.pad_queries(np.stack([it.query.concat() for it in items]))
            ids = self._flat_scan(col, qmat, min(group.max_k, col.n_rows))
            out_ids = []
            for i, it in enumerate(items):
                out_ids.append(ids[i, : min(it.query.k, col.n_rows)])
                costs[i] = float(it.query.dim() * col.n_rows)
                ndists[i] = col.n_rows
            return out_ids, costs, ndists, eks_maps

        cand: list[list[np.ndarray]] = [[np.empty(0, np.int64)] * len(specs)
                                        for _ in range(B)]
        for j, (spec, bucket) in enumerate(zip(specs, buckets)):
            kind = spec.kind if self.store is not None else "flat"
            for i, it in enumerate(items):
                eks_maps[i][spec.name] = it.eks[j]
            if kind == "ivf":
                self._ivf_scan(group, spec, j, cand, costs, ndists)
            elif kind == "flat":
                col = self.cstore.device(spec.vid)
                qmat = col.pad_queries(
                    np.stack([it.query.concat(spec.vid) for it in items]))
                ids = self._flat_scan(col, qmat, min(bucket, col.n_rows))
                for i, it in enumerate(items):
                    cand[i][j] = ids[i, : min(it.eks[j], col.n_rows)]
                    costs[i] += float(col.dim * col.n_rows)
                    ndists[i] += col.n_rows
            else:
                raise _not_ported(f"index kind {kind!r} (graph walks)")

        if group.single_exact:  # scan output is the full-score order already
            out_ids = [cand[i][0][: items[i].query.k] for i in range(B)]
            return out_ids, costs, ndists, eks_maps

        out_ids = self._rerank(group, cand)
        for i, it in enumerate(items):
            total_ek = int(sum(it.eks))  # duplicates counted — Eq. 6
            costs[i] += float(it.query.dim() * total_ek)
            ndists[i] += total_ek
        return out_ids, costs, ndists, eks_maps

    def _batched_scores(self, qmat: torch.Tensor, sub: torch.Tensor) -> np.ndarray:
        """One batched scoring dispatch (the distance kernel on the card, its
        plain version on the CPU) -> host (B, N) scores."""
        return batched_scores(qmat, sub).cpu().numpy()

    def _flat_scan(self, col: DeviceColumn, qmat: torch.Tensor, k: int) -> np.ndarray:
        return self._flat_scan_scored(col, qmat, k)[1]

    def _flat_scan_scored(self, col: DeviceColumn, qmat: torch.Tensor, k: int
                          ) -> tuple[np.ndarray, np.ndarray]:
        """One batched flat dispatch -> host (scores, ids), best-first."""
        self.counters.scan += 1
        if self.streaming:
            vals, ids = streaming_fused_scan(
                qmat, col.data, k=min(k, col.n_rows), valid_n=col.n_rows)
        else:
            vals, ids = fused_scan(qmat, col.data, k=k, valid_n=col.n_rows)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def _ivf_scan(self, group: PlanGroup, spec, j: int, cand, costs, ndists):
        """Batched IVF probe: one centroid-scoring dispatch for the whole
        group, then one gathered-row scoring pass over the padded probe
        union. Per-query nprobe / top-ek use each query's ACTUAL ek so the
        results match ``IVFFlatIndex.search`` exactly."""
        idx = self.store.get(spec)
        items = group.items
        col = self.cstore.device(spec.vid)
        qmat = col.pad_queries(
            np.stack([it.query.concat(spec.vid) for it in items]))
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
        scores = _gather_scores(col.data, torch.as_tensor(rows_mat, device=self.device),
                                qmat).cpu().numpy()
        for i, (it, rows) in enumerate(zip(items, rows_list)):
            if rows.shape[0] == 0:
                cand[i][j] = np.empty(0, np.int64)
                continue
            s = scores[i, : rows.shape[0]]
            ek = min(it.eks[j], rows.shape[0])
            part = np.argpartition(-s, ek - 1)[:ek]
            order = np.argsort(-s[part], kind="stable")
            cand[i][j] = rows[part[order]]

    def _rerank(self, group: PlanGroup, cand) -> list[np.ndarray]:
        """Full-score rerank over each query's candidate union, batched as
        ONE distance-kernel dispatch over the group-wide union; per-query
        selection slices its own candidates (sorted ids + stable ordering —
        the same tie-breaking as the per-query numpy path)."""
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
        qmat = col.pad_queries(np.stack([it.query.concat() for it in items]))
        sub = col.data[torch.as_tensor(gunion, device=self.device)]
        scores = self._batched_scores(qmat, sub)
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

    def _group_ground_truth(self, group: PlanGroup, gt_cache):
        items = group.items
        gts: list[np.ndarray | None] = [
            None if gt_cache is None else gt_cache.get(it.query.qid)
            for it in items]
        data = None
        for i, it in enumerate(items):
            if gts[i] is None:
                if data is None:
                    data = self.cstore.host(group.key.vid)
                gts[i], _ = exact_topk(data, it.query.concat(), it.query.k)
        return gts
