"""Device-resident delta segments + the engine-facing mutation view.

``DeltaSegments`` is the delta-side twin of ``serve.columnstore``: per-vid
concatenated delta rows, zero-padded to the kernel block shapes and
uploaded once per (table version, vid) to the view's torch device, so
repeated scans skip the transfer. Segments answer to the tenancy
``MemoryGovernor`` when one is attached — every upload is charged its PADDED
footprint under the owning tenant (key ``("delta",) + vid``, so delta bytes
show up in the same per-tenant accounting as resident base columns) and
released when the segment is invalidated by a new table version, evicted,
or dropped.

``MutationView`` is what ``BatchEngine`` reads at execution time:

  - ``base_dead_mask(padded_n)`` — device bool mask over padded base rows
    (True = tombstoned), threaded into the scan kernels so deleted rows are
    score-masked to -inf and can never win a top-k slot;
  - ``delta(vid)`` — a ``DeltaColumn`` (padded device matrix + stable ids +
    its own dead mask) for the brute-force delta scan;
  - ``translate(phys)`` — base physical row -> stable item id;
  - ``ground_truth(query)`` — exact top-k over LIVE rows in stable-id
    space, the oracle for recall measurement under mutations.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.types import DEFAULT_TENANT, TenantId, Vid, norm_vid
from repro_torch.ingest.table import MutableTable
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.columnstore import DeviceColumn, _round_up

DELTA_NS = "delta"  # governor key namespace: ("delta",) + vid


@dataclass
class DeltaColumn:
    """One vid's delta rows on device, plus identity and liveness."""

    col: DeviceColumn          # padded device matrix (delta rows)
    ids: np.ndarray            # (n_delta,) stable ids, delta physical order
    alive: np.ndarray          # (n_delta,) bool
    dead_mask: torch.Tensor | None  # (n_padded,) bool device mask, True=dead

    @property
    def n_rows(self) -> int:
        return self.col.n_rows

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())


class DeltaSegments:
    """Version-keyed device cache of per-vid delta concats on ``device``
    (None: the CUDA card)."""

    def __init__(self, table: MutableTable, block_rows: int = 128,
                 block_dim: int = 128, governor=None,
                 tenant: TenantId = DEFAULT_TENANT, device=None):
        self.device = resolve_device(device)
        self.table = table
        self.block_rows = block_rows
        self.block_dim = block_dim
        self.governor = governor
        self.tenant = tenant
        self._cache: dict[Vid, tuple[int, DeltaColumn]] = {}

    def _gov_key(self, vid: Vid) -> tuple:
        return (DELTA_NS,) + vid

    def _release(self, vid: Vid) -> None:
        if self.governor is not None:
            self.governor.release(self.tenant, self._gov_key(vid))

    def column(self, vid: Vid) -> DeltaColumn | None:
        """Device delta column for ``vid`` at the CURRENT table version;
        None when the table has no delta rows. Stale versions are dropped
        (and their governor charge released) before re-uploading."""
        vid = norm_vid(vid)
        version = self.table.version
        hit = self._cache.get(vid)
        if hit is not None and hit[0] == version:
            if self.governor is not None:
                self.governor.touch(self.tenant, self._gov_key(vid))
            return hit[1]
        if hit is not None:
            del self._cache[vid]
            self._release(vid)
        if self.table.n_delta == 0:
            return None
        mat = self.table.delta_concat(vid)
        n, d = mat.shape
        np_pad = _round_up(n, self.block_rows) - n
        nd_pad = _round_up(d, self.block_dim) - d
        if self.governor is not None:
            self.governor.acquire(self.tenant, self._gov_key(vid),
                                  (n + np_pad) * (d + nd_pad) * 4)
        if np_pad or nd_pad:
            mat = np.pad(mat, ((0, np_pad), (0, nd_pad)))
        col = DeviceColumn(vid=vid, data=torch.as_tensor(
            np.ascontiguousarray(mat), device=self.device), n_rows=n, dim=d)
        alive = self.table.delta_alive_arr()
        dead_mask = None
        if not alive.all():
            dm = np.zeros(n + np_pad, dtype=bool)
            dm[:n] = ~alive
            dead_mask = torch.as_tensor(dm, device=self.device)
        dcol = DeltaColumn(col=col, ids=self.table.delta_ids_arr(),
                           alive=alive, dead_mask=dead_mask)
        self._cache[vid] = (version, dcol)
        return dcol

    def evict_device(self, key: tuple) -> bool:
        """Governor eviction callback: ``key`` is ("delta",) + vid."""
        vid = tuple(key[1:])
        if vid in self._cache:
            del self._cache[vid]
            self._release(vid)
            return True
        return False

    def drop_all(self) -> None:
        """Release every cached segment (compaction swap / shutdown)."""
        for vid in list(self._cache):
            del self._cache[vid]
            self._release(vid)

    def total_device_bytes(self) -> int:
        return sum(d.col.device_bytes for _, d in self._cache.values())


class MutationView:
    """The engine's read interface over one MutableTable; its device
    columns and masks live on ``device`` (None: the CUDA card), which must
    be the serving engine's."""

    def __init__(self, table: MutableTable, block_rows: int = 128,
                 block_dim: int = 128, governor=None,
                 tenant: TenantId = DEFAULT_TENANT, device=None):
        self.table = table
        self.segments = DeltaSegments(table, block_rows=block_rows,
                                      block_dim=block_dim, governor=governor,
                                      tenant=tenant, device=device)
        self.device = self.segments.device
        self._mask_cache: tuple[int, int, torch.Tensor | None] | None = None

    @property
    def version(self) -> int:
        return self.table.version

    @property
    def n_live(self) -> int:
        return self.table.n_live

    @property
    def n_dead_base(self) -> int:
        return self.table.n_dead_base

    @property
    def base_ids(self) -> np.ndarray:
        return self.table.base_ids

    def identity_base(self) -> bool:
        """True when base physical ids ARE stable ids (pre-first-compaction
        fast path: no translation gather needed)."""
        return self.table.base_identity

    def translate(self, phys: np.ndarray) -> np.ndarray:
        """Base physical row indices -> stable item ids."""
        if self.identity_base():
            return np.asarray(phys, dtype=np.int64)
        return self.table.base_ids[np.asarray(phys, dtype=np.int64)]

    def base_dead_mask(self, padded_n: int) -> torch.Tensor | None:
        """(padded_n,) device bool mask over base rows (True = dead), or
        None when nothing is tombstoned. Cached per (version, padded_n)."""
        if self.table.n_dead_base == 0:
            return None
        key = (self.table.version, padded_n)
        if self._mask_cache is not None and self._mask_cache[:2] == key:
            return self._mask_cache[2]
        dm = np.zeros(padded_n, dtype=bool)
        dm[: self.table.n_base] = ~self.table.base_alive
        mask = torch.as_tensor(dm, device=self.device)
        self._mask_cache = (*key, mask)
        return mask

    def delta(self, vid: Vid) -> DeltaColumn | None:
        return self.segments.column(vid)

    def locate(self, stable_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Live stable ids -> (is_delta bool, physical position) — the
        rerank's gather directory (base-located rows score from the resident
        base column, delta-located from the delta segment)."""
        loc = self.table._loc
        n = len(stable_ids)
        is_delta = np.zeros(n, dtype=bool)
        phys = np.empty(n, dtype=np.int64)
        for p, sid in enumerate(stable_ids):
            kind, pos = loc[int(sid)]
            is_delta[p] = kind == "delta"
            phys[p] = pos
        return is_delta, phys

    def mutated(self) -> bool:
        """Any state diverging from the plain base snapshot? When False and
        the base is identity-mapped, execution takes the unmutated path."""
        return (self.table.n_delta > 0 or self.table.n_dead_base > 0
                or not self.identity_base())

    def ground_truth(self, query) -> np.ndarray:
        """Exact top-k stable ids over live rows (base ∪ delta − dead)."""
        qvec = query.concat()
        base = self.table.base.concat(query.vid)
        scores = base @ qvec
        alive = self.table.base_alive
        ids = self.table.base_ids
        if self.table.n_delta:
            dmat = self.table.delta_concat(query.vid)
            scores = np.concatenate([scores, dmat @ qvec])
            alive = np.concatenate([alive, self.table.delta_alive_arr()])
            ids = np.concatenate([ids, self.table.delta_ids_arr()])
        live = np.nonzero(alive)[0]
        s, ids = scores[live], ids[live]
        # canonical order: score desc, stable id asc — ties resolved exactly
        # like a materialized rebuild (rows there are sorted by stable id)
        order = np.lexsort((ids, -s))
        return ids[order][: min(query.k, live.shape[0])]
