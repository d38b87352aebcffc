"""Mutable multi-vector table: immutable base + delta rows + tombstones.

The LSM view of a ``MultiVectorDatabase`` (DESIGN.md §9):

  - the *base* is an immutable physical snapshot (what the indexes and the
    device column store were built over) plus ``base_ids``, the stable item
    id of each physical row — identity at first, arbitrary after a
    compaction rebased the table onto a materialized snapshot;
  - *delta* rows are appended per column and carry their own stable ids;
    they are never indexed — the engine brute-force scans them with the
    fused kernels and merges candidates by partial score, which keeps
    results exactly what a from-scratch rebuild would return;
  - *tombstones* are alive bitmaps over base and delta physical rows; a
    delete flips one bit, an upsert tombstones the old location and appends
    the new vectors under the same stable id.

All queries about liveness, drift statistics (incremental per-column live
sums → centroid shift), and the compactor's materialization run off this
one structure. Mutations are serialized by an internal lock; readers take
version-tagged snapshots (``version`` bumps on every applied mutation, and
device-side delta caches key on it).
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.types import Vid, norm_vid
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.ingest.mutation import (DeleteBatch, InsertBatch, MutationLog,
                                   UpsertBatch, _as_blocks)


class MutableTable:
    """Base snapshot + delta segments + tombstones over stable item ids."""

    def __init__(self, base: MultiVectorDatabase,
                 base_ids: np.ndarray | None = None,
                 log: MutationLog | None = None):
        self.base = base
        n = base.n_rows
        self.base_ids = (np.arange(n, dtype=np.int64) if base_ids is None
                         else np.asarray(base_ids, dtype=np.int64))
        if self.base_ids.shape[0] != n:
            raise ValueError("base_ids length != base rows")
        self.base_alive = np.ones(n, dtype=bool)
        self._delta_blocks: list[list[np.ndarray]] = [[] for _ in base.columns]
        self._delta_ids: list[int] = []
        self._delta_alive: list[bool] = []
        # stable id -> ("base" | "delta", physical position)
        self._loc: dict[int, tuple[str, int]] = {
            int(i): ("base", p) for p, i in enumerate(self.base_ids)}
        self.next_id = int(self.base_ids.max()) + 1 if n else 0
        # identity base: physical row index == stable id (pre-compaction)
        self.base_identity = bool(np.array_equal(
            self.base_ids, np.arange(n, dtype=np.int64)))
        self.log = log if log is not None else MutationLog()
        self.version = 0
        self.n_live = n
        self._n_delta_live = 0
        # incremental per-column live sums (float64) — the data-drift
        # detector's centroid source; O(d) per mutated row, never a rescan
        self._live_sum = [c.sum(axis=0, dtype=np.float64)
                          for c in base.columns]
        self._delta_cache: tuple[int, list[np.ndarray]] | None = None
        self._lock = threading.RLock()

    # ---- shape / stats ----------------------------------------------------

    @property
    def n_base(self) -> int:
        return self.base.n_rows

    @property
    def n_delta(self) -> int:
        return len(self._delta_ids)

    @property
    def n_dead(self) -> int:
        return (self.n_base + self.n_delta) - self.n_live

    @property
    def n_dead_base(self) -> int:
        return int(self.n_base - self.base_alive.sum())

    @property
    def delta_fraction(self) -> float:
        """Live delta rows / live rows — the delta-scan overhead signal.
        Checked every tick (compaction policy), so it runs off the
        incrementally maintained live-delta counter."""
        if self.n_live == 0:
            return 0.0
        return self._n_delta_live / self.n_live

    @property
    def dead_fraction(self) -> float:
        """Tombstoned physical rows / physical rows — wasted scan work."""
        total = self.n_base + self.n_delta
        return (self.n_dead / total) if total else 0.0

    def dims(self) -> list[int]:
        return self.base.dims

    def live_mean(self, c: int) -> np.ndarray:
        """Incremental live centroid of column ``c`` (float64)."""
        return self._live_sum[c] / max(self.n_live, 1)

    def live_ids(self) -> np.ndarray:
        """Stable ids of live rows, ascending."""
        with self._lock:
            ids = np.concatenate([
                self.base_ids[self.base_alive],
                self.delta_ids_arr()[self.delta_alive_arr()]])
        return np.sort(ids)

    def contains(self, stable_id: int) -> bool:
        loc = self._loc.get(int(stable_id))
        if loc is None:
            return False
        kind, pos = loc
        return bool(self.base_alive[pos] if kind == "base"
                    else self._delta_alive[pos])

    # ---- mutation application --------------------------------------------

    def apply(self, mutation) -> tuple[int, np.ndarray]:
        """Apply one typed batch. Returns (lsn, stable ids touched).

        Every record lands in the log WITH the vectors it moved (new rows
        for insert/upsert, tombstoned rows' prior contents for delete), so
        the log between two compaction cuts is a complete redo record —
        async compaction replays it onto the new base (DESIGN.md §10)."""
        with self._lock:
            if isinstance(mutation, InsertBatch):
                blocks = _as_blocks(mutation.vectors, self.dims())
                ids = self._insert(blocks)
                lsn = self.log.append("insert", len(ids), len(ids), ids,
                                      vectors=blocks)
            elif isinstance(mutation, DeleteBatch):
                applied_ids, killed = self._delete(mutation.ids)
                ids = mutation.ids
                lsn = self.log.append("delete", len(ids), len(applied_ids),
                                      ids, vectors=killed,
                                      applied_ids=applied_ids)
            elif isinstance(mutation, UpsertBatch):
                blocks = _as_blocks(mutation.vectors, self.dims())
                if blocks[0].shape[0] != mutation.ids.shape[0]:
                    raise ValueError("upsert ids / vectors length mismatch")
                ids = self._upsert(mutation.ids, blocks)
                lsn = self.log.append("upsert", len(ids), len(ids), ids,
                                      vectors=blocks)
            else:
                raise TypeError(f"unknown mutation type {type(mutation).__name__}")
            self.version += 1
            return lsn, ids

    def _append_delta(self, blocks: list[np.ndarray], ids: np.ndarray) -> None:
        pos0 = self.n_delta
        for c, b in enumerate(blocks):
            self._delta_blocks[c].append(b)
            self._live_sum[c] += b.sum(axis=0, dtype=np.float64)
        for off, i in enumerate(ids):
            self._delta_ids.append(int(i))
            self._delta_alive.append(True)
            self._loc[int(i)] = ("delta", pos0 + off)
        self.n_live += len(ids)
        self._n_delta_live += len(ids)
        self._delta_cache = None

    def _insert(self, blocks: list[np.ndarray]) -> np.ndarray:
        n_new = blocks[0].shape[0]
        ids = np.arange(self.next_id, self.next_id + n_new, dtype=np.int64)
        self.next_id += n_new
        self._append_delta(blocks, ids)
        return ids

    def _kill(self, stable_id: int) -> list | None:
        """Tombstone one live location; returns the killed row's per-column
        vectors (the delete log records them), None when unknown/dead."""
        loc = self._loc.get(stable_id)
        if loc is None:
            return None
        kind, pos = loc
        if kind == "base":
            if not self.base_alive[pos]:
                return None
            self.base_alive[pos] = False
            row = [c[pos] for c in self.base.columns]
        else:
            if not self._delta_alive[pos]:
                return None
            self._delta_alive[pos] = False
            self._n_delta_live -= 1
            mats = self._delta_matrices()
            row = [m[pos] for m in mats]
        for c, r in enumerate(row):
            self._live_sum[c] -= np.asarray(r, dtype=np.float64)
        self.n_live -= 1
        return row

    def _delete(self, ids: np.ndarray) -> tuple[np.ndarray, list | None]:
        """Returns (stable ids actually tombstoned, their per-column
        blocks) — the delete record's undo/audit payload."""
        applied: list[int] = []
        rows: list[list] = []
        for i in ids:
            row = self._kill(int(i))
            if row is not None:
                applied.append(int(i))
                rows.append(row)
        blocks = None
        if rows:
            blocks = [np.stack([r[c] for r in rows]).astype(np.float32)
                      for c in range(len(self.base.columns))]
        return np.asarray(applied, dtype=np.int64), blocks

    def _upsert(self, ids: np.ndarray, blocks: list[np.ndarray]) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if np.unique(ids).shape[0] != ids.shape[0]:
            # two rows under one id would leave an unreachable-but-alive
            # phantom (only the last location lands in _loc)
            raise ValueError("duplicate stable ids in one upsert batch")
        for i in ids:
            self._kill(int(i))  # fresh id: plain insert under that id
        self._append_delta(blocks, ids)
        self.next_id = max(self.next_id, int(ids.max()) + 1)
        return ids

    # ---- delta access -----------------------------------------------------

    def _delta_matrices(self) -> list[np.ndarray]:
        """Per-column (n_delta, d_c) concatenation of delta blocks, cached
        until the next append (deletes only flip bits, the matrices stand)."""
        if self._delta_cache is not None and self._delta_cache[0] == self.n_delta:
            return self._delta_cache[1]
        mats = [np.concatenate(bs, axis=0) if bs
                else np.empty((0, c.shape[1]), dtype=np.float32)
                for bs, c in zip(self._delta_blocks, self.base.columns)]
        self._delta_cache = (self.n_delta, mats)
        return mats

    def delta_concat(self, vid: Vid) -> np.ndarray:
        """(n_delta, dim(vid)) delta rows over the named columns."""
        cols = norm_vid(vid)
        mats = self._delta_matrices()
        if len(cols) == 1:
            return mats[cols[0]]
        return np.concatenate([mats[c] for c in cols], axis=1)

    def delta_ids_arr(self) -> np.ndarray:
        return np.asarray(self._delta_ids, dtype=np.int64)

    def delta_alive_arr(self) -> np.ndarray:
        return np.asarray(self._delta_alive, dtype=bool)

    # ---- materialization (compaction / rebuild oracle) --------------------

    def materialize(self) -> tuple[MultiVectorDatabase, np.ndarray]:
        """Fold base + delta − tombstones into a fresh immutable database.

        Rows are ordered by ASCENDING stable id — the canonical physical
        order, so a from-scratch rebuild breaks score ties exactly like the
        merged delta path (which breaks them by stable id). Returns
        (database, ids) with ``ids[phys] = stable id``.
        """
        with self._lock:
            base_live = np.nonzero(self.base_alive)[0]
            delta_live = np.nonzero(self.delta_alive_arr())[0]
            stable = np.concatenate([self.base_ids[base_live],
                                     self.delta_ids_arr()[delta_live]])
            order = np.argsort(stable, kind="stable")
            ids = stable[order]
            mats = self._delta_matrices()
            cols = [np.ascontiguousarray(
                        np.concatenate([bcol[base_live], dcol[delta_live]],
                                       axis=0)[order])
                    for bcol, dcol in zip(self.base.columns, mats)]
            db = MultiVectorDatabase(cols, list(self.base.names))
        return db, ids

    def snapshot(self) -> tuple[MultiVectorDatabase, np.ndarray, int]:
        """(materialized live db, stable ids, cut LSN) in ONE lock hold —
        the async compactor's cut: everything below the returned LSN is in
        the snapshot, everything at/above it must be replayed at rebase."""
        with self._lock:
            db, ids = self.materialize()
            return db, ids, self.log.next_lsn

    def rebase(self, db: MultiVectorDatabase, ids: np.ndarray,
               upto_lsn: int | None = None, replay=()) -> None:
        """Swap in a compacted snapshot: the delta and tombstones it folded
        are cleared, the log truncated to the compaction cut, and stable
        ids carried over — external references survive the rebase.

        ``replay`` re-applies post-cut ``LogRecord``s (in LSN order) onto
        the new base WITHOUT re-logging them — they are still in the live
        log after the truncate. This is the async-compaction rebase: the
        snapshot was cut at ``upto_lsn`` while mutations kept landing; the
        replayed table is identical to one that applied those batches
        directly (same stable ids, same delta order, same tombstones)."""
        with self._lock:
            upto = self.log.next_lsn if upto_lsn is None else upto_lsn
            self.base = db
            self.base_ids = np.asarray(ids, dtype=np.int64)
            self.base_identity = bool(np.array_equal(
                self.base_ids, np.arange(db.n_rows, dtype=np.int64)))
            self.base_alive = np.ones(db.n_rows, dtype=bool)
            self._delta_blocks = [[] for _ in db.columns]
            self._delta_ids = []
            self._delta_alive = []
            self._loc = {int(i): ("base", p)
                         for p, i in enumerate(self.base_ids)}
            self.next_id = max(self.next_id,
                               int(ids.max()) + 1 if len(ids) else 0)
            self.n_live = db.n_rows
            self._n_delta_live = 0
            self._live_sum = [c.sum(axis=0, dtype=np.float64)
                              for c in db.columns]
            self._delta_cache = None
            self.log.truncate(upto)
            for rec in replay:
                self._replay(rec)
            self.version += 1

    def _replay(self, rec) -> None:
        """Redo one vector-carrying log record on the current state."""
        if rec.kind == "insert":
            if rec.vectors is None:
                raise ValueError(f"lsn {rec.lsn}: insert record carries no "
                                 "vectors — cannot replay")
            blocks = _as_blocks(rec.vectors, self.dims())
            self._append_delta(blocks, np.asarray(rec.ids, dtype=np.int64))
            if rec.ids.size:
                self.next_id = max(self.next_id, int(rec.ids.max()) + 1)
        elif rec.kind == "delete":
            ids = rec.applied_ids if rec.applied_ids is not None else rec.ids
            for i in ids:
                self._kill(int(i))
        elif rec.kind == "upsert":
            if rec.vectors is None:
                raise ValueError(f"lsn {rec.lsn}: upsert record carries no "
                                 "vectors — cannot replay")
            blocks = _as_blocks(rec.vectors, self.dims())
            self._upsert(np.asarray(rec.ids, dtype=np.int64), blocks)
        else:
            raise ValueError(f"lsn {rec.lsn}: unknown record kind {rec.kind!r}")

    def stats(self) -> dict:
        return {"n_base": self.n_base, "n_delta": self.n_delta,
                "n_live": self.n_live, "n_dead": self.n_dead,
                "delta_fraction": self.delta_fraction,
                "dead_fraction": self.dead_fraction,
                "version": self.version, "log": self.log.stats()}
