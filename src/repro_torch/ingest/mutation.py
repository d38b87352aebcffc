"""Typed mutation batches + the append-only mutation log (DESIGN.md §9).

Every change to a served table flows through here as one of three batch
types — ``InsertBatch`` / ``DeleteBatch`` / ``UpsertBatch`` — applied to a
``MutableTable`` and recorded in its ``MutationLog`` with a monotonically
increasing LSN. The log is the compactor's unit of progress: a compaction
folds everything up to a cut LSN into a new base snapshot and truncates the
log to that cut, so the live log always describes exactly the mutations the
delta/tombstone layer still carries.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _as_blocks(vectors, dims: list[int]) -> list[np.ndarray]:
    """Validate one per-column block list against the table's column dims.
    Returns float32 C-contiguous blocks with a common row count."""
    if len(vectors) != len(dims):
        raise ValueError(f"expected {len(dims)} column blocks, got {len(vectors)}")
    blocks = [np.ascontiguousarray(np.atleast_2d(v), dtype=np.float32)
              for v in vectors]
    ns = {b.shape[0] for b in blocks}
    if len(ns) != 1:
        raise ValueError(f"ragged mutation row counts: {ns}")
    for c, (b, d) in enumerate(zip(blocks, dims)):
        if b.shape[1] != d:
            raise ValueError(f"column {c}: dim {b.shape[1]} != table dim {d}")
    return blocks


@dataclass
class InsertBatch:
    """New rows: one (n, d_c) block per column; stable ids are assigned by
    the table at apply time (returned from ``MutableTable.apply``)."""

    vectors: list  # list[np.ndarray], one block per column

    @property
    def n(self) -> int:
        return int(np.atleast_2d(self.vectors[0]).shape[0])


@dataclass
class DeleteBatch:
    """Tombstone rows by stable id. Deleting an id that is unknown or
    already dead is a counted no-op (``stale``), not an error — interleaved
    streams race deletes against compactions."""

    ids: np.ndarray

    def __post_init__(self):
        self.ids = np.atleast_1d(np.asarray(self.ids, dtype=np.int64))


@dataclass
class UpsertBatch:
    """Replace (or create) rows by stable id: the old location — base or
    delta — is tombstoned and the new vectors land in the delta under the
    SAME stable id, so references held outside the table stay valid."""

    ids: np.ndarray
    vectors: list

    def __post_init__(self):
        self.ids = np.atleast_1d(np.asarray(self.ids, dtype=np.int64))


Mutation = InsertBatch | DeleteBatch | UpsertBatch


def resolve_timed(table, tm) -> "Mutation | None":
    """Resolve one trace event (``online.trace.TimedMutation``) against the
    LIVE table: inserts carry their vectors; delete/upsert targets are the
    event's seeded pick from the ids alive RIGHT NOW (which the trace
    cannot know ahead of time). Returns None when nothing is applicable
    (no live rows to pick from)."""
    if tm.kind == "insert":
        return InsertBatch(tm.vectors)
    if tm.kind not in ("delete", "upsert"):
        raise ValueError(f"unknown timed mutation kind {tm.kind!r}")
    rng = np.random.default_rng(tm.seed)
    live = table.live_ids()
    count = min(tm.count, live.shape[0])
    if count == 0:
        return None
    ids = np.sort(rng.choice(live, size=count, replace=False))
    if tm.kind == "delete":
        return DeleteBatch(ids)
    return UpsertBatch(ids, [b[:count] for b in tm.vectors])


@dataclass
class LogRecord:
    """One applied mutation batch, complete enough to REPLAY (DESIGN.md
    §10): async compaction builds a new base from a cut snapshot while
    mutations keep landing, then re-applies every post-cut record onto the
    new base before the atomic rebase. Replay is redo-only, so records
    carry the row CONTENT their batch introduced or removed:

      - insert/upsert: ``vectors`` = the new per-column blocks (aligned
        with ``ids``), re-appended under the SAME stable ids on replay;
      - delete: ``applied_ids`` = the ids actually tombstoned (stale
        deletes excluded) and ``vectors`` = those rows' prior contents —
        not needed for redo (a delete replays by id) but they make the log
        a complete undo/audit record and let tests reconstruct any table
        state between two cuts.

    Vectors are retained only until the next compaction truncates the log,
    so the memory bound is one compaction interval of churn."""

    lsn: int
    kind: str          # "insert" | "delete" | "upsert"
    n: int             # rows in the batch
    applied: int       # rows actually applied (deletes: non-stale)
    ids: np.ndarray    # stable ids touched
    vectors: list | None = None        # per-column blocks (see above)
    applied_ids: np.ndarray | None = None  # delete: non-stale subset of ids


@dataclass
class MutationLog:
    """Append-only LSN-stamped record of applied mutation batches."""

    records: list = field(default_factory=list)
    next_lsn: int = 0
    truncated_upto: int = 0  # LSNs below this were folded by a compaction
    inserted: int = 0        # row counters, cumulative across truncations
    deleted: int = 0
    upserted: int = 0
    stale_deletes: int = 0

    def append(self, kind: str, n: int, applied: int, ids: np.ndarray,
               vectors: list | None = None,
               applied_ids: np.ndarray | None = None) -> int:
        lsn = self.next_lsn
        self.next_lsn += 1
        self.records.append(LogRecord(lsn=lsn, kind=kind, n=n,
                                      applied=applied, ids=ids,
                                      vectors=vectors,
                                      applied_ids=applied_ids))
        if kind == "insert":
            self.inserted += applied
        elif kind == "delete":
            self.deleted += applied
            self.stale_deletes += n - applied
        else:
            self.upserted += applied
        return lsn

    def since(self, lsn: int) -> list:
        return [r for r in self.records if r.lsn >= lsn]

    def truncate(self, upto_lsn: int) -> int:
        """Drop records with lsn < upto_lsn (compaction cut). Returns the
        number of records dropped."""
        before = len(self.records)
        self.records = [r for r in self.records if r.lsn >= upto_lsn]
        self.truncated_upto = max(self.truncated_upto, upto_lsn)
        return before - len(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def stats(self) -> dict:
        return {"records": len(self.records), "next_lsn": self.next_lsn,
                "truncated_upto": self.truncated_upto,
                "inserted": self.inserted, "deleted": self.deleted,
                "upserted": self.upserted,
                "stale_deletes": self.stale_deletes}
