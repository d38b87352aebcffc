"""Background compactor: fold delta segments + tombstones into a new base.

Delta scans and tombstone masks keep results exact but pay for it on every
query — dead rows are still scanned, delta rows cost one extra dispatch per
(group, index). The compactor reclaims that work: when a trigger fires
(delta fraction, dead fraction, or log length), it

  1. materializes the live table (``MutableTable.materialize`` — rows in
     ascending stable-id order, so post-compaction scans break score ties
     exactly like the delta-merge path did);
  2. shadow-builds the serving configuration's indexes and a fresh column
     store over the new snapshot — all OFF the serving path;
  3. hands the built state to the caller, which swaps the engine's stores
     (``BatchEngine.swap_store``) and rebases the table (clearing
     delta/tombstones, truncating the log to the compaction cut).

The compactor never mutates serving state itself: ``build()`` is pure
construction, and the caller owns the swap.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.registry import IndexStore
from repro_torch.ingest.table import MutableTable
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.columnstore import ColumnStore


@dataclass
class CompactionPolicy:
    """Trigger thresholds. ``None`` disables a trigger."""

    max_delta_fraction: float | None = 0.2   # live delta rows / live rows
    max_dead_fraction: float | None = 0.25   # tombstoned / physical rows
    max_log_records: int | None = None       # mutation batches since last cut
    min_mutated_rows: int = 1                # gate: no-op tables never fire

    def should_compact(self, table: MutableTable) -> str | None:
        """First trigger that fires, as a reason string (None: none did)."""
        if table.n_delta + table.n_dead < self.min_mutated_rows:
            return None
        if (self.max_delta_fraction is not None
                and table.delta_fraction >= self.max_delta_fraction):
            return f"delta_fraction {table.delta_fraction:.3f}"
        if (self.max_dead_fraction is not None
                and table.dead_fraction >= self.max_dead_fraction):
            return f"dead_fraction {table.dead_fraction:.3f}"
        if (self.max_log_records is not None
                and len(table.log) >= self.max_log_records):
            return f"log_records {len(table.log)}"
        return None


@dataclass
class CompactionStats:
    reason: str
    upto_lsn: int              # compaction cut: log records below are folded
    rows_before: int           # physical rows scanned pre-compaction
    rows_after: int            # live rows in the new base
    delta_folded: int
    dead_reclaimed: int
    specs_rebuilt: int
    build_seconds: float
    # deterministic work proxy for the build (rows x total column dims x
    # (1 + indexes rebuilt)) — wall-clock-free, so trace replay (autotune)
    # can model compaction occupancy reproducibly
    build_cost: float = 0.0


@dataclass
class CompactionCut:
    """A consistent snapshot of the live table at one log LSN — the input
    to an (async) shadow build. Cheap to take (one materialize under the
    table lock); the slow index build runs off it, off the serving path."""

    db: MultiVectorDatabase
    ids: np.ndarray            # stable id per snapshot physical row
    upto_lsn: int              # records below are IN the snapshot
    rows_before: int           # physical rows at the cut
    delta_folded: int
    dead_reclaimed: int


@dataclass
class CompactedState:
    """Shadow-built serving state, ready for an atomic swap."""

    db: MultiVectorDatabase
    ids: np.ndarray            # stable id per new physical row (ascending)
    store: IndexStore
    cstore: ColumnStore | None
    stats: CompactionStats


class Compactor:
    """Policy-driven compaction over one MutableTable; shadow builds run on
    ``device`` (None: the CUDA card)."""

    def __init__(self, table: MutableTable,
                 policy: CompactionPolicy | None = None, seed: int = 0,
                 builder_kwargs: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.table = table
        self.policy = policy or CompactionPolicy()
        self.seed = seed
        self.builder_kwargs = dict(builder_kwargs or {})
        self.history: list[CompactionStats] = []

    def should_compact(self) -> str | None:
        return self.policy.should_compact(self.table)

    def cut(self) -> CompactionCut:
        """Snapshot the live table at its current log LSN (cheap, one
        materialize). Mutations may keep landing after the cut — they stay
        in the log and are REPLAYED onto the built base at rebase time
        (``MutableTable.rebase(..., replay=...)``), which is what lets the
        slow build below run off the serving path (DESIGN.md §10)."""
        table = self.table
        delta_folded, dead = table.n_delta, table.n_dead
        rows_before = table.n_base + table.n_delta
        db, ids, upto_lsn = table.snapshot()
        return CompactionCut(db=db, ids=ids, upto_lsn=upto_lsn,
                             rows_before=rows_before,
                             delta_folded=delta_folded, dead_reclaimed=dead)

    def build_from(self, cut: CompactionCut, configuration,
                   reason: str = "manual", make_cstore=None) -> CompactedState:
        """Shadow-build serving state over a cut snapshot (no serving state
        touched — pure construction, safe on a worker thread). The caller
        swaps the result into its engine and then calls
        ``table.rebase(state.db, state.ids, state.stats.upto_lsn,
        replay=log.since(upto_lsn))``.

        ``make_cstore`` customizes column-store construction; ``None``
        builds a plain ``ColumnStore`` on the compactor's device; ``False``
        skips it (caller builds its own).
        """
        t0 = time.time()
        db, ids = cut.db, cut.ids
        store = IndexStore(db, seed=self.seed, device=self.device,
                           **self.builder_kwargs)
        built = 0
        for spec in sorted(configuration, key=lambda s: s.name):
            store.get(spec)
            built += 1
        if make_cstore is False:
            cstore = None
        elif make_cstore is not None:
            cstore = make_cstore(db)
        else:
            cstore = ColumnStore(db, device=self.device)
        total_dims = sum(db.dims)
        stats = CompactionStats(
            reason=reason, upto_lsn=cut.upto_lsn,
            rows_before=cut.rows_before, rows_after=db.n_rows,
            delta_folded=cut.delta_folded,
            dead_reclaimed=cut.dead_reclaimed, specs_rebuilt=built,
            build_seconds=time.time() - t0,
            build_cost=float(db.n_rows) * float(total_dims) * (1.0 + built))
        self.history.append(stats)
        return CompactedState(db=db, ids=ids, store=store, cstore=cstore,
                              stats=stats)

    def build(self, configuration, reason: str = "manual",
              make_cstore=None) -> CompactedState:
        """Synchronous cut + build (the in-line compaction path)."""
        return self.build_from(self.cut(), configuration, reason=reason,
                               make_cstore=make_cstore)

    def stats(self) -> dict:
        return {"compactions": len(self.history),
                "total_build_seconds": float(
                    sum(s.build_seconds for s in self.history)),
                "rows_reclaimed": int(
                    sum(s.dead_reclaimed for s in self.history)),
                "delta_folded": int(
                    sum(s.delta_folded for s in self.history))}
