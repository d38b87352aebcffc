"""Streaming mutation subsystem: an LSM-style mutation layer over the
immutable indexes —

  - ``mutation``  : typed insert/delete/upsert batches + the LSN log;
  - ``table``     : MutableTable — immutable base + delta rows +
                    tombstones over stable item ids;
  - ``delta``     : device-resident delta segments (brute-force scanned by
                    the scan kernels) + the engine-facing MutationView;
  - ``compactor`` : policy-triggered fold of delta + tombstones into a new
                    base with shadow-built indexes;
  - ``drift``     : DataDriftDetector — delta fraction, cumulative churn,
                    per-column centroid shift;
  - ``runtime``   : IngestRuntime — the online runtime plus the mutation
                    path, async compaction and data-drift retunes.
"""
from repro_torch.ingest.compactor import (CompactionCut, CompactionPolicy,
                                          CompactionStats, Compactor)
from repro_torch.ingest.delta import DeltaSegments, MutationView
from repro_torch.ingest.drift import DataDriftDetector, DataDriftReport
from repro_torch.ingest.mutation import (DeleteBatch, InsertBatch, MutationLog,
                                         UpsertBatch)
from repro_torch.ingest.runtime import (CompactionEvent, DataRetuneEvent,
                                        IngestConfig, IngestRuntime)
from repro_torch.ingest.table import MutableTable

__all__ = [
    "CompactionCut", "CompactionEvent", "CompactionPolicy",
    "CompactionStats", "Compactor",
    "DataDriftDetector", "DataDriftReport", "DataRetuneEvent", "DeleteBatch",
    "DeltaSegments", "IngestConfig", "IngestRuntime", "InsertBatch",
    "MutableTable", "MutationLog", "MutationView", "UpsertBatch",
]
