"""Index builders keyed by IndexSpec, with a build cache.

``IndexStore`` materializes real indexes over a MultiVectorDatabase —
multi-column specs index the column concatenation (valid because all columns
are L2-normalized, so concat-dot == sum of per-column cosine scores).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.types import DEFAULT_TENANT, IndexSpec, TenantId
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.base import VectorIndex
from repro_torch.index.bruteforce import FlatIndex
from repro_torch.index.graph import HNSWIndex, VamanaIndex
from repro_torch.index.ivf import IVFFlatIndex
from repro_torch.kernels.common import resolve_device

BUILDERS: dict[str, Callable[..., VectorIndex]] = {
    "hnsw": lambda data, seed=0, device=None, **kw: HNSWIndex(
        data, seed=seed, device=device, **kw),
    "diskann": lambda data, seed=0, device=None, **kw: VamanaIndex(
        data, seed=seed, device=device, **kw),
    "ivf": lambda data, seed=0, device=None, **kw: IVFFlatIndex(
        data, seed=seed, device=device,
        **{k: v for k, v in kw.items() if k != "col_dims"}),
    "flat": lambda data, seed=0, device=None, **kw: FlatIndex(data, device=device),
}


class IndexStore:
    """Build cache over ONE database. ``namespace`` tags the store with the
    tenant it belongs to. Dropping a spec only unlinks it from this store —
    a ``BatchEngine`` still holding the old store keeps its index objects
    alive until it lets go of the store. Indexes are built on ``device``."""

    def __init__(self, db: MultiVectorDatabase, seed: int = 0,
                 namespace: TenantId = DEFAULT_TENANT, device=None,
                 **builder_kwargs):
        self.db = db
        self.seed = seed
        self.namespace = namespace
        self.device = resolve_device(device)
        self.builder_kwargs = builder_kwargs
        self._cache: dict[IndexSpec, VectorIndex] = {}

    def get(self, spec: IndexSpec) -> VectorIndex:
        if spec not in self._cache:
            builder = BUILDERS[spec.kind]
            data = self.db.concat(spec.vid)
            kw = dict(self.builder_kwargs)
            if len(spec.vid) > 1 and spec.kind in ("hnsw", "diskann"):
                kw["col_dims"] = [self.db.dims[c] for c in spec.vid]
            self._cache[spec] = builder(data, seed=self.seed, device=self.device,
                                        **kw)
        return self._cache[spec]

    def __contains__(self, spec: IndexSpec) -> bool:
        return spec in self._cache

    def built_specs(self) -> list[IndexSpec]:
        return list(self._cache)

    def drop(self, spec: IndexSpec) -> bool:
        """Free one built index (returns whether it existed)."""
        return self._cache.pop(spec, None) is not None

    def prune(self, keep) -> list[IndexSpec]:
        """Drop every built index not in ``keep``; returns the dropped specs."""
        keep = frozenset(keep)
        dropped = [spec for spec in self._cache if spec not in keep]
        for spec in dropped:
            del self._cache[spec]
        return dropped

    def stats(self) -> dict:
        return {"namespace": self.namespace, "built": len(self._cache),
                "specs": sorted(s.name for s in self._cache)}
