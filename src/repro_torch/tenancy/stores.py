"""Namespaced multi-tenant stores (DESIGN.md §8).

``index.registry.IndexStore`` and ``serve.columnstore.ColumnStore`` are
single-database caches; these registries give every tenant its own,
namespaced by ``TenantId``:

  - ``GovernedColumnStore`` — a ColumnStore whose device residency is
    arbitrated by the shared ``MemoryGovernor`` (charge before upload,
    touch on hit, report spills);
  - ``TenantColumnStores`` / ``TenantIndexStores`` — per-tenant registries.
    Isolation is structural: a tenant's specs/vids live in its own store,
    so no key can collide across tenants and per-tenant results are
    bit-identical to a single-tenant deployment of the same store.

Stores live on ``device`` (None: the CUDA card); the charge is the padded
float32 footprint the reference charges (``ColumnStore.device_bytes``).
"""
from __future__ import annotations

from repro_torch.core.types import DEFAULT_TENANT, IndexSpec, TenantId, Vid, norm_vid
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.registry import IndexStore
from repro_torch.serve.columnstore import ColumnStore, DeviceColumn
from repro_torch.tenancy.governor import MemoryGovernor


class GovernedColumnStore(ColumnStore):
    """ColumnStore whose device residency answers to a MemoryGovernor."""

    def __init__(self, db: MultiVectorDatabase, governor: MemoryGovernor,
                 tenant: TenantId = DEFAULT_TENANT, **kw):
        super().__init__(db, **kw)
        self.governor = governor
        self.tenant = tenant

    def device(self, vid: Vid) -> DeviceColumn:
        vid = norm_vid(vid)
        gov = self.governor
        while True:
            # the check and its read, and the charge, under the governor's
            # lock: a flush on another worker that admits a column and evicts
            # this one cannot land between them (a KeyError)
            with gov.lock:
                col = self._device.get(vid)
                if col is not None:
                    gov.touch(self.tenant, vid)
                    return col
                # charge the padded footprint BEFORE materializing — the
                # governor evicts cold columns (ours for a quota breach,
                # anyone's for a budget breach) to make room
                gov.acquire(self.tenant, vid, self.device_bytes(vid))
            # the host pad and the upload outside it, so that a resident hit
            # on another worker does not wait for them
            col = self.upload(vid)
            with gov.lock:
                if gov.charged(self.tenant, vid):
                    return self._device.setdefault(vid, col)
            # evicted between the charge and the upload: charge it again

    def evict_device(self, vid: Vid) -> bool:
        evicted = super().evict_device(vid)
        if evicted:
            self.governor.release(self.tenant, norm_vid(vid))
        return evicted


class TenantColumnStores:
    """One GovernedColumnStore per tenant, all under one governor."""

    def __init__(self, governor: MemoryGovernor):
        self.governor = governor
        self._stores: dict[TenantId, GovernedColumnStore] = {}

    def register(self, tenant: TenantId, db: MultiVectorDatabase,
                 quota_bytes: int | None = None, device=None,
                 **kw) -> GovernedColumnStore:
        if tenant in self._stores:
            raise ValueError(f"tenant {tenant!r} already registered")
        store = GovernedColumnStore(db, self.governor, tenant=tenant,
                                    device=device, **kw)
        self.governor.register(tenant, store, quota_bytes=quota_bytes)
        self._stores[tenant] = store
        return store

    def get(self, tenant: TenantId) -> GovernedColumnStore:
        return self._stores[tenant]

    def replace(self, tenant: TenantId, db: MultiVectorDatabase, device=None,
                **kw) -> GovernedColumnStore:
        """Swap a registered tenant onto a new database (post-compaction):
        a fresh governed store under the same quota; the old store's
        residency accounting is released by ``governor.rebind``."""
        if tenant not in self._stores:
            raise ValueError(f"tenant {tenant!r} not registered")
        store = GovernedColumnStore(db, self.governor, tenant=tenant,
                                    device=device, **kw)
        self.governor.rebind(tenant, store)
        self._stores[tenant] = store
        return store

    def __contains__(self, tenant: TenantId) -> bool:
        return tenant in self._stores

    def tenants(self) -> list[TenantId]:
        return sorted(self._stores)


class TenantIndexStores:
    """One IndexStore per tenant — the namespaced index registry."""

    def __init__(self):
        self._stores: dict[TenantId, IndexStore] = {}

    def register(self, tenant: TenantId, db: MultiVectorDatabase,
                 seed: int = 0, device=None, **builder_kwargs) -> IndexStore:
        if tenant in self._stores:
            raise ValueError(f"tenant {tenant!r} already registered")
        store = IndexStore(db, seed=seed, namespace=tenant, device=device,
                           **builder_kwargs)
        self._stores[tenant] = store
        return store

    def get(self, tenant: TenantId) -> IndexStore:
        return self._stores[tenant]

    def replace(self, tenant: TenantId, store: IndexStore) -> IndexStore:
        """Swap a registered tenant onto a shadow-built store (compaction:
        the new base's indexes were built off the serving path)."""
        if tenant not in self._stores:
            raise ValueError(f"tenant {tenant!r} not registered")
        self._stores[tenant] = store
        return store

    def index(self, tenant: TenantId, spec: IndexSpec):
        """Namespaced index lookup: (tenant, spec) -> built index."""
        return self._stores[tenant].get(spec)

    def drop(self, tenant: TenantId, spec: IndexSpec) -> bool:
        return self._stores[tenant].drop(spec)

    def prune(self, tenant: TenantId, keep) -> list[IndexSpec]:
        return self._stores[tenant].prune(keep)

    def __contains__(self, tenant: TenantId) -> bool:
        return tenant in self._stores

    def tenants(self) -> list[TenantId]:
        return sorted(self._stores)

    def stats(self) -> dict:
        return {t: s.stats() for t, s in sorted(self._stores.items())}
