"""Shared device-memory governor (DESIGN.md §8).

One device, many tenants: every tenant's ``ColumnStore`` wants its hot
columns resident, but padded device bytes are a single shared pool. The
governor owns that pool:

  - every column admission is charged its PADDED device footprint
    (``columnstore.padded_device_bytes`` — kernel-block padding is real
    memory, logical nbytes undercount it);
  - per-tenant quotas bound any one tenant's resident set; a global budget
    bounds the device total;
  - admission over either limit evicts least-recently-used COLD columns —
    the victim's device tensor is spilled back to host (the host concat
    cache is retained, so a later access re-pads and re-uploads
    bit-identically), the tenant's own columns first for a quota breach,
    any tenant's for a budget breach. The store drops its reference at
    once; the CUDA memory is freed when the last reference goes (a flush
    in flight holds its own until it ends) and returns to the caching
    allocator, which keeps the block reserved for the next upload;
  - a single column larger than its limit is admitted anyway (the request
    holding it cannot be served otherwise) after evicting everything else
    evictable; such admissions are counted as ``overcommits``.

Every transition is counted so the benchmarks can assert the budget held
(``peak_bytes <= budget_bytes`` absent overcommit).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.core.types import TenantId, Vid
from repro_torch.obs import NULL_OBSERVER

_Key = tuple  # (TenantId, Vid)


class MemoryGovernor:
    """LRU device-byte accountant shared by every tenant's column store."""

    def __init__(self, budget_bytes: int, default_quota_bytes: int | None = None,
                 observer=None):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.budget_bytes = int(budget_bytes)
        self.default_quota_bytes = default_quota_bytes
        self._stores: dict[TenantId, object] = {}   # tenant -> column store
        self._delta_stores: dict[TenantId, object] = {}  # tenant -> segments
        self._semcaches: dict[TenantId, object] = {}  # tenant -> SemanticCache
        self._quota: dict[TenantId, int | None] = {}
        self._lru: OrderedDict[_Key, int] = OrderedDict()  # key -> nbytes
        self._tenant_bytes: dict[TenantId, int] = {}
        self.total_bytes = 0
        self.peak_bytes = 0
        self.evictions = 0
        self.overcommits = 0
        self.admissions = 0
        # Reentrant: eviction calls back into the owning store's
        # evict_device(), which reports the release back to us.
        self._lock = threading.RLock()

    @property
    def lock(self) -> threading.RLock:
        """The lock every accounting call holds, and eviction callbacks run
        under. A registered store that guards its own state with a lock
        takes this one first wherever it may call back into the governor."""
        return self._lock

    # ---- registration -----------------------------------------------------

    def register(self, tenant: TenantId, store,
                 quota_bytes: int | None = None) -> None:
        """Attach a tenant's column store (the evict callback target) and
        its quota (None = unlimited, bounded only by the global budget)."""
        with self._lock:
            self._stores[tenant] = store
            self._quota[tenant] = (quota_bytes if quota_bytes is not None
                                   else self.default_quota_bytes)
            self._tenant_bytes.setdefault(tenant, 0)

    def register_delta(self, tenant: TenantId, segments) -> None:
        """Attach a tenant's delta-segment cache (``ingest.DeltaSegments``).
        Delta uploads are charged under keys ``("delta",) + vid`` against
        the SAME tenant quota and global budget as resident base columns —
        a tenant's mutation stream competes with its own hot columns for
        device bytes, exactly like its base data does."""
        with self._lock:
            self._delta_stores[tenant] = segments

    def register_semcache(self, tenant: TenantId, cache) -> None:
        """Attach a tenant's semantic result cache (``online.SemanticCache``).
        Its device-resident query matrices are charged under keys
        ``("semcache", <namespace id>)`` against the same tenant quota and
        global budget — cached results compete with the tenant's hot
        columns for device bytes, and under pressure the governor spills
        cache namespaces exactly like cold columns (host ring retained)."""
        with self._lock:
            self._semcaches[tenant] = cache

    def rebind(self, tenant: TenantId, store) -> None:
        """Point an existing registration at a replacement column store
        (post-compaction swap); quota and accounting carry over, stale
        residency of the OLD store is released."""
        with self._lock:
            if tenant not in self._stores:
                raise KeyError(f"tenant {tenant!r} not registered")
            for key in [k for k in self._lru
                        if k[0] == tenant and k[1]
                        and k[1][0] not in ("delta", "semcache")]:
                self.release(*key)
            self._stores[tenant] = store

    def quota(self, tenant: TenantId) -> int | None:
        return self._quota.get(tenant, self.default_quota_bytes)

    # ---- accounting hooks (called by GovernedColumnStore) -----------------

    def acquire(self, tenant: TenantId, vid: Vid, nbytes: int) -> None:
        """Admit ``nbytes`` of padded device bytes for (tenant, vid),
        evicting LRU victims until the tenant quota and global budget hold.
        Must be called BEFORE the column is materialized on device."""
        nbytes = int(nbytes)
        with self._lock:
            key = (tenant, vid)
            if key in self._lru:  # already resident: refresh recency only
                self._lru.move_to_end(key)
                return
            quota = self.quota(tenant)
            if quota is not None:
                self._evict_until(
                    lambda: self._tenant_bytes.get(tenant, 0) + nbytes <= quota,
                    victims=lambda: [k for k in self._lru if k[0] == tenant])
                if self._tenant_bytes.get(tenant, 0) + nbytes > quota:
                    self.overcommits += 1  # single column above quota
                    self.obs.event("governor_overcommit", scope="quota",
                                   tenant=str(tenant), nbytes=nbytes)
            self._evict_until(
                lambda: self.total_bytes + nbytes <= self.budget_bytes,
                victims=lambda: list(self._lru))
            if self.total_bytes + nbytes > self.budget_bytes:
                self.overcommits += 1  # single column above the budget
                self.obs.event("governor_overcommit", scope="budget",
                               tenant=str(tenant), nbytes=nbytes)
            self._lru[key] = nbytes
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + nbytes
            self.total_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.total_bytes)
            self.admissions += 1

    def touch(self, tenant: TenantId, vid: Vid) -> None:
        """Mark (tenant, vid) most-recently-used (resident cache hit)."""
        with self._lock:
            key = (tenant, vid)
            if key in self._lru:
                self._lru.move_to_end(key)

    def release(self, tenant: TenantId, vid: Vid) -> None:
        """Drop accounting for a column no longer resident (store-initiated
        evict/spill, or our own eviction completing)."""
        with self._lock:
            nbytes = self._lru.pop((tenant, vid), None)
            if nbytes is None:
                return
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) - nbytes
            self.total_bytes -= nbytes

    # ---- eviction ---------------------------------------------------------

    def _evict_until(self, fits, victims) -> None:
        """Evict LRU victims (oldest first) until ``fits()`` or none left."""
        while not fits():
            pool = victims()
            if not pool:
                return
            victim_tenant, victim_vid = pool[0]  # OrderedDict: oldest first
            self._evict(victim_tenant, victim_vid)

    def _evict(self, tenant: TenantId, vid: Vid) -> None:
        # delta-segment keys are namespaced ("delta",) + vid and owned by
        # the tenant's DeltaSegments cache; ("semcache", ns) keys by its
        # SemanticCache — neither belongs to the column store
        if vid and vid[0] == "delta":
            store = self._delta_stores.get(tenant)
        elif vid and vid[0] == "semcache":
            store = self._semcaches.get(tenant)
        else:
            store = self._stores.get(tenant)
        self.evictions += 1
        if self.obs.enabled:
            kind = vid[0] if vid and vid[0] in ("delta", "semcache") \
                else "column"
            # ``key_kind``: ``Observer.event`` takes the event's own name as
            # ``kind``, so a ``kind=`` attribute would collide with it
            self.obs.event("governor_evict", tenant=str(tenant),
                           vid=str(vid), key_kind=kind,
                           nbytes=self._lru.get((tenant, vid), 0),
                           total_bytes=self.total_bytes)
            self.obs.counter("governor_evictions", tenant=str(tenant),
                             kind=kind)
        if store is not None:
            # evict_device() reports back through release(); RLock makes the
            # nested accounting update safe.
            store.evict_device(vid)
        self.release(tenant, vid)  # no-op if the store already reported

    # ---- introspection ----------------------------------------------------

    def tenant_bytes(self, tenant: TenantId) -> int:
        return self._tenant_bytes.get(tenant, 0)

    def resident(self) -> list[tuple[TenantId, Vid, int]]:
        """(tenant, vid, nbytes) in LRU order, coldest first."""
        with self._lock:
            return [(t, v, n) for (t, v), n in self._lru.items()]

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "total_bytes": self.total_bytes,
                "peak_bytes": self.peak_bytes,
                "utilization": self.total_bytes / self.budget_bytes,
                "evictions": self.evictions,
                "overcommits": self.overcommits,
                "admissions": self.admissions,
                "tenants": {t: {"bytes": self._tenant_bytes.get(t, 0),
                                "quota_bytes": self._quota.get(t)}
                            for t in sorted(self._stores)},
            }
