"""Multi-tenant serving subsystem (DESIGN.md §8).

Retires the single-database assumption baked into the stores and caches:
``TenantId``-namespaced index/column stores, a shared device-memory
governor (per-tenant quotas + global budget + LRU spill), and a serving
runtime with deficit-round-robin fairness and per-tenant plan-cache
generations. Joint cross-tenant tuning lives in
``core.tuner.tune_tenants``.
"""
from repro_torch.core.types import DEFAULT_TENANT, TenantId
from repro_torch.tenancy.governor import MemoryGovernor
from repro_torch.tenancy.runtime import MultiTenantRuntime, Tenant
from repro_torch.tenancy.stores import (GovernedColumnStore,
                                        TenantColumnStores, TenantIndexStores)

__all__ = [
    "DEFAULT_TENANT",
    "GovernedColumnStore",
    "MemoryGovernor",
    "MultiTenantRuntime",
    "Tenant",
    "TenantColumnStores",
    "TenantId",
    "TenantIndexStores",
]
