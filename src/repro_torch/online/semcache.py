"""Device-resident semantic result cache in front of the scheduler
(DESIGN.md §13).

At hot-item traffic, many queries are near-duplicates of recently answered
ones; each still pays a full micro-batch flush + fused-scan dispatch. The
``SemanticCache`` short-circuits them: before a ticket enters the
``MicroBatcher``, the query vector is probed against a small device-resident
matrix of recently answered queries — ONE batched brute-force L2 call (the
streaming fused scan on the card, its plain version on the CPU; the cache is
just a tiny second table) — and if the nearest cached query lies within
ε, its stored top-k ids are served with no flush at all. Misses fall
through to the batcher carrying an ``AdmissionToken``; the flush completion
path admits (query vector, result ids) into the cache.

Correctness is delegated to machinery that already exists:

- **Namespaces.** Entries live in per-signature namespaces keyed by
  ``(vid, k, plan signature, predicate AST, plan-cache generation, data
  epoch)``. The plan signature covers access path + (index vid, kind, ek)
  triples, so a retuned plan never matches an old namespace; the predicate
  AST (``filter/predicate.py``, hashable) isolates filtered queries; the
  generation is the tenant-scoped plan-cache generation, so every retune
  swap, compaction rebase, and ``swap_tenant`` invalidates for free. The
  data epoch is this cache's own counter, bumped by the ingest paths on
  every mutation flush (mutations deliberately do NOT bump the plan-cache
  generation — planner templates stay valid across inserts).
- **ε verification on the host.** The device probe only NOMINATES the
  nearest cached query (f32 kernel arithmetic); a float64 exact squared-L2
  check against the stored vector decides the hit, so ε=0 means bit-exact
  query equality and cached hits are bit-identical to the engine.
- **Admission keys are recomputed at admission time.** A ticket submitted
  at epoch E may flush after a mutation bumped the epoch to E+1; its
  results reflect the table at flush time, so they are admitted under the
  CURRENT (generation, epoch) — stale-keyed admissions into dead
  namespaces cannot happen. The runtime's lock ordering (mutations and
  swaps hold the batcher lock across ``sync_inflight``/``drain`` before
  bumping) guarantees in-flight admissions land before any bump.
- **The resident matrix.** Each namespace keeps its query matrix as a
  float32 tensor on the cache's device, with its squared row norms beside
  it; both are rebuilt only when an admission changed the ring
  (``dev_version``), and the probe scans them in place — no host round
  trip and no norm reduction per probe. With a ``MemoryGovernor`` attached
  the matrix is charged under ``("semcache", ns_id)`` at the reference's
  padded footprint (``_Namespace.device_bytes``); the norms beside it
  (capacity x 4 bytes) are not charged. ``evict_device`` drops the matrix
  and its norms together (the host ring stays; the next probe re-uploads
  both bit-identically).

Per-namespace storage is a fixed-capacity FIFO ring over (query vector,
result ids); namespaces themselves are LRU-bounded per cache instance, and
dead generations/epochs are swept opportunistically on every probe/bump.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.types import DEFAULT_TENANT, Query, QueryPlan, TenantId
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.distance.ref import squared_norms
from repro_torch.obs import NULL_OBSERVER
from repro_torch.serve.columnstore import padded_device_bytes
from repro_torch.serve.engine import cache_probe_scan


@dataclass
class SemCacheConfig:
    epsilon: float = 0.0       # max L2 distance between query vectors for a
                               # hit (0 = exact query match only)
    capacity: int = 256        # entries per namespace (FIFO ring)
    max_namespaces: int = 32   # live namespaces per cache instance (LRU)


@dataclass
class _Namespace:
    """One (signature, generation, epoch) slice of the cache: a host ring
    of recent query vectors + their result ids, and a lazily refreshed
    device copy of the query matrix (the probe's scan target)."""

    key: tuple
    ns_id: int
    queries: np.ndarray                 # (capacity, dim) f32 ring buffer
    results: list = field(default_factory=list)  # slot -> np.ndarray ids
    n: int = 0                          # filled slots
    w: int = 0                          # next write cursor
    version: int = 0                    # bumped per admission
    dev: torch.Tensor | None = None     # device copy of ``queries``
    dev_sq: torch.Tensor | None = None  # squared_norms(dev), kept beside it
    dev_version: int = -1
    charged: bool = False               # device bytes held in the governor

    @property
    def gvid(self) -> tuple:
        """Governor accounting key for this namespace's device matrix."""
        return ("semcache", self.ns_id)

    @property
    def device_bytes(self) -> int:
        return padded_device_bytes(self.queries.shape[0],
                                   self.queries.shape[1])


class AdmissionToken:
    """Rides a miss ticket through its flush; ``admit(ids)`` on completion
    inserts (query vector, ids) into the issuing cache. Binding the cache
    here lets the batcher stay tenant-agnostic — the multi-tenant router
    hands out tokens bound to the right tenant's cache."""

    __slots__ = ("cache", "sig", "qvec")

    def __init__(self, cache: "SemanticCache", sig: tuple, qvec: np.ndarray):
        self.cache = cache
        self.sig = sig
        self.qvec = qvec

    def admit(self, ids: np.ndarray) -> None:
        self.cache.admit(self, ids)


class SemanticCache:
    """Bounded device-resident (query vector, plan, predicate) → top-k
    cache for ONE tenant. ``probe`` returns ``(ids, token)``: exactly one
    side is non-None — served ids on a hit, an admission token on a miss.

    ``scan(qmat, mat, valid_n, mat_sq) -> (vals, ids)`` is the batched
    probe primitive (default: ``serve.engine.cache_probe_scan`` on
    ``device``; the runtime passes its engine's ``cache_probe``), called
    with the namespace's resident matrix and its squared norms;
    ``generation`` supplies the tenant's current plan-cache generation.
    ``device=None`` is the CUDA card. Thread-safe: probes run under the
    batcher lock, admissions may arrive from flush workers. With a governor,
    every path that may call it takes the governor's lock before the
    cache's, the order in which a spill (``evict_device``, called under the
    governor's lock by another store's admission) takes them.
    """

    def __init__(self, config: SemCacheConfig | None = None, *,
                 scan=None, generation=None, governor=None,
                 tenant: TenantId = DEFAULT_TENANT, device=None,
                 observer=None):
        self.config = config or SemCacheConfig()
        self.obs = observer if observer is not None else NULL_OBSERVER
        if self.config.capacity < 1:
            raise ValueError("semcache capacity must be >= 1")
        self.device = resolve_device(device)
        self.scan = scan if scan is not None else self._default_scan
        self._generation = generation
        self.governor = governor
        self.tenant = tenant
        self.epoch = 0
        self.lock = threading.RLock()
        self._ns: OrderedDict[tuple, _Namespace] = OrderedDict()  # LRU
        self._by_gvid: dict[tuple, _Namespace] = {}
        self._ids = itertools.count()
        # stats
        self.hits = 0
        self.misses = 0
        self.near_misses = 0       # device nominated a neighbor, ε rejected
        self.admissions = 0
        self.invalidations = 0     # epoch bumps
        self.dropped_namespaces = 0

    # ---- key derivation ---------------------------------------------------

    @staticmethod
    def signature(query: Query, plan: QueryPlan) -> tuple:
        """Everything besides the vector that must match for a cached
        result to be servable: target vid + k, the plan's access path and
        (index, ek) choices, and the predicate AST (hashable, DESIGN §12)."""
        plansig = (plan.access_path,) + tuple(
            (spec.vid, spec.kind, ek)
            for spec, ek in zip(plan.indexes, plan.eks))
        return (query.vid, query.k, plansig, query.predicate)

    def _key(self, sig: tuple) -> tuple:
        gen = self._generation() if self._generation is not None else 0
        return sig + (gen, self.epoch)

    # ---- hot path ---------------------------------------------------------

    def probe(self, query: Query, plan: QueryPlan,
              tenant: TenantId = DEFAULT_TENANT):
        """Return ``(ids, None)`` on a hit or ``(None, token)`` on a miss."""
        qvec = np.ascontiguousarray(query.concat(), dtype=np.float32)
        with self._locked():
            self._sweep()
            sig = self.signature(query, plan)
            key = self._key(sig)
            ns = self._ns.get(key)
            if ns is None or ns.n == 0:
                self.misses += 1
                return None, AdmissionToken(self, sig, qvec)
            self._ns.move_to_end(key)
            mat = self._device(ns)
            _, ids = self.scan(qvec[None, :], mat, ns.n, ns.dev_sq)
            slot = int(np.asarray(ids)[0, 0])
            if 0 <= slot < ns.n:
                stored = ns.queries[slot].astype(np.float64)
                d2 = float(np.sum((qvec.astype(np.float64) - stored) ** 2))
                if d2 <= float(self.config.epsilon) ** 2:
                    self.hits += 1
                    return ns.results[slot].copy(), None
                self.near_misses += 1
            self.misses += 1
            return None, AdmissionToken(self, sig, qvec)

    def admit(self, token: AdmissionToken, ids: np.ndarray) -> None:
        """Insert a flushed result. Keyed by the CURRENT (generation,
        epoch): the result reflects the table at flush time (see module
        docstring for why this is race-free under the runtime's locks)."""
        if ids is None:
            return
        arr = np.array(ids, copy=True)
        with self._locked():
            key = self._key(token.sig)
            ns = self._ns.get(key)
            if ns is None:
                ns = self._make_ns(key, token.qvec.shape[0])
            else:
                self._ns.move_to_end(key)
            ns.queries[ns.w] = token.qvec
            if ns.w < len(ns.results):
                ns.results[ns.w] = arr
            else:
                ns.results.append(arr)
            ns.w = (ns.w + 1) % self.config.capacity
            ns.n = min(ns.n + 1, self.config.capacity)
            ns.version += 1
            self.admissions += 1

    # ---- invalidation -----------------------------------------------------

    def bump(self) -> None:
        """Data-epoch bump: every namespace becomes dead. Called by the
        ingest paths on mutation flush (compaction/retune/swap invalidate
        via the plan-cache generation instead)."""
        with self._locked():
            self.epoch += 1
            self.invalidations += 1
            self._sweep()
        self.obs.event("semcache_invalidate", tenant=str(self.tenant),
                       epoch=self.epoch)

    def invalidate(self) -> None:
        """Drop everything (epoch bump + eager sweep)."""
        self.bump()

    @contextmanager
    def _locked(self):
        """The governor's lock (when governed), then the cache's."""
        with self.governor.lock if self.governor is not None else nullcontext():
            with self.lock:
                yield

    # ---- internals (caller holds ``_locked()``) ---------------------------

    def _sweep(self) -> None:
        gen = self._generation() if self._generation is not None else 0
        cur = (gen, self.epoch)
        for key in [k for k in self._ns if k[-2:] != cur]:
            self._drop(key)

    def _drop(self, key: tuple) -> None:
        ns = self._ns.pop(key)
        self._by_gvid.pop(ns.gvid, None)
        if ns.charged and self.governor is not None:
            self.governor.release(self.tenant, ns.gvid)
        self.dropped_namespaces += 1

    def _make_ns(self, key: tuple, dim: int) -> _Namespace:
        while len(self._ns) >= max(1, self.config.max_namespaces):
            oldest = next(iter(self._ns))
            self._drop(oldest)
        ns = _Namespace(key=key, ns_id=next(self._ids),
                        queries=np.zeros((self.config.capacity, dim),
                                         dtype=np.float32))
        self._ns[key] = ns
        self._by_gvid[ns.gvid] = ns
        return ns

    def _device(self, ns: _Namespace) -> torch.Tensor:
        """Resident float32 copy of the namespace's query matrix and its
        squared norms, rebuilt only after admissions and spills: a probe of
        an unchanged ring scans the same tensor again. ``torch.tensor``
        copies, so a later admission into the host ring never aliases it.
        The matrix's padded bytes are charged on materialization."""
        if ns.dev is None or ns.dev_version != ns.version:
            if self.governor is not None:
                if ns.charged:
                    self.governor.touch(self.tenant, ns.gvid)
                else:
                    self.governor.acquire(self.tenant, ns.gvid,
                                          ns.device_bytes)
                    ns.charged = True
            ns.dev = torch.tensor(ns.queries, device=self.device)
            ns.dev_sq = squared_norms(ns.dev)
            ns.dev_version = ns.version
        elif self.governor is not None and ns.charged:
            self.governor.touch(self.tenant, ns.gvid)
        return ns.dev

    def _default_scan(self, qmat, mat, valid_n, mat_sq=None):
        return cache_probe_scan(qmat, mat, valid_n, device=self.device,
                                mat_sq=mat_sq)

    # ---- governor spill protocol ------------------------------------------

    def evict_device(self, vid: tuple) -> bool:
        """Governor spill callback: release the device matrix of one
        namespace (host ring retained — the next probe re-uploads)."""
        with self._locked():
            ns = self._by_gvid.get(tuple(vid))
            if ns is None or ns.dev is None:
                return False
            ns.dev = ns.dev_sq = None
            ns.dev_version = -1
            ns.charged = False
            return True

    # ---- reporting --------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def device_bytes(self) -> int:
        with self.lock:
            return sum(ns.device_bytes for ns in self._ns.values()
                       if ns.dev is not None)

    def stats(self) -> dict:
        with self.lock:
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": self.hit_rate,
                    "near_misses": self.near_misses,
                    "admissions": self.admissions,
                    "invalidations": self.invalidations,
                    "namespaces": len(self._ns),
                    "dropped_namespaces": self.dropped_namespaces,
                    "entries": sum(ns.n for ns in self._ns.values()),
                    "device_bytes": sum(ns.device_bytes
                                        for ns in self._ns.values()
                                        if ns.dev is not None),
                    "epsilon": self.config.epsilon,
                    "epoch": self.epoch}


class TenantSemCaches:
    """Routes the batcher's single probe hook to per-tenant caches. Misses
    hand out tokens bound to the owning cache, so admissions route
    themselves and the batcher never needs tenant dispatch logic."""

    def __init__(self, caches: dict[TenantId, SemanticCache]):
        self.caches = dict(caches)

    def get(self, tenant: TenantId) -> SemanticCache | None:
        return self.caches.get(tenant)

    def probe(self, query: Query, plan: QueryPlan,
              tenant: TenantId = DEFAULT_TENANT):
        cache = self.caches.get(tenant)
        if cache is None:
            return None, None
        return cache.probe(query, plan, tenant)

    def stats(self) -> dict:
        return {t: c.stats() for t, c in sorted(self.caches.items())}
