"""Per-row attribute columns for filtered search (DESIGN.md §12).

``AttributeStore`` holds one packed array per field, indexed by the SAME
stable item ids the ingest layer hands out (``ingest/table.py``): base row
ids, delta-segment ids, and post-compaction ids all index the same arrays,
so attributes survive rebases for free.

Field vocabulary (after redisvl's schema kinds):
  * ``tag``      — categorical string; stored as int32 vocab codes,
                   ``-1`` = missing. Unknown query values encode to a
                   never-matching code.
  * ``numeric``  — float32, ``NaN`` = missing (NaN compares false under
                   every Eq/Range, which is exactly the missing-never-
                   matches rule).
  * ``texthash`` — free text matched by equality only; stored as a
                   deterministic 64-bit blake2b hash (int64), int64-min =
                   missing.

Columns grow geometrically as ids arrive. Host evaluation
(``bitmap``, numpy) and device evaluation (``device_bitmap``, torch on the
store's device) share one AST walker parameterised by the array
namespace, so they agree bit-for-bit.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.filter.predicate import And, Eq, In, Not, Or, Predicate, Range
from repro_torch.kernels.common import resolve_device

TAG, NUMERIC, TEXTHASH = "tag", "numeric", "texthash"
_KINDS = (TAG, NUMERIC, TEXTHASH)

_TAG_MISSING = np.int32(-1)
_TAG_NEVER = np.int32(-2)          # encode() result for unknown query values
_HASH_MISSING = np.int64(np.iinfo(np.int64).min)


def text_hash(value) -> np.int64:
    """Deterministic 64-bit hash of a string (blake2b, not PYTHONHASHSEED)."""
    h = hashlib.blake2b(str(value).encode("utf-8"), digest_size=8).digest()
    v = np.int64(int.from_bytes(h, "little", signed=True))
    if v == _HASH_MISSING:  # pragma: no cover - 2^-64 corner
        v = np.int64(_HASH_MISSING + 1)
    return v


@dataclass(frozen=True)
class FieldSpec:
    name: str
    kind: str  # tag | numeric | texthash

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown field kind {self.kind!r} (want {_KINDS})")


def _false_like(col):
    """All-False bool array of ``col``'s shape, in ``col``'s namespace."""
    if isinstance(col, torch.Tensor):
        return torch.zeros(col.shape, dtype=torch.bool, device=col.device)
    return np.zeros(col.shape, dtype=bool)


class AttributeStore:
    """Packed per-field columns keyed by stable item id. The columns live
    on the host; ``device_column`` / ``device_bitmap`` copy them to
    ``device`` (None: the CUDA card, resolved on first device use, so a
    host-only store never needs one)."""

    def __init__(self, fields, capacity: int = 0, device=None):
        self.fields: dict[str, FieldSpec] = {}
        for f in fields:
            spec = f if isinstance(f, FieldSpec) else FieldSpec(*f)
            self.fields[spec.name] = spec
        self._cols: dict[str, np.ndarray] = {
            name: self._empty(spec.kind, capacity)
            for name, spec in self.fields.items()}
        self._vocab: dict[str, dict] = {
            name: {} for name, spec in self.fields.items() if spec.kind == TAG}
        self.version = 0            # bumps on every put(); caches key on it
        self._device: dict[str, tuple] = {}   # field -> (version, device column)
        self.device = device

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    # ---- storage ----------------------------------------------------------

    @staticmethod
    def _empty(kind: str, n: int) -> np.ndarray:
        if kind == TAG:
            return np.full(n, _TAG_MISSING, dtype=np.int32)
        if kind == NUMERIC:
            return np.full(n, np.nan, dtype=np.float32)
        return np.full(n, _HASH_MISSING, dtype=np.int64)

    @property
    def capacity(self) -> int:
        return next(iter(self._cols.values())).shape[0] if self._cols else 0

    def _ensure(self, upto: int) -> None:
        cap = self.capacity
        if upto <= cap:
            return
        new = max(upto, 2 * cap, 64)
        for name, spec in self.fields.items():
            grown = self._empty(spec.kind, new)
            grown[:cap] = self._cols[name]
            self._cols[name] = grown

    def encode(self, field: str, value, grow: bool = False):
        """Scalar encoding of a query/storage value for ``field``.

        Tag values unseen at storage time encode to a never-matching code
        (query side), or get a fresh vocab code (``grow=True``, put side)."""
        spec = self.fields[field]
        if spec.kind == NUMERIC:
            return np.float32(value)
        if spec.kind == TEXTHASH:
            return text_hash(value)
        vocab = self._vocab[field]
        code = vocab.get(value)
        if code is None:
            if not grow:
                return _TAG_NEVER
            code = np.int32(len(vocab))
            vocab[value] = code
        return np.int32(code)

    def put(self, ids, values: dict) -> None:
        """Write attribute values for rows ``ids``.

        ``values`` maps field name -> sequence. Sequences longer than
        ``ids`` are truncated (mutation resolution can shrink a batch,
        e.g. upserts against a small live pool); shorter is an error.
        Unknown field names raise. Bumps ``version``."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0 or not values:
            return
        self._ensure(int(ids.max()) + 1)
        for name, vals in values.items():
            spec = self.fields.get(name)
            if spec is None:
                raise KeyError(f"unknown attribute field {name!r}")
            vals = list(vals) if not isinstance(vals, np.ndarray) else vals
            if len(vals) < ids.size:
                raise ValueError(
                    f"field {name!r}: {len(vals)} values for {ids.size} ids")
            col = self._cols[name]
            if spec.kind == NUMERIC:
                col[ids] = np.asarray(vals[:ids.size], dtype=np.float32)
            else:
                col[ids] = [self.encode(name, v, grow=True)
                            for v in vals[:ids.size]]
        self.version += 1
        self._device.clear()

    def take(self, field: str, ids) -> np.ndarray:
        """Encoded values of ``field`` for stable ids (host).

        Ids beyond the stored capacity read as missing — rows inserted
        without attributes simply never match positive predicates."""
        col = self._cols[field]
        ids = np.asarray(ids, dtype=np.int64)
        out = self._empty(self.fields[field].kind, ids.size)
        ok = (ids >= 0) & (ids < col.shape[0])
        out[ok] = col[ids[ok]]
        return out

    def device_column(self, field: str) -> torch.Tensor:
        """Device copy of the packed column, cached per ``version``."""
        hit = self._device.get(field)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        col = torch.as_tensor(self._cols[field], device=self.torch_device)
        self._device[field] = (self.version, col)
        return col

    # ---- evaluation -------------------------------------------------------

    def bitmap(self, pred: Predicate, ids) -> np.ndarray:
        """Host bool bitmap: does each of ``ids`` match ``pred``?"""
        ids = np.asarray(ids, dtype=np.int64)
        cache: dict[str, np.ndarray] = {}

        def take(field):
            if field not in cache:
                cache[field] = self.take(field, ids)
            return cache[field]

        return self._eval(pred, take, np)

    def device_bitmap(self, pred: Predicate, ids) -> torch.Tensor:
        """Device bool bitmap over stable ids — identical semantics to
        :meth:`bitmap` (same walker, torch namespace); feeds kernel
        ``keep_mask`` operands."""
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                              device=self.torch_device)
        cache: dict = {}

        def take(field):
            if field not in cache:
                col = self.device_column(field)
                n = col.shape[0]
                miss = self._empty(self.fields[field].kind, 1)
                if n == 0:
                    cache[field] = torch.as_tensor(miss, device=ids.device).expand(
                        ids.shape).clone()
                else:
                    ok = (ids >= 0) & (ids < n)
                    vals = col[torch.clamp(ids, 0, n - 1)]
                    cache[field] = vals.masked_fill(~ok, miss[0].item())
            return cache[field]

        return self._eval(pred, take, torch)

    def _eval(self, pred, take, xp):
        if isinstance(pred, Eq):
            return take(pred.field) == self.encode(pred.field, pred.value)
        if isinstance(pred, In):
            col = take(pred.field)
            out = _false_like(col)
            for v in pred.values:
                out = out | (col == self.encode(pred.field, v))
            return out
        if isinstance(pred, Range):
            if self.fields[pred.field].kind != NUMERIC:
                raise TypeError(f"Range on non-numeric field {pred.field!r}")
            col = take(pred.field)
            ok = ~xp.isnan(col)
            if pred.lo is not None:
                ok = ok & (col >= np.float32(pred.lo))
            if pred.hi is not None:
                ok = ok & (col <= np.float32(pred.hi))
            return ok
        if isinstance(pred, (And, Or)):
            if not pred.children:
                raise ValueError(f"{type(pred).__name__}() needs children")
            out = None
            for c in pred.children:
                b = self._eval(c, take, xp)
                if out is None:
                    out = b
                else:
                    out = (out & b) if isinstance(pred, And) else (out | b)
            return out
        if isinstance(pred, Not):
            return ~self._eval(pred.child, take, xp)
        raise TypeError(f"not a predicate node: {pred!r}")


def synth_attributes(n_rows: int, seed: int = 0, n_categories: int = 8,
                     sources: int = 4, device=None) -> AttributeStore:
    """Standard synthetic attribute set for benches / traces / tests:
    a skewed ``category`` tag, a uniform [0,1) ``score`` numeric (quantile
    ranges over it hit any target selectivity), and a small-pool ``source``
    texthash."""
    rng = np.random.default_rng(seed)
    attrs = AttributeStore([
        FieldSpec("category", TAG),
        FieldSpec("score", NUMERIC),
        FieldSpec("source", TEXTHASH),
    ], capacity=n_rows, device=device)
    # zipf-ish categorical skew: p(c) ∝ 1/(c+1)
    w = 1.0 / (np.arange(n_categories) + 1.0)
    cats = rng.choice(n_categories, size=n_rows, p=w / w.sum())
    attrs.put(np.arange(n_rows), {
        "category": [f"cat{c}" for c in cats],
        "score": rng.random(n_rows).astype(np.float32),
        "source": [f"src{int(s)}" for s in rng.integers(0, sources, n_rows)],
    })
    return attrs
