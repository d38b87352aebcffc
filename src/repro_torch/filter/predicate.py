"""Predicate AST for filtered search (DESIGN.md §12).

Six node types — ``Eq`` / ``In`` / ``Range`` / ``And`` / ``Or`` / ``Not`` —
all frozen, hashable dataclasses, so a predicate object can sit directly
inside plan-cache keys (``online/plancache.py::PlanKey``) and plan-group
keys (``serve/compiler.py::GroupKey``) without a separate fingerprint.

Semantics (missing values):
  * A row that is missing a field NEVER matches ``Eq`` / ``In`` / ``Range``
    on that field.
  * ``Not`` is the pure boolean complement — ``Not(Eq(f, v))`` therefore
    DOES match rows missing ``f``. Host bitmaps and device masks agree on
    this by construction (both evaluate leaves first, then complement).

Evaluation lives in ``AttributeStore.bitmap`` (host, numpy) and
``AttributeStore.device_bitmap`` (device, torch) so encodings (tag vocab,
text hashing) stay next to the packed columns.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Predicate:
    """Marker base class for AST nodes."""

    def fields(self) -> frozenset:
        """Attribute field names referenced anywhere in this tree."""
        return frozenset(_collect_fields(self))


@dataclass(frozen=True)
class Eq(Predicate):
    field: str
    value: object


@dataclass(frozen=True)
class In(Predicate):
    field: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclass(frozen=True)
class Range(Predicate):
    """Inclusive numeric range ``lo <= v <= hi``; ``None`` = unbounded.

    Both bounds ``None`` matches every row with a (non-missing) value."""
    field: str
    lo: float | None = None
    hi: float | None = None


@dataclass(frozen=True, init=False)
class And(Predicate):
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True, init=False)
class Or(Predicate):
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


@dataclass(frozen=True)
class Not(Predicate):
    child: Predicate


def _collect_fields(node) -> list:
    if isinstance(node, (Eq, In, Range)):
        return [node.field]
    if isinstance(node, (And, Or)):
        out = []
        for c in node.children:
            out.extend(_collect_fields(c))
        return out
    if isinstance(node, Not):
        return _collect_fields(node.child)
    raise TypeError(f"not a predicate node: {node!r}")


def describe(pred) -> str:
    """Compact human-readable form for logs / bench labels."""
    if pred is None:
        return "*"
    if isinstance(pred, Eq):
        return f"{pred.field}=={pred.value!r}"
    if isinstance(pred, In):
        return f"{pred.field} in {list(pred.values)!r}"
    if isinstance(pred, Range):
        lo = "-inf" if pred.lo is None else f"{pred.lo:g}"
        hi = "+inf" if pred.hi is None else f"{pred.hi:g}"
        return f"{pred.field} in [{lo},{hi}]"
    if isinstance(pred, And):
        return "(" + " & ".join(describe(c) for c in pred.children) + ")"
    if isinstance(pred, Or):
        return "(" + " | ".join(describe(c) for c in pred.children) + ")"
    if isinstance(pred, Not):
        return f"!{describe(pred.child)}"
    raise TypeError(f"not a predicate node: {pred!r}")
