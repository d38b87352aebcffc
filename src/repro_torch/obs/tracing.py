"""Per-ticket span trees.

A ``Trace`` owns a root ``Span`` covering submit -> done; stages hang
off the root as children. Spans are plain objects (no registry, no
thread affinity) so a span built on a WorkerPool thread can be
*adopted* by reference into several tickets' trees — one async flush
serves a whole micro-batch, and each served ticket's tree includes the
shared dispatch/merge subtree (``Span.add`` is a GIL-atomic list
append). Timestamps are ``time.perf_counter()`` seconds; durations are
reported in milliseconds.
"""
from __future__ import annotations

import itertools
import time

_ids = itertools.count(1)


class Span:
    __slots__ = ("span_id", "name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, t0: float | None = None,
                 attrs: dict | None = None):
        self.span_id = next(_ids)
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: float | None = None
        self.attrs = attrs if attrs is not None else {}
        self.children: list[Span] = []

    def end(self, t1: float | None = None) -> "Span":
        if self.t1 is None:
            self.t1 = time.perf_counter() if t1 is None else t1
        return self

    def add(self, child: "Span") -> "Span":
        self.children.append(child)
        return child

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1e3

    def walk(self):
        """Depth-first iteration over this span and its descendants."""
        stack = [self]
        while stack:
            sp = stack.pop()
            yield sp
            stack.extend(reversed(sp.children))

    def find(self, name: str) -> "Span | None":
        for sp in self.walk():
            if sp.name == name:
                return sp
        return None

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "duration_ms": self.duration_ms, "attrs": dict(self.attrs),
                "children": [c.as_dict() for c in self.children]}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_ms:.3f}ms, "
                f"children={len(self.children)})")


class Trace:
    """One ticket's span tree plus free-form timestamp marks."""

    __slots__ = ("root", "marks")

    def __init__(self, name: str = "ticket", t0: float | None = None,
                 **attrs):
        self.root = Span(name, t0=t0, attrs=dict(attrs))
        self.marks: dict = {}

    @property
    def total_ms(self) -> float:
        return self.root.duration_ms

    def stages(self) -> list[Span]:
        """Direct children of the root — the top-level stage decomposition."""
        return list(self.root.children)

    def stage_names(self) -> set:
        return {sp.name for sp in self.root.children}

    def stage_sum_ms(self) -> float:
        return sum(sp.duration_ms for sp in self.root.children)

    def coverage(self) -> float:
        """Fraction of end-to-end time accounted for by top-level stages."""
        total = self.total_ms
        return self.stage_sum_ms() / total if total > 0 else 0.0

    def find(self, name: str) -> Span | None:
        return self.root.find(name)

    def as_dict(self) -> dict:
        return {"root": self.root.as_dict(), "marks": dict(self.marks)}
