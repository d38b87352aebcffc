"""Observer seam of the engine: the disabled observer. The metrics registry,
span tracing and timeline are the observability slice (ROADMAP.md)."""
from __future__ import annotations

import contextlib


class NullObserver:
    """Disabled observer: every method is a no-op, ``enabled`` is False."""

    enabled = False

    def span(self, name, parent=None, t0=None, **attrs):
        return contextlib.nullcontext()

    def span_at(self, name, t0, t1, parent=None, **attrs):
        return None

    def current(self):
        return None

    def counter(self, name, value=1, **labels):
        return None


NULL_OBSERVER = NullObserver()

__all__ = ["NULL_OBSERVER", "NullObserver"]
