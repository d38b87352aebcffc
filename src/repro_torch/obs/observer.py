"""The Observer seam: one object the whole stack reports through.

Every instrumented component takes ``observer=None`` and falls back to
the module-level :data:`NULL_OBSERVER`, whose ``enabled`` is False and
whose methods are no-ops. Hot paths guard *allocations* with
``if obs.enabled:`` so the disabled mode costs one attribute read per
call site and changes no behavior — observability is strictly
read-only, so disabled runs are bit-identical to uninstrumented code.

Span parenting is explicit-or-implicit: ``span(...)`` opens a context
manager that pushes onto a ``threading.local`` stack, so nested calls
on the same thread (engine plan-group under scheduler dispatch) parent
automatically; ``span_at(...)`` builds an already-closed span from two
timestamps and attaches it to an explicit parent. Cross-thread
parenting never consults the stack — a flush job's tickets carry their
traces, and the worker adopts the shared dispatch span into each
ticket's root (see scheduler).

Completed ticket traces land in a bounded ``deque`` (``obs.traces``)
for reports and tests.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .metrics import MetricsRegistry
from .timeline import Timeline
from .tracing import Span, Trace

__all__ = ["Observer", "NullObserver", "NULL_OBSERVER"]


class _NullSpan:
    """Absorbs span mutations; shared singleton, holds no state."""

    __slots__ = ()
    name = "null"
    children = ()
    duration_ms = 0.0

    def end(self, t1=None):
        return self

    def add(self, child):
        return child

    def annotate(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullObserver:
    """Disabled observer: every method is a no-op, ``enabled`` is False."""

    __slots__ = ()
    enabled = False
    metrics = None
    timeline = None
    traces = ()

    def begin_trace(self, name="ticket", t0=None, **attrs):
        return None

    def end_trace(self, trace, t=None):
        return None

    def span(self, name, parent=None, t0=None, **attrs):
        return _NULL_SPAN

    def span_at(self, name, t0, t1, parent=None, **attrs):
        return _NULL_SPAN

    def current(self):
        return None

    def event(self, kind, t=None, **attrs):
        return None

    def counter(self, name, value=1, **labels):
        return None

    def gauge(self, name, value, **labels):
        return None

    def observe(self, name, value, **labels):
        return None


NULL_OBSERVER = NullObserver()


class _SpanCtx:
    """Context manager that pushes/pops the thread-local span stack."""

    __slots__ = ("_obs", "span")

    def __init__(self, obs: "Observer", span: Span):
        self._obs = obs
        self.span = span

    def __enter__(self) -> Span:
        self._obs._stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        stack = self._obs._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self.span.end()
        return False


class Observer:
    """Live observer: metrics registry + timeline + trace capture."""

    enabled = True

    def __init__(self, metrics: MetricsRegistry | None = None,
                 timeline_capacity: int = 4096, max_traces: int = 512,
                 max_series_per_name: int = 64):
        self.metrics = metrics if metrics is not None else \
            MetricsRegistry(max_series_per_name=max_series_per_name)
        self.timeline = Timeline(capacity=timeline_capacity)
        self.traces: deque = deque(maxlen=int(max_traces))
        self._tls = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # ---- traces ----------------------------------------------------------

    def begin_trace(self, name: str = "ticket", t0: float | None = None,
                    **attrs) -> Trace:
        return Trace(name, t0=t0, **attrs)

    def end_trace(self, trace: Trace, t: float | None = None) -> Trace:
        trace.root.end(t)
        self.traces.append(trace)
        return trace

    # ---- spans -----------------------------------------------------------

    def span(self, name: str, parent: Span | None = None,
             t0: float | None = None, **attrs) -> _SpanCtx:
        """Open a span as a context manager.

        Parents to ``parent`` if given, else to the current span on this
        thread, else floats (attach it yourself via ``Span.add``).
        """
        sp = Span(name, t0=t0, attrs=attrs)
        if parent is None:
            stack = self._stack()
            parent = stack[-1] if stack else None
        if parent is not None:
            parent.add(sp)
        return _SpanCtx(self, sp)

    def span_at(self, name: str, t0: float, t1: float,
                parent: Span | None = None, **attrs) -> Span:
        """Build a closed span from two timestamps (retroactive stages)."""
        sp = Span(name, t0=t0, attrs=attrs)
        sp.end(t1)
        if parent is not None:
            parent.add(sp)
        return sp

    def current(self) -> Span | None:
        stack = self._stack()
        return stack[-1] if stack else None

    # ---- timeline + metrics ---------------------------------------------

    def event(self, kind: str, t: float | None = None, **attrs):
        self.metrics.counter("events", kind=kind)
        return self.timeline.record(kind, t=t, **attrs)

    def counter(self, name: str, value: int = 1, **labels) -> None:
        self.metrics.counter(name, value=value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.metrics.gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.metrics.observe(name, value, **labels)

    # ---- convenience -----------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()
