"""Runtime timeline: control-plane events in a bounded ring buffer.

Retune swaps, compaction cut/build/rebase, governor spills/evictions,
drift detections, semcache invalidations — anything rare enough to
narrate. Events carry ``time.perf_counter()`` monotonic timestamps (so
they align with span times) and land in a ``deque(maxlen=...)`` under a
lock; producers on WorkerPool threads are safe. Query by window and/or
kind with :meth:`Timeline.window`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class TimelineEvent:
    t: float
    kind: str
    attrs: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "attrs": dict(self.attrs)}


class Timeline:
    def __init__(self, capacity: int = 4096):
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def record(self, kind: str, t: float | None = None, **attrs) -> TimelineEvent:
        ev = TimelineEvent(t=time.perf_counter() if t is None else t,
                           kind=kind, attrs=attrs)
        with self._lock:
            self._events.append(ev)
        return ev

    def window(self, t0: float | None = None, t1: float | None = None,
               kind: str | None = None) -> list[TimelineEvent]:
        with self._lock:
            evs = list(self._events)
        return [ev for ev in evs
                if (t0 is None or ev.t >= t0)
                and (t1 is None or ev.t <= t1)
                and (kind is None or ev.kind == kind)]

    def kinds(self) -> dict:
        """Event count per kind (whole ring)."""
        out: dict = {}
        for ev in self.window():
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def as_dicts(self) -> list[dict]:
        return [ev.as_dict() for ev in self.window()]
