"""Low-overhead metrics registry: counters, gauges, log-bucketed histograms.

Series are keyed by ``(name, sorted label items)``. Histograms use
geometric buckets with *upper-inclusive* boundaries — ``bounds[i] =
lo * growth**i`` and a value lands in the first bucket whose upper bound
is >= the value — so bucket placement is exact and platform-stable at
the boundaries (``bisect`` on a precomputed list, no ``log`` rounding).
Quantiles return the upper bound of the bucket holding the ceil(q*n)-th
observation, clamped to the exact observed max: at most one relative
bucket width of error, and exact for the max observation.

The registry is guarded by a single ``RLock``; a counter bump is one
dict lookup + int add under the lock.  Per-name label cardinality is
bounded: past ``max_series_per_name`` distinct label sets, updates fold
into a single ``{"overflow": "true"}`` series and are tallied in
``dropped_labelsets`` so blown cardinality is visible, not silent.
"""
from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from dataclasses import dataclass, field

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Default geometry: ~19% bucket width, 1e-3 .. ~13e3 (ms scale).
HIST_LO = 1e-3
HIST_GROWTH = 2.0 ** 0.25
HIST_BUCKETS = 96

_OVERFLOW_LABELS = (("overflow", "true"),)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Histogram:
    """Log-bucketed histogram with exact sum/count/min/max sidecars."""

    __slots__ = ("lo", "growth", "bounds", "counts", "overflow", "count",
                 "total", "vmin", "vmax")

    def __init__(self, lo: float = HIST_LO, growth: float = HIST_GROWTH,
                 n_buckets: int = HIST_BUCKETS):
        self.lo = float(lo)
        self.growth = float(growth)
        self.bounds = [self.lo * self.growth ** i for i in range(n_buckets)]
        self.counts = [0] * n_buckets
        self.overflow = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect_left(self.bounds, v)
        if i < len(self.counts):
            self.counts[i] += 1
        else:
            self.overflow += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return min(self.bounds[i], self.vmax)
        return self.vmax  # rank falls in the overflow bucket

    def merge(self, other: "Histogram") -> None:
        if other.lo != self.lo or other.growth != self.growth or \
                len(other.counts) != len(self.counts):
            raise ValueError("histogram geometry mismatch")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.overflow += other.overflow
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def data(self) -> dict:
        return {"lo": self.lo, "growth": self.growth,
                "counts": list(self.counts), "overflow": self.overflow,
                "count": self.count, "total": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0}

    @classmethod
    def from_data(cls, data: dict) -> "Histogram":
        h = cls(lo=data["lo"], growth=data["growth"],
                n_buckets=len(data["counts"]))
        h.counts = list(data["counts"])
        h.overflow = int(data["overflow"])
        h.count = int(data["count"])
        h.total = float(data["total"])
        if h.count:
            h.vmin, h.vmax = float(data["min"]), float(data["max"])
        return h


def hist_quantile(data: dict, q: float) -> float:
    """Quantile from exported histogram ``data`` (see Histogram.data)."""
    return Histogram.from_data(data).quantile(q)


def hist_summary(data: dict) -> dict:
    h = Histogram.from_data(data)
    return {"count": h.count, "mean": h.mean,
            "min": data["min"], "max": data["max"],
            "p50": h.quantile(0.50), "p95": h.quantile(0.95),
            "p99": h.quantile(0.99)}


@dataclass
class MetricsSnapshot:
    """Immutable-by-convention point-in-time export of a registry.

    ``series`` maps ``(name, label_key)`` to ``{"kind": ..., ...}``.
    ``diff`` and ``merge`` operate on counters and histogram counts;
    gauges (and histogram min/max, which are not invertible) take the
    newer snapshot's value on diff.

    A counter (or histogram) that was RESET between the two snapshots
    would produce a negative delta, which breaks monotone objective
    readers (the autotune replay reads windowed diffs as rates). ``diff``
    therefore clamps: a shrunk counter reports the newer snapshot's
    post-reset value, a shrunk histogram reports the newer data verbatim,
    and both carry a ``"resets": 1`` marker; ``resets`` also tallies the
    affected series so the discontinuity is visible, not silent.
    """

    series: dict = field(default_factory=dict)
    dropped_labelsets: dict = field(default_factory=dict)
    resets: dict = field(default_factory=dict)

    def _mark_reset(self, resets: dict, key) -> None:
        name = key[0]
        resets[name] = resets.get(name, 0) + 1

    def diff(self, older: "MetricsSnapshot") -> "MetricsSnapshot":
        out = {}
        resets: dict = {}
        for key, cur in self.series.items():
            old = older.series.get(key)
            kind = cur["kind"]
            if old is None or old["kind"] != kind:
                out[key] = json.loads(json.dumps(cur))
                continue
            if kind == COUNTER:
                d = cur["value"] - old["value"]
                if d < 0:  # reset mid-window: clamp, report post-reset value
                    out[key] = {"kind": COUNTER, "value": cur["value"],
                                "resets": 1}
                    self._mark_reset(resets, key)
                elif d:
                    out[key] = {"kind": COUNTER, "value": d}
            elif kind == GAUGE:
                out[key] = {"kind": GAUGE, "value": cur["value"]}
            else:
                d = cur["data"]["count"] - old["data"]["count"]
                counts_d = [a - b for a, b in zip(cur["data"]["counts"],
                                                  old["data"]["counts"])]
                overflow_d = (cur["data"]["overflow"]
                              - old["data"]["overflow"])
                if d < 0 or overflow_d < 0 or any(c < 0 for c in counts_d):
                    # reset mid-window: per-bucket subtraction is garbage;
                    # the newer histogram IS the post-reset window
                    entry = json.loads(json.dumps(cur))
                    entry["resets"] = 1
                    out[key] = entry
                    self._mark_reset(resets, key)
                    continue
                if d == 0:
                    continue
                data = json.loads(json.dumps(cur["data"]))
                data["counts"] = counts_d
                data["overflow"] = overflow_d
                data["count"] = d
                data["total"] = cur["data"]["total"] - old["data"]["total"]
                out[key] = {"kind": HISTOGRAM, "data": data}
        dropped = {n: c - older.dropped_labelsets.get(n, 0)
                   for n, c in self.dropped_labelsets.items()
                   if c - older.dropped_labelsets.get(n, 0)}
        return MetricsSnapshot(series=out, dropped_labelsets=dropped,
                               resets=resets)

    def merge(self, other: "MetricsSnapshot") -> "MetricsSnapshot":
        out = json.loads(json.dumps(list(self.series.items())))
        merged = {tuple(_rekey(k)): v for k, v in out}
        for key, inc in other.series.items():
            cur = merged.get(key)
            if cur is None or cur["kind"] != inc["kind"]:
                merged[key] = json.loads(json.dumps(inc))
            elif inc["kind"] == COUNTER:
                cur["value"] += inc["value"]
            elif inc["kind"] == GAUGE:
                cur["value"] = inc["value"]
            else:
                h = Histogram.from_data(cur["data"])
                h.merge(Histogram.from_data(inc["data"]))
                cur["data"] = h.data()
        dropped = dict(self.dropped_labelsets)
        for n, c in other.dropped_labelsets.items():
            dropped[n] = dropped.get(n, 0) + c
        return MetricsSnapshot(series=merged, dropped_labelsets=dropped)

    def get(self, name: str, **labels):
        return self.series.get((name, _label_key(labels)))

    def as_dict(self) -> dict:
        """JSON-able ``{"name{k=v,...}": summary}`` view (quantiles baked)."""
        out = {}
        for (name, labels), entry in sorted(self.series.items()):
            tag = name if not labels else \
                name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            if entry["kind"] == HISTOGRAM:
                out[tag] = hist_summary(entry["data"])
            else:
                out[tag] = entry["value"]
        if self.dropped_labelsets:
            out["_dropped_labelsets"] = dict(self.dropped_labelsets)
        if self.resets:
            out["_resets"] = dict(self.resets)
        return out

    def to_jsonl(self) -> str:
        lines = []
        for (name, labels), entry in sorted(self.series.items()):
            rec = {"name": name, "labels": dict(labels), "kind": entry["kind"]}
            if entry["kind"] == HISTOGRAM:
                rec["data"] = entry["data"]
                rec.update(hist_summary(entry["data"]))
            else:
                rec["value"] = entry["value"]
            lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as cumulative _bucket)."""
        lines = []
        for (name, labels), entry in sorted(self.series.items()):
            lab = ",".join(f'{k}="{v}"' for k, v in labels)
            base = f"{name}{{{lab}}}" if lab else name
            if entry["kind"] in (COUNTER, GAUGE):
                lines.append(f"# TYPE {name} {entry['kind']}")
                lines.append(f"{base} {entry['value']}")
                continue
            d = entry["data"]
            lines.append(f"# TYPE {name} histogram")
            h = Histogram.from_data(d)
            cum = 0
            for bound, c in zip(h.bounds, h.counts):
                cum += c
                blab = lab + "," if lab else ""
                lines.append(f'{name}_bucket{{{blab}le="{bound:g}"}} {cum}')
            blab = lab + "," if lab else ""
            lines.append(f'{name}_bucket{{{blab}le="+Inf"}} {d["count"]}')
            lines.append(f"{name}_sum{{{lab}}} {d['total']}")
            lines.append(f"{name}_count{{{lab}}} {d['count']}")
        return "\n".join(lines)


def _rekey(key):
    # json round-trips tuple keys as lists; restore ("name", ((k, v), ...)).
    name, labels = key
    return (name, tuple(tuple(p) for p in labels))


class MetricsRegistry:
    """Thread-safe named counters / gauges / histograms with labels."""

    def __init__(self, max_series_per_name: int = 64,
                 hist_lo: float = HIST_LO, hist_growth: float = HIST_GROWTH,
                 hist_buckets: int = HIST_BUCKETS):
        self.max_series_per_name = int(max_series_per_name)
        self._hist_geom = (float(hist_lo), float(hist_growth),
                           int(hist_buckets))
        self._lock = threading.RLock()
        self._series: dict = {}          # (name, label_key) -> (kind, obj)
        self._per_name: dict = {}        # name -> n distinct label sets
        self._dropped: dict = {}         # name -> dropped updates

    def _entry(self, name: str, labels: dict, kind: str):
        key = (name, _label_key(labels) if labels else ())
        entry = self._series.get(key)
        if entry is not None:
            if entry[0] != kind:
                raise TypeError(f"metric {name!r} is a {entry[0]}, "
                                f"not a {kind}")
            return entry[1]
        n = self._per_name.get(name, 0)
        if n >= self.max_series_per_name and key[1] != _OVERFLOW_LABELS:
            self._dropped[name] = self._dropped.get(name, 0) + 1
            return self._entry(name, dict(_OVERFLOW_LABELS), kind)
        if kind == HISTOGRAM:
            lo, growth, nb = self._hist_geom
            obj = Histogram(lo=lo, growth=growth, n_buckets=nb)
        else:
            obj = [0] if kind == COUNTER else [0.0]
        self._series[key] = (kind, obj)
        self._per_name[name] = n + 1
        return obj

    def counter(self, name: str, value: int = 1, **labels) -> None:
        with self._lock:
            self._entry(name, labels, COUNTER)[0] += value

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._entry(name, labels, GAUGE)[0] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._entry(name, labels, HISTOGRAM).observe(value)

    def histogram(self, name: str, **labels) -> Histogram:
        """Fetch (creating if needed) the histogram for direct use."""
        with self._lock:
            return self._entry(name, labels, HISTOGRAM)

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            series = {}
            for key, (kind, obj) in self._series.items():
                if kind == HISTOGRAM:
                    series[key] = {"kind": kind, "data": obj.data()}
                else:
                    series[key] = {"kind": kind, "value": obj[0]}
            return MetricsSnapshot(series=series,
                                   dropped_labelsets=dict(self._dropped))

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._per_name.clear()
            self._dropped.clear()
