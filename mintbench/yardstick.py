"""The benchmark's own arithmetic: percentiles, spreads, the card's published
peaks, a kernel's least time, and the reduction of a device trace to busy
time and idle gaps. Plain Python and numpy, so the tests can feed it made-up
spans and intervals."""
from __future__ import annotations

import statistics

import numpy as np

# NVIDIA's data sheets, dense rates: bytes/s of HBM, float32 FLOP/s outside
# the tensor cores. Keyed by a part of the name torch.cuda.get_device_name gives.
PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, fp32=51e12),
    "H100 NVL": dict(bytes=3.9e12, fp32=60e12),
    "H100": dict(bytes=3.35e12, fp32=67e12),  # SXM
}


def peaks_for(kind: str) -> dict:
    """The published peaks of the card named ``kind``; raises for a card
    the table does not hold (a share against a guessed peak means nothing)."""
    for part in ("H100 PCIe", "H100 NVL", "H100"):
        if part in kind:
            return dict(PEAKS[part], part=part)
    raise KeyError(f"no published peaks for {kind!r}")


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default)."""
    if len(values) == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def spread(values) -> float:
    """Quartile distance over the median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def least_time_s(flops: float, nbytes: float, peaks: dict) -> tuple[float, str]:
    """The least time the card needs for ``flops`` float32 operations and
    ``nbytes`` of memory traffic, and which of the two bounds it."""
    t_ops = flops / peaks["fp32"]
    t_bytes = nbytes / peaks["bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """Union of (start, end) intervals as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_time(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(e - s for s, e in merge_intervals(clip(intervals, lo, hi)))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in merge_intervals(clip(intervals, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_activity(gaps, host_events, default: str = "host_python",
                  max_steps: int = 256) -> dict[str, float]:
    """Idle time by what the host was doing: each gap goes to the innermost
    host event (name, start, end) open at its midpoint; events of one thread
    nest, so walking back from the latest start finds it. A gap no event
    covers within ``max_steps`` goes to ``default``."""
    evs = sorted(host_events, key=lambda ev: ev[1])
    starts = np.array([ev[1] for ev in evs], dtype=np.float64)
    out: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = default
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        for j in range(i, max(i - max_steps, -1), -1):
            if evs[j][2] >= mid:
                name = evs[j][0]
                break
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def top(totals: dict[str, float], n: int = 10) -> list[list]:
    """The ``n`` largest entries of ``totals`` as [name, value] pairs."""
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
