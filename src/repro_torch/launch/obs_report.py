"""Render captured observability state: per-stage latency breakdown,
span trees, and the runtime timeline (DESIGN.md §14).

This is the consumption side of ``repro_torch.obs``: the per-stage latency
attribution an online benchmark or ``chip_smoke.py`` prints.

Usage::

    from repro_torch.index.registry import IndexStore
    from repro_torch.online import OnlineRuntime, RuntimeConfig
    from repro_torch.launch.obs_report import render_report, render_trace, report

    cfg = RuntimeConfig(semcache=True, observe=True)   # enable the seam
    rt = OnlineRuntime(db, mint, workload, constraints,
                       store=IndexStore(db, seed=0), config=cfg)  # on the card
    rt.run_trace(trace)

    obs = rt.observer
    print(render_report(obs))            # human-readable breakdown+timeline
    print(render_trace(obs.traces[-1]))  # one ticket's span tree
    rep = report(obs)                    # JSON-able dict for bench artifacts
    # rep["stages"]["dispatch"]["p99"], rep["timeline"], rep["metrics"], ...

Stage rows aggregate the DIRECT children of each ticket's root span
(enqueue / semcache_probe / flush_wait / dispatch / merge — disjoint by
construction, so they sum to ≈ end-to-end); ``coverage`` reports that
sum over the measured total per ticket. Dispatch spans carry the
kernel-level attribution (plan signature, index kinds, batch size,
modeled HBM bytes from ``launch/roofline.py``) on their ``plan_group``
children.
"""
from __future__ import annotations

from repro_torch.obs import Histogram, Timeline, Trace

_ATTR_KEYS = ("hit", "batch", "lists", "rows", "ek", "cand", "union", "index_kinds",
             "hbm_bytes_modeled")


def _fmt_attrs(attrs: dict) -> str:
    parts = []
    for key in _ATTR_KEYS:
        if key in attrs:
            val = attrs[key]
            if key == "hbm_bytes_modeled":
                parts.append(f"hbm={val / 1e6:.2f}MB")
            else:
                parts.append(f"{key}={val}")
    return (" [" + " ".join(parts) + "]") if parts else ""


def render_trace(trace: Trace) -> str:
    """One ticket's span tree, indented, durations in ms."""
    lines = []

    def walk(span, depth):
        lines.append(f"{'  ' * depth}{span.name:<16} "
                     f"{span.duration_ms:9.3f} ms{_fmt_attrs(span.attrs)}")
        for child in span.children:
            walk(child, depth + 1)

    walk(trace.root, 0)
    lines.append(f"stage coverage: {trace.coverage():.3f} "
                 f"(stages {trace.stage_sum_ms():.3f} ms "
                 f"of {trace.total_ms:.3f} ms)")
    return "\n".join(lines)


def stage_breakdown(traces) -> dict:
    """Aggregate top-level stages across ticket traces: per-stage count,
    mean, and p50/p95/p99 (ms), plus mean stage-sum coverage."""
    hists: dict[str, Histogram] = {}
    total = Histogram()
    coverages = []
    for trace in traces:
        for span in trace.stages():
            hists.setdefault(span.name, Histogram()).observe(span.duration_ms)
        total.observe(trace.total_ms)
        coverages.append(trace.coverage())
    out = {}
    for name, h in sorted(hists.items()):
        out[name] = {"count": h.count, "mean_ms": h.mean,
                     "p50_ms": h.quantile(0.50), "p95_ms": h.quantile(0.95),
                     "p99_ms": h.quantile(0.99)}
    return {"stages": out,
            "total": {"count": total.count, "mean_ms": total.mean,
                      "p50_ms": total.quantile(0.50),
                      "p99_ms": total.quantile(0.99)},
            "coverage_mean": (sum(coverages) / len(coverages)
                              if coverages else 0.0)}


def hbm_attribution(traces) -> dict:
    """Modeled HBM bytes per (index kinds) signature, summed over every
    plan_group span — the bandwidth-cost side of the latency breakdown."""
    out: dict = {}
    for trace in traces:
        for span in trace.root.walk():
            if span.name != "plan_group":
                continue
            key = ",".join(span.attrs.get("index_kinds", ()))
            row = out.setdefault(key, {"groups": 0, "hbm_bytes_modeled": 0.0})
            row["groups"] += 1
            row["hbm_bytes_modeled"] += span.attrs.get("hbm_bytes_modeled", 0.0)
    return out


def timeline_table(timeline: Timeline, t0: float | None = None,
                   t1: float | None = None) -> list[dict]:
    return [ev.as_dict() for ev in timeline.window(t0, t1)]


def render_timeline(timeline: Timeline, t0: float | None = None,
                    t1: float | None = None) -> str:
    evs = timeline.window(t0, t1)
    if not evs:
        return "(timeline empty)"
    base = evs[0].t
    lines = []
    for ev in evs:
        attrs = " ".join(f"{k}={v}" for k, v in ev.attrs.items())
        lines.append(f"+{(ev.t - base) * 1e3:10.3f} ms  {ev.kind:<22} {attrs}")
    return "\n".join(lines)


def report(observer) -> dict:
    """JSON-able report: stage breakdown + HBM attribution + timeline +
    metrics-registry snapshot."""
    traces = list(observer.traces)
    return {"n_traces": len(traces),
            "breakdown": stage_breakdown(traces),
            "hbm": hbm_attribution(traces),
            "timeline": ([] if observer.timeline is None
                         else [ev.as_dict() for ev in observer.timeline.window()]),
            "timeline_kinds": ({} if observer.timeline is None
                               else observer.timeline.kinds()),
            "metrics": ({} if observer.metrics is None
                        else observer.metrics.snapshot().as_dict())}


def render_report(observer) -> str:
    rep = report(observer)
    lines = [f"== per-stage latency breakdown "
             f"({rep['n_traces']} ticket traces, "
             f"coverage {rep['breakdown']['coverage_mean']:.3f}) =="]
    rows = dict(rep["breakdown"]["stages"])
    rows["TOTAL"] = rep["breakdown"]["total"]
    for name, row in rows.items():
        cells = "  ".join(f"{k.replace('_ms', '')}={v:.3f}ms"
                          if isinstance(v, float) else f"{k}={v}"
                          for k, v in row.items())
        lines.append(f"  {name:<16} {cells}")
    if rep["hbm"]:
        lines.append("== modeled HBM bytes by index kinds ==")
        for key, row in sorted(rep["hbm"].items()):
            lines.append(f"  {key or 'flat':<16} groups={row['groups']}  "
                         f"hbm={row['hbm_bytes_modeled'] / 1e6:.2f}MB")
    lines.append("== runtime timeline ==")
    lines.append(render_timeline(observer.timeline)
                 if observer.timeline is not None else "(no timeline)")
    return "\n".join(lines)
