"""The benchmark's arithmetic and the per-layer readers on made-up spans,
intervals and counts."""
from pathlib import Path

import pytest

from mintbench import harness, yardstick

ROOT = Path(__file__).resolve().parents[2]
H100 = yardstick.peaks_for("NVIDIA H100 80GB HBM3")


def reader(name):
    return harness.load_reader(ROOT, name)


def test_percentile_and_spread():
    vals = list(range(1, 101))
    assert yardstick.percentile(vals, 95) == pytest.approx(95.05)
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((5.25 - 1.75) / 3.5)
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)


def test_peaks_and_least_time():
    assert H100["part"] == "H100" and H100["fp32"] == 67e12
    assert yardstick.peaks_for("NVIDIA H100 PCIe")["bytes"] == 2.0e12
    with pytest.raises(KeyError):
        yardstick.peaks_for("NVIDIA A100")
    t, bound = yardstick.least_time_s(67e12, 1.0, H100)
    assert (t, bound) == (1.0, "operations")
    t, bound = yardstick.least_time_s(1.0, 3.35e12, H100)
    assert t == pytest.approx(1.0) and bound == "bytes"


def test_busy_time_and_idle_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert yardstick.merge_intervals(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert yardstick.busy_time(iv, 0.5, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert yardstick.idle_gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    host = [("outer", 0.0, 10.0), ("numpy_argsort", 4.0, 8.0), ("sync", 2.0, 2.9)]
    got = yardstick.host_activity([(2.0, 3.0), (4.0, 9.0)], host)
    assert got == {"sync": 1.0, "numpy_argsort": 5.0}
    assert yardstick.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def record(**kw):
    rec = harness.TraceRecord(tune_s=20.0, index_build_s=8.0, rows=1000, dims=[10, 20, 30],
                              peaks=H100)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


GROUPS = [dict(flush=1, ms=4.0, plan_sig=(("flat", (0, 1), 100),), batch=10),
          dict(flush=1, ms=6.0, plan_sig=(("ivf", (2,), 200), ("flat", (0, 1), 100)),
               batch=30),
          dict(flush=2, ms=8.0, plan_sig=(("ivf", (2,), 200),), batch=20)]


def test_span_readers():
    rec = record(groups=GROUPS, dispatches=2, flushes=2, flushed_queries=60)
    assert reader("group_ms_mean").read(rec) == pytest.approx(6.0)
    assert reader("plan_groups_per_flush").read(rec) == pytest.approx(1.5)
    assert reader("flush_batch_mean").read(rec) == pytest.approx(30.0)
    assert reader("tune_s").read(rec) == 20.0
    assert reader("index_build_s").read(rec) == 8.0
    lat = record(lat_ms=[float(v) for v in range(1, 101)])
    assert reader("query_p95_ms").read(lat) == pytest.approx(95.05)
    empty = record()
    for name in ("group_ms_mean", "plan_groups_per_flush", "flush_batch_mean", "query_p95_ms",
                 "scan_roofline", "distance_us_per_query", "device_idle_pct"):
        assert reader(name).read(empty) is None


def test_scan_roofline_counts_the_work_not_the_kernel():
    mod = reader("scan_roofline")
    rec = record(groups=GROUPS, dispatches=2)
    flops, nbytes = mod.work(rec)
    assert flops == 2.0 * (10 + 30) * 1000 * 30
    # the (0, 1) columns once in flush 1, queries and (score, id) pairs per group
    assert nbytes == 4.0 * 1000 * 30 + 4.0 * 40 * 30 + 8.0 * 40 * 100
    least, _ = yardstick.least_time_s(flops, nbytes, H100)
    rec.device_ops = [("void scan_kernel<64>(Params)", 0.0, 2 * least),
                      ("merge_rank_kernel", 0.0, 2 * least),
                      ("distance_kernel", 0.0, 1.0)]
    assert mod.read(rec) == pytest.approx(25.0)
    rec.device_ops = [("distance_kernel", 0.0, 1.0)]
    assert mod.read(rec) is None


def test_distance_and_idle_readers():
    rec = record(served=400, device_ops=[("distance_kernel<1>", 0.0, 0.002),
                                         ("distance_kernel<2>", 1.0, 1.002),
                                         ("index_kernel", 2.0, 3.0)],
                 busy_s=1.004, window_s=4.0)
    assert reader("distance_us_per_query").read(rec) == pytest.approx(10.0)
    assert reader("device_idle_pct").read(rec) == pytest.approx(74.9)
