"""A whole run of each cell on the CPU at about 2,000 rows: the window drives
``OnlineRuntime`` on the plain PyTorch versions of the kernels and the check
holds it to the reference. The card's runs are the same code at full size."""
import json
import time

import pytest
import torch

from mintbench import harness
from mintbench.tests.small import CELLS, ROOT, small


def run(name, trace=False, seconds=1.0, **kw):
    cell = small(harness.load_cell(ROOT, name))
    return harness.run(cell, 2**31 + 99, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_is_correct_and_reports_its_metrics(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    cell = harness.load_cell(ROOT, name)
    want = {m["name"] for m in cell.end_to_end} - {"peak_device_gib"}
    assert want <= set(res["metrics"])
    assert res["metrics"]["qps"]["value"] > 0
    assert 0.9 <= res["metrics"]["recall_mean"]["value"] <= 1.0


def test_a_traced_cpu_run_reads_the_program_spans_and_counters():
    res = run(CELLS[0], trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["flush_batch_mean"]["value"] == pytest.approx(32.0)
    assert m["plan_groups_per_flush"]["value"] >= 1.0
    assert m["group_ms_mean"]["value"] > 0 and m["tune_s"]["value"] > 0
    assert m["query_p95_ms"]["value"] > 0
    # no card: nothing is read from a device trace, and nothing reads 0
    assert "device_idle_pct" not in m and "scan_roofline" not in m
    assert "busy_s" not in res["device"]


def test_the_result_line_is_the_last_line_and_names_each_limit(capsys):
    res = run(CELLS[0], seconds=0.5)
    harness.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    tail = err.strip().splitlines()[-5:]
    assert [t.split(":")[0] for t in tail] == ["check unanswered", "check malformed",
                                               "check recall_mean", "check order_gap",
                                               "check judged"]
