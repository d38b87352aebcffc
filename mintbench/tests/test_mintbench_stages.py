"""The readers of the engine's stage spans (``mintbench/stages.py`` and the
five ``*_ms_per_query`` metrics), and the one clock the harness maps the
program's spans by: on a hand-built record, in a traced CPU run of the cell,
and against the profiler's own ranges."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mintbench import harness, stages
from mintbench.tests.small import CELLS, ROOT, small
from repro_torch.serve.engine import BatchEngine

STAGES = ["ivf_probe", "ivf_gather", "ivf_select", "rerank_union", "rerank_order"]
# the cell cut to a size whose tuning plans reranks: at 2,000 rows every
# IVF plan covers its query exactly, so no group reranks
ROWS = 4000


def record(host_ops, served):
    return harness.TraceRecord(tune_s=1.0, index_build_s=1.0, rows=10, dims=[4],
                               peaks=None, served=served, host_ops=host_ops)


@pytest.mark.parametrize("stage", STAGES)
def test_a_reader_sums_its_stage_over_the_queries_served(stage):
    reader = harness.load_reader(ROOT, f"{stage}_ms_per_query")
    ops = [(f"span:{stage}", 10.0, 10.002), ("aten::index", 10.0, 10.001),
           ("span:rerank_score", 10.002, 10.9), (f"span:{stage}", 11.0, 11.003),
           (stage, 12.0, 13.0)]
    assert reader.read(record(ops, served=5)) == pytest.approx(1.0)
    assert reader.read(record(ops, served=0)) is None
    assert reader.read(record([op for op in ops if op[0] != f"span:{stage}"], 5)) is None
    assert reader.read(record([], 5)) is None


def test_a_program_without_the_spans_reads_nothing():
    ops = [("span:plan_group", 0.0, 1.0), ("span:rerank", 0.5, 0.9)]
    assert all(stages.ms_per_query(record(ops, 3), s) is None for s in STAGES)


def test_a_traced_cpu_run_reports_every_stage():
    cell = small(harness.load_cell(ROOT, CELLS[0]), rows=ROWS, clients=None)
    res = harness.run(cell, 2**31 + 77, 1.0, True, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for stage in STAGES:
        assert m[f"{stage}_ms_per_query"]["value"] > 0, stage
    # the stages lie inside the groups, one group a query
    inside = sum(m[f"{s}_ms_per_query"]["value"] for s in STAGES)
    assert inside < m["group_ms_mean"]["value"]


def test_spans_map_onto_the_profilers_clock(monkeypatch):
    """The harness maps the program's spans (``perf_counter``) onto the
    profiler's clock by one offset taken as the window opens. The ops the
    rerank issues inside its ``rerank_score`` stage, tagged here by a
    profiler range around the engine's gather of the union's scores, lie
    inside the mapped ``span:rerank_score`` to within 0.2 ms. The warm-up
    has entered a profiler range already (the tag): a process's first range
    stamps its start ~1 ms before it returns, which shifts a window opened by
    it, and that shift is the harness's own (PERF.md, open questions)."""
    dev = torch.device("cpu")
    cell = small(harness.load_cell(ROOT, CELLS[0]), rows=ROWS, clients=None)
    db, workload, stream = harness.build_inputs(cell, 2**31 + 5, dev)
    rt, _, _ = harness.build_runtime(cell, db, workload, dev, observe=True)
    gathered = BatchEngine._gathered_scores

    def tagged(self, *args):
        with record_function("probe.rerank_score"):
            return gathered(self, *args)
    monkeypatch.setattr(BatchEngine, "_gathered_scores", tagged)
    try:
        harness.closed_loop(rt, stream, 0, 1, rounds=4)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("mintbench.window"):
                t0 = harness.clock()
                served = harness.closed_loop(rt, stream, 4, 1, rounds=40)
        rec = record([], len(served))
        harness.read_trace(rec, prof, served, t0)
    finally:
        rt.close()
    spans = [(s, e) for n, s, e in rec.host_ops if n == "span:rerank_score"]
    tags = [(s, e) for n, s, e in rec.host_ops if n == "probe.rerank_score"]
    ops = [(s, e) for n, s, e in rec.host_ops if n.startswith("aten::")
           and any(a <= s and e <= b for a, b in tags)]
    assert spans and tags and ops
    assert len(tags) == len(spans)
    slack = 0.2e-3
    for s, e in tags + ops:
        assert any(a - slack <= s and e <= b + slack for a, b in spans), (s, e)
