"""The engine's stage spans inside each plan group (``serve/engine.py``), on
the fixture of tests/test_torch_obs.py (400 rows, 2 columns, k = 8, MINT
tuned over an IVF store): the tree each kind of group holds, that children
nest in their parents and siblings do not overlap, and that the counts on
the spans are the sizes the probe and the rerank worked on, recomputed here
from ``IVFFlatIndex.search``, which the engine's batched probe matches.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro_torch.core.tuner import Mint
from repro_torch.core.types import Constraints, Workload
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.index.registry import IndexStore
from repro_torch.launch.obs_report import render_trace
from repro_torch.obs import Observer, Trace
from repro_torch.serve.compiler import compile_batch
from repro_torch.serve.engine import BatchEngine

K = 8
COLS = [("a", 24), ("b", 32)]
TEMPLATES = [(0,), (0, 1), (1,)]
IVF_STAGES = ["ivf_centroids", "ivf_probe", "ivf_gather", "ivf_select"]
RERANK_STAGES = ["rerank_union", "rerank_score", "rerank_order"]


@pytest.fixture(scope="module")
def served():
    """The tuned templates' plans over a batch that sends each template
    three times, so every plan group serves three queries; the batch is
    served once under a ``dispatch`` span of an enabled observer."""
    db = make_database(400, COLS, seed=0)
    qs = make_queries(db, TEMPLATES, k=K, seed=7)
    wl = Workload(queries=qs, probs=np.ones(len(qs)))
    mint = Mint(db, index_kind="ivf", seed=0, min_sample_rows=300, device="cpu")
    tuned = mint.tune(wl, Constraints(theta_recall=0.85, theta_storage=3))
    by_vid = {q.vid: tuned.plans[q.qid] for q in qs}
    batch = make_queries(db, TEMPLATES * 3, k=K, seed=11)
    pairs = [(q, dataclasses.replace(by_vid[q.vid], query_qid=q.qid)) for q in batch]
    store = IndexStore(db, seed=0, device="cpu")
    obs = Observer()
    engine = BatchEngine(db, store=store, observer=obs)
    trace = Trace()
    with obs.span("dispatch", parent=trace.root) as dsp:
        ids = engine.search_batch(pairs)
    trace.root.end()
    groups = [g for g in dsp.children if g.name == "plan_group"]
    return dict(db=db, pairs=pairs, store=store, ids=ids, dispatch=dsp,
                groups=groups, trace=trace, engine=engine, obs=obs)


def _queries(served):
    """Each plan group's span with the (query, [(spec, ek)]) it served, from
    the batch compiled again (compiling is deterministic)."""
    groups = compile_batch(served["pairs"])
    assert len(groups) == len(served["groups"])
    return [(sp, [(it.query, list(zip(g.specs, it.eks))) for it in g.items])
            for g, sp in zip(groups, served["groups"])]


def test_every_group_holds_the_stage_tree(served):
    kinds = {}
    for g, qs in _queries(served):
        assert len(qs) == g.attrs["batch"] == 3
        names = [c.name for c in g.children]
        used = qs[0][1]
        if not used:  # the flat fallback group: one scan
            assert names == ["flat_scan"]
            assert g.children[0].attrs["index"] == "x[1]:flat"
            assert not g.children[0].children
        else:
            exact = len(used) == 1 and used[0][0].vid == qs[0][0].vid
            assert names == ["ivf_scan"] * len(used) + ([] if exact else ["rerank"])
            for sp, (spec, _) in zip(g.children, used):
                assert sp.attrs["index"] == spec.name
                assert [c.name for c in sp.children] == IVF_STAGES
            if not exact:
                assert [c.name for c in g.children[-1].children] == RERANK_STAGES
        kinds[tuple(names)] = True
    # the fixture's three plans: an exact IVF probe, a probe and a rerank,
    # and a flat scan
    assert set(kinds) == {("ivf_scan",), ("ivf_scan", "rerank"), ("flat_scan",)}


def test_children_nest_and_siblings_do_not_overlap(served):
    n = 0
    for sp in served["dispatch"].walk():
        assert sp.t1 is not None and sp.t0 <= sp.t1
        prev = None
        for c in sp.children:
            assert sp.t0 <= c.t0 and c.t1 <= sp.t1, (sp.name, c.name)
            if prev is not None:
                assert prev.t1 <= c.t0, (prev.name, c.name)
            prev = c
            n += 1
    assert n >= 3 + 2 * 5 + 3


def test_the_stages_cover_each_group(served):
    """The leaf stages and flat scans account for nearly all of a group's
    time: the host work between them is a few list operations."""
    for g in served["groups"]:
        leaves = sum(x.duration_ms for x in g.walk()
                     if x.name == "flat_scan" or x.name in IVF_STAGES + RERANK_STAGES)
        assert leaves >= 0.9 * g.duration_ms, g.name


def test_ivf_scan_counts_are_what_it_probed(served):
    store = served["store"]
    seen = 0
    for g, qs in _queries(served):
        for j, sp in enumerate(c for c in g.children if c.name == "ivf_scan"):
            lists = rows = ek = 0
            for q, used in qs:
                spec, q_ek = used[j]
                idx = store.get(spec)
                res = idx.search(q.concat(spec.vid), q_ek)
                lists += idx._nprobe_for(q_ek)
                rows += res.num_dist - idx.n_lists
                ek += len(res.ids)
            assert (sp.attrs["lists"], sp.attrs["rows"], sp.attrs["ek"]) == (lists, rows, ek)
            assert 0 < ek <= rows
            seen += 1
    assert seen == 2


def test_rerank_counts_are_the_true_union_and_candidates(served):
    store = served["store"]
    seen = 0
    for g, qs in _queries(served):
        rr = [c for c in g.children if c.name == "rerank"]
        if not rr:
            continue
        cand, union = 0, []
        for q, used in qs:
            ids = [store.get(spec).search(q.concat(spec.vid), ek).ids for spec, ek in used]
            cand += sum(len(x) for x in ids)
            union.append(np.concatenate(ids))
        assert rr[0].attrs["cand"] == cand
        assert rr[0].attrs["union"] == len(np.unique(np.concatenate(union)))
        assert rr[0].attrs["batch"] == 3
        seen += 1
    assert seen == 1


def test_rerank_stages_tile_the_rerank_span(served):
    """The rerank's three stages run in order, the first from the span's
    start, each from where the last one ended."""
    spans = [sp for sp in served["dispatch"].walk() if sp.name == "rerank"]
    assert len(spans) == 1
    for rr in spans:
        stages = rr.children
        assert [c.name for c in stages] == RERANK_STAGES
        assert stages[0].t0 == rr.t0 and stages[-1].t1 <= rr.t1
        assert all(a.t1 == b.t0 for a, b in zip(stages, stages[1:]))


def test_rerank_span_says_where_the_union_was_built(served):
    """An unmutated table's union is built on the device, once per group
    that reranks."""
    spans = [sp for sp in served["dispatch"].walk() if sp.name == "rerank"]
    assert [sp.attrs["union_on"] for sp in spans] == ["device"]
    assert served["engine"].device_unions == served["engine"].counters.rerank == 1


def test_a_rendered_tree_shows_the_counts(served):
    text = render_trace(served["trace"])
    for stage in IVF_STAGES + RERANK_STAGES + ["ivf_scan", "rerank", "flat_scan"]:
        assert f" {stage} " in text
    assert all(f"{key}=" in text for key in ("lists", "rows", "ek", "cand", "union"))


def test_the_stage_spans_change_no_answer(served):
    plain = BatchEngine(served["db"], store=served["store"])
    for a, b in zip(plain.search_batch(served["pairs"]), served["ids"]):
        np.testing.assert_array_equal(a, b)


def test_wall_ms_times_the_group_and_not_the_oracle(served, monkeypatch):
    engine = BatchEngine(served["db"], store=served["store"])
    engine.execute_batch(served["pairs"])  # warm
    truth = BatchEngine._group_ground_truth

    def slow_oracle(self, group, gt_cache):
        time.sleep(0.5)
        return truth(self, group, gt_cache)
    monkeypatch.setattr(BatchEngine, "_group_ground_truth", slow_oracle)
    metrics = engine.execute_batch(served["pairs"])
    assert all(0 < m.wall_ms < 0.5e3 / 3 for m in metrics)
    assert all(m.recall > 0 for m in metrics)
