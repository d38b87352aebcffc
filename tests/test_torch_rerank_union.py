"""The rerank's candidate union built on the device (``serve/engine.py:
_device_rerank``: a row-membership mask, its nonzero columns, the top-k
kernel) against the host algorithm it replaced, written out here: each
query's ``np.unique`` over its candidate lists and the group's, the union's
scores from the same distance dispatch, ``searchsorted`` of each query's
union into the group's and a stable ``argsort``. Answers must be identical.

The database (300 rows, 4 columns) holds planted duplicate rows, so equal
scores pin the tie rule (ascending row id). Served plans run without an
index store, so each planned index is a flat scan at its ek and candidate
lists overlap across indexes; hand-made candidate lists pin the per-query
mask of a B = 4 group. Each case runs on the CPU (the plain distance and
top-k versions) and, marked ``cuda``, on the card, where both sides score
with the distance kernel and the engine orders with the top-k kernel:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_rerank_union.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.types import IndexSpec, Query, QueryPlan
from repro_torch.data.vectors import make_database, make_queries
from repro_torch.filter import Range, synth_attributes
from repro_torch.ingest import InsertBatch, MutableTable, MutationView
from repro_torch.obs import Observer, Trace
from repro_torch.serve.compiler import compile_batch
from repro_torch.serve.engine import BatchEngine

N_ROWS = 300
COLS = [("a", 16), ("b", 16), ("c", 16), ("d", 16)]
DUP = (10, 200, 30)  # rows 200..229 are copies of rows 10..39


@pytest.fixture(scope="module")
def db():
    db = make_database(N_ROWS, COLS, seed=0)
    src, dst, n = DUP
    for c in db.columns:
        c[dst:dst + n] = c[src:src + n]
    return db


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the distance and top-k kernels run only there")
    return request.param


def host_rerank(engine, group, cand):
    """The host algorithm: sorted unions, the group's union scored in one
    dispatch, each query's stable argsort of its own scores."""
    items = group.items
    unions = []
    for row in cand:
        parts = [c for c in row if c.shape[0]]
        unions.append(np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64))
    nonempty = [u for u in unions if u.shape[0]]
    if not nonempty:
        return [np.empty(0, np.int64) for _ in items]
    gunion = np.unique(np.concatenate(nonempty))
    col = engine.cstore.device(group.key.vid)
    qmat = engine._qmat(col, items)
    scores = engine._gathered_scores(col, qmat, gunion).cpu().numpy()
    out = []
    for i, it in enumerate(items):
        if unions[i].shape[0] == 0:
            out.append(np.empty(0, np.int64))
            continue
        pos = np.searchsorted(gunion, unions[i])
        top = np.argsort(-scores[i, pos], kind="stable")[: it.query.k]
        out.append(unions[i][top])
    return out


def _spy(engine):
    """Records each (group, cand) the engine reranks, with the host
    algorithm's answers computed before the engine's own."""
    seen = []
    rerank = engine._rerank

    def run(group, cand, mv=None, sq=None):
        want = host_rerank(engine, group, cand) if mv is None else None
        got = rerank(group, cand, mv=mv, sq=sq)
        seen.append(dict(group=group, cand=cand, want=want, got=got))
        return got
    engine._rerank = run
    return seen


def _plan(q, vids, eks, **kw):
    return QueryPlan(q.qid, [IndexSpec(v, "flat") for v in vids], list(eks), 1.0, 1.0, **kw)


def _row_query(db, qid, row, vid, k):
    """A query that is row ``row`` itself: its best scores are that row and
    the row's planted copy, a tie."""
    return Query(qid=qid, vid=vid, vectors={c: db.columns[c][row].copy() for c in vid}, k=k)


def _assert_same(seen):
    assert seen
    for s in seen:
        assert len(s["got"]) == len(s["want"])
        for got, want in zip(s["got"], s["want"]):
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)


# (case, query vid, planned index vids, eks, k): candidates duplicated across
# two and across four indexes, and a union shorter than k
SERVED = [
    ("two_indexes", (0, 1), [(0,), (1,)], [60, 60], 50),
    ("four_indexes", (0, 1, 2, 3), [(0,), (1,), (2,), (3,)], [40, 40, 40, 40], 50),
    ("pairs_of_columns", (0, 1, 2, 3), [(0, 1), (1, 2), (2, 3), (0, 3)], [70] * 4, 100),
    ("union_shorter_than_k", (0, 1), [(0,), (1,)], [12, 12], 100),
]


@pytest.mark.parametrize("case,vid,vids,eks,k", SERVED, ids=[c[0] for c in SERVED])
def test_served_rerank_equals_the_host_algorithm(db, device, case, vid, vids, eks, k):
    engine = BatchEngine(db, device=device)
    seen = _spy(engine)
    qs = make_queries(db, [vid] * 3, k=k, seed=5)
    ids = engine.search_batch([(q, _plan(q, vids, eks)) for q in qs])
    _assert_same(seen)
    assert len(seen) == 1 and seen[0]["group"].batch == 3
    cand = seen[0]["cand"]
    n_cand = [sum(len(c) for c in row) for row in cand]
    n_union = [len(np.unique(np.concatenate(row))) for row in cand]
    assert all(u < c for u, c in zip(n_union, n_cand))  # duplicates across indexes
    for got, u in zip(ids, n_union):
        assert len(got) == min(k, u) and len(set(got.tolist())) == len(got)
    if case == "union_shorter_than_k":
        assert all(u < k for u in n_union)
    assert engine.device_unions == engine.counters.rerank == 1


@pytest.mark.parametrize("row", [15, 22, 39])
def test_equal_scores_rank_by_ascending_row_id(db, device, row):
    src, dst, _ = DUP
    engine = BatchEngine(db, device=device)
    seen = _spy(engine)
    vid = (0, 1, 2)
    q = _row_query(db, 0, row, vid, k=20)
    (got,) = engine.search_batch([(q, _plan(q, [(0,), (1, 2)], [40, 40]))])
    _assert_same(seen)
    twin = row - src + dst
    assert got[:2].tolist() == [row, twin]  # the tie, ascending id


def _group(db, n, vids, eks, k):
    qs = make_queries(db, [(0, 1)] * n, k=k, seed=9)
    (group,) = compile_batch([(q, _plan(q, vids, eks)) for q in qs])
    return group


def _ids(*ranges):
    return np.concatenate([np.arange(a, b) for a, b in ranges]).astype(np.int64)


# hand-made candidate lists of a B = 4 group (two indexes a query): disjoint
# and overlapping unions, duplicates inside and across a query's lists, a
# query with no candidates beside ones with some, and int32 lists
GROUPS = [
    ("disjoint", [[_ids((0, 40)), _ids((20, 60))], [_ids((100, 150)), _ids((140, 160))],
                  [_ids((200, 230)), _ids((10, 40))], [_ids((250, 300)), _ids((240, 250))]]),
    ("overlapping", [[_ids((0, 120)), _ids((60, 180))], [_ids((50, 150)), _ids((0, 10))],
                     [_ids((100, 200)), _ids((100, 200))], [_ids((0, 300)), _ids((0, 1))]]),
    ("one_empty", [[_ids((0, 80)), _ids((40, 90))], [np.empty(0, np.int64)] * 2,
                   [_ids((10, 40)), np.empty(0, np.int64)], [_ids((200, 240)), _ids((5, 15))]]),
    ("int32_lists", [[_ids((0, 70)).astype(np.int32), _ids((35, 99)).astype(np.int32)]] * 2
     + [[_ids((150, 170)).astype(np.int32), _ids((160, 300)).astype(np.int32)]] * 2),
]


@pytest.mark.parametrize("case,cand", GROUPS, ids=[g[0] for g in GROUPS])
def test_group_of_four_equals_the_host_algorithm(db, device, case, cand, monkeypatch):
    engine = BatchEngine(db, device=device)
    group = _group(db, 4, [(0,), (1,)], [30, 30], k=50)
    want = host_rerank(engine, group, cand)

    def refused(*a, **kw):
        raise AssertionError("the device union sorted on the host")
    monkeypatch.setattr(np, "unique", refused)
    monkeypatch.setattr(np, "searchsorted", refused)
    got = engine._rerank(group, cand)
    monkeypatch.undo()
    for g, w, row in zip(got, want, cand):
        np.testing.assert_array_equal(g, w)
        n = len(np.unique(np.concatenate(row)))
        assert len(g) == min(50, n)  # a union shorter than k comes back whole
    assert engine.device_unions == engine.counters.rerank == 1


def test_a_group_without_candidates_launches_nothing(db):
    engine = BatchEngine(db, device="cpu")
    group = _group(db, 2, [(0,), (1,)], [30, 30], k=10)
    empty = [[np.empty(0, np.int64)] * 2] * 2
    got = engine._rerank(group, empty)
    assert [g.shape for g in got] == [(0,), (0,)]
    assert engine.device_unions == engine.counters.rerank == 0


def test_filtered_group_equals_the_host_algorithm(db, device):
    engine = BatchEngine(db, device=device)
    engine.attach_filters(synth_attributes(N_ROWS, seed=0, device=device))
    seen = _spy(engine)
    pred = Range("score", lo=0.2, hi=0.8)
    qs = [dataclasses.replace(q, predicate=pred)
          for q in make_queries(db, [(0, 1, 2)] * 4, k=30, seed=3)]
    pairs = [(q, _plan(q, [(0,), (1, 2)], [60, 60], access_path="post", selectivity=0.6))
             for q in qs]
    ids = engine.search_batch(pairs)
    _assert_same(seen)
    assert len(seen) == 1 and seen[0]["group"].batch == 4
    keep = engine._filter_state(pred).base_keep
    assert all(keep[i].all() and len(i) for i in ids)
    assert engine.device_unions == engine.counters.rerank == 1


def _rerank_spans(engine, pairs):
    trace = Trace()
    with engine.obs.span("dispatch", parent=trace.root) as dsp:
        ids = engine.search_batch(pairs)
    return ids, [sp for sp in dsp.walk() if sp.name == "rerank"]


def test_every_unmutated_group_takes_the_device_union(db):
    """Groups of three plans in one batch: each rerank is counted once and
    carries ``union_on="device"``; the flat fallback group reranks nothing."""
    engine = BatchEngine(db, device="cpu", observer=Observer())
    vids = [(0, 1), (0, 1, 2, 3), (2,)]
    qs = make_queries(db, vids * 2, k=25, seed=4)
    plans = {(0, 1): ([(0,), (1,)], [40, 40]),
             (0, 1, 2, 3): ([(0, 1), (2, 3)], [50, 50]),
             (2,): ([], [])}
    pairs = [(q, _plan(q, *plans[q.vid])) for q in qs]
    _, spans = _rerank_spans(engine, pairs)
    assert [sp.attrs["union_on"] for sp in spans] == ["device", "device"]
    assert engine.device_unions == engine.counters.rerank == 2


def test_a_mutated_table_keeps_the_host_union(db):
    engine = BatchEngine(db, device="cpu", observer=Observer())
    table = MutableTable(db)
    rng = np.random.default_rng(1)
    table.apply(InsertBatch([c[rng.choice(N_ROWS, 12)] + 0.01 for c in db.columns]))
    engine.attach_mutations(MutationView(table, device="cpu"))
    qs = make_queries(db, [(0, 1)] * 2, k=20, seed=6)
    ids, spans = _rerank_spans(engine, [(q, _plan(q, [(0,), (1,)], [40, 40])) for q in qs])
    assert [sp.attrs["union_on"] for sp in spans] == ["host"]
    assert engine.counters.rerank == 1 and engine.device_unions == 0
    for got in ids:
        assert len(got) == 20 and set(got.tolist()) <= set(table.live_ids().tolist())
