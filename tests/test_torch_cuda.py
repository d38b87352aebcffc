"""The port's hand-written kernels against their plain PyTorch versions on
the card, over the grid and tolerance rule of ``repro_torch.kernels.parity``
(the same grid ``chip_smoke.py`` runs). Every test here needs a CUDA device
and skips without one; the file imports neither JAX nor the reference
package, so it runs on the GPU machine:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.parity import (CARD_CASES, FLASH_CASES, FLASH_DTYPES, TOPK_CASES,
                                        check_case, check_flash_case, check_scores,
                                        check_topk_case)
from repro_torch.kernels.topk.kernel import topk_scores
from repro_torch.kernels.topk.ref import topk_ref

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    common.strict_fp32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda_device, name, metric, dtype):
    check_case(name, metric, DTYPES[dtype], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_cases_equal_plain_on_card(cuda_device, name):
    """Rising scores, ties, NEG_INF tails, k beyond the live columns, 1e6
    columns, k = 2048 and odd N in each dtype: equal to ``topk_ref``."""
    check_topk_case(name, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
def test_distance_and_topk_kernels_match_plain_on_card(cuda_device, metric):
    """A serving-width case: 64 queries at a padded width of 384, k = 2048."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(64, 384, generator=g).to(cuda_device)
    db = torch.randn(5000, 384, generator=g).to(cuda_device)
    rs = batched_scores_ref(q, db, metric=metric)
    check_scores(batched_scores(q, db, metric=metric), rs, 384, f"distance/{metric}")
    vals, ids = topk_scores(rs, 2048)
    rvals, rids = topk_ref(rs, 2048)
    assert torch.equal(ids, rids) and torch.equal(vals, rvals)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_matches_plain_on_card(cuda_device, name, dtype):
    check_flash_case(name, FLASH_DTYPES[dtype], cuda_device)


# ---- the engine's filtered, mutated, cache-probe, graph and DP paths on the card ----
#
# Each is held against the same path on the CPU (the plain versions) and the
# host oracle: ids exactly equal (seeded random scores leave no ties).


def _engine_fixture(dev):
    import numpy as np
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.filter import Range, synth_attributes
    db = make_database(3000, [("a", 48), ("b", 64)], seed=0)
    qs = make_queries(db, [(0, 1), (0,), (1,)], k=10, seed=7)
    attrs = {d: synth_attributes(db.n_rows, seed=3, device=d) for d in ("cpu", dev)}
    vals = np.sort(attrs["cpu"].take("score", np.arange(db.n_rows)))
    preds = [Range("score", lo=float(np.quantile(vals, 0.2)),
                   hi=float(np.quantile(vals, 0.2 + sel))) for sel in (0.01, 0.1, 0.5)]
    return db, qs, attrs, preds


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("access", ["pre", "masked", "post"])
def test_filtered_engine_on_card_equals_cpu(cuda_device, access, streaming):
    from dataclasses import replace

    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BatchEngine
    db, qs, attrs, preds = _engine_fixture(cuda_device)
    engs = {}
    for d in ("cpu", cuda_device):
        engs[d] = BatchEngine(db, device=d, streaming=streaming)
        engs[d].attach_filters(attrs[d])
    reset_launch_counts()
    for pred in preds:
        pairs = []
        for q in qs:
            fq = replace(q, predicate=pred)
            specs = [IndexSpec(fq.vid, "flat")] if access == "post" else []
            pairs.append((fq, QueryPlan(fq.qid, specs, [40] * len(specs), 1.0, 1.0,
                                        access_path=access, selectivity=0.1)))
        card, cpu = (engs[d].search_batch(pairs) for d in (cuda_device, "cpu"))
        for (fq, _), a, b in zip(pairs, card, cpu):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, engs["cpu"].ground_truth(fq))
    counts = launch_counts()
    assert counts["batched_scores"] > 0 if access == "pre" or not streaming else \
        counts["streaming_fused_scan"] > 0
    assert engs[cuda_device].counters.as_dict() == engs["cpu"].counters.as_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [True, False])
def test_mutated_engine_on_card_equals_cpu(cuda_device, streaming):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database
    from repro_torch.ingest import DeleteBatch, InsertBatch, MutableTable, MutationView
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import BatchEngine
    db, qs, _, _ = _engine_fixture(cuda_device)
    table = MutableTable(db)
    table.apply(InsertBatch(make_database(200, [("a", 48), ("b", 64)], seed=77).columns))
    table.apply(DeleteBatch(np.random.default_rng(1).choice(table.live_ids(), 150,
                                                            replace=False)))
    engs = {}
    for d in ("cpu", cuda_device):
        engs[d] = BatchEngine(db, device=d, streaming=streaming)
        engs[d].attach_mutations(MutationView(table, device=d))
    pairs = []
    for q in qs:
        pairs.append((q, QueryPlan(q.qid, [], [], 1.0, 1.0)))
        pairs.append((q, QueryPlan(q.qid, [IndexSpec(q.vid, "flat")], [40], 1.0, 1.0)))
        if len(q.vid) > 1:
            pairs.append((q, QueryPlan(q.qid, [IndexSpec((c,), "flat") for c in q.vid],
                                       [30, 50], 1.0, 1.0)))
    reset_launch_counts()
    card, cpu = (engs[d].search_batch(pairs) for d in (cuda_device, "cpu"))
    for (q, p), a, b in zip(pairs, card, cpu):
        np.testing.assert_array_equal(a, b)
        if not p.indexes:
            np.testing.assert_array_equal(a, engs["cpu"].ground_truth(q))
    c = engs[cuda_device].counters.as_dict()
    assert c == engs["cpu"].counters.as_dict()
    assert (c["delta"] == 0) == streaming
    if streaming:  # one merged base + delta launch per flat (group, index)
        assert launch_counts()["streaming_fused_scan"] == c["scan"]


@pytest.mark.cuda
def test_cache_probe_on_card_equals_cpu(cuda_device):
    import numpy as np
    from repro_torch.serve.engine import cache_probe_scan
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((256, 384)).astype(np.float32)
    q = rng.standard_normal((64, 384)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)  # the cache holds unit
    q /= np.linalg.norm(q, axis=1, keepdims=True)      # query vectors
    q[:8] = mat[[3, 9, 27, 81, 100, 150, 190, 199]]
    vals, ids = cache_probe_scan(q, mat, 200, device=cuda_device)
    cvals, cids = cache_probe_scan(q, mat, 200, device="cpu")
    np.testing.assert_array_equal(ids, cids)
    np.testing.assert_array_equal(ids[:8, 0], [3, 9, 27, 81, 100, 150, 190, 199])
    assert (np.abs(vals - cvals) <= 1e-5 * np.sqrt(384) * np.maximum(np.abs(cvals), 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hnsw", "diskann"])
def test_graph_build_on_card_agrees_with_cpu(cuda_device, kind):
    import numpy as np
    from repro_torch.data.vectors import make_database
    from repro_torch.index.registry import BUILDERS
    data = make_database(3000, [("a", 48), ("b", 64)], seed=0).concat((0, 1))
    card = BUILDERS[kind](data, seed=0, device=cuda_device)
    cpu = BUILDERS[kind](data, seed=0, device="cpu")
    a, b = (card._layers[0], cpu._layers[0]) if kind == "hnsw" else (card.adj, cpu.adj)
    assert np.mean(a == b) >= 0.99
    qv = data[:5] + 0.01
    for v in qv:
        assert len(set(card.search(v, 20).ids) & set(cpu.search(v, 20).ids)) >= 18


@pytest.mark.cuda
def test_vectorized_dp_on_card_equals_cpu(cuda_device):
    import numpy as np
    from repro_torch.core.planner_jax import dp_solve
    rng = np.random.default_rng(0)
    req = torch.as_tensor(rng.integers(0, 400, size=(8, 6, 5)).astype(np.float32))
    args = (rng.integers(16, 160, 6).astype(np.float32),
            rng.uniform(1, 30, 6).astype(np.float32),
            rng.uniform(0, 300, 6).astype(np.float32), 144.0, 2500.0, 4.0, 5)
    cost, eks = dp_solve(req.to(cuda_device), *args)
    ccost, ceks = dp_solve(req, *args)
    assert torch.allclose(cost.cpu(), ccost, rtol=1e-6)
    assert torch.equal(eks.cpu(), ceks)
