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
from repro_torch.kernels.parity import (CARD_CASES, FLASH_BWD_CASES, FLASH_BWD_TILE_CASES,
                                        FLASH_CASES, FLASH_DTYPES, TOPK_CASES, check_case,
                                        check_flash_bwd_case, check_flash_case, check_scores,
                                        check_topk_case, flash_bwd_case_arrays,
                                        flash_bwd_kwargs)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xattn_sq1", "xattn_sq384"])
def test_cross_attention_cases_take_their_routes(cuda_device, name):
    """Whisper's cross attention shapes: decode on the split-KV route in every
    dtype; a 384-query prompt on tensor cores (bf16, f16) and the FP32 kernel."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    routes = set()
    for dtype in FLASH_DTYPES.values():
        check_flash_case(name, dtype, cuda_device)
        routes.add(flash_attention.last_route[0])
    assert routes == ({"split_kv"} if name == "xattn_sq1" else {"tensor_core", "fp32"})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_matches_plain_on_card(cuda_device, name, dtype):
    """The backward kernel against ``attention_bwd_ref`` on the same (q, k, v,
    out, lse, dout), the forward's lse against ``attention_lse_ref``, two
    backward calls bit for bit, and the serving forward (no lse) bit for bit
    the lse-writing one's (``parity.check_flash_bwd``)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    before = flash_attention_bwd.launches
    check_flash_bwd_case(name, FLASH_DTYPES[dtype], cuda_device)
    assert flash_attention_bwd.launches == before + 2


@pytest.mark.cuda
def test_flash_backward_never_takes_the_plain_version_on_card(cuda_device, monkeypatch):
    """On CUDA tensors the autograd function's backward launches the kernel:
    the plain backward, made to raise, is never reached."""
    from repro_torch.kernels.flash_attention import kernel as K
    monkeypatch.setattr(K, "attention_bwd_ref", lambda *a, **k: 1 / 0)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 100, 64), generator=g, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    before = K.flash_attention_bwd.launches
    K.flash_attention(q, k, v).float().square().sum().backward()
    assert K.flash_attention_bwd.launches == before + 1
    assert all(bool(x.grad.abs().max() > 0) for x in (q, k, v))


def _bwd_case(name, dtype, device):
    return tuple(torch.as_tensor(x, device=device).to(FLASH_DTYPES[dtype])
                 for x in flash_bwd_case_arrays(name))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_BWD_TILE_CASES))
def test_flash_backward_route_by_dtype_repeats_bit_for_bit(cuda_device, name, dtype):
    """bf16 and f16 launch the backward's tensor-core route, float32 its FP32
    FMA route; two calls on a route give the same bits."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_lse)
    q, k, v, dout = _bwd_case(name, dtype, cuda_device)
    kw = flash_bwd_kwargs(name)
    out, lse = flash_attention_lse(q, k, v, **kw)
    route = "ffma" if dtype == "f32" else "tensor_core"
    before = flash_attention_bwd.route_launches[route]
    first = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert flash_attention_bwd.last_route == route
    second = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert flash_attention_bwd.route_launches[route] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_BWD_TILE_CASES))
def test_flash_backward_strided_views_equal_contiguous(cuda_device, name, dtype):
    """(B, S, H, d) tensors seen as (B, H, S, d), the models' layout, give the
    gradients of contiguous copies bit for bit, in the inputs' layouts."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_lse)
    q, k, v, dout = _bwd_case(name, dtype, cuda_device)
    kw = flash_bwd_kwargs(name)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()  # (k and v with one head count as contiguous)
    out, lse = flash_attention_lse(q, k, v, **kw)
    want = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    got = flash_attention_bwd(*views, out, lse, dout, **kw)
    for g, w, x in zip(got, want, views):
        assert g.stride() == x.stride()
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "gemma2-27b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_reduced_train_step_on_card_equals_cpu(cuda_device, name):
    """One ``make_train_step`` of a ``reduced()`` config on the card
    (attention both ways in the flash kernels) against the CPU (plain
    attention under autograd) from the same weights: loss within the JAX
    suite's bf16 tolerance (rtol 0.05 / atol 0.1), gnorm within 5%, the same
    lr; every flash forward on the card has its backward."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get_arch(name).reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": TokenPipeline(cfg.vocab_size, 2, 96, seed=0).batch_at(0)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, cfg.cross_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    params = M.init_params(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, peak_lr=1e-3, total_steps=100)
    out = {}
    for dev in ("cpu", cuda_device):
        tree = _tree_to(params, dev)
        st = adamw_init(tree)
        reset_launch_counts()
        _, _, m = step(tree, st._replace(step=st.step + 5), batch)
        out[str(dev)] = {k: float(v) for k, v in m.items()}
    counts = launch_counts()
    assert counts["flash_attention"] > 0
    assert counts["flash_attention_bwd"] == counts["flash_attention"]
    np.testing.assert_allclose(out["cuda"]["loss"], out["cpu"]["loss"], rtol=0.05, atol=0.1)
    np.testing.assert_allclose(out["cuda"]["gnorm"], out["cpu"]["gnorm"], rtol=0.05)
    assert out["cuda"]["lr"] == out["cpu"]["lr"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium", "qwen2-vl-2b"])
def test_family_on_card_equals_cpu(cuda_device, name):
    """Each family's ``reduced()`` prefill and one decode step on the card
    (attention in the flash kernel) against the CPU (plain attention): logits
    within the JAX suite's prefill-vs-decode tolerance, the same top-1 except
    at a near tie (the CPU's score of the card's pick within atol of its
    best)."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    cfg = get_arch(name).reduced()
    B, S = 2, 96
    rng = np.random.default_rng(0)
    batch = {"tokens": TokenPipeline(cfg.vocab_size, B, S + 1, seed=0).batch_at(0)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.cross_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    pos = S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    params = M.init_params(cfg, seed=0, device="cpu")
    out = {}
    reset_launch_counts()
    for dev in ("cpu", cuda_device):
        tree = _tree_to(params, dev)
        pre, cache = M.prefill(cfg, tree, dict(batch, tokens=batch["tokens"][:, :S]))
        dec, _ = M.decode_step(cfg, tree, M.grow_cache(cache, pos + 1),
                               batch["tokens"][:, S:], pos)
        out[str(dev)] = (pre.float().cpu(), dec.float().cpu())
    assert (launch_counts()["flash_attention"] > 0) == (cfg.family != "ssm")
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0.15, atol=0.35)
        pick = got.argmax(-1)
        short = want.amax(-1) - want.gather(-1, pick[..., None])[..., 0]
        assert bool((short[pick != want.argmax(-1)] <= 0.35).all()), short


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "qwen2-7b"])
def test_sharded_step_on_card_equals_cpu(cuda_device, name):
    """One sharded step (tp, ZeRO-1 moments) of a ``reduced()`` config on a
    (2, 4) debug mesh of the card (each rank's attention in the flash
    kernels, both ways) against the same mesh on the CPU (the plain
    versions): loss within rtol 0.05 / atol 0.1, gnorm within 5%; every
    flash forward has its backward; a repeat on the card is bit-equal."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import gather_tree, param_shardings, shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import zero1_shardings
    from repro_torch.train.step import make_sharded_train_step, sharded_adamw_init
    cfg = get_arch(name).reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 96)).astype(np.int32)}
    params = M.init_params(cfg, seed=0, device="cpu")
    step = make_sharded_train_step(cfg, peak_lr=1e-3, total_steps=100)
    out = {}
    for dev, runs in (("cpu", 1), (cuda_device, 2)):
        mesh = make_debug_mesh(2, 4, device=dev)
        tree = _tree_to(params, dev)
        psh = param_shardings(tree, mesh)
        reset_launch_counts()
        res = []
        for _ in range(runs):
            st = sharded_adamw_init(shard_tree(tree, psh), zero1_shardings(psh, tree, mesh))
            p2, _, m = step(shard_tree(tree, psh), st._replace(step=st.step + 5), batch)
            res.append(({k: float(v) for k, v in m.items()}, gather_tree(p2)))
        out[str(dev)] = res
    counts = launch_counts()
    assert counts["flash_attention"] > 0
    assert counts["flash_attention_bwd"] == counts["flash_attention"]
    (card, p_card), (again, p_again) = out["cuda"]
    cpu = out["cpu"][0][0]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=0.05, atol=0.1)
    np.testing.assert_allclose(card["gnorm"], cpu["gnorm"], rtol=0.05)
    assert card == again
    assert all(torch.equal(p_card[k], p_again[k]) for k in ("embed", "ln_final"))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p_card), _leaves(p_again)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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


@pytest.mark.cuda
def test_cache_probe_scans_a_resident_matrix_in_place(cuda_device, monkeypatch):
    """The probe takes the cache's resident float32 matrix as it is: the
    scan receives that very tensor (no host round trip, no copy), and the
    result equals the numpy call's, with or without the kept norms."""
    import numpy as np
    from repro_torch.kernels.distance.ref import squared_norms
    from repro_torch.serve import engine
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((256, 384)).astype(np.float32)
    q = rng.standard_normal((16, 384)).astype(np.float32)
    q[:4] = mat[[5, 50, 150, 199]]
    ref = engine.cache_probe_scan(q, mat, 200, device=cuda_device)
    dev = torch.as_tensor(mat, device=cuda_device)
    seen = []
    scan = engine.streaming_fused_scan

    def spy(qt, db, **kw):
        seen.append((db.data_ptr(), kw.get("db_sq")))
        return scan(qt, db, **kw)
    monkeypatch.setattr(engine, "streaming_fused_scan", spy)
    for mat_sq in (None, squared_norms(dev)):
        got = engine.cache_probe_scan(q, dev, 200, device=cuda_device, mat_sq=mat_sq)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0], ref[0])
    assert [p for p, _ in seen] == [dev.data_ptr()] * 2 and seen[1][1] is not None
    np.testing.assert_array_equal(ref[1][:4, 0], [5, 50, 150, 199])


def _staging_fixture(dev):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.index.registry import IndexStore
    from repro_torch.serve.engine import BatchEngine
    db = make_database(3000, [("a", 48), ("b", 64)], seed=0)
    engine = BatchEngine(db, store=IndexStore(db, seed=0, device=dev))
    rng = np.random.default_rng(2)
    pairs = []
    for i, q in enumerate(make_queries(db, [(0, 1), (0,), (1,), (0, 1)] * 4, k=10,
                                       seed=3)):
        q.qid = 100 + i
        kind = ("ivf", "flat")[i % 2]
        if i % 3 == 2:
            plan = QueryPlan(q.qid, [], [], 1.0, 1.0)
        elif len(q.vid) > 1 and i % 3 == 1:
            plan = QueryPlan(q.qid, [IndexSpec((c,), kind) for c in q.vid],
                             [int(rng.integers(20, 60)) for _ in q.vid], 1.0, 1.0)
        else:
            plan = QueryPlan(q.qid, [IndexSpec(q.vid, kind)], [40], 1.0, 1.0)
        pairs.append((q, plan))
    return engine, pairs


@pytest.mark.cuda
def test_staged_batch_on_card_equals_unstaged(cuda_device):
    """Staging on the card: pinned host buffers, copies on the engine's
    side stream behind an event, the executing thread's stream waits on
    it; the ids equal the unstaged call's, also when a worker thread
    executes."""
    import threading

    import numpy as np
    engine, pairs = _staging_fixture(cuda_device)
    ref = engine.search_batch(pairs)
    staged = engine.stage_batch(pairs)
    assert isinstance(staged.ready, torch.cuda.Event)
    assert staged.pinned and all(t.is_pinned() for t in staged.pinned)
    assert all(t.device.type == "cuda" for t in staged.qmats.values())
    assert engine._stage_stream != torch.cuda.current_stream(cuda_device)
    for r, a in zip(ref, engine.search_batch(pairs, staged=staged)):
        np.testing.assert_array_equal(r, a)
    out = []
    staged = engine.stage_batch(pairs)
    worker = threading.Thread(
        target=lambda: out.append(engine.search_batch(pairs, staged=staged)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and out
    for r, a in zip(ref, out[0]):
        np.testing.assert_array_equal(r, a)


@pytest.mark.cuda
def test_async_flush_on_a_real_pool_equals_sync_on_card(cuda_device):
    import numpy as np
    from repro_torch.async_ import WorkerPool
    from repro_torch.online.scheduler import MicroBatcher
    engine, pairs = _staging_fixture(cuda_device)

    def run(executor=None, stage=False):
        mb = MicroBatcher(
            lambda tks, staged=None: engine.search_batch(
                [(t.query, t.plan) for t in tks], staged=staged),
            plan_for=None, max_batch=4, executor=executor,
            stage=(lambda tks: engine.stage_batch([(t.query, t.plan) for t in tks]))
            if stage else None)
        tks = [mb.submit(q, now=i * 1e-4, plan=p) for i, (q, p) in enumerate(pairs)]
        mb.drain(1.0)
        return [np.asarray(t.result(timeout=60)) for t in tks]
    ref = run()
    with WorkerPool(workers=2, name="card") as pool:
        for stage in (True, False):
            for r, a in zip(ref, run(pool, stage)):
                np.testing.assert_array_equal(r, a)


@pytest.mark.cuda
def test_semcache_namespace_tensor_stays_on_card(cuda_device):
    """Probes without admissions scan the same resident CUDA tensor; an
    admission rebuilds it (and its norms) once."""
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.online import SemanticCache, SemCacheConfig
    db = make_database(500, [("a", 48), ("b", 64)], seed=0)
    qs = make_queries(db, [(0, 1)] * 3, k=10, seed=4)
    plan = QueryPlan(0, [IndexSpec((0, 1), "flat")], [10], 1.0, 1.0)
    cache = SemanticCache(SemCacheConfig(epsilon=0.0, capacity=8), device=cuda_device)
    for i, q in enumerate(qs[:2]):
        cache.probe(q, plan)[1].admit(np.arange(10) + i)
    (ns,) = cache._ns.values()
    cache.probe(qs[0], plan)
    ptr = ns.dev.data_ptr()
    assert ns.dev.device.type == "cuda" and ns.dev_sq.device.type == "cuda"
    for i, q in enumerate(qs[:2]):
        np.testing.assert_array_equal(cache.probe(q, plan)[0], np.arange(10) + i)
        assert ns.dev.data_ptr() == ptr
    cache.probe(qs[2], plan)[1].admit(np.arange(10) + 2)
    np.testing.assert_array_equal(cache.probe(qs[2], plan)[0], np.arange(10) + 2)
    assert ns.dev_version == ns.version == 3


@pytest.mark.cuda
def test_governed_spill_frees_card_memory_and_comes_back_bit_identical(cuda_device):
    """A budget eviction drops the store's tensor: ``memory_allocated`` (not
    ``memory_reserved``: the caching allocator keeps the block) falls by the
    column's padded bytes, and the column comes back equal."""
    from repro_torch.data.vectors import make_database
    from repro_torch.serve.columnstore import ColumnStore
    from repro_torch.tenancy import MemoryGovernor, TenantColumnStores
    db = make_database(10_000, [("a", 200), ("b", 130)], seed=0)
    col = ColumnStore(db, device="cpu").device_bytes
    gov = MemoryGovernor(col((0,)) + col((1,)))
    stores = TenantColumnStores(gov)
    sa = stores.register("a", db, device=cuda_device)
    sb = stores.register("b", db, device=cuda_device)
    before = sa.device((0,)).data.clone()
    sb.device((1,))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    sb.device((0,))  # over the budget: a's (0,) is the LRU victim, freed first
    torch.cuda.synchronize()
    assert sa.resident() == [] and gov.evictions == 1
    assert torch.cuda.memory_allocated() - held < col((0,))
    held = torch.cuda.memory_allocated()
    assert sb.evict_device((0,))
    torch.cuda.synchronize()
    assert held - torch.cuda.memory_allocated() >= col((0,))
    assert gov.tenant_bytes("b") == col((1,))
    assert torch.equal(sa.device((0,)).data, before)


@pytest.mark.cuda
def test_spilled_semcache_namespace_frees_matrix_and_norms_on_card(cuda_device):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.data.vectors import make_database, make_queries
    from repro_torch.online import SemanticCache, SemCacheConfig
    from repro_torch.tenancy import MemoryGovernor
    db = make_database(500, [("a", 300), ("b", 200)], seed=0)
    qs = make_queries(db, [(0, 1)] * 2, k=10, seed=4)
    plan = QueryPlan(0, [IndexSpec((0, 1), "flat")], [10], 1.0, 1.0)
    gov = MemoryGovernor(10**9)
    cache = SemanticCache(SemCacheConfig(capacity=4096), governor=gov, tenant="t",
                          device=cuda_device)
    gov.register_semcache("t", cache)
    for i, q in enumerate(qs):
        cache.probe(q, plan)[1].admit(np.arange(10) + i)
    np.testing.assert_array_equal(cache.probe(qs[0], plan)[0], np.arange(10))
    (ns,) = cache._ns.values()
    assert gov.resident() == [("t", ns.gvid, ns.device_bytes)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gov._evict("t", ns.gvid)
    torch.cuda.synchronize()
    assert ns.dev is None and ns.dev_sq is None and gov.resident() == []
    assert held - torch.cuda.memory_allocated() >= 4096 * 500 * 4 + 4096 * 4
    for i, q in enumerate(qs):  # re-uploads both, and hits
        np.testing.assert_array_equal(cache.probe(q, plan)[0], np.arange(10) + i)
    assert ns.dev.device.type == "cuda" and ns.dev_sq.device.type == "cuda"
    assert gov.resident() == [("t", ns.gvid, ns.device_bytes)]


@pytest.mark.cuda
def test_governed_delta_segment_is_charged_and_released_on_card(cuda_device):
    import numpy as np
    from repro_torch.data.vectors import make_database
    from repro_torch.ingest import DeltaSegments, InsertBatch, MutableTable
    from repro_torch.online import row_batch
    from repro_torch.tenancy import MemoryGovernor
    db = make_database(1000, [("a", 200), ("b", 100)], seed=0)
    table = MutableTable(db)
    gov = MemoryGovernor(10**9)
    seg = DeltaSegments(table, governor=gov, tenant="t", device=cuda_device)
    gov.register_delta("t", seg)
    table.apply(InsertBatch(row_batch(db, np.random.default_rng(0), 5000)))
    d = seg.column((0, 1))
    assert d.col.data.device.type == "cuda"
    assert gov.resident() == [("t", ("delta", 0, 1), d.col.device_bytes)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del d
    seg.drop_all()
    torch.cuda.synchronize()
    assert gov.resident() == [] and gov.stats()["total_bytes"] == 0
    assert held - torch.cuda.memory_allocated() >= 5120 * 384 * 4


# ---- serving over a row-sharded mesh on one card ----------------------------------
#
# make_debug_mesh(4, 1) repeats the card over four data ranks: each shard is
# scanned by the kernel, exactly the per-shard code a mesh of cards runs.


def _mesh_inputs(dev, n=40_000, d=384, B=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    db = torch.randn(n, d, generator=g).to(dev)
    q = torch.randn(B, d, generator=g).to(dev)
    bad = (torch.rand(n, generator=g) < 0.2).to(dev)
    return db, q, bad


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_mesh_step_per_shard_kernel_matches_plain_on_card(cuda_device, masked):
    """Each shard's kernel scan against the plain version on that shard, and
    the merged step against the plain scan over the whole matrix."""
    from repro_torch.distributed import row_sharding
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.common import NEG_INF
    from repro_torch.kernels.parity import check_topk, combined_plain_scores
    from repro_torch.kernels.streaming.ref import streaming_fused_scan_ref
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.search.distributed import _local_scan, make_search_step
    db, q, bad = _mesh_inputs(cuda_device)
    mesh = make_debug_mesh(4, 1)
    valid_n, k = 39_000, 100
    shards = row_sharding(mesh).shard(db)
    bads = row_sharding(mesh).shard(bad) if masked else [None] * 4
    for r, x in enumerate(shards):
        vn = min(max(valid_n - r * x.shape[0], 0), x.shape[0])
        vals, ids = _local_scan(x, q, k, r * x.shape[0], valid_n=valid_n, bad=bads[r])
        kw = dict(valid_n=vn, dead_mask=bads[r])
        rvals, rids = streaming_fused_scan_ref(q, x, k, **kw)
        rids = torch.where(rvals <= NEG_INF / 2, 0, rids + r * x.shape[0])
        full = torch.nn.functional.pad(combined_plain_scores(q, x, "dot", kw),
                                       (r * x.shape[0], 0), value=NEG_INF)
        check_topk(vals, ids, rvals, rids, full, q.shape[1], f"shard {r}")
    step = make_search_step(mesh, k, valid_n=valid_n, masked=masked)
    reset_launch_counts()
    vals, ids = step(shards, q, bad) if masked else step(shards, q)
    assert launch_counts()["streaming_fused_scan"] == 4
    kw = dict(valid_n=valid_n, dead_mask=bad if masked else None)
    rvals, rids = streaming_fused_scan_ref(q, db, k, **kw)
    check_topk(vals, ids, rvals, rids, combined_plain_scores(q, db, "dot", kw),
               q.shape[1], "mesh step")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_one_card_mesh_equals_single_device_scan_bit_for_bit(cuda_device, masked):
    """A row's score does not depend on the shard it sits in (one FMA order
    per row), so the merged step equals the single-device scan exactly."""
    from repro_torch.distributed import row_sharding
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.search.distributed import distributed_rerank, make_search_step
    db, q, bad = _mesh_inputs(cuda_device, seed=1)
    mesh = make_debug_mesh(4, 1)
    shards = row_sharding(mesh).shard(db)
    step = make_search_step(mesh, 100, valid_n=39_000, masked=masked)
    vals, ids = step(shards, q, bad) if masked else step(shards, q)
    v1, i1 = streaming_fused_scan(q, db, k=100, valid_n=39_000,
                                  dead_mask=bad if masked else None)
    assert torch.equal(vals, v1) and torch.equal(ids, i1)
    cand = torch.randperm(39_000, generator=torch.Generator().manual_seed(2))[:5000]
    cand = cand.sort().values.to(cuda_device)
    rv, ri = distributed_rerank(mesh, shards, cand, q[0], 100)
    s = batched_scores(q[:1], db[cand])[0]
    best = torch.sort(s, descending=True, stable=True)
    assert torch.equal(rv, best.values[:100]) and torch.equal(ri, cand[best.indices[:100]])


@pytest.mark.cuda
def test_mesh_engine_on_card_equals_single_device_engine(cuda_device):
    import numpy as np
    from repro_torch.core.types import IndexSpec, QueryPlan
    from repro_torch.index.registry import IndexStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.engine import BatchEngine
    db, qs, _, _ = _engine_fixture(cuda_device)
    store = IndexStore(db, seed=0)
    mesh_eng = BatchEngine(db, store=store, mesh=make_debug_mesh(4, 1))
    one = BatchEngine(db, store=store)
    pairs = []
    for q in qs:
        pairs.append((q, QueryPlan(q.qid, [], [], 1.0, 1.0)))
        for kind in ("flat", "ivf"):
            pairs.append((q, QueryPlan(q.qid, [IndexSpec(q.vid, kind)], [60], 1.0, 1.0)))
            if len(q.vid) > 1:
                pairs.append((q, QueryPlan(q.qid, [IndexSpec((c,), kind) for c in q.vid],
                                           [60, 60], 1.0, 1.0)))
    reset_launch_counts()
    a = mesh_eng.execute_batch(pairs)
    scans = launch_counts()["streaming_fused_scan"]
    assert scans > 0 and scans % 4 == 0  # four shards a flat dispatch
    b = one.execute_batch(pairs)
    for m1, m2 in zip(a, b):
        np.testing.assert_array_equal(m1.ids, m2.ids)
        assert (m1.cost, m1.num_dist) == (m2.cost, m2.num_dist)
    assert mesh_eng.counters.as_dict() == one.counters.as_dict()


# ---- serving on a mesh of the card, and the scan sweep --------------------------------


def _serve(cfg, params, mesh, batch, steps, tokens=None):
    """A prefill, a grow and ``steps`` decodes of ``params`` (placed on
    ``mesh``) under ``use_mesh``: the logits of each, and the tokens fed."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree, use_mesh
    from repro_torch.models import model as M
    placed = shard_tree(params, param_shardings(params, mesh))
    S = batch["tokens"].shape[1]
    with use_mesh(mesh), torch.no_grad():
        logits, cache = M.prefill(cfg, placed, batch)
        cache = M.grow_cache(cache, S + steps)
        out, fed = [logits], []
        for i in range(steps):
            tok = logits.argmax(-1).cpu() if tokens is None else tokens[i]
            fed.append(tok)
            logits, cache = M.decode_step(cfg, placed, cache, tok, S + i)
            out.append(logits)
    return [x.float().cpu() for x in out], fed


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-7b", "gemma2-27b", "whisper-medium", "zamba2-1.2b"])
def test_sharded_serving_on_card_equals_cpu(cuda_device, name):
    """A prefill and 3 decode steps of a ``reduced()`` config on a (2, 4)
    debug mesh of the card (each rank's prefill attention in the flash
    kernel, each sequence shard's decode in its split-KV route with lse)
    against the same mesh on the CPU (the plain versions), fed the card's
    greedy tokens: logits within rtol 0.05 / atol 0.1; a repeat on the card
    bit-equal."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    cfg = get_arch(name).reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((4, cfg.cross_len, cfg.d_model)).astype(np.float32)
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    reset_launch_counts()
    card, fed = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(2, 4), batch, 3)
    routes = dict(flash_attention.route_launches)
    # the decode steps' shards take the split-KV route (a prefill this short
    # may too: Sq x group <= 64)
    assert routes["split_kv"] >= 3 * cfg.n_layers
    again, _ = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(2, 4), batch, 3, fed)
    cpu, _ = _serve(cfg, params, make_debug_mesh(2, 4, device="cpu"), batch, 3, fed)
    for a, b, c in zip(card, again, cpu):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0.05, atol=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-350m"])
def test_ssm_blocks_split_by_head_on_card_equal_cpu(cuda_device, name):
    """The Mamba-2 / xLSTM blocks split by head over the 4 model ranks of a
    (2, 4) debug mesh of the card (tp mode; zamba2's shared attention in
    the flash kernels on each rank): a training loss and its gradients'
    norm, then a prefill and 3 decode steps, against the same mesh on the
    CPU (the plain versions), fed the card's greedy tokens: loss within
    rtol 1e-2, gradient norm within 5%, logits within rtol 0.05 / atol 0.1;
    a repeat on the card bit-equal."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.step import sharded_loss_and_grads
    cfg = get_arch(name).reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)}
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")

    def train(dev):
        tree = _tree_to(params, dev)
        placed = shard_tree(tree, param_shardings(tree, make_debug_mesh(2, 4, device=dev)))
        loss, _, grads = sharded_loss_and_grads(cfg, placed, batch)
        return float(loss), float(sum(g.float().square().sum() for g in grads.values())) ** 0.5
    card, again, cpu = train(cuda_device), train(cuda_device), train("cpu")
    assert card == again
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-2)
    np.testing.assert_allclose(card[1], cpu[1], rtol=0.05)
    out, fed = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(2, 4), batch, 3)
    out2, _ = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(2, 4), batch, 3, fed)
    ref, _ = _serve(cfg, params, make_debug_mesh(2, 4, device="cpu"), batch, 3, fed)
    for a, b, c in zip(out, out2, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0.05, atol=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,shape", [((6, 2), (1, 4)), ((4, 1), (2, 8)), ((8, 2), (1, 3))],
                         ids=["6q2kv-1x4", "4q1kv-2x8", "8q2kv-1x3"])
def test_uneven_head_split_on_card_equals_cpu(cuda_device, heads, shape):
    """Attention's q heads split unevenly over the model ranks of a debug
    mesh of the card (``head_range``: rank 1 of 6 q / 2 kv heads on 4
    straddles the kv groups, ranks 4-7 of 8 own none, rank 1 of 8 / 2 on 3
    runs its unequal runs as two flash calls over one kv head each): a
    training loss and its gradients' norm, then a prefill and 3 decode
    steps, against the same mesh on the CPU (the plain versions), fed the
    card's greedy tokens: loss within rtol 1e-2, gradient norm within 5%,
    logits within rtol 0.05 / atol 0.1; a repeat on the card bit-equal."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.train.step import sharded_loss_and_grads
    cfg = dataclasses.replace(get_arch("qwen2-7b").reduced(), n_heads=heads[0],
                              n_kv_heads=heads[1])
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 96)).astype(np.int32)}
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")

    def train(dev):
        tree = _tree_to(params, dev)
        placed = shard_tree(tree, param_shardings(tree, make_debug_mesh(*shape, device=dev)))
        loss, _, grads = sharded_loss_and_grads(cfg, placed, batch)
        return float(loss), float(sum(g.float().square().sum() for g in grads.values())) ** 0.5
    card, again, cpu = train(cuda_device), train(cuda_device), train("cpu")
    assert card == again
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-2)
    np.testing.assert_allclose(card[1], cpu[1], rtol=0.05)
    out, fed = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(*shape), batch, 3)
    out2, _ = _serve(cfg, _tree_to(params, cuda_device), make_debug_mesh(*shape), batch, 3, fed)
    ref, _ = _serve(cfg, params, make_debug_mesh(*shape, device="cpu"), batch, 3, fed)
    for a, b, c in zip(out, out2, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0.05, atol=0.1)


@pytest.mark.cuda
def test_seq_shard_decode_on_card_equals_one_device(cuda_device):
    """A long-context (``shard_seq``) decode at batch 1 over a random cache
    whose 256 positions spread over the 8 ranks, at slot 100: one split-KV
    launch with lse for each of the slices 0..3 that hold valid keys and
    none for the others; logits within rtol 0.05 / atol 0.1 of one device's
    on the card."""
    import numpy as np
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.sharding import (cache_shardings, param_shardings,
                                                  shard_tree, use_mesh)
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    cfg = get_arch("qwen2-7b").reduced()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda_device)
    cache = M.make_cache(cfg, 1, 256, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for t in (cache["k"], cache["v"]):
        t.normal_(generator=gen)
    mesh = make_debug_mesh(2, 4)
    placed = shard_tree({k: t.clone() for k, t in cache.items()},
                        cache_shardings(cache, mesh, shard_seq=True))
    tok = torch.tensor([[7]])
    with torch.no_grad():
        want, _ = M.decode_step(cfg, params, cache, tok, 100)
        reset_launch_counts()
        with use_mesh(mesh):
            got, _ = M.decode_step(cfg, shard_tree(params, param_shardings(params, mesh)),
                                   placed, tok, 100)
    assert flash_attention.route_launches["split_kv"] == 4 * cfg.n_layers
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0.05, atol=0.1)


@pytest.mark.cuda
def test_scan_sweep_on_card_is_bit_equal(cuda_device):
    """``streaming_vs_twopass(measure=True)`` on the card at two sizes: both
    scans timed, their results bit-equal."""
    from repro_torch.launch.roofline import streaming_vs_twopass
    out = streaming_vs_twopass(ns=(2048, 8192), measure=True, device=cuda_device)
    for row in out["sweep"]:
        m = row["measured"]
        assert m["equal"] and m["n_measured"] == row["n"]
        assert m["streaming_ms"] > 0 and m["twopass_ms"] > 0
