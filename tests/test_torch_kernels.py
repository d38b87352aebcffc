"""Port parity: the three kernels of the PyTorch/CUDA port against the JAX
package, on the same seeded numpy inputs.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
as its own tests run it here (Pallas in interpret mode, or its pure-jnp
oracle). Tolerance: both sides sum float32 products in different orders,
so scores agree to rtol = atol = 1e-5 at these widths (d <= 128, scores of
magnitude <= 2d); ids are equal because the seeded scores have no ties that
close. bf16 inputs are rounded to bf16 once, identically on both sides, and
then computed in f32, so they keep the f32 tolerance. The hand-written
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance.ops import fused_scan as jax_fused_scan
from repro.kernels.distance.ref import batched_scores_ref as jax_scores_ref
from repro.kernels.streaming.ref import streaming_fused_scan_ref as jax_stream_ref
from repro.kernels.topk.kernel import neg_inf_for as jax_neg_inf_for
from repro.kernels.topk.ref import topk_ref as jax_topk_ref
from repro_torch.kernels import common, launch_counts
from repro_torch.kernels.common import NEG_INF, neg_inf_for
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ops import fused_scan
from repro_torch.kernels.parity import CASES, case_arrays, to_torch
from repro_torch.kernels.streaming import kernel as streaming_kernel
from repro_torch.kernels.streaming.ops import streaming_fused_scan
from repro_torch.kernels.topk.kernel import topk_scores

RTOL = ATOL = 1e-5

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_jax(x, dtype):
    if x is None or isinstance(x, int):
        return x
    return jnp.asarray(x).astype(dtype) if x.dtype == np.float32 else jnp.asarray(x)


def _assert_same(vals, ids, rvals, rids):
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(rids))
    np.testing.assert_allclose(np.asarray(vals), np.asarray(rvals),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_streaming_matches_jax_oracle(name, metric, dtype):
    jdt, tdt = DTYPES[dtype]
    q, db, kw = case_arrays(CASES[name], seed=sorted(CASES).index(name))
    k = CASES[name]["k"]
    rvals, rids = jax_stream_ref(_to_jax(q, jdt), _to_jax(db, jdt), k=k,
                                 metric=metric, interpret=True,
                                 **{n: _to_jax(v, jdt) for n, v in kw.items()})
    vals, ids = streaming_fused_scan(to_torch(q, tdt), to_torch(db, tdt), k=k,
                                     metric=metric,
                                     **{n: to_torch(v, tdt) for n, v in kw.items()})
    _assert_same(vals, ids, rvals, rids)


def test_streaming_deep_k_matches_jax_topk():
    """k = 2048 over 5000 rows (the estimators search samples at ek up to
    n_sample / 4): the port's fold against lax.top_k of the full scores."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 64)).astype(np.float32)
    db = rng.standard_normal((5000, 64)).astype(np.float32)
    rvals, rids = jax_topk_ref(jax_scores_ref(jnp.asarray(q), jnp.asarray(db)), 2048)
    vals, ids = streaming_fused_scan(torch.as_tensor(q), torch.as_tensor(db), k=2048)
    _assert_same(vals, ids, rvals, rids)


def test_streaming_all_dead_tail_contract():
    """k slots over zero live rows: every slot is (NEG_INF, 0)."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.standard_normal((2, 16)).astype(np.float32))
    db = torch.as_tensor(rng.standard_normal((200, 16)).astype(np.float32))
    vals, ids = streaming_fused_scan(q, db, k=10,
                                     dead_mask=torch.ones(200, dtype=torch.bool))
    assert torch.all(vals == NEG_INF) and torch.all(ids == 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
@pytest.mark.parametrize("B,N,d", [(4, 64, 32), (17, 130, 100), (128, 512, 128),
                                   (3, 1000, 25)])
def test_distance_matches_jax_ref(B, N, d, metric, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(B * 1000 + N)
    q = rng.standard_normal((B, d)).astype(np.float32)
    db = rng.standard_normal((N, d)).astype(np.float32)
    ref = jax_scores_ref(_to_jax(q, jdt), _to_jax(db, jdt), metric=metric)
    out = batched_scores(to_torch(q, tdt), to_torch(db, tdt), metric=metric)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,N,k", [(4, 200, 10), (9, 1000, 50), (2, 64, 64),
                                   (1, 5000, 100)])
def test_topk_matches_jax_ref(B, N, k):
    s = np.random.default_rng(N).standard_normal((B, N)).astype(np.float32)
    rvals, rids = jax_topk_ref(jnp.asarray(s), min(k, N))
    vals, ids = topk_scores(torch.as_tensor(s), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))


def test_topk_ties_by_ascending_id():
    """Equal scores are ordered by ascending id: the canonical tie-break."""
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, ids = topk_scores(s, 4)
    assert ids.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16),
                                     (torch.float16, jnp.float16)])
def test_neg_inf_for_per_dtype(tdt, jdt):
    assert neg_inf_for(tdt) == jax_neg_inf_for(jdt)
    v = neg_inf_for(tdt)
    if tdt != torch.float32 and np.isfinite(v):  # a narrow sentinel is exact
        assert float(torch.tensor(v, dtype=tdt)) == v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_topk_narrow_dtype_all_dead_tail(dtype):
    """With 10 live columns and the rest at the dtype's sentinel, k=16
    surfaces exactly the live ids; no masked column beats an empty slot."""
    s = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 100))
                        .astype(np.float32)).to(dtype)
    s[:, 10:] = neg_inf_for(dtype)
    vals, ids = topk_scores(s, 16)
    for b in range(4):
        assert set(ids[b, :10].tolist()) == set(range(10))
        assert torch.all(vals[b, 10:] <= NEG_INF)


@pytest.mark.parametrize("valid_n,k", [(200, 5), (30, 50), (256, 300)])
def test_fused_scan_clamps_k_to_valid_rows(valid_n, k):
    """Two-pass ``min(k, valid_n)`` narrowing and padding mask, as in JAX."""
    rng = np.random.default_rng(valid_n)
    data = (rng.standard_normal((200, 32)) - 2.0).astype(np.float32)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    padded = np.pad(data, ((0, 56), (0, 0)))  # zero rows would win unmasked
    rvals, rids = jax_fused_scan(jnp.asarray(q), jnp.asarray(padded), k=k,
                                 valid_n=valid_n, interpret=True)
    vals, ids = fused_scan(torch.as_tensor(q), torch.as_tensor(padded), k=k,
                           valid_n=valid_n)
    assert ids.shape == rids.shape
    _assert_same(vals, ids, rvals, rids)


@pytest.mark.parametrize("metric", ["dot", "cosine", "l2"])
def test_two_pass_equals_streaming(metric):
    """The two-pass path (distance + mask + top-k) and the one-pass scan
    return identical values and ids: the port's own internal contract."""
    q, db, kw = case_arrays(CASES["pad_and_dead"], seed=5)
    q, db = torch.as_tensor(q), torch.as_tensor(db)
    dead = torch.as_tensor(kw["dead_mask"])
    k = min(25, kw["valid_n"])
    v1, i1 = streaming_fused_scan(q, db, k=k, metric=metric,
                                  valid_n=kw["valid_n"], dead_mask=dead)
    v2, i2 = fused_scan(q, db, k=k, metric=metric, valid_n=kw["valid_n"],
                        dead_mask=dead)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


def test_cpu_tensors_launch_nothing():
    before = launch_counts()
    q = torch.randn(3, 8)
    streaming_fused_scan(q, torch.randn(40, 8), k=5)
    topk_scores(batched_scores(q, torch.randn(40, 8)), 5)
    assert launch_counts() == before


def test_kernel_build_targets_sm90a_one_compile_per_source(tmp_path):
    compiles, link = common.build_commands("nvcc", tmp_path, tmp_path / "lib.so")
    cu = [p for p in common.kernel_sources() if p.suffix == ".cu"]
    assert len(compiles) == len(cu) >= 4
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in link
    assert common.library_path().name.startswith("libmint_kernels_")


@pytest.mark.parametrize("B,P,Lc,k", [(1, 1, 10, 10), (3, 5, 100, 100),
                                      (2, 3, 1024, 2500), (64, 977, 128, 128),
                                      (1, 261, 100, 100), (64, 131, 100, 100)])
def test_merge_scratch_covers_every_round(B, P, Lc, k):
    """The scratch buffers hold the partial lists and every merge round's
    output at the fan-in the wrappers pick, and the rounds end at one list
    of exactly k keys."""
    fan_in = common.merge_fan_in(B, P, Lc)
    assert fan_in == (8 if B * P * Lc <= 1 << 17 else 2)
    scratch = common.merge_scratch_elems(B, P, Lc, k, fan_in)
    assert B * P * Lc <= scratch
    L = Lc
    while P > 1:
        P, L = -(-P // fan_in), min(k, fan_in * L)
        assert B * P * L <= scratch
    assert L == k


@pytest.mark.parametrize("B,Nb,Nd,k", [(64, 1_000_000, 0, 100), (1, 1_000_000, 0, 100),
                                       (1, 10_000, 0, 2500), (2, 5000, 0, 2048),
                                       (65, 3000, 0, 30), (128, 256, 40, 10),
                                       (1, 520, 70, 50), (64, 100_000, 0, 300),
                                       (1, 300_000, 0, 2048), (3, 2_000_000, 7, 20_000)])
def test_scan_grid_covers_every_row_once(B, Nb, Nd, k):
    """The scan's grid: its row blocks cover each source's rows once, in
    order; the query tiles cover B; each block's list holds its min(k, rows)
    keys in a power of two; the lists fit the shared-memory budget; and the
    merge scratch covers its P lists down to k."""
    g = streaming_kernel.scan_grid(B, Nb, Nd, k)
    rb = g.rows_per_block
    blocks = ([(0, r, min(r + rb, Nb)) for r in range(0, Nb, rb)]
              + [(1, r, min(r + rb, Nd)) for r in range(0, Nd, rb)])
    assert len(blocks) == g.P and sum(src == 0 for src, _, _ in blocks) == g.base_blocks
    for src, n in ((0, Nb), (1, Nd)):
        spans = [(r0, r1) for s, r0, r1 in blocks if s == src]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # contiguous
        assert (spans[0][0], spans[-1][1]) == (0, n) if n else spans == []
        assert all(0 < r1 - r0 <= g.rows_per_block for r0, r1 in spans)
    assert g.rows_per_block % streaming_kernel.ROW_TILE == 0
    assert g.qt in streaming_kernel.QUERY_TILES and g.n_qtiles == -(-B // g.qt)
    assert (g.n_qtiles - 1) * g.qt < B <= g.n_qtiles * g.qt
    assert g.lc == min(k, g.rows_per_block) <= g.lpad < 2 * g.lc + 1
    assert g.lpad & (g.lpad - 1) == 0 and g.cap & (g.cap - 1) == 0 and g.cap <= g.lpad
    assert g.qt * (g.lpad + g.cap) * 8 <= streaming_kernel.LIST_BYTES
    fan_in = common.merge_fan_in(B, g.P, g.lc)
    scratch = common.merge_scratch_elems(B, g.P, g.lc, min(k, Nb + Nd), fan_in)
    assert B * g.P * g.lc <= scratch
