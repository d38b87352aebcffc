"""Port parity of the index layer (flat and IVF) against the JAX package.

k-means sums its float reductions in another order in each framework, so a
from-scratch build is held by agreement: >= 99% of rows on the same list
and centroids within 1e-4. With the reference's lists carried across
(``repro_torch.convert``), IVF search is held to exact equality of ids,
scores and numDist.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index.base import exact_topk as jax_exact_topk
from repro.index.bruteforce import FlatIndex as JaxFlat
from repro.index.bruteforce import batch_exact_topk as jax_batch_exact_topk
from repro.index.ivf import IVFFlatIndex as JaxIVF
from repro.index.ivf import _lloyd as jax_lloyd
from repro.index.ivf import _scan_gathered as jax_scan_gathered
from repro_torch.convert import ivf_from_arrays
from repro_torch.core.types import IndexSpec
from repro_torch.data.vectors import make_database
from repro_torch.index.base import exact_topk
from repro_torch.index.bruteforce import FlatIndex, batch_exact_topk
from repro_torch.index.ivf import IVFFlatIndex, _lloyd, _scan_gathered
from repro_torch.index.registry import IndexStore

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    db = make_database(3000, [("a", 40), ("b", 24)], seed=3)
    return db.concat((0, 1))


@pytest.fixture(scope="module")
def jax_ivf(data):
    return JaxIVF(data, seed=0)


def _queries(n, d, seed):
    q = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("n_lists,n_iters", [(54, 8), (16, 3)])
def test_lloyd_agrees_with_jax(data, n_lists, n_iters):
    init = data[np.random.default_rng(n_lists).choice(len(data), n_lists,
                                                      replace=False)]
    jc, ja = jax_lloyd(jnp.asarray(data), jnp.asarray(init), n_iters)
    tc, ta = _lloyd(torch.as_tensor(data), torch.as_tensor(init), n_iters)
    assert np.mean(np.asarray(ja) == ta.numpy()) >= 0.99
    assert np.abs(np.asarray(jc) - tc.numpy()).max() <= 1e-4


def test_ivf_build_agrees_with_jax(data, jax_ivf):
    idx = IVFFlatIndex(data, seed=0, device="cpu")
    assert idx.n_lists == jax_ivf.n_lists
    assert np.abs(idx.centroids - jax_ivf.centroids).max() <= 1e-4
    assert np.mean(idx.row_ids == jax_ivf.row_ids) >= 0.99


@pytest.mark.parametrize("ek", [1, 10, 60, 400])
def test_ivf_search_exact_with_carried_lists(data, jax_ivf, ek):
    idx = ivf_from_arrays(data, jax_ivf.centroids, jax_ivf.row_ids,
                          jax_ivf.offsets, jax_ivf.n_lists, device="cpu")
    for qv in _queries(5, data.shape[1], seed=ek):
        ref = jax_ivf.search(qv, ek)
        got = idx.search(qv, ek)
        np.testing.assert_array_equal(got.ids, ref.ids)
        np.testing.assert_array_equal(got.scores, ref.scores)
        assert got.num_dist == ref.num_dist


def test_ivf_nprobe_matches_jax(data, jax_ivf):
    idx = ivf_from_arrays(data, jax_ivf.centroids, jax_ivf.row_ids,
                          jax_ivf.offsets, jax_ivf.n_lists, device="cpu")
    for ek in (1, 7, 55, 300, 5000):
        assert idx._nprobe_for(ek) == jax_ivf._nprobe_for(ek)
    assert idx.storage_bytes() == jax_ivf.storage_bytes()


@pytest.mark.parametrize("ek", [17, 150])
def test_scan_gathered_cpu_path_matches_jax(ek):
    rng = np.random.default_rng(ek)
    sub = rng.standard_normal((150, 24)).astype(np.float32)
    q = rng.standard_normal(24).astype(np.float32)
    s0, v0 = jax_scan_gathered(sub, q, ek, use_kernel=False)
    s1, v1 = _scan_gathered(sub, q, ek, CPU)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(v0, v1)


@pytest.mark.parametrize("block_rows", [64, 8192])
@pytest.mark.parametrize("k", [5, 100])
def test_batch_exact_topk_matches_jax(data, block_rows, k):
    q = _queries(6, data.shape[1], seed=k)
    ids0, s0 = jax_batch_exact_topk(data, q, k, block_rows=block_rows,
                                    use_kernel=False)
    ids1, s1 = batch_exact_topk(data, q, k, block_rows=block_rows, device="cpu")
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_allclose(s0, s1, rtol=1e-5, atol=1e-6)


def test_flat_index_matches_jax(data):
    qv = _queries(1, data.shape[1], seed=9)[0]
    ref = JaxFlat(data).search(qv, 30)
    got = FlatIndex(data, device="cpu").search(qv, 30)
    np.testing.assert_array_equal(got.ids, ref.ids)
    assert got.num_dist == ref.num_dist == len(data)


def test_exact_topk_copy_matches_jax(data):
    qv = _queries(1, data.shape[1], seed=2)[0]
    ids0, s0 = jax_exact_topk(data, qv, 50)
    ids1, s1 = exact_topk(data, qv, 50)
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_array_equal(s0, s1)


def test_index_store_builds_on_its_device():
    db = make_database(600, [("a", 16), ("b", 8)], seed=1)
    store = IndexStore(db, seed=0, device="cpu")
    spec = IndexSpec((0, 1), "ivf")
    idx = store.get(spec)
    assert idx is store.get(spec) and spec in store
    assert idx.device == CPU
    ref = JaxIVF(db.concat((0, 1)), seed=0)
    assert np.abs(idx.centroids - ref.centroids).max() <= 1e-4
