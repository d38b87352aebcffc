"""Port parity: the flash-attention kernel's plain version and the models'
attention routes against the JAX package, on the same seeded numpy inputs.

On the CPU the port's ``flash_attention`` computes its plain version; the
JAX side is ``attention_ref`` (the pure-jnp oracle) and, on two cases, the
Pallas kernel in interpret mode. Tolerances are the JAX tests' own
(tests/test_kernels.py): rtol = atol = 2e-3 in float32, 5e-2 in bf16, where
both sides round the same float32 result to bf16. Rows that no kv position
reaches give NaN in ``attention_ref`` and 0 in the kernel (its
max(l, 1e-30) clamp); the port's plain version keeps the kernel's rule. The
hand-written kernel itself is held against the plain version on the card
by tests/test_torch_cuda.py, over the same grid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.kernel import (SPLIT_MIN_KEYS, flash_attention,
                                                      split_plan)
from repro_torch.kernels.flash_attention.ref import (attention_ref, combine_splits,
                                                   split_partials_ref)
from repro_torch.kernels.parity import (FLASH_CASES, FLASH_DTYPES, FLASH_TOL,
                                        flash_case_arrays, flash_kwargs)
from repro_torch.models import attention as A
from repro_torch.models import model as M

JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this module off
    the cores that the suite's other workers run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _sides(name, dtype):
    arrays = flash_case_arrays(name)
    jq, jk, jv = (jnp.asarray(x).astype(JAX_DTYPES[dtype]) for x in arrays)
    q, k, v = (torch.as_tensor(x).to(FLASH_DTYPES[dtype]) for x in arrays)
    return (jq, jk, jv), (q, k, v)


def _assert_close(got, want, dtype, what=""):
    tol = FLASH_TOL[FLASH_DTYPES[dtype]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_ref(name, dtype):
    (jq, jk, jv), (q, k, v) = _sides(name, dtype)
    kw = flash_kwargs(name)
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == before  # CPU: no launch
    assert got.shape == q.shape and got.dtype == q.dtype
    want = jax_attention_ref(jq, jk, jv, **kw)
    reached = ~np.isnan(np.asarray(want.astype(jnp.float32))).any(-1)
    _assert_close(got[torch.as_tensor(reached)],
                  jnp.asarray(np.asarray(want)[reached]), dtype, name)
    # rows no kv position reaches give exactly 0
    assert not got[torch.as_tensor(~reached)].any()
    assert reached.all() == (name != "masked_rows")


@pytest.mark.parametrize("name", ["gqa_causal", "window16_cap20"])
def test_flash_plain_matches_pallas_interpret(name):
    (jq, jk, jv), (q, k, v) = _sides(name, "f32")
    kw = flash_kwargs(name)
    want = jax_flash(jq, jk, jv, bq=32, bkv=32, interpret=True, **kw)
    _assert_close(flash_attention(q, k, v, **kw), want, "f32", name)


def test_flash_rejects_mismatched_heads():
    q = torch.zeros(1, 3, 4, 32)
    k = v = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(torch.zeros(1, 2, 4, 32), k, torch.zeros(1, 2, 5, 32))


# ---- the models' attention: the card's route, run here on its plain version ----


def _bshd(rng, B, S, H, d):
    return rng.standard_normal((B, S, H, d)).astype(np.float32)


ROUTE_CASES = {
    # prefill: the cache is the prompt (q_offset 0, Sq == kv_len)
    "prefill": dict(Sq=40, max_len=40, kv_len=40, window=JM.NO_WINDOW, softcap=0.0),
    "prefill_window_softcap": dict(Sq=40, max_len=40, kv_len=40, window=16,
                                   softcap=20.0),
    # decode: one query at position kv_len - 1 of a longer cache
    "decode": dict(Sq=1, max_len=64, kv_len=37, window=JM.NO_WINDOW, softcap=50.0),
    "decode_window": dict(Sq=1, max_len=64, kv_len=37, window=16, softcap=50.0),
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_flash_route_matches_jax_dense(name):
    c = ROUTE_CASES[name]
    rng = np.random.default_rng(sorted(ROUTE_CASES).index(name))
    q = _bshd(rng, 2, c["Sq"], 4, 32)
    k, v = _bshd(rng, 2, c["max_len"], 2, 32), _bshd(rng, 2, c["max_len"], 2, 32)
    kw = dict(causal=True, window=c["window"], softcap=c["softcap"],
              q_offset=c["kv_len"] - c["Sq"], kv_len=c["kv_len"])
    want = JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = A.flash_route(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                        **kw)
    assert got.shape == q.shape
    _assert_close(got, want, "f32", name)


def test_flash_route_int8_cache_matches_jax_dense():
    rng = np.random.default_rng(7)
    q = _bshd(rng, 2, 1, 4, 32)
    kq, ks = JM._quantize_kv(jnp.asarray(_bshd(rng, 2, 48, 2, 32)))
    vq, vs = JM._quantize_kv(jnp.asarray(_bshd(rng, 2, 48, 2, 32)))
    kw = dict(causal=True, window=JM.NO_WINDOW, softcap=50.0, q_offset=29, kv_len=30)
    want = JA.dense_attention(jnp.asarray(q).astype(jnp.bfloat16), kq, vq,
                              k_scale=ks, v_scale=vs, **kw)
    t = [torch.as_tensor(np.array(x)) for x in (kq, vq, ks, vs)]
    got = A.flash_route(torch.as_tensor(q).to(torch.bfloat16), t[0], t[1],
                        k_scale=t[2], v_scale=t[3], **kw)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, "bf16")


def test_flash_route_refuses_unaligned_queries():
    q = torch.zeros(1, 2, 2, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="end of the kv"):
        A.flash_route(q, k, k, q_offset=0, kv_len=8)


@pytest.mark.parametrize("kv_len", [300, 250])
def test_chunked_attention_matches_jax(kv_len):
    """The CPU path above 2048 x 2048, at small chunks."""
    rng = np.random.default_rng(kv_len)
    q = _bshd(rng, 1, 100, 4, 32)
    k, v = _bshd(rng, 1, 300, 2, 32), _bshd(rng, 1, 300, 2, 32)
    kw = dict(causal=True, window=64, softcap=30.0, q_offset=kv_len - 100,
              kv_len=kv_len, q_chunk=32, kv_chunk=128)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = A.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_attention_dispatch_matches_jax():
    """attention() on a CPU tensor keeps the reference's dense/chunked rule."""
    rng = np.random.default_rng(3)
    q = _bshd(rng, 1, 24, 4, 32)
    k, v = _bshd(rng, 1, 24, 2, 32), _bshd(rng, 1, 24, 2, 32)
    kw = dict(causal=True, window=8, softcap=0.0, q_offset=0, kv_len=24)
    want = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = A.attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert M.NO_WINDOW == JM.NO_WINDOW


def plan_ranges(plan):
    """The [s0, s1) kv range of each split of ``plan``, as the split kernel
    cuts them (split s starts at kv_begin + s * chunk)."""
    if plan.chunk == 0:
        return [(plan.kv_begin, plan.kv_begin)]
    return [(s, min(s + plan.chunk, plan.kv_end))
            for s in range(plan.kv_begin, plan.kv_end, plan.chunk)]


SPLIT_CASES = ["decode_sq1", "split_long", "split_long_window", "split_gqa4",
               "split_mqa", "split_sq4", "gqa_causal", "masked_rows"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_combine_splits_matches_refs(name):
    """The split-KV route's arithmetic, plainly: per-split (m, l, acc) over the
    planned kv ranges, folded by ``combine_splits``, equal the plain version
    and JAX's reference in float32."""
    (jq, jk, jv), (q, k, v) = _sides(name, "f32")
    kw = flash_kwargs(name)
    c = FLASH_CASES[name]
    plan = split_plan(c["B"], c["Hkv"], c["Sq"], c["Skv"], kw["causal"], kw["window"])
    got = combine_splits(*split_partials_ref(q, k, v, plan_ranges(plan), **kw), c["Hq"], c["Sq"])
    np.testing.assert_allclose(got.numpy(), attention_ref(q, k, v, **kw).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_attention_ref(jq, jk, jv, **kw))
    reached = ~np.isnan(want).any(-1)
    _assert_close(got[torch.as_tensor(reached)], jnp.asarray(want[reached]), "f32", name)
    assert not got[torch.as_tensor(~reached)].any()


@pytest.mark.parametrize("B,Hkv,Sq,Skv,causal,window", [
    (2, 16, 1, 8193, True, 1 << 30), (2, 16, 1, 8193, True, 4096), (1, 1, 1, 5, True, 0),
    (2, 2, 4, 700, True, 256), (1, 8, 2, 100_000, False, 0), (1, 2, 80, 40, True, 0),
    (4, 8, 1, 129, True, 64)])
def test_split_plan_covers_kept_range_once(B, Hkv, Sq, Skv, causal, window):
    """The splits cover the kv range some q row keeps exactly once, in order,
    with no empty split, and give the card at least two blocks per SM where
    the range has the keys for it."""
    plan = split_plan(B, Hkv, Sq, Skv, causal, window)
    qpos = np.arange(Sq) + Skv - Sq
    kept = np.zeros(Skv, dtype=bool)
    for p in qpos:
        lo = max(p - window + 1, 0) if window > 0 else 0
        kept[lo:(min(p, Skv - 1) if causal else Skv - 1) + 1] = True
    ranges = plan_ranges(plan)
    assert len(ranges) == plan.n_splits
    if not kept.any():
        assert ranges == [(plan.kv_begin, plan.kv_begin)]
        return
    assert (ranges[0][0], ranges[-1][1]) == (kept.argmax(), Skv - kept[::-1].argmax())
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s1 > s0 for s0, s1 in ranges)
    n_kv = ranges[-1][1] - ranges[0][0]
    assert (B * Hkv * plan.n_splits >= 2 * 132
            or plan.n_splits == -(-n_kv // SPLIT_MIN_KEYS))
