"""Serving of the port on single-controller debug meshes of the CPU,
``make_debug_mesh(4, 2)`` and ``(2, 4)``: ``models.model.prefill`` and
``decode_step`` under ``use_mesh`` with parameters placed by
``param_shardings`` and caches placed by ``cache_shardings`` (the sequence
over ``model``: flash-decoding per sequence shard, ``distributed.kv_cache``).

- Every family's ``reduced()`` config (dense qwen2-7b and gemma2-27b, moe,
  vlm, hybrid, ssm, encdec), tp mode on both meshes, and fsdp mode on
  (2, 4) for a dense arch, and with sequence parallelism for three
  families: a prefill, a grow, then 3 decode steps equal one
  device's run of the port, with float32 activations (each ``ACT_DTYPE``
  set, as tests/test_torch_tp_train.py does, so the caches are float32
  too): logits to 1e-5 (relative and absolute); the gathered k / v leaves
  to 1e-6 relative L2 (int8 leaves bit-equal) and the recurrent states
  (Mamba-2, xLSTM) to 1e-5, since a recurrence compounds its inputs'
  float32 rounding over the prompt (measured: at most 6.6e-7 for k / v,
  1.24e-6 for a state).
- The placed caches' specs equal the reference's ``cache_shardings`` leaf
  by leaf (its ``AbstractMesh`` in one process, as
  tests/test_torch_sharding.py does).
- A long-context (``shard_seq``) batch-1 decode and an int8-cache decode
  equal one device's; a sequence slice without a valid key launches no
  attention and gives no NaN.
- A decode step's ``Mesh.log`` equals its closed form.
- Against the reference: every family's mesh prefill and 3 decode steps on
  carried reference weights, and a ``shard_seq`` batch-1 decode on a
  carried reference cache, equal the reference's ``prefill`` /
  ``decode_step`` on the same tokens with float32 activations on both
  sides: logits to 1e-5; the gathered k / v to 2e-6 and the states to 1e-5
  relative L2, since the two sides' products sum in other orders (measured:
  at most 8e-6 absolute for logits, 9.6e-7 for k / v, 1.8e-6 for a state).
- A prefill's all-to-all lands each sequence slice on the rank that owns
  it, on a mesh whose ranks are distinct devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_arch as jax_get_arch
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import model_cache_from_jax, model_params_from_jax
from repro_torch.distributed import kv_cache as KV
from repro_torch.distributed import sharding as S
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (cache_shardings, gather_tree, param_shardings,
                                              shard_tree, tree_map, use_mesh)
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import model as M
from repro_torch.train.step import make_prefill_step, make_serve_step

MESHES = [(4, 2), (2, 4)]
FAMILY_ARCHS = ["qwen2-7b", "gemma2-27b", "granite-moe-1b-a400m", "qwen2-vl-2b",
                "zamba2-1.2b", "xlstm-350m", "whisper-medium"]
B, S_PROMPT, STEPS = 4, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(M, "ACT_DTYPE", torch.float32)


@pytest.fixture
def f32_both(monkeypatch, f32):
    """float32 activations and caches on both sides: the reference's
    ``make_cache`` took its dtype default (bf16) when it was defined."""
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(JM.make_cache, "__defaults__", (jnp.float32, False, None))


def batch_for(cfg, b=B, s=S_PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.cross_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) /
                 max(float(torch.linalg.vector_norm(want)), 1e-30))


def assert_caches_equal(full, want):
    got = dict(M._leaves(gather_tree(full)))
    for path, w in M._leaves(want):
        assert got[path].shape == w.shape, path
        if w.dtype == torch.int8:
            assert torch.equal(got[path], w), path
        else:
            bound = 1e-6 if path[-1] in M.GROWN + ("ck", "cv") else 1e-5
            assert rel_l2(got[path], w) <= bound, path


def serve_both(cfg, mesh, mode="tp", steps=STEPS, b=B):
    """(one device's, the mesh's) logits of a prefill + ``steps`` decodes,
    and their final caches (the mesh's placed)."""
    params = M.init_params(cfg, 0, device="cpu")
    placed = shard_tree(params, param_shardings(params, mesh, mode))
    batch = batch_for(cfg, b=b)
    n0 = S_PROMPT + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    want, c1 = M.prefill(cfg, params, batch)
    with use_mesh(mesh):
        got, c2 = M.prefill(cfg, placed, batch)
    logits = [(want, got)]
    c1, c2 = M.grow_cache(c1, n0 + 4), M.grow_cache(c2, n0 + 4)
    rng = np.random.default_rng(1)
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (b, 1))
        want, c1 = M.decode_step(cfg, params, c1, tok, n0 + i)
        with use_mesh(mesh):
            got, c2 = M.decode_step(cfg, placed, c2, tok, n0 + i)
        logits.append((want, got))
    return logits, c1, c2


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_prefill_and_decode_equal_one_device(name, shape, f32):
    cfg = get_arch(name).reduced()
    mesh = make_debug_mesh(*shape, device="cpu")
    logits, c1, c2 = serve_both(cfg, mesh)
    for want, got in logits:
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert_caches_equal(c2, c1)


def test_fsdp_prefill_and_decode_equal_one_device(f32):
    cfg = get_arch("qwen2-7b").reduced()
    logits, c1, c2 = serve_both(cfg, make_debug_mesh(2, 4, device="cpu"), mode="fsdp")
    for want, got in logits:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert_caches_equal(c2, c1)


@pytest.mark.parametrize("name", ["qwen2-7b", "zamba2-1.2b", "qwen2-vl-2b"])
def test_sequence_parallel_prefill_and_decode_equal_one_device(name, f32):
    """With sequence parallelism on, the prefill's residual stream goes in
    sequence blocks (reduce-scatter / all-gather pairs); the results are
    one device's as above."""
    cfg = get_arch(name).reduced()
    S.set_sequence_parallel(True)
    try:
        logits, c1, c2 = serve_both(cfg, make_debug_mesh(2, 4, device="cpu"))
    finally:
        S.set_sequence_parallel(False)
    for want, got in logits:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert_caches_equal(c2, c1)


def test_serve_steps_on_a_mesh_equal_one_device():
    """``make_prefill_step`` / ``make_serve_step`` (bf16 params, bf16 caches)
    work on a mesh unchanged: the logits within bf16's rounding of one
    device's, the greedy tokens equal."""
    cfg = get_arch("yi-9b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    mesh = make_debug_mesh(2, 4, device="cpu")
    placed = shard_tree(params, param_shardings(params, mesh))
    batch = batch_for(cfg)
    want, c1 = make_prefill_step(cfg)(params, batch)
    with use_mesh(mesh):
        got, c2 = make_prefill_step(cfg)(placed, batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05, rtol=0.02)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    c1, c2 = M.grow_cache(c1, S_PROMPT + 1), M.grow_cache(c2, S_PROMPT + 1)
    tok = want.argmax(-1)
    want, _ = make_serve_step(cfg)(params, c1, tok, S_PROMPT)
    with use_mesh(mesh):
        got, _ = make_serve_step(cfg)(placed, c2, tok, S_PROMPT)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05, rtol=0.02)


def _jax_specs(tree):
    return [(JS._path_str(p), tuple(s.spec)) for p, s in
            jax.tree_util.tree_leaves_with_path(tree)]


def _port_specs(tree):
    return [(S._path_str(p), tuple(b.spec)) for p, b in S.leaves_with_path(tree)]


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", ["qwen2-7b", "zamba2-1.2b", "xlstm-350m", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_placed_cache_specs_equal_reference(name, shape):
    """The specs of a mesh prefill's cache and of its grown cache equal the
    reference's ``cache_shardings`` of the same cache specs."""
    cfg, jcfg = get_arch(name).reduced(), jax_get_arch(name).reduced()
    jmesh = AbstractMesh(shape, ("data", "model"))
    mesh = make_debug_mesh(*shape, device="cpu")
    params = M.init_params(cfg, 0, device="cpu")
    n0 = S_PROMPT + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    with use_mesh(mesh):
        _, cache = M.prefill(cfg, shard_tree(params, param_shardings(params, mesh)),
                             batch_for(cfg))
    jc = JM.cache_specs(jcfg, B, n0)
    assert _port_specs(cache) == _jax_specs(JS.cache_shardings(jc, jmesh))
    grown = M.grow_cache(cache, n0 + 8)
    assert _port_specs(grown) == _jax_specs(
        JS.cache_shardings(JM.cache_specs(jcfg, B, n0 + 8), jmesh))


def rand_cache(cfg, b, length, kv_dtype=None, seed=1):
    """A one-device cache of random entries (int8 values, small scales)."""
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8)
        scale = 0.05 if kv_dtype == "int8" and t.ndim == 4 else 1.0
        return (torch.randn(t.shape, generator=g) * scale).to(t.dtype)
    return tree_map(fill, M.make_cache(cfg, b, length, kv_dtype=kv_dtype, device="cpu"))


def decode_both(cfg, mesh, cache, pos, shard_seq=False, b=B):
    params = M.init_params(cfg, 0, device="cpu")
    placed = shard_tree(params, param_shardings(params, mesh))
    c2 = shard_tree(tree_map(lambda t: t.clone(), cache),
                    cache_shardings(cache, mesh, shard_seq=shard_seq))
    tok = (np.arange(b)[:, None] * 7) % cfg.vocab_size
    want, c1 = M.decode_step(cfg, params, cache, tok, pos)
    mesh.log.clear()
    with use_mesh(mesh):
        got, c2 = M.decode_step(cfg, placed, c2, tok, pos)
    return want, got, c1, c2


@pytest.mark.parametrize("name,pos", [("qwen2-7b", 3), ("qwen2-7b", 40), ("qwen2-7b", 63),
                                      ("zamba2-1.2b", 50), ("gemma2-27b", 37)])
def test_shard_seq_batch_one_decode_equals_one_device(name, pos, f32):
    """The long-context layout (``shard_seq``: the sequence over all eight
    ranks, batch 1 computed once) at a slot in the first, a middle and the
    last slice."""
    cfg = get_arch(name).reduced()
    mesh = make_debug_mesh(2, 4, device="cpu")
    want, got, c1, c2 = decode_both(cfg, mesh, rand_cache(cfg, 1, 64), pos, shard_seq=True, b=1)
    assert tuple(c2["k"].spec)[2] == ("data", "model")
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert_caches_equal(c2, c1)


@pytest.mark.parametrize("b,shard_seq", [(4, False), (1, True)])
def test_int8_cache_decode_equals_one_device(b, shard_seq, f32):
    """An int8 cache: values and scales written by the slot's owner (the
    scales are replicated under ``shard_seq``, as the reference places
    them), attention over the dequantized slices."""
    cfg = get_arch("qwen2-7b").reduced()
    mesh = make_debug_mesh(2, 4, device="cpu")
    want, got, c1, c2 = decode_both(cfg, mesh, rand_cache(cfg, b, 64, "int8"), 33,
                                    shard_seq=shard_seq, b=b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert_caches_equal(c2, c1)


def test_a_slice_without_a_valid_key_launches_nothing(monkeypatch, f32):
    """At slot 3 of 64 over eight slices of 8 only the first slice holds
    valid keys: one flash call a layer, lse -inf elsewhere, no NaN."""
    calls = []
    real = KV.flash_attention_lse

    def counted(q, k, v, **kw):
        calls.append(k.shape[2])
        return real(q, k, v, **kw)
    monkeypatch.setattr(KV, "flash_attention_lse", counted)
    cfg = get_arch("qwen2-7b").reduced()
    mesh = make_debug_mesh(2, 4, device="cpu")
    _, got, _, _ = decode_both(cfg, mesh, rand_cache(cfg, 1, 64), 3, shard_seq=True, b=1)
    assert calls == [4] * cfg.n_layers  # slots 0..3 of the first slice
    assert torch.isfinite(got).all()
    outs = [torch.zeros(1, 2, 1, 8)] * 3 + [torch.ones(1, 2, 1, 8)]
    lses = [torch.full((1, 2, 1), float("-inf"))] * 3 + [torch.zeros(1, 2, 1)]
    out = KV.combine(mesh, "model", outs, lses, torch.device("cpu"), False)
    assert torch.equal(out, torch.ones(1, 2, 1, 8))


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
def test_decode_collectives_equal_closed_form(shape, f32):
    """gemma2-27b ``reduced()`` (2 kv heads, a dense MLP) at batch 4, cache
    64 with its sequence over ``model``. Per step: the embedding's
    all-to-all into vocab rows and the lookup's psum; per layer the new
    token's k / v all-gathered by head (kv heads that do not split over the
    model ranks also gather ``wk`` / ``wv`` first), q all-gathered by head,
    the combine's pmax and two psums, ``wo``'s and the MLP's psums; the
    logits all-gathered over ``model`` and then over the data ranks."""
    cfg = get_arch("gemma2-27b").reduced()
    n_data, n = shape
    mesh = make_debug_mesh(*shape, device="cpu")
    decode_both(cfg, mesh, rand_cache(cfg, B, 64), 40)
    D, V, Hq, Hkv, hd, L = (cfg.d_model, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            cfg.n_layers)
    b, f = B // n_data, 4
    gather = [-(-V // n) * n * -(-D // n) * f]
    reduce = [b * D * f]
    for _ in range(L):
        if Hkv % n:
            gather += [D * Hkv * hd * f] * 2
        gather += [b * Hkv * hd * f] * 2 + [b * Hq * hd * f]
        reduce += [b * Hq * f, b * Hq * f, b * Hq * hd * f, b * D * f, b * D * f]
    gather += [b * V * f, B * V * f]
    want = {"all-to-all": (1, gather[0]), "all-reduce": (len(reduce), sum(reduce)),
            "all-gather": (len(gather) - 1, sum(gather[1:]))}
    assert mesh.log == want


def _grow_jax(cache, max_len):
    """The reference's cache with its self-attention k / v grown to
    ``max_len`` slots."""
    return {k: (jnp.zeros(a.shape[:2] + (max_len,) + a.shape[3:], a.dtype)
                .at[:, :, :a.shape[2]].set(a) if k in ("k", "v") else a)
            for k, a in cache.items()}


def _carried(name):
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                                     device="cpu")


def assert_caches_match_reference(placed, jcache):
    got = dict(M._leaves(gather_tree(placed)))
    for path, w in M._leaves(jcache):
        bound = 2e-6 if path[-1] in M.GROWN + ("ck", "cv") else 1e-5
        assert rel_l2(got[path], torch.from_numpy(np.array(w, np.float32))) <= bound, path


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_mesh_serving_equals_the_reference_in_float32(name, f32_both):
    """Carried reference weights on (2, 4): the mesh's prefill and 3
    decode steps against the reference's single-device ``prefill`` /
    ``decode_step`` on the same tokens, and the caches after them."""
    jcfg, cfg, jparams, params = _carried(name)
    mesh = make_debug_mesh(2, 4, device="cpu")
    placed = shard_tree(params, param_shardings(params, mesh))
    batch = batch_for(cfg)
    want, jc = JM.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with use_mesh(mesh):
        got, c = M.prefill(cfg, placed, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    n0 = S_PROMPT + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    jc, c = _grow_jax(jc, n0 + 4), M.grow_cache(c, n0 + 4)
    rng = np.random.default_rng(1)
    for i in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, 1))
        want, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tok), n0 + i)
        with use_mesh(mesh):
            got, c = M.decode_step(cfg, placed, c, tok, n0 + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"decode {i}")
    assert_caches_match_reference(c, jc)


@pytest.mark.parametrize("name,pos", [("qwen2-7b", 40), ("gemma2-27b", 37),
                                      ("zamba2-1.2b", 50)])
def test_shard_seq_decode_equals_the_reference_in_float32(name, pos, f32_both):
    """A reference cache of 64 seeded random slots, carried and placed with
    ``shard_seq`` (the sequence over all eight ranks), and one batch-1
    decode at a slot in a middle slice, against the reference's."""
    jcfg, cfg, jparams, params = _carried(name)
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                          JM.make_cache(jcfg, 1, 64))
    mesh = make_debug_mesh(2, 4, device="cpu")
    placed = shard_tree(params, param_shardings(params, mesh))
    cache = model_cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    c = shard_tree(cache, cache_shardings(cache, mesh, shard_seq=True))
    tok = np.array([[7]])
    want, jnew = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok), pos)
    with use_mesh(mesh):
        got, c = M.decode_step(cfg, placed, c, tok, pos)
    assert tuple(c["k"].spec)[2] == ("data", "model")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_caches_match_reference(c, jnew)


@pytest.mark.parametrize("shard_seq,d", [(False, 0), (False, 1), (True, 0)])
def test_prefill_all_to_all_lands_on_the_slice_owners(shard_seq, d, monkeypatch):
    """On a (2, 4) mesh of eight distinct (meta) devices, a prefill's write
    into a sequence-split cache layer sends each slice of data rank d's
    rows to the rank that holds that slice's block: its own data row's
    model ranks when the sequence is split over ``model``, grid row j's for
    run j when it spreads over every axis (``shard_seq``)."""
    devs = [torch.device("meta", i) for i in range(8)]
    grid = np.empty(8, dtype=object)
    grid[:] = devs
    mesh = Mesh(("data", "model"), grid.reshape(2, 4))
    cfg = get_arch("qwen2-7b").reduced()
    b, L = 1 if shard_seq else B, 64
    specs = M.cache_specs(cfg, b, L)
    cache = tree_map(lambda t, sh: S.placed_zeros(sh, t.shape, t.dtype), specs,
                     cache_shardings(specs, mesh, shard_seq=shard_seq))
    ctx = TP.ShardCtx(mesh, split_data=not shard_seq)
    kv = KV.layers(cache)[0]
    b_d = b // ctx.n_dp
    ks = [torch.empty(b_d, L, cfg.n_kv_heads, cfg.hd, device=devs[d * 4 + m]) for m in range(4)]
    sent = []
    real = KV.C.all_to_all

    def logged(per_rank, mesh_, axis, split_dim, concat_dim, devices, **kw):
        sent.append(list(devices))
        return real(per_rank, mesh_, axis, split_dim, concat_dim, devices, **kw)
    monkeypatch.setattr(KV.C, "all_to_all", logged)
    KV.write(ctx, kv, d, ks, list(ks), 0, (cfg.n_heads, cfg.n_kv_heads), None)
    rows = [0, 1] if shard_seq else [d]
    want = [[mesh.devices[r, m] for m in range(4)] for r in rows for _ in ("k", "v")]
    assert sent == want
