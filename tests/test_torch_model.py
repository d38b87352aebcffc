"""Port parity: the dense-family serving path of the model substrate
(embed -> N x (attention + gated MLP) -> logits, through prefill and
decode_step) against the JAX package, on the same weights and tokens.

The reference's ``init_params(PRNGKey(0))`` weights are carried into the
port with ``convert.model_params_from_jax``; tokens are seeded numpy. Both
sides run bf16 activations, so each bf16 rounding of one side can land one
bf16 step away from the other's: logits are held to rtol = 0.05,
atol = 0.1 (tighter than the JAX suite's own prefill-vs-decode tolerance,
rtol 0.15 / atol 0.35, tests/test_arch_smoke.py) and the top-1 token must
be equal at every position compared. On the CPU, attention runs the dense
path; the card's route (the flash kernel's wrapper, whose plain version
runs here) is held against the reference's dense attention separately.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import list_archs as jax_list_archs
from repro.models import model as JM
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.convert import model_params_from_jax
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import model as M
from repro_torch.train.step import cast_tree, make_prefill_step, make_serve_step

RTOL, ATOL = 0.05, 0.1
# the JAX suite's prefill-vs-decode tolerance, for the port against itself
SELF_RTOL, SELF_ATOL = 0.15, 0.35
DENSE = ["gemma2-27b", "qwen2-7b", "yi-9b"]
B, S = 2, 96  # S > the reduced gemma2's 64-token window: local layers mask



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this module off
    the cores that the suite's other workers run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, seed=0, n=S + 1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _grow_jax(cache, max_len):
    """The reference's cache grown to ``max_len`` slots, as
    tests/test_arch_smoke.py grows it."""
    return {k: jnp.zeros(a.shape[:2] + (max_len,) + a.shape[3:], a.dtype)
            .at[:, :, :a.shape[2]].set(a) for k, a in cache.items()}


def _assert_logits(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else _np(want)
    assert np.isfinite(got).all(), f"{what}: non-finite logits"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{what}: top-1 tokens differ")


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(name, port cfg, jax cfg, jax params, port params)."""
    name = request.param
    jcfg = jax_get_arch(name).reduced()
    cfg = get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return name, cfg, jcfg, jparams, params


def test_configs_are_the_references():
    assert list_archs() == jax_list_archs()
    for name in list_archs():
        assert vars(get_arch(name)) == vars(jax_get_arch(name))
        assert vars(get_arch(name).reduced()) == vars(jax_get_arch(name).reduced())


def test_params_tree_matches(pair):
    name, cfg, jcfg, jparams, params = pair
    ours = M.init_params(cfg, seed=0, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_ref:
        node = ours
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, (name, path)
        assert node.dtype == torch.float32
    assert M.param_count(ours) == JM.param_count(jparams) == M.param_count(params)


def test_prefill_and_decode_match_jax(pair):
    name, cfg, jcfg, jparams, params = pair
    toks = _tokens(cfg)
    jlog, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])})
    log, cache = M.prefill(cfg, params, {"tokens": toks[:, :S]})
    _assert_logits(log, jlog, f"{name} prefill")
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].float().numpy(), _np(jcache[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{name} cache {key}")

    jbig = _grow_jax(jcache, S + 1)
    big = M.grow_cache(cache, S + 1)
    tok = toks[:, S:S + 1]
    jdec, jnew = JM.decode_step(jcfg, jparams, jbig, jnp.asarray(tok), S)
    dec, new = M.decode_step(cfg, params, big, tok, S)
    _assert_logits(dec, jdec, f"{name} decode")
    for key in ("k", "v"):
        np.testing.assert_allclose(new[key][:, :, S].float().numpy(),
                                   _np(jnew[key][:, :, S]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} decoded cache {key}")


@pytest.mark.parametrize("name", DENSE)
def test_port_prefill_decode_parity(name):
    """decode_step at position S matches the prefill logits of S + 1 tokens
    (tests/test_arch_smoke.py's check, on the port alone, through the serve
    steps), and the cache grown for decode leaves the prefilled slots as
    they were."""
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, seed=1, device="cpu")
    toks = TokenPipeline(cfg.vocab_size, B, S + 1, seed=1).batch_at(0)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    full, _ = prefill_step(params, {"tokens": toks})
    _, cache = prefill_step(params, {"tokens": toks[:, :S]})
    big = M.grow_cache(cache, S + 1)
    dec, big = serve_step(params, big, toks[:, S:S + 1], S)
    assert dec.shape == (B, 1, cfg.vocab_size) and dec.dtype == torch.float32
    _assert_logits(dec, full, f"{name} decode vs prefill", SELF_RTOL, SELF_ATOL)
    assert torch.equal(big["k"][:, :, :S], cache["k"])


def test_int8_kv_decode_parity():
    """tests/test_kv_quant.py on the port: the int8 cache tracks the bf16
    cache, is about half its bytes, and decodes as the reference does."""
    name = "yi-9b"
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = _tokens(cfg, seed=5)
    tok = toks[:, S:S + 1]
    _, cache16 = M.prefill(cfg, params, {"tokens": toks[:, :S]})
    big16 = M.grow_cache(cache16, S + 1)
    big8 = M.make_cache(cfg, B, S + 1, kv_dtype="int8", device="cpu")
    for src, (val, scale) in (("k", ("k", "k_scale")), ("v", ("v", "v_scale"))):
        qv, sc = M._quantize_kv(cache16[src])
        big8[val][:, :, :S] = qv
        big8[scale][:, :, :S] = sc
    jbig8 = {k: jnp.asarray(v.numpy()) for k, v in big8.items()}
    logit16, _ = M.decode_step(cfg, params, big16, tok, S)
    logit8, new8 = M.decode_step(cfg, params, big8, tok, S)
    assert new8["k"].dtype == torch.int8
    a, b = logit16.numpy(), logit8.numpy()
    assert np.median(np.abs(a - b)) < 0.15
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5
    b16 = sum(t.numel() * t.element_size() for t in big16.values())
    b8 = sum(t.numel() * t.element_size() for t in big8.values())
    assert b8 < 0.66 * b16
    jlogit8, jnew8 = JM.decode_step(jcfg, jparams, jbig8, jnp.asarray(tok), S)
    _assert_logits(logit8, jlogit8, "int8 decode")
    # the new slot, dequantized: one bf16 step of k apart moves an int8 code
    # by a step or two, so the codes are compared through their values
    for val, scale in (("k", "k_scale"), ("v", "v_scale")):
        got = new8[val][:, :, S].float() * new8[scale][:, :, S, ..., None]
        want = np.asarray(jnew8[val][:, :, S], np.float32) * \
            np.asarray(jnew8[scale][:, :, S])[..., None]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 8)).astype(np.float32) * 7
    q, s = M._quantize_kv(torch.as_tensor(x))
    jq, js = JM._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_grow_cache_matches_the_references_growth(kv_dtype):
    """grow_cache keeps each entry's dtype and slots (int8 values and their
    scales too) and zero-fills the new slots, as tests/test_arch_smoke.py
    grows the reference's cache; it refuses to shrink a cache."""
    cfg = get_arch("qwen2-7b").reduced()
    cache = M.make_cache(cfg, B, 5, kv_dtype=kv_dtype, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for key, t in cache.items():
        fill = torch.randint(-127, 128, t.shape, generator=gen) if t.dtype == torch.int8 \
            else torch.randn(t.shape, generator=gen)
        t.copy_(fill.to(t.dtype))
    big = M.grow_cache(cache, 9)
    want = _grow_jax({k: jnp.asarray(t.float().numpy()) for k, t in cache.items()}, 9)
    assert big.keys() == cache.keys()
    for key, t in big.items():
        assert t.dtype == cache[key].dtype and t.shape[2] == 9
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(want[key]))
    with pytest.raises(ValueError, match="cannot grow"):
        M.grow_cache(cache, 4)


def test_cache_write_past_the_end_raises():
    """The reference clamps such a write (dynamic_update_slice); the port
    refuses it."""
    cfg = get_arch("qwen2-7b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    cache = M.make_cache(cfg, B, 4, device="cpu")
    with pytest.raises(ValueError, match="runs past"):
        M.decode_step(cfg, params, cache, np.zeros((B, 1), np.int32), 4)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium", "qwen2-vl-2b"])
def test_unported_families_raise(name):
    cfg = get_arch(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.make_cache(cfg, 1, 8, device="cpu")


def test_token_pipeline_is_the_references():
    from repro.data.tokens import TokenPipeline as JaxTokenPipeline
    for step in (0, 3):
        np.testing.assert_array_equal(TokenPipeline(512, 4, 64, seed=9).batch_at(step),
                                      JaxTokenPipeline(512, 4, 64, seed=9).batch_at(step))


def test_cast_tree_keeps_a_bf16_tree():
    params = M.init_params(get_arch("yi-9b").reduced(), device="cpu",
                           dtype=torch.bfloat16)
    cast = cast_tree(params, torch.bfloat16)
    assert cast["embed"] is params["embed"]
    assert cast["layers"]["mlp"]["w_up"] is params["layers"]["mlp"]["w_up"]
    assert cast_tree(M.init_params(get_arch("yi-9b").reduced(), device="cpu"),
                     torch.bfloat16)["embed"].dtype == torch.bfloat16
