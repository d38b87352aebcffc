"""Port parity: the moe, hybrid, ssm, encdec and vlm families' serving path
(granite-moe, zamba2, xlstm, whisper, qwen2-vl at ``reduced()``, through
prefill and decode_step) and their blocks (MoE dispatch, Mamba-2, mLSTM,
sLSTM, unmasked flash attention) against the JAX package, on the same
weights and inputs.

The reference's ``init_params(PRNGKey(0))`` weights are carried into the
port with ``convert.model_params_from_jax``; tokens, frames and vision
embeddings are seeded numpy. Model outputs are held to
tests/test_torch_model.py's rtol 0.05 / atol 0.1 (bf16 activations on both
sides) with equal top-1 tokens; every cache leaf too. One decode step runs
on the reference's own prefill cache, carried by
``convert.model_cache_from_jax``, so it is compared on equal inputs. The
blocks run in float32 at float32 tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.models import xlstm as JXL
from repro_torch.configs.base import get_arch
from repro_torch.convert import model_cache_from_jax, model_params_from_jax
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.train.step import make_prefill_step, make_serve_step

RTOL, ATOL = 0.05, 0.1
# the JAX suite's prefill-vs-decode tolerance, for the port against itself
SELF_RTOL, SELF_ATOL = 0.15, 0.35
# float32 blocks: both sides sum the same products in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# a near tie of the router: the k-th and (k + 1)-th expert probabilities this
# close may swap between the sides' bf16 activations (swaps seen at <= 1.3e-3)
ROUTE_TIE = 2e-3
FAMILIES = {"moe": "granite-moe-3b-a800m", "hybrid": "zamba2-1.2b", "ssm": "xlstm-350m",
            "encdec": "whisper-medium", "vlm": "qwen2-vl-2b"}
B = 2
# prompts long enough to cross a chunk (Mamba-2: 128, mLSTM: 64) with a ragged tail
PROMPT = {"hybrid": 160}
S_DEFAULT = 96


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


def _assert_logits(got, want, what, rtol=RTOL, atol=ATOL):
    """Logits within rtol / atol, and the same top-1 token except at a near
    tie: where the reference scores the port's pick within ``atol`` of its
    own best (``kernels/parity.py``'s rule for top-k ids), which bf16 on
    either side can reorder."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else _np(want)
    assert np.isfinite(got).all(), f"{what}: non-finite logits"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    pick = got.argmax(-1)
    swapped = pick != want.argmax(-1)
    short = want.max(-1) - np.take_along_axis(want, pick[..., None], -1)[..., 0]
    assert (short[swapped] <= atol).all(), f"{what}: top-1 tokens differ: {short}"
    assert swapped.sum() <= 1, f"{what}: {swapped.sum()} top-1 tokens differ"


def _batch(cfg, S, seed=0):
    """Seeded numpy inputs: S + 1 tokens (the prompt and the held-out one)
    and the family's modality input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.cross_len, cfg.d_model)
                                              ).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _prompt(batch, S):
    return dict(batch, tokens=batch["tokens"][:, :S])


def _decode_pos(cfg, S):
    return S + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _grow_jax(cache, max_len):
    """The reference's cache with its self-attention k / v grown to
    ``max_len`` slots (tests/test_arch_smoke.py's growth)."""
    return {k: (jnp.zeros(a.shape[:2] + (max_len,) + a.shape[3:], a.dtype)
                .at[:, :, :a.shape[2]].set(a) if k in ("k", "v") else a)
            for k, a in cache.items()}


def _cache_leaves(cache):
    """{path: float32 numpy} of a reference or port cache (dicts and state
    NamedTuples)."""
    return {path: t.float().numpy() if isinstance(t, torch.Tensor) else _np(t)
            for path, t in M._leaves(cache)}


def _routing_flips(jcfg, jparams, cfg, params, batch):
    """The (b, s) prompt positions whose routed experts differ between the
    reference and the port at some MoE layer of the prefill, each checked
    to be a near tie on the port's side (its k-th and (k + 1)-th router
    probabilities within ROUTE_TIE): the two sides' bf16 activations differ
    by about one bf16 step, which can reorder such experts. The reference's
    choices are read by a ``jax.debug.callback`` on its ``_router``."""
    ref, ours, gaps = [], [], []
    j_router, t_router = JMOE._router, MOE._router

    def j_rec(p, x2d, top_k):
        out = j_router(p, x2d, top_k)
        jax.debug.callback(lambda e: ref.append(np.asarray(e)), out[1], ordered=True)
        return out

    def t_rec(p, x2d, top_k):
        out = t_router(p, x2d, top_k)
        probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        ours.append(out[1].numpy())
        gaps.append((top[:, top_k - 1] - top[:, top_k]).numpy())
        return out

    JMOE._router, MOE._router = j_rec, t_rec
    try:
        jax.jit(lambda p, b: JM.prefill(jcfg, p, b))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
        M.prefill(cfg, params, batch)
    finally:
        JMOE._router, MOE._router = j_router, t_router
    assert len(ref) == len(ours) == cfg.n_layers
    S = batch["tokens"].shape[1]
    flipped = np.zeros(len(ref[0]), dtype=bool)
    for e_ref, e_ours, gap in zip(ref, ours, gaps):
        differ = (np.sort(e_ref, -1) != np.sort(e_ours, -1)).any(-1)
        # a token's first flip is a near tie; after it, its input differs
        first = differ & ~flipped
        assert (gap[first] < ROUTE_TIE).all(), gap[first]
        flipped |= differ
    return {(t // S, t % S) for t in np.nonzero(flipped)[0].tolist()}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    """One family's configs, weights on both sides, inputs, and the
    reference's jitted prefill and decode outputs."""
    name = FAMILIES[request.param]
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    S = PROMPT.get(cfg.family, S_DEFAULT)
    batch = _batch(cfg, S)
    pre = _prompt(batch, S)
    jlog, jcache = jax.jit(lambda p, b: JM.prefill(jcfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in pre.items()})
    pos = _decode_pos(cfg, S)
    tok = batch["tokens"][:, S:S + 1]
    jbig = _grow_jax(jcache, pos + 1)
    jdec, jnew = jax.jit(lambda p, c, t: JM.decode_step(jcfg, p, c, t, pos))(
        jparams, jbig, jnp.asarray(tok))
    flips = _routing_flips(jcfg, jparams, cfg, params, pre) if cfg.n_experts else set()
    # a flip is rare: a routing change everywhere would be a fault
    assert len(flips) <= 0.05 * B * S
    return dict(name=name, cfg=cfg, jcfg=jcfg, jparams=jparams, params=params, S=S,
                batch=batch, pos=pos, tok=tok, jlog=jlog, jcache=jcache, jbig=jbig,
                jdec=jdec, jnew=jnew, flips=flips)


def test_params_tree_matches(fam):
    """The port's own init has the reference's tree: keys, shapes, float32."""
    cfg, jparams = fam["cfg"], fam["jparams"]
    ours = M.init_params(cfg, seed=0, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = dict(M._leaves(ours))
    assert set(got) == {tuple(k.key for k in path) for path, _ in flat_ref}
    for path, leaf in flat_ref:
        node = got[tuple(k.key for k in path)]
        assert tuple(node.shape) == leaf.shape, (fam["name"], path)
        assert node.dtype == torch.float32 and leaf.dtype == jnp.float32
    assert M.param_count(ours) == JM.param_count(jparams) == M.param_count(fam["params"])


def test_prefill_matches_jax(fam):
    cfg = fam["cfg"]
    log, cache = M.prefill(cfg, fam["params"], _prompt(fam["batch"], fam["S"]))
    assert log.shape == (B, 1, cfg.vocab_size) and log.dtype == torch.float32
    _assert_logits(log, fam["jlog"], f"{fam['name']} prefill")
    got, want = _cache_leaves(cache), _cache_leaves(fam["jcache"])
    assert set(got) == set(want)
    # positions whose experts the two sides chose differently (near ties)
    # hold other values in the layers after the flip; every other one is held
    keep = np.ones((B, fam["S"]), dtype=bool)
    for b, t in fam["flips"]:
        keep[b, t] = False
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        g = got[path][:, keep] if fam["flips"] else got[path]
        np.testing.assert_allclose(g, w[:, keep] if fam["flips"] else w, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{fam['name']} cache {path}")


def test_decode_matches_jax(fam):
    """One decode step from the reference's own prefill cache: logits, and
    every leaf of the cache it writes."""
    cfg, pos = fam["cfg"], fam["pos"]
    big = M.grow_cache(model_cache_from_jax(jax.tree.map(np.asarray, fam["jcache"]),
                                            device="cpu"), pos + 1)
    dec, new = M.decode_step(cfg, fam["params"], big, fam["tok"], pos)
    _assert_logits(dec, fam["jdec"], f"{fam['name']} decode")
    got, want = _cache_leaves(new), _cache_leaves(fam["jnew"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{fam['name']} decoded cache {path}")


def test_port_decode_vs_prefill(fam):
    """decode_step at the prompt's end matches the prefill logits of S + 1
    tokens (tests/test_arch_smoke.py's check, on the port alone, through the
    serve steps, on the port's own weights and TokenPipeline tokens); the
    grown cache keeps what prefill wrote."""
    cfg, S, pos = fam["cfg"], fam["S"], fam["pos"]
    params = M.init_params(cfg, seed=1, device="cpu")
    batch = dict(_batch(cfg, S, seed=1),
                 tokens=TokenPipeline(cfg.vocab_size, B, S + 1, seed=1).batch_at(0))
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    drops = []  # per MoE layer of the S + 1 prefill: (B, S + 1, K) dropped pairs
    router = MOE._router

    def noted(p, x2d, top_k):
        out = router(p, x2d, top_k)
        drops.append(MOE.dropped(out[1], cfg.n_experts).reshape(B, S + 1, top_k))
        return out

    MOE._router = noted
    try:
        full, _ = prefill_step(params, batch)
    finally:
        MOE._router = router
    _, cache = prefill_step(params, _prompt(batch, S))
    big = M.grow_cache(cache, pos + 1)
    dec, big = serve_step(params, big, batch["tokens"][:, S:S + 1], pos)
    # a decode step (T = B) never drops; where the S + 1 prefill dropped some
    # expert of the last position (capacity: the stable sort drops each
    # expert's latest tokens) the two compute different things, as in the
    # reference: those rows are left out, and at least one row is held
    rows = [b for b in range(B) if not any(bool(d[b, -1].any()) for d in drops)]
    assert rows, "every row's last position dropped an expert"
    _assert_logits(dec[rows], full[rows], f"{fam['name']} decode vs prefill",
                   SELF_RTOL, SELF_ATOL)
    for key in ("k", "v"):
        if key in cache:
            assert torch.equal(big[key][:, :, :cache[key].shape[2]], cache[key])


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "granite-moe-1b-a400m",
                                  "qwen2-7b", "zamba2-1.2b"])
def test_active_param_count_matches_jax(name):
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.init_params(cfg, device="cpu")
    assert M.active_param_count(cfg, params) == JM.active_param_count(jcfg, jparams)
    assert (M.active_param_count(cfg, params) < M.param_count(params)) == bool(cfg.n_experts)


def test_grow_cache_grows_only_self_attention():
    """Recurrent states and whisper's cross k / v keep their size and are
    copied (decode writes the states in place); the self k / v grow."""
    for name in ("zamba2-1.2b", "xlstm-350m", "whisper-medium"):
        cfg = get_arch(name).reduced()
        cache = M.make_cache(cfg, B, 5, device="cpu")
        big = M.grow_cache(cache, 9)
        assert big.keys() == cache.keys()
        for (path, t), (_, g) in zip(M._leaves(cache), M._leaves(big)):
            grows = path[0] in ("k", "v")
            assert g.shape[2] == (9 if grows else t.shape[2]), (name, path)
            assert g.data_ptr() != t.data_ptr()


def test_config_modules_are_the_references():
    import importlib
    for mod in ("codeqwen1p5_7b", "gemma2_27b", "granite_moe_1b_a400m",
                "granite_moe_3b_a800m", "qwen2_7b", "qwen2_vl_2b", "whisper_medium",
                "xlstm_350m", "yi_9b", "zamba2_1p2b"):
        ours = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        ref = importlib.import_module(f"repro.configs.{mod}").CONFIG
        assert vars(ours) == vars(ref)


# ---- blocks --------------------------------------------------------------------


def _moe_params(cfg, seed):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.n_experts,
                       cfg.expert_dff, cfg.moe_top_k)
    return jp, model_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _moe_input(cfg, jp, S, skew, seed):
    """(B, S, D) float32 tokens; ``skew`` adds the direction of expert 0's
    router column, so expert 0 takes more than its capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    u = np.asarray(jp["router"])[:, 0]
    return x + skew * (u / np.linalg.norm(u)).astype(np.float32)


def _reference_drops(jp, x, top_k, capacity_factor=1.25):
    """The (token, expert) pairs the reference's moe_sorted drops, from its
    router and its dispatch rule, in numpy."""
    T = x.shape[0] * x.shape[1]
    _, experts, _ = JMOE._router(jp, jnp.asarray(x.reshape(T, -1)), top_k)
    experts = np.asarray(experts)
    E = jp["router"].shape[1]
    flat_e = experts.reshape(-1)
    flat_t = np.repeat(np.arange(T), top_k)
    order = np.argsort(flat_e, kind="stable")
    e_sorted = flat_e[order]
    pos = np.arange(T * top_k) - np.searchsorted(e_sorted, np.arange(E))[e_sorted]
    cap = int(max(round(capacity_factor * top_k * T / E), min(T, 128), 1))
    drop = pos >= cap
    return set(zip(flat_t[order][drop].tolist(), e_sorted[drop].tolist()))


def test_moe_dense_matches_jax():
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    jp, p = _moe_params(cfg, 2)
    x = _moe_input(cfg, jp, 16, 0.0, 2)
    jy, jaux = JMOE.moe_dense(jp, jnp.asarray(x), cfg.moe_top_k)
    y, aux = MOE.moe_dense(p, torch.as_tensor(x), cfg.moe_top_k)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("skew", [0.0, 6.0], ids=["no_drops", "drops"])
def test_moe_sorted_matches_jax(skew):
    """Without drops and with an overflowing expert 0: the same outputs and
    aux loss as the reference, the same dropped (token, expert) pairs (the
    stable sort drops each expert's latest tokens), and without drops the
    dense oracle's output."""
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    jp, p = _moe_params(cfg, 3)
    S = 160  # T = 320: capacity max(round(1.25 * 2 * 320 / 8), 128) = 128
    x = _moe_input(cfg, jp, S, skew, 3)
    xt = torch.as_tensor(x)
    jy, jaux = JMOE.moe_sorted(jp, jnp.asarray(x), cfg.moe_top_k)
    y, aux = MOE.moe_sorted(p, xt, cfg.moe_top_k)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    _, experts, _ = MOE._router(p, xt.reshape(B * S, -1), cfg.moe_top_k)
    t, k = MOE.dropped(experts, cfg.n_experts).nonzero(as_tuple=True)
    ours = set(zip(t.tolist(), experts[t, k].tolist()))
    want = _reference_drops(jp, x, cfg.moe_top_k)
    assert ours == want
    assert bool(want) == (skew > 0)
    if not want:
        yd, _ = MOE.moe_dense(p, xt, cfg.moe_top_k)
        np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=F32_RTOL, atol=F32_ATOL)
    else:  # a dropped pair contributes nothing: its token's output is short of it
        y_all = MOE.moe_sorted(p, xt, cfg.moe_top_k, capacity_factor=64.0)[0]
        tok = sorted({t for t, _ in want})
        assert not np.allclose(y.reshape(B * S, -1)[tok].numpy(),
                               y_all.reshape(B * S, -1)[tok].numpy())


def test_moe_router_ties_take_the_lower_expert():
    """Equal router probabilities: the lower expert ranks first, as
    jax.lax.top_k orders them."""
    p = {"router": torch.zeros(4, 6)}
    p["router"][:, 3] = 1.0
    x = torch.ones(5, 4)
    _, experts, _ = MOE._router(p, x, 3)
    jp = {"router": jnp.asarray(p["router"].numpy())}
    _, jexperts, _ = JMOE._router(jp, jnp.asarray(x.numpy()), 3)
    assert experts.tolist() == np.asarray(jexperts).tolist() == [[3, 0, 1]] * 5


def _mamba(seed, D=32, state=8, expand=2, hd=16):
    jp = JSSM.init_mamba2(jax.random.PRNGKey(seed), D, state, expand, hd, 4)
    return jp, model_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _ssm_cache(rng, Bn, H, P, N, conv_dim):
    return (rng.standard_normal((Bn, H, P, N)).astype(np.float32) * 0.5,
            rng.standard_normal((Bn, 3, conv_dim)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("S,with_cache", [(40, False), (40, True), (1, True)])
def test_mamba2_matches_jax(S, with_cache):
    """The chunked scan (S = 40 at chunk 16: a ragged last chunk), from zeros
    and from a carried state, and the S = 1 recurrence: outputs and states."""
    D, state, hd = 32, 8, 16
    jp, p = _mamba(5)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    h, conv = _ssm_cache(rng, B, 2 * D // hd, hd, state, 2 * D + 2 * state)
    jc = JSSM.SSMCache(jnp.asarray(h), jnp.asarray(conv)) if with_cache else None
    c = SSM.SSMCache(torch.as_tensor(h), torch.as_tensor(conv)) if with_cache else None
    jy, jnew = JSSM.mamba2_forward(jp, jnp.asarray(x), state, 2, hd, cache=jc, chunk=16)
    y, new = SSM.mamba2_forward(p, torch.as_tensor(x), state, 2, hd, cache=c, chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    for got, want in zip(new, jnew):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                   atol=F32_ATOL)


def test_mamba2_chunked_equals_own_recurrence():
    """tests/test_arch_smoke.py's check on the port: the chunked scan equals
    feeding one token at a time (its tolerance)."""
    D, state, hd = 32, 8, 16
    _, p = _mamba(3)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1, 12, D))
                        .astype(np.float32))
    y_par, c_par = SSM.mamba2_forward(p, x, state, 2, hd, chunk=4)
    cache = SSM.SSMCache(torch.zeros(1, 2 * D // hd, hd, state),
                         torch.zeros(1, 3, 2 * D + 2 * state))
    ys = []
    for t in range(12):
        y, cache = SSM.mamba2_forward(p, x[:, t:t + 1], state, 2, hd, cache=cache)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), rtol=2e-2,
                               atol=2e-3)
    np.testing.assert_allclose(c_par.h.numpy(), cache.h.numpy(), rtol=2e-2, atol=2e-3)


def _carried(tree):
    return model_params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("S,with_cache", [(20, False), (20, True), (1, True), (1, False)])
def test_mlstm_matches_jax(S, with_cache):
    """Chunked (S = 20 at chunk 8: a ragged last chunk) and stepped, from the
    empty state and from a carried one: outputs and (C, n, m)."""
    D, H = 32, 4
    jp = JXL.init_mlstm(jax.random.PRNGKey(4), D, H)
    p = _carried(jp)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    P = 2 * D // H
    st = (rng.standard_normal((B, H, P, P)).astype(np.float32),
          np.abs(rng.standard_normal((B, H, P))).astype(np.float32),
          rng.standard_normal((B, H)).astype(np.float32))
    jc = JXL.MLSTMCache(*map(jnp.asarray, st)) if with_cache else None
    c = XL.MLSTMCache(*map(torch.as_tensor, st)) if with_cache else None
    jy, jnew = JXL.mlstm_forward(jp, jnp.asarray(x), H, cache=jc, chunk=8)
    y, new = XL.mlstm_forward(p, torch.as_tensor(x), H, cache=c, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    for got, want in zip(new, jnew):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                   atol=F32_ATOL)


def test_mlstm_chunked_equals_own_recurrence():
    """tests/test_arch_smoke.py's check on the port (its tolerance)."""
    D, H = 32, 4
    p = _carried(JXL.init_mlstm(jax.random.PRNGKey(4), D, H))
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((1, 12, D))
                        .astype(np.float32))
    y_par, _ = XL.mlstm_forward(p, x, H, chunk=4)
    cache, ys = None, []
    for t in range(12):
        y, cache = XL.mlstm_forward(p, x[:, t:t + 1], H, cache=cache)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), rtol=3e-2,
                               atol=3e-3)


@pytest.mark.parametrize("S,with_cache", [(12, False), (12, True), (1, True)])
def test_slstm_matches_jax(S, with_cache):
    D = 32
    jp = JXL.init_slstm(jax.random.PRNGKey(6), D)
    p = _carried(jp)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = tuple(rng.standard_normal((B, D)).astype(np.float32) for _ in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    jc = JXL.SLSTMCache(*map(jnp.asarray, st)) if with_cache else None
    c = XL.SLSTMCache(*map(torch.as_tensor, st)) if with_cache else None
    jy, jnew = JXL.slstm_forward(jp, jnp.asarray(x), cache=jc)
    y, new = XL.slstm_forward(p, torch.as_tensor(x), cache=c)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_RTOL, atol=F32_ATOL)
    for got, want in zip(new, jnew):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("Sq,Skv,kv_len", [(7, 50, 50), (1, 50, 50), (30, 30, 30),
                                           (5, 64, 40)])
def test_flash_route_unmasked_matches_jax_dense(Sq, Skv, kv_len):
    """Cross and encoder attention (not causal, no window) at q_offset 0, Sq <=
    kv_len, through the card's route (its plain version here), against the
    reference's dense attention: q's position changes nothing without a
    positional mask, so the kernel's end alignment gives the same result."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((B, Sq, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, 2, 32)).astype(np.float32) for _ in "kv")
    kw = dict(causal=False, window=M.NO_WINDOW, softcap=0.0, q_offset=0, kv_len=kv_len)
    want = JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = A.flash_route(*map(torch.as_tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_flash_route_still_refuses_masked_unaligned_queries():
    q = torch.zeros(1, 2, 2, 32)
    k = torch.zeros(1, 8, 2, 32)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="end of the kv"):
            A.flash_route(q, k, k, q_offset=0, kv_len=8, **kw)
