"""Attention's q heads split unevenly over the mesh's ``model`` axis (tp
mode), as the reference's GSPMD layout computes them: each model rank owns
``tensor_parallel.head_range``'s contiguous ceil(Hq / n) q heads, ranks past
the last own none, and a rank's heads may straddle kv groups
(``kv_heads_for``, ``q_runs``, ``attn_calls``); ``wq`` / ``bq`` columns and
``wo`` rows outside a rank's own block move as weights or as products
(``col_product``, ``take``, ``row_product``). Single-controller debug meshes
of the CPU.

Configs (``reduced()``, parameters carried from the reference by
``convert.model_params_from_jax``):

- qwen2-7b, granite-moe-3b-a800m, qwen2-vl-2b, zamba2-1.2b (its shared
  attention) and whisper-medium (self and cross attention), 4 q heads, on
  (1, 8) and (2, 8): ranks 4-7 own no head;
- qwen2-7b with 6 q / 2 kv heads on (1, 4) and (2, 4): rank 1's heads 2-3
  straddle the kv groups of 3, rank 3 owns none;
- qwen2-7b with 7 q / 1 kv heads on (1, 4): the last rank owns one head.

In float32 (``ACT_DTYPE`` on both sides), against one device of the port
and against the reference on one JAX device: the training loss to 1e-5
relative and every gradient to 1e-4 relative L2 (with remat and sequence
parallelism too), a prefill and 3 decode steps' logits to 1e-5, the caches'
k / v to 1e-6 relative L2 (2e-6 against the reference, as
tests/test_torch_sharded_serve.py holds them) and recurrent states to 1e-5;
a ``shard_seq`` decode; repeats bit-equal. No tensor a collective delivers
is a whole ``wq`` / ``bq`` / ``wo``; a rank without heads launches no
attention; one attention block's ``Mesh.log`` equals its closed form.

The reference itself computes this layout: the 6 q / 2 kv config's
``train_loss`` and ``prefill`` under its ``use_mesh`` on a JAX mesh of 4
model ranks (a subprocess with forced host devices, Auto axes as
tests/test_torch_distributed.py uses) equal its single-device results and
the port's mesh results.

``moe_impl="dense"`` (the MoE's oracle) on the mesh: granite-moe-1b-a400m
``reduced()`` training and prefill on (2, 4) against one device's dense
oracle and the reference's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import model_cache_from_jax, model_params_from_jax
from repro_torch.distributed import collectives as C
from repro_torch.distributed import kv_cache as KV
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (cache_shardings, gather_tree, param_shardings,
                                              set_sequence_parallel, shard_tree, tree_map,
                                              use_mesh)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import full_grads, loss_and_grads, sharded_loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-7b", "granite-moe-3b-a800m", "qwen2-vl-2b", "zamba2-1.2b", "whisper-medium"]
HEADS = {"qwen2-7b-6q2kv": ("qwen2-7b", 6, 2), "qwen2-7b-7q1kv": ("qwen2-7b", 7, 1),
         "qwen2-7b-8q2kv": ("qwen2-7b", 8, 2)}
CASES = ([(a, s) for a in ARCHS for s in [(1, 8), (2, 8)]] +
         [("qwen2-7b-6q2kv", (1, 4)), ("qwen2-7b-6q2kv", (2, 4)), ("qwen2-7b-7q1kv", (1, 4))])
IDS = [f"{name}-{s[0]}x{s[1]}" for name, s in CASES]
B, S, S_PROMPT, STEPS = 4, 32, 16, 3
Q_WEIGHTS = ("wq", "bq", "wo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _f32:
    """float32 activations and caches on both sides (the reference's
    ``make_cache`` took its dtype default when it was defined); for the
    cached runs, outside a test's monkeypatch."""

    def __enter__(self):
        self.saved = M.ACT_DTYPE, JM.ACT_DTYPE, JM.make_cache.__defaults__
        M.ACT_DTYPE, JM.ACT_DTYPE = torch.float32, jnp.float32
        JM.make_cache.__defaults__ = (jnp.float32, False, None)

    def __exit__(self, *exc):
        M.ACT_DTYPE, JM.ACT_DTYPE, JM.make_cache.__defaults__ = self.saved


@pytest.fixture
def f32():
    with _f32():
        yield


def configs(name, **changes):
    """(the reference's config, the port's) of ``name``: an arch's
    ``reduced()``, or one of HEADS' head counts on qwen2-7b's."""
    arch, *heads = HEADS.get(name, (name,))
    if heads:
        changes.update(n_heads=heads[0], n_kv_heads=heads[1])
    return (dataclasses.replace(jax_get_arch(arch).reduced(), **changes),
            dataclasses.replace(get_arch(arch).reduced(), **changes))


def batch_for(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.cross_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def rel_l2(got, want) -> float:
    got, want = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (got, want))
    return float(torch.linalg.vector_norm(got - want) /
                 max(float(torch.linalg.vector_norm(want)), 1e-30))


def placed(params, mesh, mode="tp"):
    return shard_tree(params, param_shardings(params, mesh, mode))


def check_grads(got, want, bound=1e-4):
    errs = {i: rel_l2(g, w) for i, (g, w) in enumerate(zip(got, want))
            if float(np.linalg.norm(np.asarray(w))) > 0}
    assert len(got) == len(want) and max(errs.values()) <= bound, errs


def check_caches(got, want, kv_bound=1e-6):
    have = dict(M._leaves(got))
    for path, w in M._leaves(want):
        bound = kv_bound if path[-1] in M.GROWN + ("ck", "cv") else 1e-5
        assert rel_l2(have[path], w) <= bound, path


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _n0(cfg):
    return S_PROMPT + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _grown_jax(cache, size):
    return {k: (jnp.zeros(a.shape[:2] + (size,) + a.shape[3:], a.dtype)
                .at[:, :, :a.shape[2]].set(a) if k in ("k", "v") and a.shape[2] < size else a)
            for k, a in cache.items()}


def decode_tokens(cfg, i):
    return np.random.default_rng(10 + i).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)


def serve(cfg, params, mesh=None):
    """The logits of a prefill of S_PROMPT tokens and STEPS decode steps (on
    ``mesh`` under ``use_mesh``, or on one device), and the final cache
    (gathered). The cache grows to a length 8 ranks do not divide, so the
    decode steps read an unsplit cache on (x, 8) and a split one on (x, 4)."""
    p = params if mesh is None else placed(params, mesh)
    ctx = (lambda: use_mesh(mesh)) if mesh is not None else torch.no_grad
    with ctx():
        logits, cache = M.prefill(cfg, p, batch_for(cfg, s=S_PROMPT, seed=4))
    out = [logits]
    cache = M.grow_cache(cache, _n0(cfg) + STEPS + 1)
    for i in range(STEPS):
        with ctx():
            logits, cache = M.decode_step(cfg, p, cache, decode_tokens(cfg, i), _n0(cfg) + i)
        out.append(logits)
    return out, (cache if mesh is None else gather_tree(cache))


@functools.lru_cache(maxsize=None)
def _runs(name):
    """(carried port params, {one device of the port, the reference}: the
    float32 loss, gradients, serving logits and final cache) of ``name``."""
    jcfg, cfg = configs(name)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = batch_for(cfg)
    with _f32():
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(jcfg, p, b)))(
            jparams, _jnp(batch))
        logits, jcache = JM.prefill(jcfg, jparams, _jnp(batch_for(cfg, s=S_PROMPT, seed=4)))
        jlogits = [np.asarray(logits)]
        for i in range(STEPS):
            logits, jcache = JM.decode_step(jcfg, jparams,
                                            _grown_jax(jcache, _n0(cfg) + STEPS + 1),
                                            jnp.asarray(decode_tokens(cfg, i)), _n0(cfg) + i)
            jlogits.append(np.asarray(logits))
        loss, grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
        logits, cache = serve(cfg, params)
    return params, dict(
        one=(float(loss), grads, logits, cache),
        ref=(float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)], jlogits,
             jax.tree.map(np.asarray, jcache)))


def sharded_grads(cfg, params, mesh, batch):
    p = placed(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, p, batch, bf16_grads=False)
    return float(loss), tree_leaves(full_grads(p, leaf_tree, grads))


# ---- training and serving against one device and the reference -----------


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_training_equals_one_device_and_the_reference(name, shape, f32):
    params, want = _runs(name)
    _, cfg = configs(name)
    mesh = make_debug_mesh(*shape, device="cpu")
    (loss, grads), (loss2, grads2) = (sharded_grads(cfg, params, mesh, batch_for(cfg))
                                      for _ in range(2))
    for side in ("one", "ref"):
        want_loss, want_grads = want[side][:2]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=side)
        check_grads(grads, want_grads)
    assert loss == loss2 and all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_serving_equals_one_device_and_the_reference(name, shape, f32):
    params, want = _runs(name)
    _, cfg = configs(name)
    mesh = make_debug_mesh(*shape, device="cpu")
    (got, cache), (again, cache2) = serve(cfg, params, mesh), serve(cfg, params, mesh)
    for side, kv_bound in (("one", 1e-6), ("ref", 2e-6)):
        for i, (g, w) in enumerate(zip(got, want[side][2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{side} {i}")
        check_caches(cache, want[side][3], kv_bound)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(M._leaves(cache),
                                                           M._leaves(cache2)))


@pytest.mark.parametrize("name,shape", [("qwen2-7b", (2, 8)), ("qwen2-7b-6q2kv", (2, 4)),
                                        ("zamba2-1.2b", (1, 8)), ("whisper-medium", (2, 8))],
                         ids=["qwen2-7b-2x8", "6q2kv-2x4", "zamba2-1x8", "whisper-2x8"])
def test_remat_and_sequence_parallelism(name, shape, f32):
    """With ``cfg.remat`` each block is recomputed in the backward inside
    the forward's mesh context, and under sequence parallelism the residual
    stream is sequence-split between blocks: the training step and the
    serving steps still equal one device."""
    jcfg, cfg = configs(name, remat=True)
    params, want = _runs(name)
    mesh = make_debug_mesh(*shape, device="cpu")
    set_sequence_parallel(True)
    try:
        loss, grads = sharded_grads(cfg, params, mesh, batch_for(cfg))
        got, cache = serve(cfg, params, mesh)
    finally:
        set_sequence_parallel(False)
    np.testing.assert_allclose(loss, want["one"][0], rtol=1e-5)
    check_grads(grads, want["one"][1])
    for g, w in zip(got, want["one"][2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    check_caches(cache, want["one"][3])
    assert mesh.log["reduce-scatter"][0] > 0


@pytest.mark.parametrize("name,shape,pos", [("qwen2-7b-6q2kv", (2, 4), 40),
                                            ("qwen2-7b", (2, 8), 50),
                                            ("qwen2-7b-7q1kv", (1, 4), 63),
                                            ("zamba2-1.2b", (1, 8), 3)],
                         ids=["6q2kv-2x4", "qwen2-7b-2x8", "7q1kv-1x4", "zamba2-1x8"])
def test_shard_seq_decode_equals_one_device_and_the_reference(name, shape, pos, f32):
    """A seeded random cache of 64 slots placed with ``shard_seq`` (the
    sequence over every rank, batch 1 computed once), one decode at ``pos``
    against one device of the port and the reference's."""
    jcfg, cfg = configs(name)
    params = _runs(name)[0]
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                          JM.make_cache(jcfg, 1, 64))
    mesh = make_debug_mesh(*shape, device="cpu")
    cache = model_cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    c = shard_tree(tree_map(lambda t: t.clone(), cache),
                   cache_shardings(cache, mesh, shard_seq=True))
    tok = np.array([[7]])
    want_j, jnew = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok), pos)
    want, c1 = M.decode_step(cfg, params, cache, tok, pos)
    with use_mesh(mesh):
        got, c = M.decode_step(cfg, placed(params, mesh), c, tok, pos)
    assert "model" in str(tuple(c["k"].spec)[2])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), rtol=1e-5, atol=1e-5)
    check_caches(gather_tree(c), c1)
    check_caches(gather_tree(c), jax.tree.map(np.asarray, jnew), 2e-6)


# ---- what moves, what launches ----------------------------------------------


def _whole_q_weights(params) -> list:
    """Every layer's whole ``wq`` / ``bq`` / ``wo`` (and their layer
    stacks)."""
    out = []
    for path, t in M._leaves(params):
        if path[-1] in Q_WEIGHTS:
            out.append(t)
            out += list(t.reshape(-1, *t.shape[-(1 if path[-1] == "bq" else 2):]).unbind())
    return out


@pytest.mark.parametrize("name,shape", [("qwen2-7b-6q2kv", (2, 4)), ("qwen2-7b-7q1kv", (1, 4)),
                                        ("qwen2-vl-2b", (1, 8)), ("whisper-medium", (2, 8))],
                         ids=["6q2kv-2x4", "7q1kv-1x4", "qwen2-vl-1x8", "whisper-2x8"])
def test_no_whole_q_weight_moves(name, shape, monkeypatch, f32):
    """Every tensor a collective delivers in a tp training step, a prefill
    and two decode steps (``all_gather_dim``, ``take``, ``ShardCtx.full``)
    is an activation, a piece of columns or a kv weight: none is a whole
    ``wq``, ``bq`` or ``wo`` (compared by value, every leaf drawn at random,
    as their shapes can be a norm's or, with as many kv heads as q heads,
    ``wk``'s), yet pieces of them do move (collective-permutes are
    logged)."""
    _, cfg = configs(name)
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: torch.randn(t.shape, generator=g) * 0.1,
                      M.init_params(cfg, 0, device="cpu"))
    whole = _whole_q_weights(params)
    seen = []
    gather, take, full = C.all_gather_dim, TP.take, TP.ShardCtx.full

    def spy(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen.extend(t for t in (out if isinstance(out, list) else [out]) if t is not None)
            return out
        return run
    monkeypatch.setattr(C, "all_gather_dim", spy(gather))
    monkeypatch.setattr(TP, "take", spy(take))
    monkeypatch.setattr(TP.ShardCtx, "full", lambda self, leaf, d: spy(full)(self, leaf, d))
    mesh = make_debug_mesh(*shape, device="cpu")
    p = placed(params, mesh)
    with use_mesh(mesh):
        M.train_loss(cfg, p, batch_for(cfg))
        _, cache = M.prefill(cfg, p, batch_for(cfg, s=S_PROMPT))
        cache = M.grow_cache(cache, _n0(cfg) + 4)
        for i in range(2):
            M.decode_step(cfg, p, cache, decode_tokens(cfg, i), _n0(cfg) + i)
    assert seen and not [t for t in seen for w in whole
                         if t.shape == w.shape and torch.equal(t, w)]
    assert mesh.log["collective-permute"][0] > 0


def _attention_calls(monkeypatch):
    """Records each attention call's (q heads, kv heads): the model's and
    the unsplit cache's ``attention``, the split cache's
    ``flash_attention_lse`` ((B, H, S, d) there)."""
    calls = []
    attention, lse = A.attention, KV.flash_attention_lse

    def counted(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return attention(q, k, v, **kw)

    def counted_lse(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return lse(q, k, v, **kw)
    monkeypatch.setattr(A, "attention", counted)
    monkeypatch.setattr(KV, "flash_attention_lse", counted_lse)
    return calls


@pytest.mark.parametrize("name,shape,want", [
    ("qwen2-7b", (1, 8), [(1, 1)] * 4),             # ranks 4-7: no heads, no call
    ("qwen2-7b-6q2kv", (1, 4), [(2, 1), (2, 2), (2, 1)]),  # rank 1's runs: one call
    ("qwen2-7b-8q2kv", (1, 3), [(3, 1), (1, 1), (2, 1), (2, 1)]),  # rank 1: two runs
], ids=["qwen2-7b-1x8", "6q2kv-1x4", "8q2kv-1x3"])
def test_attention_calls_follow_the_head_layout(name, shape, want, monkeypatch, f32):
    """Per layer, a training forward and a decode step over an unsplit
    cache call attention once per ``attn_calls`` entry of each rank with
    heads, in rank order: a rank without heads calls nothing, a straddling
    rank's runs of one length share a call (a uniform group), runs of
    different lengths take one each (kv sliced to one head). A decode over
    a sequence-split cache makes one call a slice with every q head."""
    _, cfg = configs(name)
    params = M.init_params(cfg, 0, device="cpu")
    calls = _attention_calls(monkeypatch)
    mesh = make_debug_mesh(*shape, device="cpu")
    p = placed(params, mesh)
    n = shape[1]
    with use_mesh(mesh), torch.no_grad():
        M.train_loss(cfg, p, batch_for(cfg))
        assert calls == want * cfg.n_layers
        _, cache = M.prefill(cfg, p, batch_for(cfg, s=S_PROMPT))
        calls.clear()
        M.decode_step(cfg, p, M.grow_cache(cache, n * 8 + 1), decode_tokens(cfg, 0), S_PROMPT)
        assert calls == want * cfg.n_layers  # unsplit: n x 8 + 1 slots
        calls.clear()
        M.decode_step(cfg, p, M.grow_cache(cache, n * 8), decode_tokens(cfg, 0), S_PROMPT)
    # split: only the slices holding one of the S_PROMPT + 1 valid slots launch
    per_layer = [(cfg.n_heads, cfg.n_kv_heads)] * -(-(S_PROMPT + 1) // 8)
    assert calls == per_layer * cfg.n_layers


def _cols(ranges):
    return set(i for lo, hi in ranges for i in range(lo, hi))


def _own(N, n, m):
    b = -(-N // n)
    return set(range(m * b, min((m + 1) * b, N)))


def _foreign(wants, owns):
    return max(len(w - o) for w, o in zip(wants, owns))


def _record(log, kind, nbytes):
    if nbytes:
        calls, total = log.get(kind, (0, 0))
        log[kind] = (calls + 1, total + nbytes)


@pytest.mark.parametrize("tokens_", [4, 512], ids=["products", "weights"])
@pytest.mark.parametrize("name,n", [("qwen2-7b-6q2kv", 4), ("qwen2-7b", 8),
                                    ("qwen2-7b-7q1kv", 4)], ids=["6q2kv-4", "4q-8", "7q1kv-4"])
def test_attention_block_log_equals_closed_form(name, n, tokens_, f32):
    """One attention block of data rank 0 on (1, n), against one device:
    ``wk`` / ``wv`` and their biases gathered whole (the kv heads do not
    split over n), ``wq``'s columns outside each rank's block moved as
    weights or as products (the most one rank gets, at min(d_model,
    tokens)), ``bq``'s as pieces, ``wo``'s rows as weights or the output's
    columns as products, whichever is fewer bytes, and ``wo``'s psum."""
    _, cfg = configs(name)
    params = M.init_params(cfg, 0, device="cpu")
    mesh = make_debug_mesh(1, n, device="cpu")
    layer = M._unstack_placed(placed(params, mesh)["layers"])[0]["attn"]
    x = torch.randn(1, tokens_, cfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = M._positions_for(cfg, 1, tokens_)
    ctx = TP.ShardCtx(mesh)
    with TP.active(ctx):
        got = M._attn_tp(cfg, ctx, ctx.view(layer, 0), x, pos, 0, window=M.NO_WINDOW)
    want = M._attn(cfg, gather_tree(layer), x, pos, window=M.NO_WINDOW)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    D, hd, Hq, Hkv, T, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, tokens_, 4
    log = {}
    for _ in ("wk", "wv"):
        _record(log, "all-gather", D * Hkv * hd * f)
    for _ in ("bk", "bv"):
        _record(log, "all-gather", Hkv * hd * f)
    heads = [TP.head_range(Hq, n, m) for m in range(n)]
    wants = [_cols([(a * hd, b * hd)]) for a, b in heads]
    owns = [_own(Hq * hd, n, m) for m in range(n)]
    _record(log, "collective-permute", _foreign(wants, owns) * min(D, T) * f)
    _record(log, "collective-permute", _foreign(wants, owns) * f)  # bq's pieces
    _record(log, "collective-permute", min(_foreign(wants, owns) * D,
                                           _foreign(owns, wants) * T) * f)
    _record(log, "all-reduce", T * D * f)
    assert mesh.log == log


@pytest.mark.parametrize("Hq,Hkv,n", [(28, 4, 16), (28, 4, 8), (24, 8, 16), (12, 2, 16),
                                      (6, 2, 4), (7, 1, 4), (4, 1, 8), (8, 2, 3), (32, 8, 16),
                                      (16, 16, 16), (4, 4, 8), (28, 4, 1)])
def test_head_layout_covers_every_head_once(Hq, Hkv, n):
    """``kv_heads_for``, ``q_runs``, ``attn_calls`` and ``kv_cache.
    rep_heads``: the runs cover each rank's ``head_range`` in order, each
    run's q heads read its kv head, the rank's kv heads are exactly its
    runs', each call is a uniform GQA group over the rank's kv heads, and
    the ranks' contributed kv heads joined are every kv head once."""
    G = Hq // Hkv
    contributed = []
    for m, (lo_rep, hi_rep) in enumerate(KV.rep_heads(n, Hq, Hkv)):
        a, b = TP.head_range(Hq, n, m)
        first, cnt = TP.kv_heads_for(m, n, Hq, Hkv)
        runs = TP.q_runs(m, n, Hq, Hkv)
        assert [h for lo, hi, _ in runs for h in range(lo, hi)] == list(range(a, b))
        assert all(h // G == j for lo, hi, j in runs for h in range(lo, hi))
        assert [j for _, _, j in runs] == list(range(first, first + cnt))
        calls = TP.attn_calls(m, n, Hq, Hkv)
        assert len(calls) in ((0,) if b == a else (1, len(runs)))
        q_heads, kv_heads = [], []
        for hq, hk in calls:
            nq, nk = hq.stop - hq.start, hk.stop - hk.start
            assert nq % nk == 0
            q_heads += list(range(a + hq.start, a + hq.stop))
            kv_heads += [first + hk.start + i // (nq // nk) for i in range(nq)]
        assert q_heads == list(range(a, b))
        assert kv_heads == [h // G for h in range(a, b)]
        contributed += list(range(first + lo_rep, first + hi_rep))
    assert contributed == list(range(Hkv))


# ---- the reference computes this layout on a mesh ---------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs.base import get_arch
    from repro.distributed.sharding import param_shardings, use_mesh
    from repro.models import model as M

    M.ACT_DTYPE = jnp.float32
    M.make_cache.__defaults__ = (jnp.float32, False, None)
    batch = json.loads(sys.argv[2])
    cfg = dataclasses.replace(get_arch("qwen2-7b").reduced(), n_heads=6, n_kv_heads=2)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    train = {"tokens": jnp.asarray(batch["train"], jnp.int32)}
    prompt = {"tokens": jnp.asarray(batch["prompt"], jnp.int32)}
    out = {}
    loss_fn = jax.jit(lambda p, b: M.train_loss(cfg, p, b))
    prefill = jax.jit(lambda p, b: M.prefill(cfg, p, b))
    out["one_loss"] = np.asarray(loss_fn(params, train))
    logits, cache = prefill(params, prompt)
    out["one_logits"], out["one_k"] = np.asarray(logits), np.asarray(cache["k"])
    # make_debug_mesh's axes are Explicit under this JAX, where shard_act's
    # constraints raise; GSPMD's Auto axes are what the model code targets
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    placed = jax.device_put(params, param_shardings(params, mesh))
    with use_mesh(mesh):
        out["mesh_loss"] = np.asarray(loss_fn(placed, train))
        logits, cache = prefill(placed, prompt)
    out["mesh_logits"], out["mesh_k"] = np.asarray(logits), np.asarray(cache["k"])
    out["wq_spec"] = np.array(str(placed["layers"]["attn"]["wq"].sharding.spec))
    np.savez(sys.argv[1], **out)
    """)


def test_the_reference_computes_the_uneven_layout_on_a_mesh(tmp_path, f32):
    """The 6 q / 2 kv config on 4 model ranks, which the port used to
    refuse: the reference's ``train_loss`` and ``prefill`` under its
    ``use_mesh`` (``wq``'s 192 columns split 48 a rank) equal its single
    device's, and the port's mesh run (``head_range``: 2 heads a rank, rank
    1 straddling the kv groups, rank 3 none) equals both."""
    name = "qwen2-7b-6q2kv"
    _, cfg = configs(name)
    train, prompt = batch_for(cfg)["tokens"], batch_for(cfg, s=S_PROMPT, seed=4)["tokens"]
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out), json.dumps(
        {"train": train.tolist(), "prompt": prompt.tolist()})], capture_output=True, text=True,
        timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    assert "'model'" in str(ref["wq_spec"])
    np.testing.assert_allclose(ref["mesh_loss"], ref["one_loss"], rtol=1e-5)
    np.testing.assert_allclose(ref["mesh_logits"], ref["one_logits"], rtol=1e-5, atol=1e-5)
    assert rel_l2(ref["mesh_k"], ref["one_k"]) <= 1e-6
    params = _runs(name)[0]
    mesh = make_debug_mesh(1, 4, device="cpu")
    p = placed(params, mesh)
    with use_mesh(mesh):
        loss = float(M.train_loss(cfg, p, {"tokens": train}))
        logits, cache = M.prefill(cfg, p, {"tokens": prompt})
    np.testing.assert_allclose(loss, ref["mesh_loss"], rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref["mesh_logits"], rtol=1e-5, atol=1e-5)
    assert rel_l2(gather_tree(cache)["k"], ref["mesh_k"]) <= 2e-6


# ---- the dense MoE on the mesh ------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense_moe_runs():
    jcfg, cfg = configs("granite-moe-1b-a400m", moe_impl="dense")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = batch_for(cfg)
    prompt = batch_for(cfg, s=S_PROMPT, seed=4)
    with _f32():
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(jcfg, p, b)))(
            jparams, _jnp(batch))
        jlogits, _ = JM.prefill(jcfg, jparams, _jnp(prompt))
        loss, grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
        with torch.no_grad():
            logits, _ = M.prefill(cfg, params, prompt)
    return cfg, params, batch, prompt, dict(
        one=(float(loss), grads, logits.numpy()),
        ref=(float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)],
             np.asarray(jlogits)))


@pytest.mark.parametrize("step", ["train", "prefill"])
def test_dense_moe_on_the_mesh(step, f32):
    """``moe_impl="dense"`` on (2, 4) in tp mode (each expert's d_ff split
    over ``model``, the load-balancing loss global) against one device's
    dense oracle and the reference's."""
    cfg, params, batch, prompt, want = _dense_moe_runs()
    mesh = make_debug_mesh(2, 4, device="cpu")
    if step == "train":
        loss, grads = sharded_grads(cfg, params, mesh, batch)
        for side in ("one", "ref"):
            np.testing.assert_allclose(loss, want[side][0], rtol=1e-5, err_msg=side)
            check_grads(grads, want[side][1])
    else:
        with use_mesh(mesh):
            logits, _ = M.prefill(cfg, placed(params, mesh), prompt)
        for side in ("one", "ref"):
            np.testing.assert_allclose(logits.numpy(), want[side][2], rtol=1e-5, atol=1e-5,
                                       err_msg=side)
