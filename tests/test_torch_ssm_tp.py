"""The Mamba-2 and xLSTM blocks split by head over the mesh's ``model`` axis
(tp mode): ``models/ssm.py: mamba2_tp``, ``models/xlstm.py: mlstm_tp`` /
``slstm_tp`` and their wiring in ``models/model.py`` (``_mamba_tp``,
``_xlstm_super_tp``), on single-controller debug meshes of the CPU.

zamba2-1.2b ``reduced()`` has 8 SSM heads (``in_proj``'s 552 columns split
into blocks that cut across its z / x / B / C / dt parts) and xlstm-350m
``reduced()`` 4 mLSTM heads (``up_proj``'s inner and z halves in other
ranks' blocks). Meshes (4, 2) and (2, 4) for both, and (1, 8) for xlstm:
more model ranks than mLSTM heads, so ranks 4-7 own no head (zamba2's 4
attention q heads do not split over 8 ranks: ROADMAP "What still raises").

- Training in float32 (each ``ACT_DTYPE`` set): the loss to 1e-5 relative
  and every gradient to 1e-4 relative L2 against one device of the port and
  against the reference's ``train_loss`` on one JAX device (parameters
  carried by ``convert.model_params_from_jax``); with remat, with sequence
  parallelism; two runs bit-equal.
- Serving in float32: a prefill and 3 decode steps, logits to 1e-5 and the
  recurrent states to 1e-5 relative L2 (the attention k / v to 1e-6, as
  tests/test_torch_sharded_serve.py holds them) against one device of the
  port and against the reference's ``prefill`` / ``decode_step``; with
  sequence parallelism; two runs bit-equal.
- ``Mesh.log`` of one Mamba-2, mLSTM and sLSTM block equals its closed
  form (each rank's foreign columns counted as sets); no op of a tp step
  delivers a whole split weight of these blocks, and fsdp mode still
  gathers them.
- Each rank's scan reads only its heads (the single device's inputs of
  those heads); the helpers ``take`` / ``col_product`` / ``col_gather`` /
  ``row_product`` equal the plain products by either route.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import model_params_from_jax
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (gather_tree, param_shardings,
                                              set_sequence_parallel, shard_tree, use_mesh)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import full_grads, loss_and_grads, sharded_loss_and_grads

NAMES = ["zamba2-1.2b", "xlstm-350m"]
MESHES = {"zamba2-1.2b": [(4, 2), (2, 4)], "xlstm-350m": [(4, 2), (2, 4), (1, 8)]}
CASES = [(name, shape) for name in NAMES for shape in MESHES[name]]
IDS = [f"{name}-{shape[0]}x{shape[1]}" for name, shape in CASES]
B, S, S_PROMPT, STEPS = 4, 32, 16, 3
SPLIT_WEIGHTS = ("in_proj", "out_proj", "up_proj", "q", "k", "v", "down_proj", "w_in")


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
    """float32 activations and caches on both sides (the reference's
    ``make_cache`` took its dtype default when it was defined)."""
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(JM.make_cache, "__defaults__", (jnp.float32, False, None))


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def rel_l2(got, want) -> float:
    got, want = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (got, want))
    return float(torch.linalg.vector_norm(got - want) /
                 max(float(torch.linalg.vector_norm(want)), 1e-30))


def placed(params, mesh, mode="tp"):
    return shard_tree(params, param_shardings(params, mesh, mode))


def sharded_grads(cfg, params, mesh, batch):
    p = placed(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, p, batch, bf16_grads=False)
    return loss, tree_leaves(full_grads(p, leaf_tree, grads))


def check_grads(got, want, bound=1e-4):
    errs = {i: rel_l2(g, w) for i, (g, w) in enumerate(zip(got, want))
            if float(np.linalg.norm(np.asarray(w))) > 0}
    assert max(errs.values()) <= bound, errs


# ---- training --------------------------------------------------------------


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_tp_loss_and_grads_equal_one_device(name, shape, f32):
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": tokens(cfg, B, S, 0)}
    want_loss, want_grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
    mesh = make_debug_mesh(*shape, device="cpu")
    runs = [sharded_grads(cfg, params, mesh, batch) for _ in range(2)]
    (loss, grads), (loss2, grads2) = runs
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    check_grads(grads, want_grads)
    assert float(loss) == float(loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("sp", [False, True], ids=["remat", "remat_sp"])
@pytest.mark.parametrize("name", NAMES)
def test_tp_grads_under_remat_and_sequence_parallelism(name, sp, f32):
    """With ``cfg.remat`` each block is recomputed in the backward inside
    the forward's mesh context; with sequence parallelism the residual
    stream between blocks is sequence-split (an all-gather before each
    block, a reduce-scatter at its end)."""
    import dataclasses
    cfg = dataclasses.replace(get_arch(name).reduced(), remat=True)
    params = M.init_params(cfg, 1, device="cpu")
    batch = {"tokens": tokens(cfg, B, S, 6)}
    want_loss, want_grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
    mesh = make_debug_mesh(2, 4, device="cpu")
    set_sequence_parallel(sp)
    try:
        loss, grads = sharded_grads(cfg, params, mesh, batch)
    finally:
        set_sequence_parallel(False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    check_grads(grads, want_grads)
    if sp:
        assert mesh.log["reduce-scatter"][0] > 0


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(carried port params, the reference's float32 loss and gradients, its
    prefill + decode logits and final cache) of ``name`` ``reduced()``."""
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    with _jax_f32():
        batch = {"tokens": jnp.asarray(tokens(cfg, B, S, 3))}
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(jcfg, p, b)))(
            jparams, batch)
        logits, cache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(
            tokens(cfg, B, S_PROMPT, 4))})
        outs = [np.asarray(logits)]
        for i in range(STEPS):
            tok = jnp.asarray(tokens(cfg, B, 1, 10 + i))
            logits, cache = JM.decode_step(jcfg, jparams, _grown(cache), tok, S_PROMPT + i)
            outs.append(np.asarray(logits))
    return (params, float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)], outs,
            jax.tree.map(np.asarray, cache))


class _jax_f32:
    """float32 activations and caches on the reference's side (for the
    cached reference runs, outside a test's monkeypatch)."""

    def __enter__(self):
        self.saved = JM.ACT_DTYPE, JM.make_cache.__defaults__
        JM.ACT_DTYPE, JM.make_cache.__defaults__ = jnp.float32, (jnp.float32, False, None)

    def __exit__(self, *exc):
        JM.ACT_DTYPE, JM.make_cache.__defaults__ = self.saved


def _grown(cache):
    """The reference's cache with its attention k / v grown to S_PROMPT +
    STEPS + 1 slots (once; the recurrent states keep their shapes)."""
    size = S_PROMPT + STEPS + 1
    return {k: (jnp.zeros(a.shape[:2] + (size,) + a.shape[3:], a.dtype)
                .at[:, :, :a.shape[2]].set(a) if k in ("k", "v") and a.shape[2] < size else a)
            for k, a in cache.items()}


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_tp_loss_and_grads_equal_the_reference(name, shape, f32_both):
    params, jloss, jgrads, _, _ = _reference(name)
    cfg = get_arch(name).reduced()
    mesh = make_debug_mesh(*shape, device="cpu")
    loss, grads = sharded_grads(cfg, params, mesh, {"tokens": tokens(cfg, B, S, 3)})
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    check_grads(grads, jgrads)


# ---- serving ---------------------------------------------------------------


def serve(cfg, params, mesh=None):
    """The logits of a prefill of S_PROMPT tokens and STEPS decode steps
    (on ``mesh`` under ``use_mesh``, or on one device), and the final cache
    (gathered)."""
    ctx = use_mesh(mesh) if mesh is not None else _nothing()
    p = params if mesh is None else placed(params, mesh)
    with ctx:
        logits, cache = M.prefill(cfg, p, {"tokens": tokens(cfg, B, S_PROMPT, 4)})
    out = [logits]
    cache = M.grow_cache(cache, S_PROMPT + STEPS + 1)
    for i in range(STEPS):
        with (use_mesh(mesh) if mesh is not None else _nothing()):
            logits, cache = M.decode_step(cfg, p, cache, tokens(cfg, B, 1, 10 + i),
                                          S_PROMPT + i)
        out.append(logits)
    return out, (cache if mesh is None else gather_tree(cache))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def check_caches(got, want):
    have = dict(M._leaves(got))
    for path, w in M._leaves(want):
        bound = 1e-6 if path[-1] in M.GROWN else 1e-5
        assert rel_l2(have[path], w) <= bound, path


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_tp_serving_equals_one_device(name, shape, f32):
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    want, c1 = serve(cfg, params)
    mesh = make_debug_mesh(*shape, device="cpu")
    (got, c2), (again, c3) = serve(cfg, params, mesh), serve(cfg, params, mesh)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=str(i))
    check_caches(c2, c1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(M._leaves(c2), M._leaves(c3)))


@pytest.mark.parametrize("name", NAMES)
def test_tp_serving_with_sequence_parallelism(name, f32):
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    want, c1 = serve(cfg, params)
    mesh = make_debug_mesh(2, 4, device="cpu")
    set_sequence_parallel(True)
    try:
        got, c2 = serve(cfg, params, mesh)
    finally:
        set_sequence_parallel(False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    check_caches(c2, c1)
    assert mesh.log["reduce-scatter"][0] > 0


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_tp_serving_equals_the_reference(name, shape, f32_both):
    params, _, _, jlogits, jcache = _reference(name)
    cfg = get_arch(name).reduced()
    got, cache = serve(cfg, params, make_debug_mesh(*shape, device="cpu"))
    for i, (g, w) in enumerate(zip(got, jlogits)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=str(i))
    have = dict(M._leaves(cache))
    for path, w in M._leaves(jcache):
        bound = 2e-6 if path[-1] in M.GROWN else 1e-5
        assert rel_l2(have[path], w) <= bound, path


# ---- what moves: the blocks' collectives in closed form --------------------


def _own(N, n, m):
    b = -(-N // n)
    return set(range(m * b, min((m + 1) * b, N)))


def _cols(ranges):
    return set(i for lo, hi in ranges for i in range(lo, hi))


def _foreign(wants, owns):
    return max(len(w - o) for w, o in zip(wants, owns))


def _record(log, kind, nbytes):
    if nbytes:
        calls, total = log.get(kind, (0, 0))
        log[kind] = (calls + 1, total + nbytes)


def _layer_of(tree, *idx):
    for i in idx:
        tree = M._unstack_placed(tree)[i]
    return tree


def _block_call(mesh, tree, fn):
    """``fn(ctx, per-rank view of tree, d)`` (a block's generator) driven
    over every data rank on the same input with a clean log: data rank 0's
    result."""
    ctx = TP.ShardCtx(mesh)
    mesh.log.clear()
    with TP.active(ctx):
        return TP.each_grouped(ctx, lambda d: fn(ctx, ctx.view(tree, d), d))[0]


TOKENS = [(2, 32), (2, 128)]  # fewer tokens than d_model moves products, more moves weights


@pytest.mark.parametrize("b,s", TOKENS, ids=["products", "weights"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 3), (1, 8)], ids=str)
def test_mamba2_block_log_equals_closed_form(shape, b, s):
    cfg = get_arch("zamba2-1.2b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    mesh = make_debug_mesh(*shape, device="cpu")
    layer = _layer_of(placed(params, mesh)["mamba_groups"], 0, 0)["m"]
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(0))
    D, P, N, di = cfg.d_model, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_expand * cfg.d_model
    H, n, T = di // P, shape[1], b * s
    out, _ = _block_call(mesh, layer, lambda ctx, pv, d: SSM.mamba2_tp(
        ctx, pv, x, d, N, cfg.ssm_expand, P))
    want_out, _ = SSM.mamba2_forward(gather_tree(layer), x, N, cfg.ssm_expand, P)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-5, atol=1e-5)
    heads = [TP.head_range(H, n, m) for m in range(n)]
    n_in = 2 * di + 2 * N + H
    wants = [_cols([(a * P, c * P), (di + a * P, di + c * P), (2 * di, 2 * di + 2 * N),
                    (2 * di + 2 * N + a, 2 * di + 2 * N + c)]) for a, c in heads]
    want = {}
    extra = _foreign(wants, [_own(n_in, n, m) for m in range(n)])
    _record(want, "collective-permute", extra * min(D, T) * 4)
    _record(want, "all-reduce", T * 4)  # the gated RMSNorm's sums of squares
    rows = [_cols([(a * P, c * P)]) for a, c in heads]
    owns = [_own(di, n, m) for m in range(n)]
    w_extra, a_extra = _foreign(rows, owns) * D, _foreign(owns, rows) * T
    _record(want, "collective-permute", min(w_extra, a_extra) * 4)
    _record(want, "all-reduce", T * D * 4)  # out_proj's psum
    assert mesh.log == want


@pytest.mark.parametrize("b,s", TOKENS, ids=["products", "weights"])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)], ids=str)
def test_xlstm_blocks_log_equals_closed_form(shape, b, s):
    cfg = get_arch("xlstm-350m").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    mesh = make_debug_mesh(*shape, device="cpu")
    sup = _layer_of(placed(params, mesh)["super"], 0)
    ml, sl = _layer_of(sup["mlstm"], 0)["x"], sup["slstm"]["x"]
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(0))
    D, H, n, T = cfg.d_model, cfg.n_heads, shape[1], b * s
    di = int(cfg.proj_factor * D)
    P = di // H
    out, _ = _block_call(mesh, ml, lambda ctx, pv, d: XL.mlstm_tp(ctx, pv, x, d, H))
    want_out, _ = XL.mlstm_forward(gather_tree(ml), x, H)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-5, atol=1e-5)
    heads = [TP.head_range(H, n, m) for m in range(n)]
    active = [(a, c) for a, c in heads if c > a]
    want = {}
    _record(want, "all-gather", di * min(D, T) * 4)  # inner, whole on every rank
    zs = [_cols([(di + a * P, di + c * P)]) for a, c in heads]
    _record(want, "collective-permute",
            _foreign(zs, [_own(2 * di, n, m) for m in range(n)]) * min(D, T) * 4)
    qs = [_cols([(a * P, c * P)]) for a, c in heads]
    owns = [_own(di, n, m) for m in range(n)]
    for _ in "qkv":
        _record(want, "collective-permute", _foreign(qs, owns) * min(di, T) * 4)
    if len(active) > 1:
        _record(want, "all-reduce", T * 4)
    _record(want, "collective-permute",
            min(_foreign(qs, owns) * D, _foreign(owns, qs) * T) * 4)
    _record(want, "all-reduce", T * D * 4)
    assert mesh.log == want

    out, _ = _block_call(mesh, sl, lambda ctx, pv, d: XL.slstm_tp(ctx, pv, x, d))
    want_out, _ = XL.slstm_forward(gather_tree(sl), x)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=1e-5, atol=1e-5)
    rows_per = -(-b // n)
    want = {}
    _record(want, "all-to-all", rows_per * s * n * -(-4 * D // n) * 4)  # rows of whole gates
    _record(want, "all-to-all", b * s * -(-D // n) * 4)  # units of every row
    _record(want, "all-reduce", T * D * 4)
    assert mesh.log == want


def _whole_weights(params) -> set:
    """The shapes of the split weights of the Mamba-2 and xLSTM blocks, as a
    layer's and as xlstm's stack of a super-block's mLSTM layers."""
    return {tuple(t.shape[-k:]) for path, t in M._leaves(params)
            if path[-1] in SPLIT_WEIGHTS and path[0] != "shared_attn"
            for k in (2, 3) if t.ndim > k}


@pytest.mark.parametrize("name", NAMES)
def test_no_whole_weight_moves_in_tp_and_fsdp_still_gathers(name, monkeypatch, f32):
    """Every tensor a collective delivers in a tp training step, a prefill
    and a decode step (``all_gather_dim``, ``take``, ``ShardCtx.full``) is
    an activation or a few columns: none has a whole split weight's shape.
    In fsdp mode the blocks gather their weights whole."""
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    whole = _whole_weights(params)
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
    for mode in ("tp", "fsdp"):
        seen.clear()
        mesh = make_debug_mesh(2, 4, device="cpu")
        p = placed(params, mesh, mode)
        with use_mesh(mesh):
            M.train_loss(cfg, p, {"tokens": tokens(cfg, B, S, 0)})
            _, cache = M.prefill(cfg, p, {"tokens": tokens(cfg, B, S_PROMPT, 4)})
            M.decode_step(cfg, p, M.grow_cache(cache, S_PROMPT + 4),
                          tokens(cfg, B, 1, 5), S_PROMPT)
        moved = {tuple(t.shape) for t in seen} & whole
        if mode == "tp":
            assert not moved, moved
        else:
            assert {s[-2:] for s in moved} == {s[-2:] for s in whole}


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_each_rank_scans_only_its_heads(name, shape, monkeypatch, f32):
    """The scan (Mamba-2) or recurrence (mLSTM) inputs of each rank
    (``tensor_parallel.grouped``'s per-rank arguments) hold its model
    rank's ``head_range`` of heads and its data rank's rows, and they are
    the single device's inputs of those heads and rows: per layer, the
    model ranks' heads and the data ranks' rows joined give the one-device
    call's."""
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    mod, fn = (SSM, "_ssd") if name == "zamba2-1.2b" else (XL, "_mlstm_cells")
    one, calls = [], []
    real_fn, real_grouped = getattr(mod, fn), TP.grouped

    def spy(*args):
        one.append(args[0].detach().clone())  # xs / q: (B, S, heads, P)
        return real_fn(*args)

    def per_rank(ctx, args, cat, rows, fn, *rest):
        if fn is real_fn:  # not the sLSTM's loop, which splits rows
            calls.append({k: a[0].detach().clone() for k, a in args.items()})
        return real_grouped(ctx, args, cat, rows, fn, *rest)
    batch = {"tokens": tokens(cfg, B, S, 0)}
    with torch.no_grad():
        with monkeypatch.context() as mp:
            mp.setattr(mod, fn, spy)
            M.train_loss(cfg, params, batch)
        monkeypatch.setattr(TP, "grouped", per_rank)
        mesh = make_debug_mesh(*shape, device="cpu")
        with use_mesh(mesh):
            M.train_loss(cfg, placed(params, mesh), batch)
    n_dp, n = shape
    H = one[0].shape[2]
    heads = {m: TP.head_range(H, n, m) for m in range(n) if TP.head_range(H, n, m)[1] >
             TP.head_range(H, n, m)[0]}
    assert len(calls) == len(one)
    for want, got in zip(one, calls):
        assert {k: t.shape[2] for k, t in got.items()} == {
            (d, m): b - a for d in range(n_dp) for m, (a, b) in heads.items()}
        rows = [torch.cat([got[(d, m)] for m in sorted(heads)], dim=2) for d in range(n_dp)]
        torch.testing.assert_close(torch.cat(rows), want, rtol=1e-5, atol=1e-6)


def test_grouped_equals_each_rank_alone():
    """Ranks sharing a device run as one batch, their rows and heads
    joined: the same results as each rank's own call, cut back per rank;
    an argument that is not a data rank's rows is the first's."""
    mesh = make_debug_mesh(2, 3, device="cpu")
    ctx = TP.ShardCtx(mesh)
    g = torch.Generator().manual_seed(0)
    heads = {0: 2, 1: 3, 2: 1}
    args = {(d, m): (torch.randn(2, 5, h, 4, generator=g), torch.randn(h, generator=g),
                     torch.randn(2, 1, 1, 1, generator=g))
            for d in range(2) for m, h in heads.items()}
    for m in heads:  # the per-head parameter is the model rank's, whatever the data rank
        args[(1, m)] = (args[(1, m)][0], args[(0, m)][1], args[(1, m)][2])

    def fn(x, w, s):
        return (x * w[:, None] * s).cumsum(1).flatten(2), x.sum(1)
    got = TP.grouped(ctx, args, (2, 0, None), (True, False, True), fn, ((-1, 4), (1, 1)),
                     heads)
    for (d, m), (x, w, s) in args.items():
        want = fn(x, w, args[(d, 0)][2])
        assert all(torch.allclose(a, b) for a, b in zip(got[(d, m)], want))


# ---- the helpers -------------------------------------------------------------


@pytest.mark.parametrize("H,n", [(8, 3), (4, 8), (64, 16), (4, 16), (8, 8)])
def test_head_range_covers_every_head_once(H, n):
    ranges = [TP.head_range(H, n, m) for m in range(n)]
    assert [i for a, b in ranges for i in range(a, b)] == list(range(H))
    c = -(-H // n)
    assert all(b - a in (0, c) for a, b in ranges[:-1])
    assert sum(b > a for a, b in ranges) == -(-H // c)


@pytest.mark.parametrize("tokens_", [3, 400], ids=["products", "weights"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_col_and_row_products_equal_the_plain_products(n, tokens_):
    """Misaligned column wants of a (K, N) column-split weight, the columns
    of a (N, Dout) row-split weight each rank holds as heads: both routes
    give the plain products; ``col_gather`` gives one replicated product."""
    K, N, Dout = 24, 50, 7
    g = torch.Generator().manual_seed(n)
    x = torch.randn(1, tokens_, K, generator=g)
    w, wo = torch.randn(K, N, generator=g), torch.randn(N, Dout, generator=g)
    mesh = make_debug_mesh(1, n, device="cpu")
    ctx = TP.ShardCtx(mesh)
    col = placed({"a/in_proj": w}, mesh)["a/in_proj"]
    row = placed({"a/out_proj": wo}, mesh)["a/out_proj"]
    heads = [TP.head_range(10, n, m) for m in range(n)]
    want = [[(5 * a, 5 * b), (N - 3, N)] if b > a else [] for a, b in heads]
    got = TP.col_product(ctx, x, ctx.local(col, 0), N, 0, want)
    for m, ranges in enumerate(want):
        if ranges:
            idx = [i for lo, hi in ranges for i in range(lo, hi)]
            torch.testing.assert_close(got[m], x @ w[:, idx])
        else:
            assert got[m] is None
    torch.testing.assert_close(TP.col_gather(ctx, x, ctx.local(col, 0), N, 0, 7, 41),
                               x @ w[:, 7:41])
    have = [[(5 * a, 5 * b)] if b > a else [] for a, b in heads]
    y = torch.randn(1, tokens_, N, generator=g)
    ys = [y[..., lo:hi] if r else None for r in have for lo, hi in (r or [(0, 0)])]
    torch.testing.assert_close(TP.row_product(ctx, ys, have, ctx.local(row, 0), N, 0, False),
                               y @ wo, rtol=1e-5, atol=1e-5)
    mesh.log.clear()
    TP.col_product(ctx, x, ctx.local(col, 0), N, 0, want)
    extra = _foreign([_cols(r) for r in want], [_own(N, n, m) for m in range(n)])
    assert mesh.log == ({"collective-permute": (1, extra * min(K, tokens_) * 4)} if extra
                        else {})


def test_take_joins_pieces_from_their_owners():
    mesh = make_debug_mesh(1, 3, device="cpu")
    ctx = TP.ShardCtx(mesh)
    full = torch.arange(30.0).reshape(3, 10)
    have = [[(0, 4)], [(4, 8)], [(8, 10)]]
    parts = [full[:, lo:hi] for r in have for lo, hi in r]
    out = TP.take(ctx, parts, 0, -1, have, [[(2, 9)], [], [(0, 1), (9, 10)]])
    assert torch.equal(out[0], full[:, 2:9]) and out[1] is None
    assert torch.equal(out[2], full[:, [0, 9]])
    assert mesh.log == {"collective-permute": (1, 3 * 5 * 4)}  # rank 0 gets columns 4-8
    mesh.log.clear()
    out = TP.take(ctx, parts, 0, -1, have, [[(0, 10)]] * 3)
    assert all(torch.equal(o, full) for o in out)
    assert mesh.log == {"all-gather": (1, full.numel() * 4)}
    mesh.log.clear()
    TP.take(ctx, parts, 0, -1, have, [[(0, 4)], [(4, 8)], []])
    assert mesh.log == {}
