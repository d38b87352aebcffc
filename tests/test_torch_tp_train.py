"""Sharded training of the port on single-controller debug meshes of the
CPU, ``make_debug_mesh(4, 2)`` and ``(2, 4)``: ``models.model.train_loss``
under ``use_mesh`` with parameters placed by ``param_shardings``, and
``train.step.make_sharded_train_step``.

- The reference's multi-device test (tests/test_distributed.py, its model
  half), ported: qwen2-7b ``reduced()`` fits the mesh, its sharded loss is
  finite and holds within 1e-2 relative after ``reshard_tree`` onto (2, 4).
- The sharded loss equals the unsharded port's on the reduced config of all
  ten architectures: with float32 activations (each ``ACT_DTYPE`` set, as
  tests/test_torch_train_f32.py does) to 1e-5 relative and every gradient
  to 1e-4 relative L2; in bf16 to 1e-2 relative.
- Against the reference: qwen2-7b on carried weights, in float32, at the
  bounds of tests/test_torch_train_f32.py (loss 1e-5 relative, gradients
  1e-3 relative L2).
- A sharded step (tp, tp + sequence parallelism, fsdp, ZeRO-1 moments)
  equals the unsharded step (updates and moments to 1e-4 relative L2), and
  two runs are bit-equal.
- Below the capacity's floor the sharded MoE computes the dense oracle's
  function.
- Sequence parallelism replaces each tensor-parallel all-reduce by a
  reduce-scatter + all-gather pair of the same payload; an elastic restart
  from a checkpoint onto the other mesh keeps the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.convert import model_params_from_jax
from repro_torch.distributed.elastic import check_mesh_fits, reshard_tree
from repro_torch.distributed.sharding import (gather_tree, param_shardings,
                                              set_sequence_parallel, shard_tree, use_mesh)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWState, tree_leaves, tree_unflatten, zero1_shardings
from repro_torch.train.step import (full_grads, loss_and_grads, make_sharded_train_step,
                                    make_train_step, sharded_loss_and_grads)

MESHES = [(4, 2), (2, 4)]
B, S = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(M, "ACT_DTYPE", torch.float32)


def batch_for(cfg, seed=0, b=B, s=S):
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


def sharded(params, mesh, mode="tp"):
    return shard_tree(params, param_shardings(params, mesh, mode))


def test_reference_multidevice_model_half():
    """tests/test_distributed.py's model half on the port: fits, a finite
    sharded loss, and the loss after an elastic reshard onto (2, 4)."""
    cfg = get_arch("qwen2-7b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    mesh = make_debug_mesh(4, 2, device="cpu")
    assert check_mesh_fits(params, mesh) == []
    params_sharded = reshard_tree(params, mesh)
    batch = {"tokens": np.zeros((8, 32), np.int32)}
    with use_mesh(mesh):
        loss = M.train_loss(cfg, params_sharded, batch)
    assert np.isfinite(float(loss))
    mesh2 = make_debug_mesh(2, 4, device="cpu")
    params2 = reshard_tree(gather_tree(params_sharded), mesh2)
    with use_mesh(mesh2):
        loss2 = M.train_loss(cfg, params2, batch)
    assert abs(float(loss) - float(loss2)) < 1e-2 * max(abs(float(loss)), 1.0)


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", list_archs())
def test_sharded_loss_and_grads_equal_unsharded_in_float32(name, shape, f32):
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg)
    want_loss, want_grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
    mesh = make_debug_mesh(*shape, device="cpu")
    placed = sharded(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, placed, batch, bf16_grads=False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = tree_leaves(full_grads(placed, leaf_tree, grads))
    errs = {i: rel_l2(g, w) for i, (g, w) in enumerate(zip(got, want_grads))
            if float(torch.linalg.vector_norm(w)) > 0}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
def test_sharded_moe_equals_the_dense_oracle_when_nothing_drops(shape, f32):
    """At 128 tokens no expert drops (the capacity's floor), so the sharded
    sorted dispatch computes the function of the single-device dense oracle
    (``moe_impl="dense"``: every expert for every token); the oracle itself
    also runs on the mesh (``moe.moe_dense_tp``) and gives that loss."""
    import dataclasses
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    dense = dataclasses.replace(cfg, moe_impl="dense")
    params = M.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg, seed=7)
    want_loss, want_grads = loss_and_grads(dense, params, batch, bf16_grads=False)
    mesh = make_debug_mesh(*shape, device="cpu")
    placed = sharded(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, placed, batch, bf16_grads=False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(full_grads(placed, leaf_tree, grads)), want_grads):
        assert rel_l2(g, w) <= 1e-4
    with use_mesh(mesh):
        dense_loss = float(M.train_loss(dense, placed, batch))
    np.testing.assert_allclose(dense_loss, float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", list_archs())
def test_sharded_loss_equals_unsharded_in_bf16(name, shape):
    """Full tensors under ``use_mesh`` are placed by the tp rules first."""
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg, seed=2)
    want = M.train_loss(cfg, params, batch)
    mesh = make_debug_mesh(*shape, device="cpu")
    with use_mesh(mesh):
        got = M.train_loss(cfg, params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
def test_sharded_qwen2_equals_the_reference_in_float32(shape, f32, monkeypatch):
    """Carried reference weights: the sharded port's loss and gradients
    against the reference's single-device ``train_loss`` (float32
    activations on both sides: tests/test_torch_train_f32.py's bounds)."""
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    jcfg, cfg = jax_get_arch("qwen2-7b").reduced(), get_arch("qwen2-7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = batch_for(cfg, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(jcfg, p, b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = make_debug_mesh(*shape, device="cpu")
    placed = sharded(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, placed, batch, bf16_grads=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, jg in zip(tree_leaves(full_grads(placed, leaf_tree, grads)), jax.tree.leaves(jgrads)):
        assert rel_l2(g, torch.from_numpy(np.array(jg, np.float32))) <= 1e-3


def _seeded_state(params, step=5, seed=1):
    g = torch.Generator().manual_seed(seed)
    leaves = tree_leaves(params)
    return AdamWState(step=torch.tensor(step, dtype=torch.int32),
                      m=tree_unflatten(params, [torch.randn(x.shape, generator=g) * 1e-2
                                                for x in leaves]),
                      v=tree_unflatten(params, [torch.rand(x.shape, generator=g) * 1e-4
                                                for x in leaves]))


STEP_CASES = {"tp": ("tp", False, False), "tp_sp": ("tp", True, False),
              "fsdp": ("fsdp", False, False), "tp_zero1": ("tp", False, True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_sharded_step_equals_unsharded_step(name, shape, case, f32):
    mode, sp, zero1 = STEP_CASES[case]
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    state = _seeded_state(params)
    batch = batch_for(cfg, seed=4)
    kw = dict(peak_lr=1e-3, total_steps=50, bf16_grads=False)
    p1, s1, m1 = make_train_step(cfg, **kw)(params, state, batch)
    mesh = make_debug_mesh(*shape, device="cpu")
    psh = param_shardings(params, mesh, mode)
    msh = zero1_shardings(psh, params, mesh) if zero1 else psh
    step = make_sharded_train_step(cfg, **kw)
    runs = []
    set_sequence_parallel(sp)
    try:
        for _ in range(2):
            st = AdamWState(step=state.step, m=shard_tree(state.m, msh),
                            v=shard_tree(state.v, msh))
            runs.append(step(shard_tree(params, psh), st, batch))
    finally:
        set_sequence_parallel(False)
    (p2, s2, m2), (p3, s3, m3) = runs
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5, err_msg=key)
    gp, gm, gv = gather_tree(p2), gather_tree(s2.m), gather_tree(s2.v)
    for new, old, want in zip(tree_leaves(gp), tree_leaves(params), tree_leaves(p1)):
        assert rel_l2(new - old, want - old) <= 1e-4
    for got, want in zip(tree_leaves(gm) + tree_leaves(gv), tree_leaves(s1.m) + tree_leaves(s1.v)):
        assert rel_l2(got, want) <= 1e-4
    assert int(s2.step) == int(s1.step)
    if zero1:
        assert any(any(a == "data" for a in (e if isinstance(e, tuple) else (e,)))
                   for b in tree_leaves(s2.m) for e in b.spec)
    # bit-equal repeat
    assert float(m2["loss"]) == float(m3["loss"]) and float(m2["gnorm"]) == float(m3["gnorm"])
    for a, b in zip(tree_leaves(gp) + tree_leaves(gm), tree_leaves(gather_tree(p3)) +
                    tree_leaves(gather_tree(s3.m))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen2-7b", "gemma2-27b"])
def test_sequence_parallel_swaps_all_reduces_for_pairs(name):
    """Per layer the attention and MLP all-reduces (and the embedding's)
    become reduce-scatters of 1/n of the payload plus all-gathers of all of
    it; nothing else changes, nor does the loss."""
    cfg = get_arch(name).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg)
    logs, losses = [], []
    for sp in (False, True):
        mesh = make_debug_mesh(2, 4, device="cpu")
        set_sequence_parallel(sp)
        try:
            with use_mesh(mesh):
                losses.append(float(M.train_loss(cfg, sharded(params, mesh), batch)))
        finally:
            set_sequence_parallel(False)
        logs.append(dict(mesh.log))
    off, on = logs
    n_pairs = 2 * cfg.n_layers + 1
    payload = (B // 2) * S * cfg.d_model * 2  # one data rank's bf16 residual stream
    assert on["reduce-scatter"] == (n_pairs, n_pairs * payload // 4)
    assert off["all-reduce"][0] - on["all-reduce"][0] == n_pairs
    assert off["all-reduce"][1] - on["all-reduce"][1] == n_pairs * payload
    ag_off = off.get("all-gather", (0, 0))
    assert on["all-gather"][0] - ag_off[0] == n_pairs  # one before each block + the loss's
    assert on["all-gather"][1] - ag_off[1] == n_pairs * payload
    assert on["all-to-all"] == off["all-to-all"]
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def test_elastic_restart_from_a_checkpoint(tmp_path, f32):
    """Save under (4, 2) (checkpoints hold full arrays), restore, reshard
    onto (2, 4): the loss holds."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg, seed=5)
    mesh = make_debug_mesh(4, 2, device="cpu")
    placed = reshard_tree(params, mesh)
    with use_mesh(mesh):
        loss = float(M.train_loss(cfg, placed, batch))
    save_checkpoint(str(tmp_path), 7, gather_tree(placed))
    like = M.init_params(cfg, 1, device="cpu")
    restored = restore_checkpoint(str(tmp_path), 7, like)
    mesh2 = make_debug_mesh(2, 4, device="cpu")
    with use_mesh(mesh2):
        loss2 = float(M.train_loss(cfg, reshard_tree(restored, mesh2), batch))
    np.testing.assert_allclose(loss2, loss, rtol=1e-5)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium"])
def test_sharded_grads_under_remat(name, f32):
    """With ``cfg.remat`` each block is recomputed in the backward, inside
    the forward's mesh context (tensor-parallel, gathered and MoE blocks):
    the gradients stay the unsharded ones, and the recomputation's
    collectives are logged again."""
    import dataclasses
    cfg = dataclasses.replace(get_arch(name).reduced(), remat=True)
    params = M.init_params(cfg, 1, device="cpu")
    batch = batch_for(cfg, seed=6)
    want_loss, want_grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
    mesh = make_debug_mesh(2, 4, device="cpu")
    placed = sharded(params, mesh)
    loss, leaf_tree, grads = sharded_loss_and_grads(cfg, placed, batch, bf16_grads=False)
    forward_only = make_debug_mesh(2, 4, device="cpu")
    with use_mesh(forward_only):
        M.train_loss(cfg, sharded(params, forward_only), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(full_grads(placed, leaf_tree, grads)), want_grads):
        assert rel_l2(g, w) <= 1e-4
    assert sum(c for c, _ in mesh.log.values()) > sum(c for c, _ in forward_only.log.values())
