"""Port parity: the training substrate (``repro_torch.train``: AdamW, the
cosine schedule, the train step's microbatching, checkpoints and the
fault-tolerant loop) against the reference's ``repro.train``, and the
counterparts of tests/test_train_substrate.py on the port.

The optimizer functions take the same seeded float32 tree on both sides
and agree to rtol 1e-6 (the same float32 arithmetic in the same order, up
to the global norm's summation order). Checkpoints: the port writes the
reference's layout (file names, manifest, bf16 tag) for the same tree, and
each package restores the other's.
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JOPT
from repro_torch.configs.base import get_arch
from repro_torch.convert import adamw_state_from_jax, model_params_from_jax
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import (AdamWState, adamw_init, adamw_update,
                                         clip_by_global_norm, cosine_schedule,
                                         tree_leaves, zero1_shardings)
from repro_torch.train.step import make_train_step

RTOL = 1e-6


def _tree(seed=0):
    """A seeded numpy tree of the models' shape: nested dicts, stacked and
    scalar-like leaves."""
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"attn": {"wq": rng.standard_normal((2, 8, 8)).astype(np.float32)},
                       "ln": rng.standard_normal((2, 8)).astype(np.float32)},
            "ln_final": rng.standard_normal((8,)).astype(np.float32)}


def _port(tree):
    return model_params_from_jax(tree, device="cpu")


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _close_trees(got, want, **kw):
    jl = [np.asarray(x) for x in jax.tree.leaves(want)]
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b, **kw)


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 10000])
def test_cosine_schedule_equals_reference(step):
    for kw in (dict(), dict(peak_lr=1e-3, warmup=100, total=10000)):
        want = JOPT.cosine_schedule(jnp.asarray(float(step)), **kw)
        got = cosine_schedule(torch.tensor(float(step)), **kw)
        _close(got, want)
    if step == 0:  # the reference warms up from 0: the first step has lr 0
        assert float(cosine_schedule(torch.tensor(0.0))) == 0.0


def test_clip_by_global_norm_equals_reference():
    tree = _tree(1)
    for max_norm in (1.0, 1e3):
        want, wgn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        got, gn = clip_by_global_norm(_port(tree), max_norm)
        _close(gn, wgn)
        _close_trees(got, want)


def test_adamw_update_equals_reference():
    """Three updates from a state with moments already in it, f32 and bf16
    params."""
    params, grads = _tree(2), _tree(3)
    jstate = JOPT.adamw_init(jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.asarray(4, jnp.int32),
                             m=jax.tree.map(lambda x: jnp.asarray(x) * 0.1, _tree(4)),
                             v=jax.tree.map(lambda x: jnp.asarray(x) ** 2 * 0.01, _tree(5)))
    state = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    jp, tp = jax.tree.map(jnp.asarray, params), _port(params)
    for i in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(x) * (i + 1), grads)
        jp, jstate, jgn = JOPT.adamw_update(jp, g, jstate, 1e-2)
        tp, state, gn = adamw_update(tp, _port(jax.tree.map(np.asarray, g)), state,
                                     torch.tensor(1e-2))
        _close(gn, jgn)
        _close_trees(tp, jp)
        _close_trees(state.m, jstate.m)
        _close_trees(state.v, jstate.v)
        assert int(state.step) == int(jstate.step)
    # bf16 params stay bf16, updated from their f32 values
    bp, bstate = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params), JOPT.adamw_init(
        jax.tree.map(jnp.asarray, params))
    want, _, _ = JOPT.adamw_update(bp, jax.tree.map(jnp.asarray, grads), bstate, 1e-2)
    got, _, _ = adamw_update(model_params_from_jax(jax.tree.map(np.asarray, bp), "cpu"),
                             _port(grads), adamw_init(_port(params)), 1e-2)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    # within one bf16 rounding of each other
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        _close(a.float(), np.asarray(b, np.float32), rtol=8e-3)


def test_zero1_shardings_names_the_model_sharding_item():
    """ZeRO-1 of the model sharding: each moment's spec widens its first
    free dim that divides the data axis; a data-sharded (fsdp) spec stays."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(4, 2, device="cpu")
    params = {"embed": torch.zeros(64, 16), "ln": torch.zeros(6), "wq": torch.zeros(8, 16)}
    z = zero1_shardings(param_shardings(params, mesh), params, mesh)
    assert tuple(z["embed"].spec) == ("data", "model")
    assert tuple(z["ln"].spec) == (None,)  # 6 rows do not divide 4
    assert tuple(z["wq"].spec) == ("data", "model")
    f = param_shardings(params, mesh, "fsdp")
    assert zero1_shardings(f, params, mesh)["embed"] is f["embed"]


# ---- the counterparts of tests/test_train_substrate.py ----------------------------


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]}, state, lr=0.05,
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2


def test_clip_global_norm():
    clipped, gn = clip_by_global_norm({"a": torch.ones(4) * 10.0}, 1.0)
    assert abs(float(gn) - 20.0) < 1e-4
    assert abs(float(torch.linalg.vector_norm(clipped["a"])) - 1.0) < 1e-4


def test_cosine_schedule_shape():
    assert float(cosine_schedule(torch.tensor(0.0), peak_lr=1.0, warmup=10, total=100)) == 0.0
    peak = float(cosine_schedule(torch.tensor(10.0), peak_lr=1.0, warmup=10, total=100))
    end = float(cosine_schedule(torch.tensor(100.0), peak_lr=1.0, warmup=10, total=100))
    assert peak > end >= 0.1 * 0.99


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    CKPT.save_checkpoint(str(tmp_path), 7, tree)
    assert CKPT.latest_step(str(tmp_path)) == 7
    restored = CKPT.restore_checkpoint(str(tmp_path), 7, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_keep_k(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        CKPT.save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert CKPT.list_checkpoints(str(tmp_path)) == [4, 5]


def test_train_loop_runs_and_loss_drops(tmp_path):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    tcfg = TrainConfig(steps=12, batch=4, seq_len=64, ckpt_dir=str(tmp_path),
                       ckpt_every=4, peak_lr=1e-3, device="cpu")
    res = train(cfg, tcfg)
    assert res.final_step == 12
    assert len(res.losses) == 12
    assert res.losses[-1] < res.losses[0]  # learns something on zipf data
    assert CKPT.latest_step(str(tmp_path)) == 12


def test_train_loop_recovers_from_failure(tmp_path):
    cfg = get_arch("xlstm-350m").reduced()
    tcfg = TrainConfig(steps=10, batch=2, seq_len=32, ckpt_dir=str(tmp_path),
                       ckpt_every=3, device="cpu")
    tripped = {"n": 0}

    def fail_once(step):
        if step == 7 and tripped["n"] == 0:
            tripped["n"] = 1
            return True
        return False

    res = train(cfg, tcfg, fail_injector=fail_once)
    assert res.restarts == 1
    assert res.final_step == 10


def test_data_pipeline_deterministic():
    p1, p2 = TokenPipeline(1000, 4, 16, seed=5), TokenPipeline(1000, 4, 16, seed=5)
    np.testing.assert_array_equal(p1.batch_at(3), p2.batch_at(3))
    assert not np.array_equal(p1.batch_at(3), p1.batch_at(4))
    pa = TokenPipeline(1000, 4, 16, dp_rank=0, dp_size=2, seed=5)
    pb = TokenPipeline(1000, 4, 16, dp_rank=1, dp_size=2, seed=5)
    assert not np.array_equal(pa.batch_at(0), pb.batch_at(0))


# ---- the step, checkpoints across packages, the loop's replay ---------------------


def test_microbatch_two_equals_one():
    """Two microbatches of 2 rows against one batch of 4: the mean of the
    halves' losses is the whole batch's (equal token counts), and the
    accumulated float32 gradients give the same update. bf16 activations
    round the halves and the whole differently: held at 1e-3 / 2e-3."""
    cfg = get_arch("gemma2-27b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": TokenPipeline(cfg.vocab_size, 4, 48, seed=1).batch_at(0)}
    out = {}
    for mb in (1, 2):
        st = adamw_init(params)
        out[mb] = make_train_step(cfg, microbatch=mb, peak_lr=1e-2, total_steps=10)(
            params, st._replace(step=st.step + 3), batch)
    (p1, s1, m1), (p2, s2, m2) = out[1], out[2]
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-3, atol=0)
    torch.testing.assert_close(m2["gnorm"], m1["gnorm"], rtol=2e-3, atol=0)
    assert float(m1["lr"]) == float(m2["lr"]) > 0
    for a, b in zip(tree_leaves(s2.m), tree_leaves(s1.m)):
        torch.testing.assert_close(a, b, rtol=0.05, atol=2e-5)
    assert int(s1.step) == int(s2.step) == 4


def _train_tree(cfg, seed=0):
    """(params, AdamWState) of ``cfg`` on both sides: the reference's, and
    the port's carried from it; one leaf in bf16."""
    jp = jax.tree.map(np.asarray, JM.init_params(jax_get_arch(cfg.name).reduced(),
                                                 jax.random.PRNGKey(seed)))
    jp["ln_final"] = jp["ln_final"].astype(jnp.bfloat16)
    jst = JOPT.adamw_init(jax.tree.map(jnp.asarray, jp))
    jst = jax.tree.map(np.asarray, jst._replace(step=jnp.asarray(11, jnp.int32)))
    return (jp, jst), (model_params_from_jax(jp, "cpu"), adamw_state_from_jax(jst, "cpu"))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_layout_equals_reference_and_restores_across(tmp_path):
    cfg = get_arch("qwen2-vl-2b").reduced()
    jtree, ttree = _train_tree(cfg)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCKPT.save_checkpoint(jd, 11, jtree)
    CKPT.save_checkpoint(td, 11, ttree)
    assert _manifest(td, 11) == _manifest(jd, 11)
    assert sorted(os.listdir(os.path.join(td, "step_00000011"))) == \
        sorted(os.listdir(os.path.join(jd, "step_00000011")))
    # the port restores the reference's checkpoint, leaf for leaf, bf16 included
    params, st = CKPT.restore_checkpoint(jd, 11, ttree)
    assert isinstance(st, AdamWState) and int(st.step) == 11
    assert params["ln_final"].dtype == torch.bfloat16
    for (name, got), (_, want) in zip(CKPT._leaf_paths((params, st)),
                                      JCKPT._leaf_paths(jtree)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=name)
    # and the reference restores the port's
    back = JCKPT.restore_checkpoint(td, 11, jax.tree.map(jnp.asarray, jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    # a tree of another configuration is refused, as the reference refuses it
    other = M.init_params(dataclasses.replace(cfg, d_model=64), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        CKPT.restore_checkpoint(jd, 11, (other, adamw_init(other)))


def test_async_checkpoint_lands(tmp_path):
    tree = {"a": torch.arange(5, dtype=torch.float32)}
    path = CKPT.save_checkpoint(str(tmp_path), 3, tree, async_write=True)
    tree["a"].add_(100)  # the leaves were copied before the call returned
    for _ in range(500):
        if CKPT.latest_step(str(tmp_path)) == 3:
            break
        time.sleep(0.01)
    assert path.endswith("step_00000003")
    assert torch.equal(CKPT.restore_checkpoint(str(tmp_path), 3, tree)["a"],
                       torch.arange(5, dtype=torch.float32))


def test_loop_replays_the_clean_run_after_a_failure(tmp_path):
    """One injected failure at step 5 of 8 (checkpoints every 2 steps): one
    restart, the losses after the restore equal the clean run's bit for bit
    (the restored float32 state, step-keyed data and a deterministic step),
    and whisper's frames are step-keyed too."""
    cfg = get_arch("whisper-medium").reduced()
    kw = dict(steps=8, batch=2, seq_len=24, ckpt_every=2, peak_lr=1e-3, device="cpu")
    clean = train(cfg, TrainConfig(ckpt_dir=str(tmp_path / "clean"), **kw))
    tripped = []

    def fail_at_5(step):
        if step == 5 and not tripped:
            tripped.append(step)
            return True
        return False

    failed = train(cfg, TrainConfig(ckpt_dir=str(tmp_path / "failed"), **kw),
                   fail_injector=fail_at_5)
    assert clean.restarts == 0 and failed.restarts == 1
    assert failed.final_step == clean.final_step == 8
    # steps 0-4 ran, the restore went back to step 4, then steps 4-7 ran
    assert failed.losses[:5] == clean.losses[:5]
    assert failed.losses[5:] == clean.losses[4:]


def test_loop_counts_a_non_finite_loss_as_a_failure(tmp_path, monkeypatch):
    """A NaN loss restores the latest checkpoint like any failure; past
    max_retries in a row the loop raises."""
    cfg = get_arch("gemma2-27b").reduced()
    import repro_torch.train.loop as L
    real = L.make_train_step

    def nan_at_3(cfg, **kw):
        step = real(cfg, **kw)
        seen = []

        def wrapped(params, opt, batch):
            p, o, m = step(params, opt, batch)
            if int(opt.step) == 3 and not seen:
                seen.append(1)
                m = dict(m, loss=torch.tensor(float("nan")))
            return p, o, m
        return wrapped

    monkeypatch.setattr(L, "make_train_step", nan_at_3)
    res = train(cfg, TrainConfig(steps=5, batch=2, seq_len=16, ckpt_every=2,
                                 ckpt_dir=str(tmp_path), device="cpu"))
    assert res.restarts == 1 and res.final_step == 5 and len(res.losses) == 6
    monkeypatch.setattr(L, "make_train_step", lambda cfg, **kw: (
        lambda p, o, b: (p, o, {"loss": torch.tensor(float("inf"))})))
    with pytest.raises(FloatingPointError):
        train(cfg, TrainConfig(steps=7, batch=2, seq_len=16, ckpt_every=2, max_retries=2,
                               ckpt_dir=str(tmp_path), device="cpu"))


def test_train_launcher_and_example_run_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` and
    examples/torch_train_embedder.py (checkpoint, injected failure, resume),
    cut short, with ``--device cpu``."""
    import importlib.util
    from repro_torch.launch.train import main as launch_main
    res = launch_main(["--device", "cpu", "--steps", "3", "--seq-len", "32", "--batch", "2",
                       "--ckpt-dir", str(tmp_path / "launch")])
    assert res.final_step == 3 and res.restarts == 0
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch_train_embedder.py")
    spec = importlib.util.spec_from_file_location("torch_train_embedder", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res = example.main(["--device", "cpu", "--steps", "16", "--ckpt", str(tmp_path / "ex")])
    assert res.restarts == 1 and res.final_step == 16
    assert "ok: trained through a failure" in capsys.readouterr().out
