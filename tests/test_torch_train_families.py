"""Port parity: training on every model family (``models.model.train_loss``
and one ``train.step.make_train_step``) against the reference's
(``repro.models.model.train_loss``, ``jax.jit(make_train_step)``), at
``reduced()``: gemma2 (dense, softcap and window), granite-moe, zamba2,
xlstm, whisper (cross attention), qwen2-vl (the vision prefix masked out,
GQA group 2 here).

The reference's ``init_params(PRNGKey(0))`` weights are carried into the
port with ``convert.model_params_from_jax`` and its AdamW state with
``convert.adamw_state_from_jax``; tokens, frames and vision embeddings are
seeded numpy. The setting is the training step's own: bf16 gradients of
bf16 activations on both sides, so the loss is held to
tests/test_torch_families.py's rtol 0.05 / atol 0.1, and each leaf's
gradient to a relative L2 error of ``GRAD_REL_L2`` (0.05; 0.25 for the MoE,
whose router near ties send a token to other experts on either side, and
for xLSTM, whose exponential gates carry bf16 rounding through every
recurrent step; seen at most 0.18 and 0.15). tests/test_torch_train_f32.py
holds the same functions in float32 at 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.step import cast_tree as jax_cast_tree
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_arch
from repro_torch.convert import adamw_state_from_jax, model_params_from_jax
from repro_torch.train.step import loss_and_grads, make_train_step

NAMES = ("gemma2-27b", "granite-moe-1b-a400m", "zamba2-1.2b", "xlstm-350m",
         "whisper-medium", "qwen2-vl-2b")
RTOL, ATOL = 0.05, 0.1
GRAD_REL_L2 = {"moe": 0.25, "ssm": 0.25}  # the rest: 0.05
B, S = 2, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps this module off the cores the
    suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_batch(cfg, seed=0):
    """Seeded numpy tokens (B, S) and the family's modality input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.cross_len, cfg.d_model)
                                              ).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def seeded_state(params, step=5, seed=1):
    """A reference AdamW state some steps in: seeded moments (v >= 0)."""
    rng = np.random.default_rng(seed)
    st = jax_adamw_init(params)
    return st._replace(
        step=jnp.asarray(step, jnp.int32),
        m=jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2,
                                             jnp.float32), params),
        v=jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape) * 1e-4, jnp.float32),
                       params))


def jax_grads_and_step(jcfg, jparams, jstate, jbatch, bf16_grads: bool, **kw):
    """The reference's (loss, grads) of ``train_loss`` (w.r.t. a bf16 copy of
    the params when ``bf16_grads``) and one ``make_train_step`` from
    ``jstate``, in one jitted program (one compile)."""
    step = jax_make_train_step(jcfg, bf16_grads=bf16_grads, **kw)

    def both(p, st, b):
        grad_of = jax.value_and_grad(lambda q: JM.train_loss(jcfg, q, b))
        return grad_of(jax_cast_tree(p, jnp.bfloat16) if bf16_grads else p), step(p, st, b)
    return jax.jit(both)(jparams, jstate, jbatch)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check_grads(jgrads, grads, bound, what):
    """Every leaf's gradient non-zero on both sides, within ``bound``
    relative L2 of the reference's; returns {leaf: error}."""
    errs = {}
    for (path, jg), g in zip(jax.tree_util.tree_leaves_with_path(jgrads), grads):
        name = jax.tree_util.keystr(path)
        want = np.asarray(jnp.asarray(jg, jnp.float32))
        got = g.float().numpy()
        assert np.abs(want).max() > 0 and np.abs(got).max() > 0, f"{what}: {name} grad is 0"
        assert np.isfinite(got).all(), f"{what}: {name} grad not finite"
        errs[name] = rel_l2(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound, f"{what}: {worst} grad rel L2 {errs[worst]:.3g} > {bound}"
    return errs


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_grads_and_step_equal_reference(name):
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = train_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = seeded_state(jparams)
    kw = dict(peak_lr=1e-3, total_steps=50)
    (jloss, jgrads), (jp2, js2, jm) = jax_grads_and_step(jcfg, jparams, jstate, jbatch,
                                                          True, **kw)
    loss, grads = loss_and_grads(cfg, params, batch, bf16_grads=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    errs = check_grads(jgrads, grads, GRAD_REL_L2.get(cfg.family, 0.05), name)
    if cfg.family == "encdec":  # the cross k / v weights learn through the decoder
        assert errs["['dec_layers']['cross']['wk']"] <= 0.05
        assert errs["['dec_layers']['cross']['wv']"] <= 0.05

    # one training step from the same params and AdamW state
    state = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    p2, s2, m = make_train_step(cfg, bf16_grads=True, **kw)(params, state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=0.05)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(s2.step) == int(js2.step) == 6
