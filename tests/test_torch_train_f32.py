"""Port parity of training in float32: ``train_loss``, its gradients and one
``make_train_step`` (``bf16_grads=False``) on every family at ``reduced()``,
with the activations in float32 on both sides (each model module's
``ACT_DTYPE`` set to float32 for the test), against the reference.

In bf16 (tests/test_torch_train_families.py) rounding hides small errors
in the algorithm; here both sides compute the same float32 function, so
the loss agrees to rtol 1e-5, each leaf's gradient to a relative L2 error
of 1e-3 (seen at most 7e-5: zamba2's A_log, through the Mamba-2 decay's
exp and cumsum) and the step's new params, moments, gnorm and lr to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import adamw_state_from_jax, model_params_from_jax
from repro_torch.models import model as M
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import loss_and_grads, make_train_step
from test_torch_train_families import (NAMES, check_grads, jax_grads_and_step, rel_l2,
                                       seeded_state, train_batch)

GRAD_REL_L2, RTOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _float32_activations(monkeypatch):
    monkeypatch.setattr(JM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(M, "ACT_DTYPE", torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_equals_reference_in_float32(name):
    jcfg, cfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = model_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = train_batch(cfg, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = seeded_state(jparams)
    kw = dict(peak_lr=1e-3, total_steps=50)
    (jloss, jgrads), (jp2, js2, jm) = jax_grads_and_step(jcfg, jparams, jstate, jbatch,
                                                          False, **kw)
    loss, grads = loss_and_grads(cfg, params, batch, bf16_grads=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    check_grads(jgrads, grads, GRAD_REL_L2, name)

    state = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    p2, s2, m = make_train_step(cfg, bf16_grads=False, **kw)(params, state, batch)
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL, err_msg=key)
    # the update (new - old) of every leaf, and the new moments
    for tree, jtree, old in ((p2, jp2, params), (s2.m, js2.m, None), (s2.v, js2.v, None)):
        olds = tree_leaves(old) if old is not None else [0.0] * len(tree_leaves(tree))
        for got, want, o in zip(tree_leaves(tree), jax.tree.leaves(jtree), olds):
            assert rel_l2(got - o, np.asarray(want) - np.asarray(o)) <= RTOL
