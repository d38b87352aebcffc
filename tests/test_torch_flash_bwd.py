"""Port parity: the flash-attention backward's plain versions
(``attention_lse_ref``, ``attention_bwd_ref``) against ``jax.vjp`` of the
reference's attention, and the autograd function around the kernel
(``FlashAttentionFn``) on the CPU.

The reference has no attention backward of its own: XLA differentiates its
pure-JAX attention. So the plain backward is held, on the backward grid of
``repro_torch.kernels.parity`` (the cases ``chip_smoke.py`` runs on the
card), to ``jax.vjp`` of ``repro.kernels.flash_attention.ref.attention_ref``
and of ``repro.models.attention.dense_attention`` (the function the
reference trains through), in float32 at rtol 1e-4 / atol 1e-5: both sides
sum the same float32 products in another order. The lse is held to JAX's
``logsumexp`` over the same masked scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import dense_attention as jax_dense_attention
from repro_torch.kernels.flash_attention.kernel import (FlashAttentionFn, flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
from repro_torch.kernels.parity import (FLASH_BWD_CASES, flash_bwd_case_arrays,
                                        flash_bwd_kwargs)

RTOL, ATOL = 1e-4, 1e-5
NO_WINDOW = 1 << 30


def _jax_lse(q, k, causal, window, softcap):
    """logsumexp of the reference's masked scores (attention_ref's math)."""
    B, Hq, Sq, d = q.shape
    Skv = k.shape[2]
    kk = jnp.repeat(k, Hq // k.shape[1], axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kk) * d ** -0.5
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    qpos = jnp.arange(Sq)[:, None] + (Skv - Sq)
    kpos = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)


def _jax_vjp(fn, q, k, v, dout):
    """(fn(q, k, v), its vjp at dout), jitted: one compile per case instead
    of one per operation."""
    @jax.jit
    def both(a, b, c, g):
        out, vjp = jax.vjp(fn, a, b, c)
        return out, vjp(g)
    return both(q, k, v, dout)


def _torch_grads(name):
    q, k, v, dout = (torch.as_tensor(x) for x in flash_bwd_case_arrays(name))
    kw = flash_bwd_kwargs(name)
    out, lse = attention_lse_ref(q, k, v, **kw)
    return out, lse, attention_bwd_ref(q, k, v, out, lse, dout, **kw)


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_plain_backward_equals_vjp_of_attention_ref(name):
    q, k, v, dout = flash_bwd_case_arrays(name)
    kw = flash_bwd_kwargs(name)
    out, lse, grads = _torch_grads(name)
    want_out, want = _jax_vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw), q, k, v, dout)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.jit(_jax_lse, static_argnums=(
        2, 3, 4))(q, k, kw["causal"], kw["window"], kw["softcap"])), rtol=RTOL, atol=ATOL)
    for got, want, what in zip(grads, want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{what}")


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_plain_backward_equals_vjp_of_dense_attention(name):
    """The models' attention, (B, S, H, d) layout: q at offset Skv - Sq, the
    window NO_WINDOW where the kernel's is 0."""
    q, k, v, dout = (np.swapaxes(x, 1, 2) for x in flash_bwd_case_arrays(name))
    kw = flash_bwd_kwargs(name)
    Sq, Skv = q.shape[1], k.shape[1]
    jkw = dict(causal=kw["causal"], window=kw["window"] or NO_WINDOW,
               softcap=kw["softcap"], q_offset=Skv - Sq)
    _, want = _jax_vjp(lambda a, b, c: jax_dense_attention(a, b, c, **jkw), q, k, v, dout)
    _, _, grads = _torch_grads(name)
    for got, want, what in zip(grads, want, "qkv"):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=f"d{what}")


@pytest.mark.parametrize("kw", [dict(causal=True, window=0, softcap=0.0),
                                dict(causal=True, window=3, softcap=5.0),
                                dict(causal=False, window=0, softcap=0.0)],
                         ids=["causal", "window_cap", "full"])
def test_flash_attention_fn_gradcheck(kw):
    """FlashAttentionFn's backward (``attention_bwd_ref`` on the CPU) against
    finite differences in float64, GQA group 2 and Sq < Skv."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((1, 4, 5, 8), (1, 2, 7, 8), (1, 2, 7, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, kw["causal"], kw["window"],
                                               kw["softcap"], 0.35), (q, k, v))


def test_flash_attention_takes_the_autograd_function_only_under_grad():
    q, k, v, dout = (torch.as_tensor(x) for x in flash_bwd_case_arrays("granite_heads"))
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qg, kg, vg)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    with torch.no_grad():
        assert flash_attention(qg, kg, vg).grad_fn is None
    out.backward(dout)
    out_ref, lse = attention_lse_ref(q, k, v)
    for got, want in zip((qg.grad, kg.grad, vg.grad),
                         flash_attention_bwd(q, k, v, out_ref, lse, dout)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
