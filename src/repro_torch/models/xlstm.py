"""xLSTM blocks (arXiv:2405.04517), as in ``repro.models.xlstm``: mLSTM
(matrix memory, parallelizable) and sLSTM (scalar memory with recurrent
gating, sequential by construction).

mLSTM prefills through a chunked stabilized form (exp-gated linear attention
with a running (C, n, m) chunk state carried by a loop over the chunks);
sLSTM loops over time (its recurrent gate inputs R·h_{t-1} admit no parallel
form). Both have O(1)-state decode steps. Gates, the stabiliser m and the
states stay in float32 with -inf masks, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm


class MLSTMCache(NamedTuple):
    C: torch.Tensor   # (B, H, P, P)
    n: torch.Tensor   # (B, H, P)
    m: torch.Tensor   # (B, H)


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)
    h: torch.Tensor   # (B, D)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float = 2.0, dtype=torch.float32,
               layers: tuple[int, ...] = ()) -> dict:
    """One mLSTM block's parameters; ``layers`` stacks them along leading axes."""
    d_inner = int(proj_factor * d_model)
    n, dev = len(layers), generator.device

    def w(*shape):
        return dense_init(generator, (*layers, *shape), n, dtype)

    return {
        "up_proj": w(d_model, 2 * d_inner),
        "q": w(d_inner, d_inner),
        "k": w(d_inner, d_inner),
        "v": w(d_inner, d_inner),
        "i_gate": w(d_inner, n_heads),
        "f_gate": w(d_inner, n_heads),
        # open forget gates at init
        "f_bias": torch.full((*layers, n_heads), 3.0, dtype=dtype, device=dev),
        "norm_scale": torch.zeros((*layers, d_inner), dtype=dtype, device=dev),
        "down_proj": w(d_inner, d_model),
    }


def mlstm_forward(params, x: torch.Tensor, n_heads: int,
                  cache: MLSTMCache | None = None, chunk: int = 64):
    """x: (B, S, D) -> (y, new_cache); the cache given is not written.
    Stabilized exp-gating (log-space m)."""
    B, S, D = x.shape
    dt_f = x.dtype
    f32 = torch.float32
    up = x @ params["up_proj"].to(dt_f)
    inner, z = torch.chunk(up, 2, dim=-1)
    d_inner = inner.shape[-1]
    P = d_inner // n_heads

    def heads(t):
        return t.reshape(B, S, n_heads, P)

    q = heads(inner @ params["q"].to(dt_f)).float() * (P ** -0.5)
    k = heads(inner @ params["k"].to(dt_f)).float()
    v = heads(inner @ params["v"].to(dt_f)).float()
    logf = F.logsigmoid((inner @ params["f_gate"].to(dt_f)).float()
                        + params["f_bias"].float())                 # (B, S, H)
    logi = (inner @ params["i_gate"].to(dt_f)).float()

    zeros = dict(dtype=f32, device=x.device)
    C0 = cache.C if cache is not None else torch.zeros((B, n_heads, P, P), **zeros)
    n0 = cache.n if cache is not None else torch.zeros((B, n_heads, P), **zeros)
    m0 = cache.m if cache is not None else torch.full((B, n_heads), -30.0, **zeros)

    if S == 1:
        m_new = torch.maximum(logf[:, 0] + m0, logi[:, 0])
        fw = torch.exp(logf[:, 0] + m0 - m_new)
        iw = torch.exp(logi[:, 0] - m_new)
        C = C0 * fw[..., None, None] + torch.einsum("bhp,bhq->bhpq", v[:, 0],
                                                    k[:, 0] * iw[..., None])
        n = n0 * fw[..., None] + k[:, 0] * iw[..., None]
        num = torch.einsum("bhpq,bhq->bhp", C, q[:, 0])
        den = torch.abs(torch.einsum("bhq,bhq->bh", n, q[:, 0]))
        y = (num / den.clamp(min=1.0)[..., None]).reshape(B, 1, d_inner)
        Cn, nn, mn = C, n, m_new
    else:
        Q = min(chunk, S)
        pad = (-S) % Q
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            logf = F.pad(logf, (0, 0, 0, pad))
            logi = F.pad(logi, (0, 0, 0, pad), value=-30.0)
        nC = (S + pad) // Q
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
        C, n, m = C0, n0, m0
        ys = []
        for c in range(nC):
            sl = slice(c * Q, (c + 1) * Q)
            fH = logf[:, sl].permute(0, 2, 1)                       # (B, H, Q)
            iH = logi[:, sl].permute(0, 2, 1)
            cumf = torch.cumsum(fH, dim=-1)                         # (B, H, Q)
            # log decay from step j (exclusive) to i: cumf_i - cumf_j
            lD = cumf[..., :, None] - cumf[..., None, :] + iH[..., None, :]
            lD = lD.masked_fill(~tri, float("-inf"))                # (B, H, Q, Q)
            l_in = cumf + m[..., None]                              # carry contribution
            m_row = torch.maximum(lD.amax(dim=-1), l_in)            # (B, H, Q)
            Dmat = torch.exp(lD - m_row[..., None])
            carry_w = torch.exp(l_in - m_row)                       # (B, H, Q)
            qH = q[:, sl].permute(0, 2, 1, 3)                       # (B, H, Q, P)
            kH = k[:, sl].permute(0, 2, 1, 3)
            vH = v[:, sl].permute(0, 2, 1, 3)
            scores = torch.einsum("bhqp,bhkp->bhqk", qH, kH) * Dmat
            # carry: y += (C @ q) — q contracts C's k-dim (second axis)
            num = torch.einsum("bhqk,bhkp->bhqp", scores, vH) + \
                torch.einsum("bhqr,bhpr,bhq->bhqp", qH, C, carry_w)
            den_raw = scores.sum(dim=-1) + \
                torch.einsum("bhqp,bhp,bhq->bhq", qH, n, carry_w)
            y = num / torch.abs(den_raw).clamp(min=1.0)[..., None]
            # chunk-end state
            m_end = torch.maximum(cumf[..., -1] + m,
                                  (cumf[..., -1:] - cumf + iH).amax(dim=-1))
            wC = torch.exp(cumf[..., -1] + m - m_end)               # (B, H)
            wk = torch.exp(cumf[..., -1:] - cumf + iH - m_end[..., None])  # (B, H, Q)
            C = C * wC[..., None, None] + torch.einsum("bhkp,bhk,bhkr->bhpr", vH, wk, kH)
            n = n * wC[..., None] + torch.einsum("bhk,bhkp->bhp", wk, kH)
            m = m_end
            ys.append(y.permute(0, 2, 1, 3))                        # (B, Q, H, P)
        y = torch.stack(ys, dim=1).reshape(B, nC * Q, d_inner)[:, :S]
        Cn, nn, mn = C, n, m

    y = rms_norm(y.to(dt_f), params["norm_scale"])
    y = y * F.silu(z)
    out = y @ params["down_proj"].to(dt_f)
    return out, MLSTMCache(C=Cn, n=nn, m=mn)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, d_model: int, dtype=torch.float32,
               layers: tuple[int, ...] = ()) -> dict:
    """One sLSTM block's parameters; ``layers`` stacks them along leading axes."""
    n, dev = len(layers), generator.device
    r_rec = dense_init(generator, (*layers, d_model, 4 * d_model), n, dtype)
    return {
        "w_in": dense_init(generator, (*layers, d_model, 4 * d_model), n, dtype),
        "r_rec": r_rec * 0.1,
        "bias": torch.zeros((*layers, 4 * d_model), dtype=dtype, device=dev),
        "norm_scale": torch.zeros((*layers, d_model), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (*layers, d_model, d_model), n, dtype),
    }


def slstm_forward(params, x: torch.Tensor, cache: SLSTMCache | None = None):
    """x: (B, S, D) -> (y, new_cache). A loop over time (recurrent gates);
    the cache given is not written."""
    B, S, D = x.shape
    dt_f = x.dtype
    pre = (x @ params["w_in"].to(dt_f)).float() + params["bias"].float()
    zeros = dict(dtype=torch.float32, device=x.device)
    if cache is not None:
        c, n, m, h = cache
    else:
        c, n, m, h = (torch.zeros((B, D), **zeros), torch.ones((B, D), **zeros),
                      torch.zeros((B, D), **zeros), torch.zeros((B, D), **zeros))
    R = params["r_rec"].float()
    ys = []
    for t in range(S):
        g = pre[:, t] + h @ R
        zi, ii, fi, oi = torch.chunk(g, 4, dim=-1)
        logf = F.logsigmoid(fi)
        m_new = torch.maximum(logf + m, ii)
        fw = torch.exp(logf + m - m_new)
        iw = torch.exp(ii - m_new)
        c = fw * c + iw * torch.tanh(zi)
        n = fw * n + iw
        h = torch.sigmoid(oi) * (c / n.clamp(min=1e-6))
        m = m_new
        ys.append(h)
    y = torch.stack(ys, dim=1).to(dt_f)
    y = rms_norm(y, params["norm_scale"])
    out = y @ params["out_proj"].to(dt_f)
    return out, SLSTMCache(c=c, n=n, m=m, h=h)
