"""Mamba-2 (SSD) block, as in ``repro.models.ssm``: a chunked parallel scan
for prefill and a one-step recurrence for decode (arXiv:2405.21060,
'minimal SSD' form).

State: h (B, H, P, N) per head; x is chunked along time, within-chunk terms
use the quadratic (attention-like) form with the segment-sum decay matrix,
and the across-chunk state is carried by a loop over the chunks — O(S·Q)
work, O(Q²) memory. The decay terms (``_segsum``, the state) stay in
float32 with -inf masks, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm


class SSMCache(NamedTuple):
    h: torch.Tensor       # (B, H, P, N)
    conv: torch.Tensor    # (B, K-1, conv_dim)


def init_mamba2(generator: torch.Generator, d_model: int, d_state: int, expand: int,
                headdim: int, d_conv: int, dtype=torch.float32,
                layers: tuple[int, ...] = ()) -> dict:
    """One Mamba-2 block's parameters; ``layers`` stacks them along leading
    axes."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * d_state
    n, dev = len(layers), generator.device

    def full(value, *shape):
        return torch.full((*layers, *shape), value, dtype=dtype, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)).to(dtype)
    return {
        "in_proj": dense_init(generator, (*layers, d_model,
                                          2 * d_inner + 2 * d_state + n_heads), n, dtype),
        "conv_w": torch.empty((*layers, d_conv, conv_dim), dtype=dtype,
                              device=dev).normal_(0.0, 0.1, generator=generator),
        "conv_b": full(0.0, conv_dim),
        "A_log": a_log.expand(*layers, n_heads).clone(),
        "D": full(1.0, n_heads),
        "dt_bias": full(0.0, n_heads),
        "norm_scale": full(0.0, d_inner),
        "out_proj": dense_init(generator, (*layers, d_inner, d_model), n, dtype),
    }


def _split_proj(cfg_dims, zxbcdt: torch.Tensor):
    d_inner, d_state, n_heads = cfg_dims
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state, n_heads], dim=-1)


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv, k = conv_w.shape[0]. conv_state: (B, k-1, C)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], k - 1, xBC.shape[-1]), dtype=xBC.dtype,
                          device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(full[:, i:i + S] * conv_w[i][None, None] for i in range(k))
    new_state = full[:, -(k - 1):] if k > 1 else pad
    return F.silu(out + conv_b[None, None]), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) lower-tri segment sums: out[i,j] = sum a[j+1..i]."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def mamba2_forward(params, x: torch.Tensor, d_state: int, expand: int, headdim: int,
                   cache: SSMCache | None = None, chunk: int = 128):
    """x: (B, S, D). Returns (y, new_cache); the cache given is not written."""
    B, S, D = x.shape
    d_inner = expand * D
    n_heads = d_inner // headdim
    dt_f = x.dtype
    f32 = torch.float32

    zxbcdt = x @ params["in_proj"].to(dt_f)
    z, xBC, dt = _split_proj((d_inner, d_state, n_heads), zxbcdt)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"].to(dt_f), params["conv_b"].to(dt_f),
                                 None if cache is None else cache.conv)
    xs, Bm, Cm = torch.split(xBC, [d_inner, d_state, d_state], dim=-1)
    xs = xs.reshape(B, S, n_heads, headdim)
    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (B, S, H)
    A = -torch.exp(params["A_log"].float())                         # (H,)
    Dp = params["D"].float()
    h0 = (cache.h.float() if cache is not None
          else torch.zeros((B, n_heads, headdim, d_state), dtype=f32, device=x.device))

    if S == 1:  # decode recurrence
        dA = torch.exp(dt[:, 0] * A[None, :])                       # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xs[:, 0].float())
        h = h0 * dA[:, :, None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
        y = y + Dp[None, :, None] * xs[:, 0].float()
        y = y.reshape(B, 1, d_inner).to(dt_f)
    else:
        Q = min(chunk, S)
        pad = (-S) % Q
        if pad:
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
        nC = (S + pad) // Q
        xs_c = xs.reshape(B, nC, Q, n_heads, headdim)
        B_c = Bm.reshape(B, nC, Q, d_state).float()
        C_c = Cm.reshape(B, nC, Q, d_state).float()
        dt_c = dt.reshape(B, nC, Q, n_heads)
        h, ys = h0, []
        for c in range(nC):
            xc, bc, cc, dtc = xs_c[:, c], B_c[:, c], C_c[:, c], dt_c[:, c]
            a_hq = (dtc * A[None, None, :]).permute(0, 2, 1)        # (B, H, Q)
            L = torch.exp(_segsum(a_hq))                            # (B, H, Q, Q)
            xdt = xc.float() * dtc[..., None]                       # (B, Q, H, P)
            # within-chunk (quadratic form)
            scores = torch.einsum("bqn,bkn->bqk", cc, bc)           # (B, Q, Q)
            y_diag = torch.einsum("bhqk,bqk,bkhp->bqhp", L, scores, xdt)
            # contribution of the incoming state
            cum = torch.cumsum(a_hq, dim=-1)                        # (B, H, Q)
            y_off = torch.einsum("bqn,bhpn,bhq->bqhp", cc, h, torch.exp(cum))
            # new state: decayed old + within-chunk accumulation
            decay_out = torch.exp(cum[..., -1:] - cum)              # (B, H, Q)
            h = h * torch.exp(cum[..., -1])[:, :, None, None] + torch.einsum(
                "bkn,bhk,bkhp->bhpn", bc, decay_out, xdt)
            ys.append(y_diag + y_off + Dp[None, None, :, None] * xc.float())
        y = torch.stack(ys, dim=1).reshape(B, nC * Q, d_inner)[:, :S].to(dt_f)

    y = y * F.silu(z)
    y = rms_norm(y, params["norm_scale"])
    out = y @ params["out_proj"].to(dt_f)
    return out, SSMCache(h=h.float(), conv=new_conv.float())
