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


def _ssd(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Dp: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor, h0: torch.Tensor, chunk: int):
    """The SSD scan over the heads it is given: xs (B, S, H, P), dt (B, S,
    H) float32 (after softplus), A / Dp (H,), the shared Bm / Cm (B, S, N)
    and the incoming state h0 (B, H, P, N) float32. S = 1 is the decode
    recurrence, else the chunked scan. Returns (y (B, S, H * P) float32,
    the new state)."""
    B, S, H, P = xs.shape
    if S == 1:  # decode recurrence
        dA = torch.exp(dt[:, 0] * A[None, :])                       # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xs[:, 0].float())
        h = h0 * dA[:, :, None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
        y = y + Dp[None, :, None] * xs[:, 0].float()
        return y.reshape(B, 1, H * P), h
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nC = (S + pad) // Q
    xs_c = xs.reshape(B, nC, Q, H, P)
    B_c = Bm.reshape(B, nC, Q, N).float()
    C_c = Cm.reshape(B, nC, Q, N).float()
    dt_c = dt.reshape(B, nC, Q, H)
    h, ys = h0, []
    for c in range(nC):
        xc, bc, cc, dtc = xs_c[:, c], B_c[:, c], C_c[:, c], dt_c[:, c]
        a_hq = (dtc * A[None, None, :]).permute(0, 2, 1)            # (B, H, Q)
        L = torch.exp(_segsum(a_hq))                                # (B, H, Q, Q)
        xdt = xc.float() * dtc[..., None]                           # (B, Q, H, P)
        # within-chunk (quadratic form)
        scores = torch.einsum("bqn,bkn->bqk", cc, bc)               # (B, Q, Q)
        y_diag = torch.einsum("bhqk,bqk,bkhp->bqhp", L, scores, xdt)
        # contribution of the incoming state
        cum = torch.cumsum(a_hq, dim=-1)                            # (B, H, Q)
        y_off = torch.einsum("bqn,bhpn,bhq->bqhp", cc, h, torch.exp(cum))
        # new state: decayed old + within-chunk accumulation
        decay_out = torch.exp(cum[..., -1:] - cum)                  # (B, H, Q)
        h = h * torch.exp(cum[..., -1])[:, :, None, None] + torch.einsum(
            "bkn,bhk,bkhp->bhpn", bc, decay_out, xdt)
        ys.append(y_diag + y_off + Dp[None, None, :, None] * xc.float())
    return torch.stack(ys, dim=1).reshape(B, nC * Q, H * P)[:, :S], h


def mamba2_forward(params, x: torch.Tensor, d_state: int, expand: int, headdim: int,
                   cache: SSMCache | None = None, chunk: int = 128):
    """x: (B, S, D). Returns (y, new_cache); the cache given is not written."""
    B, S, D = x.shape
    d_inner = expand * D
    n_heads = d_inner // headdim
    dt_f = x.dtype

    zxbcdt = x @ params["in_proj"].to(dt_f)
    z, xBC, dt = _split_proj((d_inner, d_state, n_heads), zxbcdt)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"].to(dt_f), params["conv_b"].to(dt_f),
                                 None if cache is None else cache.conv)
    xs, Bm, Cm = torch.split(xBC, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (B, S, H)
    h0 = (cache.h.float() if cache is not None
          else torch.zeros((B, n_heads, headdim, d_state), dtype=torch.float32,
                           device=x.device))
    y, h = _ssd(xs.reshape(B, S, n_heads, headdim), dt, -torch.exp(params["A_log"].float()),
                params["D"].float(), Bm, Cm, h0, chunk)
    y = y.to(dt_f) * F.silu(z)
    y = rms_norm(y, params["norm_scale"])
    out = y @ params["out_proj"].to(dt_f)
    return out, SSMCache(h=h.float(), conv=new_conv.float())


def mamba2_tp(ctx, p: dict, x: torch.Tensor, d: int, d_state: int, expand: int,
              headdim: int, cache: list | None = None, split: bool = False,
              chunk: int = 128):
    """``mamba2_forward`` of data rank ``d`` split by head over its model
    ranks (``distributed.tensor_parallel``): ``p`` holds each leaf's
    per-rank blocks (``ShardCtx.view``), ``x`` (B, S, D) is the data rank's
    whole input, ``cache[m]`` model rank m's replica of the layer's state.
    Rank m owns the heads ``head_range`` gives it and multiplies only by
    the ``in_proj`` columns they read: its heads' z, x and dt and the
    shared B and C (``col_product``: columns outside its block move as
    weights or as products, whichever is fewer bytes); the depthwise conv
    (replicated weights) runs on its channels and B / C, the scan on its
    heads, the gated RMSNorm over all of d_inner from a psum of sums of
    squares, and ``out_proj`` row-parallel over its heads' rows
    (``row_product``), ending in ``row_end`` (a reduce-scatter when
    ``split``). A generator for ``tensor_parallel.each_grouped``: it yields
    its model ranks' scans as one ``Batch`` and returns (out, per model rank
    its new state pieces (h of its heads, conv of its channels), None where
    it owns no head)."""
    from repro_torch.distributed import tensor_parallel as TP
    B, S, D = x.shape
    d_inner = expand * D
    H = d_inner // headdim
    n = len(p["in_proj"])
    N_in = 2 * d_inner + 2 * d_state + H
    heads = [TP.head_range(H, n, m) for m in range(n)]
    bc = (2 * d_inner, 2 * d_inner + 2 * d_state)
    dt0 = 2 * d_inner + 2 * d_state
    want = [[(a * headdim, b * headdim), (d_inner + a * headdim, d_inner + b * headdim), bc,
             (dt0 + a, dt0 + b)] if b > a else [] for a, b in heads]
    zxbcdt = TP.col_product(ctx, x, p["in_proj"], N_in, d, want)
    dt_f = x.dtype
    scans, convs, zs = {}, {}, {}
    for m, (a, b) in enumerate(heads):
        if b == a:
            continue
        c = (b - a) * headdim
        z, xs, BC, dt = torch.split(zxbcdt[m], [c, c, 2 * d_state, b - a], dim=-1)
        def chans(t):  # the rank's x channels and B / C of a conv-channel dim
            return torch.cat([t[..., a * headdim:b * headdim],
                              t[..., d_inner:d_inner + 2 * d_state]], -1)
        xBC, new_conv = _causal_conv(torch.cat([xs, BC], -1), chans(p["conv_w"][m].to(dt_f)),
                                     chans(p["conv_b"][m].to(dt_f)),
                                     None if cache is None else chans(cache[m].conv).to(xs.device))
        xs, Bm, Cm = torch.split(xBC, [c, d_state, d_state], dim=-1)
        dt = F.softplus(dt.float() + p["dt_bias"][m][a:b].float())
        h0 = (cache[m].h[:, a:b].float().to(xs.device) if cache is not None
              else torch.zeros((B, b - a, headdim, d_state), dtype=torch.float32,
                               device=xs.device))
        scans[m] = (xs.reshape(B, S, b - a, headdim), dt, -torch.exp(p["A_log"][m][a:b].float()),
                    p["D"][m][a:b].float(), Bm, Cm, h0, chunk)
        convs[m], zs[m] = new_conv, z
    # the scan over each rank's heads (ranks sharing a device: one scan)
    done = yield TP.Batch(scans, (2, 2, 0, 0, None, None, 1, None),
                          (True, True, False, False, True, True, True, False), _ssd,
                          ((-1, headdim), (1, 1)), {m: b - a for m, (a, b) in enumerate(heads)})
    ys = [None if m not in done else done[m][0].to(dt_f) * F.silu(zs[m]) for m in range(n)]
    news = [None if m not in done else SSMCache(h=done[m][1].float(), conv=convs[m].float())
            for m in range(n)]
    scales = [None if b == a else p["norm_scale"][m][a * headdim:b * headdim]
              for m, (a, b) in enumerate(heads)]
    ys = TP.split_rms_norm(ctx, ys, scales, d_inner, d)
    have = [[(a * headdim, b * headdim)] if b > a else [] for a, b in heads]
    return TP.row_product(ctx, ys, have, p["out_proj"], d_inner, d, split), news
