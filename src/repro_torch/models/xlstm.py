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


def _mlstm_cells(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logf: torch.Tensor,
                 logi: torch.Tensor, C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                 chunk: int):
    """The mLSTM recurrence over the heads it is given: q (scaled), k, v
    (B, S, H, P) float32, the gates' logs (B, S, H), the incoming (C, n, m).
    S = 1 is the decode step, else the chunked stabilized form. Returns (y
    (B, S, H * P) float32, C, n, m)."""
    B, S, H, P = q.shape
    if S == 1:
        m_new = torch.maximum(logf[:, 0] + m0, logi[:, 0])
        fw = torch.exp(logf[:, 0] + m0 - m_new)
        iw = torch.exp(logi[:, 0] - m_new)
        C = C0 * fw[..., None, None] + torch.einsum("bhp,bhq->bhpq", v[:, 0],
                                                    k[:, 0] * iw[..., None])
        n = n0 * fw[..., None] + k[:, 0] * iw[..., None]
        num = torch.einsum("bhpq,bhq->bhp", C, q[:, 0])
        den = torch.abs(torch.einsum("bhq,bhq->bh", n, q[:, 0]))
        return (num / den.clamp(min=1.0)[..., None]).reshape(B, 1, H * P), C, n, m_new
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))
        logi = F.pad(logi, (0, 0, 0, pad), value=-30.0)
    nC = (S + pad) // Q
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    C, n, m = C0, n0, m0
    ys = []
    for c in range(nC):
        sl = slice(c * Q, (c + 1) * Q)
        fH = logf[:, sl].permute(0, 2, 1)                           # (B, H, Q)
        iH = logi[:, sl].permute(0, 2, 1)
        cumf = torch.cumsum(fH, dim=-1)                             # (B, H, Q)
        # log decay from step j (exclusive) to i: cumf_i - cumf_j
        lD = cumf[..., :, None] - cumf[..., None, :] + iH[..., None, :]
        lD = lD.masked_fill(~tri, float("-inf"))                    # (B, H, Q, Q)
        l_in = cumf + m[..., None]                                  # carry contribution
        m_row = torch.maximum(lD.amax(dim=-1), l_in)                # (B, H, Q)
        Dmat = torch.exp(lD - m_row[..., None])
        carry_w = torch.exp(l_in - m_row)                           # (B, H, Q)
        qH = q[:, sl].permute(0, 2, 1, 3)                           # (B, H, Q, P)
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
        wC = torch.exp(cumf[..., -1] + m - m_end)                   # (B, H)
        wk = torch.exp(cumf[..., -1:] - cumf + iH - m_end[..., None])  # (B, H, Q)
        C = C * wC[..., None, None] + torch.einsum("bhkp,bhk,bhkr->bhpr", vH, wk, kH)
        n = n * wC[..., None] + torch.einsum("bhk,bhkp->bhp", wk, kH)
        m = m_end
        ys.append(y.permute(0, 2, 1, 3))                            # (B, Q, H, P)
    return torch.stack(ys, dim=1).reshape(B, nC * Q, H * P)[:, :S], C, n, m


def _mlstm_state(B: int, H: int, P: int, device):
    zeros = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, H, P, P), **zeros), torch.zeros((B, H, P), **zeros),
            torch.full((B, H), -30.0, **zeros))


def mlstm_forward(params, x: torch.Tensor, n_heads: int,
                  cache: MLSTMCache | None = None, chunk: int = 64):
    """x: (B, S, D) -> (y, new_cache); the cache given is not written.
    Stabilized exp-gating (log-space m)."""
    B, S, D = x.shape
    dt_f = x.dtype
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
    state = _mlstm_state(B, n_heads, P, x.device) if cache is None else cache
    y, Cn, nn, mn = _mlstm_cells(q, k, v, logf, logi, *state, chunk)
    y = rms_norm(y.to(dt_f), params["norm_scale"])
    y = y * F.silu(z)
    out = y @ params["down_proj"].to(dt_f)
    return out, MLSTMCache(C=Cn, n=nn, m=mn)


def mlstm_tp(ctx, p: dict, x: torch.Tensor, d: int, n_heads: int, cache: list | None = None,
             split: bool = False, chunk: int = 64):
    """``mlstm_forward`` of data rank ``d`` split by head over its model
    ranks (``distributed.tensor_parallel``): ``p`` holds each leaf's
    per-rank blocks, ``x`` (B, S, D) is the data rank's whole input,
    ``cache[m]`` model rank m's replica of the layer's state. ``q`` / ``k``
    / ``v`` / the gates read all of ``inner``, so ``up_proj``'s inner half
    is all-gathered (``col_gather``: as products, or as its columns where
    they are fewer bytes); rank m (``head_range``) takes its heads' z
    columns of ``up_proj`` and its heads' columns of ``q`` / ``k`` / ``v``
    (``col_product``) and of the replicated gates, runs the recurrence on
    its heads' (C, n, m), the RMSNorm over all of d_inner from a psum of
    sums of squares, and ``down_proj`` row-parallel (``row_product``,
    ending in ``row_end``). A rank past the last head launches nothing of
    its own. A generator for ``tensor_parallel.each_grouped`` (it yields
    the recurrences as one ``Batch``) that returns (out, per model rank its
    heads' new state or None)."""
    from repro_torch.distributed import tensor_parallel as TP
    B, S, D = x.shape
    dt_f = x.dtype
    d_inner = p["q"][0].shape[0]
    P = d_inner // n_heads
    heads = [TP.head_range(n_heads, len(p["q"]), m) for m in range(len(p["q"]))]
    inner = TP.col_gather(ctx, x, p["up_proj"], 2 * d_inner, d, 0, d_inner)
    zs = TP.col_product(ctx, x, p["up_proj"], 2 * d_inner, d,
                        [[(d_inner + a * P, d_inner + b * P)] if b > a else [] for a, b in heads])
    have = [[(a * P, b * P)] if b > a else [] for a, b in heads]
    q, k, v = (TP.col_product(ctx, inner, p[w], d_inner, d, have) for w in ("q", "k", "v"))
    cells = {}
    for m, (a, b) in enumerate(heads):
        if b == a:
            continue
        xm = inner.to(q[m].device)

        def hs(t):
            return t.reshape(B, S, b - a, P).float()
        logf = F.logsigmoid((xm @ p["f_gate"][m][:, a:b].to(dt_f)).float()
                            + p["f_bias"][m][a:b].float())
        logi = (xm @ p["i_gate"][m][:, a:b].to(dt_f)).float()
        state = (_mlstm_state(B, b - a, P, xm.device) if cache is None else
                 tuple(t[:, a:b].to(xm.device) for t in cache[m]))
        cells[m] = (hs(q[m]) * (P ** -0.5), hs(k[m]), hs(v[m]), logf, logi, *state, chunk)
    # the recurrence over each rank's heads (ranks sharing a device: one loop)
    done = yield TP.Batch(cells, (2, 2, 2, 2, 2, 1, 1, 1, None), (True,) * 9, _mlstm_cells,
                          ((-1, P), (1, 1), (1, 1), (1, 1)),
                          {m: b - a for m, (a, b) in enumerate(heads)})
    ys = [None if m not in done else done[m][0].to(dt_f) for m in range(len(heads))]
    news = [None if m not in done else MLSTMCache(*done[m][1:]) for m in range(len(heads))]
    ys = TP.split_rms_norm(ctx, ys, [None if b == a else p["norm_scale"][m][a * P:b * P]
                                     for m, (a, b) in enumerate(heads)], d_inner, d)
    ys = [None if y is None else y * F.silu(z) for y, z in zip(ys, zs)]
    return TP.row_product(ctx, ys, have, p["down_proj"], d_inner, d, split), news


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


def _slstm_state(B: int, D: int, device) -> SLSTMCache:
    zeros = dict(dtype=torch.float32, device=device)
    return SLSTMCache(c=torch.zeros((B, D), **zeros), n=torch.ones((B, D), **zeros),
                      m=torch.zeros((B, D), **zeros), h=torch.zeros((B, D), **zeros))


def _slstm_scan(pre: torch.Tensor, R: torch.Tensor, state):
    """The sLSTM's loop over time for the rows it is given: pre (B, S, 4D)
    float32, R (D, 4D) float32, the incoming (c, n, m, h). Returns (h of
    every step (B, S, D) float32, the new state)."""
    c, n, m, h = state
    ys = []
    for t in range(pre.shape[1]):
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
    return torch.stack(ys, dim=1), SLSTMCache(c=c, n=n, m=m, h=h)


def slstm_forward(params, x: torch.Tensor, cache: SLSTMCache | None = None):
    """x: (B, S, D) -> (y, new_cache). A loop over time (recurrent gates);
    the cache given is not written."""
    B, S, D = x.shape
    dt_f = x.dtype
    pre = (x @ params["w_in"].to(dt_f)).float() + params["bias"].float()
    y, new = _slstm_scan(pre, params["r_rec"].float(),
                         _slstm_state(B, D, x.device) if cache is None else cache)
    y = rms_norm(y.to(dt_f), params["norm_scale"])
    out = y @ params["out_proj"].to(dt_f)
    return out, new


def slstm_tp(ctx, p: dict, x: torch.Tensor, d: int, cache: list | None = None,
             split: bool = False):
    """``slstm_forward`` of data rank ``d`` over its model ranks
    (``distributed.tensor_parallel``): ``p`` holds each leaf's per-rank
    blocks, ``x`` (B, S, D) is the data rank's whole input, ``cache[m]``
    model rank m's replica of the layer's state. ``r_rec`` is dense and
    replicated, so every step couples all units and the units cannot split
    without a collective a step; the rows can. So each rank multiplies by
    its own ``w_in`` column block, an all-to-all over ``model`` gives rank
    m whole gate rows for its block of the batch rows (``block_ranges``;
    a rank past the last row launches nothing), it runs the loop over time
    and the RMSNorm on those rows, an all-to-all gives each rank its block
    of units of every row, and ``out_proj`` runs row-parallel, ending in
    ``row_end``. A generator for ``tensor_parallel.each_grouped`` (it
    yields the loops as one ``Batch``: ranks that share a device, a debug
    mesh, run their rows as one loop) that returns (out, per model rank its
    rows' new state or None)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import tensor_parallel as TP
    B, S, D = x.shape
    dt_f = x.dtype
    n = len(p["w_in"])
    rows = [r[0] if r else (0, 0) for r in TP.block_ranges(B, n)]
    prods = [x.to(w.device) @ w.to(dt_f) for w in p["w_in"]]
    gates = prods if n == 1 else C.all_to_all(prods, ctx.mesh, "model", 0, -1, ctx.devs(d),
                                              record=d == 0)
    args = {m: (gates[m][:hi - lo, :, :4 * D],
                *(_slstm_state(hi - lo, D, gates[m].device) if cache is None else
                  (t[lo:hi].to(gates[m].device) for t in cache[m])))
            for m, (lo, hi) in enumerate(rows) if hi > lo}

    def scan(g, *state):  # the rows of every rank that shares a device: one loop
        y, new = _slstm_scan(g.float() + p["bias"][0].to(g.device).float(),
                             p["r_rec"][0].to(g.device).float(), state)
        return (rms_norm(y.to(dt_f), p["norm_scale"][0].to(g.device)), *new)
    done = yield TP.Batch(args, (0,) * 5, (True,) * 5, scan, ((0, 1),) * 5,
                          {m: hi - lo for m, (lo, hi) in enumerate(rows)})
    ys = [done[m][0] if m in done else
          torch.empty((0, S, D), dtype=dt_f, device=ctx.dev(d, m)) for m in range(n)]
    news = [SLSTMCache(*done[m][1:]) if m in done else None for m in range(n)]
    units = ys if n == 1 else C.all_to_all(ys, ctx.mesh, "model", -1, 0, ctx.devs(d),
                                           record=d == 0)
    parts = [y @ w.to(dt_f).to(y.device) for y, w in zip(units, p["out_proj"])]
    return ctx.row_end(parts, d, split), news
