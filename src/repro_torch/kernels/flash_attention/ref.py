"""Plain PyTorch version of the flash-attention kernel (GQA, causal end
alignment, sliding window, softcap): the CPU path and the card's oracle."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def _keep(Sq: int, Skv: int, i0: int, i1: int, causal: bool, window: int, device):
    """(i1 - i0, Skv) bool: the kv positions q rows i0..i1-1 keep (q aligned
    to the END of the kv sequence)."""
    kpos = torch.arange(Skv, device=device)
    qpos = torch.arange(i0, i1, device=device)[:, None] + (Skv - Sq)
    mask = torch.ones((i1 - i0, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window > 0:
        mask &= kpos[None, :] > qpos - window
    return mask


def _acc(dtype) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 inputs (the
    CPU's gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(qb, kk, scale: float, softcap: float):
    """(raw scores x scale, capped scores, tanh of the capped ones or None)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qb.to(kk.dtype), kk) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        return s, softcap * t, t
    return s, s, None


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0,
                      scale: float | None = None, q_block: int = 512):
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0 ->
    (out (B, Hq, Sq, d) in q's dtype, lse (B, Hq, Sq) float32), computed in
    float32 (float64, lse too, for float64 inputs).

    Query head h reads KV head h // (Hq // Hkv). q positions are aligned to
    the END of the kv sequence: q row i sits at position Skv - Sq + i, and
    under ``causal`` sees kv positions up to it. ``window`` > 0 keeps the
    kv positions > position - window. Scores are scaled by ``scale``
    (default d^-0.5), then soft-capped (cap * tanh(s / cap)), then masked.
    ``lse`` is the natural-log sum of exp over each row's kept scores (what
    the backward recomputes P from). A row that every kv position masks
    (padding, or Sq > Skv under causal) gives 0 and lse NEG_INF, as the
    kernel's max(l, 1e-30) clamp does. Queries go in blocks of ``q_block``
    rows, so the score matrix never exceeds (B, Hq, q_block, Skv)."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    acc = _acc(q.dtype)
    kk = k.to(acc).repeat_interleave(group, dim=1)
    vv = v.to(acc).repeat_interleave(group, dim=1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=acc, device=q.device)
    for i0 in range(0, Sq, q_block):
        i1 = min(i0 + q_block, Sq)
        _, s, _ = _scores(q[:, :, i0:i1], kk, scale, softcap)
        s = s.masked_fill(~_keep(Sq, Skv, i0, i1, causal, window, q.device),
                          float("-inf"))
        # a fully masked row has max -inf: clamping it keeps exp() at 0, not NaN
        m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vv) / l
        out[:, :, i0:i1] = o.to(q.dtype)
        lse[:, :, i0:i1] = (m + torch.log(l))[..., 0]
    return out, lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None, q_block: int = 512) -> torch.Tensor:
    """The output of ``attention_lse_ref``: (B, Hq, Sq, d) in q's dtype."""
    return attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_block=q_block)[0]


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0,
                      scale: float | None = None, q_block: int = 512):
    """The gradients (dq, dk, dv) of ``attention_lse_ref``'s output, in the
    dtypes of q, k and v, by the explicit formulas in float32 (float64 for
    float64 inputs; no autograd):
    P = exp(s - lse) on kept positions and exactly 0 on masked ones,
    D = rowsum(dout * out), dV = P^T dout, dS = P * (dout V^T - D), through
    the softcap dS_raw = dS * (1 - tanh^2(s_raw / cap)), times the scale;
    dQ = dS_raw K, dK = dS_raw^T Q; dK and dV summed over each KV head's
    group of query heads. A row with no kept key contributes 0."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    acc = _acc(q.dtype)
    kk = k.to(acc).repeat_interleave(group, dim=1)
    vv = v.to(acc).repeat_interleave(group, dim=1)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, Hq, Skv, d), dtype=acc, device=q.device)
    dv = torch.zeros((B, Hq, Skv, d), dtype=acc, device=q.device)
    for i0 in range(0, Sq, q_block):
        i1 = min(i0 + q_block, Sq)
        qb, dob = q[:, :, i0:i1].to(acc), dout[:, :, i0:i1].to(acc)
        _, s, t = _scores(qb, kk, scale, softcap)
        keep = _keep(Sq, Skv, i0, i1, causal, window, q.device)
        p = torch.exp(torch.where(keep, s - lse[:, :, i0:i1, None], float("-inf")))
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        delta = (dob * out[:, :, i0:i1].to(acc)).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dob, vv) - delta)
        if t is not None:
            ds = ds * (1 - t * t)
        ds = ds * scale
        dq[:, :, i0:i1] = torch.einsum("bhqk,bhkd->bhqd", ds, kk).to(q.dtype)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qb)
    dk = dk.reshape(B, Hkv, group, Skv, d).sum(2).to(k.dtype)
    dv = dv.reshape(B, Hkv, group, Skv, d).sum(2).to(v.dtype)
    return dq, dk, dv


def split_partials_ref(q, k, v, ranges, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, scale: float | None = None):
    """The split-KV route's per-split partials, plainly: for each kv range
    [s0, s1) of ``ranges``, each KV head and its ``group`` x Sq q rows (row
    g * Sq + i is query head h * group + g, row i), the running max ``m``,
    the sum ``l`` of exp(s - m) and the unnormalised ``acc`` over the kept
    keys of that range. Shapes (B, Hkv, n_splits, rows) and
    (B, Hkv, n_splits, rows, d), float32; a row with nothing kept in a
    range has (NEG_INF, 0, 0)."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, Hkv, group * Sq, d)
    qpos = torch.arange(Sq, device=q.device).repeat(group) + (Skv - Sq)
    ms, ls, accs = [], [], []
    for s0, s1 in ranges:
        kpos = torch.arange(s0, s1, device=q.device)
        s = torch.einsum("bhrd,bhkd->bhrk", qg, k[:, :, s0:s1].float()) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        keep = torch.ones((group * Sq, s1 - s0), dtype=torch.bool, device=q.device)
        if causal:
            keep &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            keep &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(dim=-1).clamp(min=NEG_INF) if s1 > s0 else \
            torch.full(qg.shape[:3], NEG_INF, device=q.device)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhrk,bhkd->bhrd", p, v[:, :, s0:s1].float()))
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def combine_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, Hq: int,
                   Sq: int) -> torch.Tensor:
    """Fold per-split (m, l, acc) of ``split_partials_ref``'s layout into the
    (B, Hq, Sq, d) float32 output, as the combine kernel does: weights
    exp(m_s - max_s m_s), splits in order, a row with nothing kept -> 0."""
    M = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - M)
    L = (l * w).sum(dim=2)
    O = (acc * w[..., None]).sum(dim=2) / L.clamp(min=1e-30)[..., None]
    B, Hkv, _, d = O.shape
    return O.reshape(B, Hkv, Hq // Hkv, Sq, d).reshape(B, Hq, Sq, d)
