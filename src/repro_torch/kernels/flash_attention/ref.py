"""Plain PyTorch version of the flash-attention kernel (GQA, causal end
alignment, sliding window, softcap): the CPU path and the card's oracle."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None, q_block: int = 512) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d), Hq % Hkv == 0 ->
    (B, Hq, Sq, d) in q's dtype, computed in float32.

    Query head h reads KV head h // (Hq // Hkv). q positions are aligned to
    the END of the kv sequence: q row i sits at position Skv - Sq + i, and
    under ``causal`` sees kv positions up to it. ``window`` > 0 keeps the
    kv positions > position - window. Scores are scaled by ``scale``
    (default d^-0.5), then soft-capped (cap * tanh(s / cap)), then masked.
    A row that every kv position masks (padding, or Sq > Skv under causal)
    gives 0, as the kernel's max(l, 1e-30) clamp does. Queries go in blocks
    of ``q_block`` rows, so the score matrix never exceeds
    (B, Hq, q_block, Skv)."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = d ** -0.5 if scale is None else scale
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, Sq, q_block):
        i1 = min(i0 + q_block, Sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i1].float(), kk) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(i0, i1, device=q.device)[:, None] + (Skv - Sq)
        mask = torch.ones((i1 - i0, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window > 0:
            mask &= kpos[None, :] > qpos - window
        s = s.masked_fill(~mask, float("-inf"))
        # a fully masked row has max -inf: clamping it keeps exp() at 0, not NaN
        m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vv) / l.clamp(min=1e-30)
        out[:, :, i0:i1] = o.to(q.dtype)
    return out
