"""GQA attention: on the card through the hand-written flash kernel
(``kernels/flash_attention``), on the CPU through the reference's dense and
chunked (flash-style) paths.

All take q: (B, Sq, Hq, d) and k / v: (B, Skv, Hkv, d), the models' layout.
The chunked path keeps memory at O(q_chunk x kv_chunk) per head.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.flash_attention.kernel import flash_attention


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, d)
    v: torch.Tensor  # (B, S_max, Hkv, d)


def _mask(qpos, kpos, *, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    # window may be NO_WINDOW (1 << 30) on global layers: then a no-op
    mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _attn_chunk(q, k, v, qpos, kpos, *, causal, window, cap, scale):
    """q: (B, Q, Hkv, G, d); k/v: (B, Kc, Hkv, d) -> partial (o, m, l)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    mask = _mask(qpos, kpos, causal=causal, window=window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                              # (B,H,G,Q)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o, m, l


def chunked_attention(q, k, v, *, causal: bool = True, window=1 << 30,
                      softcap: float = 0.0, q_offset: int = 0,
                      kv_len: int | None = None, q_chunk: int = 1024,
                      kv_chunk: int = 2048, k_scale=None, v_scale=None):
    """q: (B, Sq, Hq, d); k/v: (B, Skv, Hkv, d) -> (B, Sq, Hq, d).

    q position i is global position q_offset + i. ``kv_len`` masks cache
    padding (positions >= kv_len are invalid). ``k_scale``/``v_scale``
    (B, Skv, Hkv) dequantize int8 KV caches chunk by chunk."""
    B, Sq, Hq, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = d ** -0.5
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(B, Sq, Hkv, G, d)
    quant = k_scale is not None
    dev = q.device
    # zero-pad kv to whole chunks, as the reference's scan does (its padded
    # positions are masked by causality, not by kv_len)
    kv_pad = (-Skv) % kv_chunk
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kv_pad))
        if quant:
            k_scale = torch.nn.functional.pad(k_scale, (0, 0, 0, kv_pad))
            v_scale = torch.nn.functional.pad(v_scale, (0, 0, 0, kv_pad))

    def per_q_chunk(q_c, q_start):
        Qc = q_c.shape[1]
        qpos = q_offset + q_start + torch.arange(Qc, device=dev)
        o = torch.zeros((B, Hkv, G, Qc, d), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, G, Qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, Qc), dtype=torch.float32, device=dev)
        for j0 in range(0, Skv + kv_pad, kv_chunk):
            kc, vc = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
            if quant:
                kc = kc.float() * k_scale[:, j0:j0 + kv_chunk, :, None]
                vc = vc.float() * v_scale[:, j0:j0 + kv_chunk, :, None]
            kpos = j0 + torch.arange(kc.shape[1], device=dev)
            kpos = torch.where(kpos < kv_len, kpos, kv_len + Skv + 10)  # mask pad
            oc, mc, lc = _attn_chunk(q_c, kc, vc, qpos, kpos, causal=causal,
                                     window=window, cap=softcap, scale=scale)
            m_new = torch.maximum(m, mc)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(mc - m_new)
            l = l * alpha + lc * beta
            o = o * alpha[..., None] + oc * beta[..., None]
            m = m_new
        out = o / l.clamp(min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(B, Qc, Hq, d)

    outs = [per_q_chunk(qg[:, i:i + q_chunk], i) for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).to(q.dtype)


def dense_attention(q, k, v, *, causal: bool = True, window=1 << 30,
                    softcap: float = 0.0, q_offset: int = 0,
                    kv_len: int | None = None, k_scale=None, v_scale=None):
    """Small-S path: the whole score matrix at once, same semantics."""
    if k_scale is not None:  # int8 cache: dequant upfront (small shapes only)
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    B, Sq, Hq, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = d ** -0.5
    kv_len = Skv if kv_len is None else kv_len
    qg = q.reshape(B, Sq, Hkv, G, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = _mask(qpos, kpos, causal=causal, window=window) & (kpos[None, :] < kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, d).to(q.dtype)


def flash_route(q, k, v, *, causal: bool = True, window=1 << 30,
                softcap: float = 0.0, q_offset: int = 0, kv_len: int | None = None,
                k_scale=None, v_scale=None):
    """Attention through the flash kernel's wrapper (the card's route; on a
    CPU tensor the wrapper computes its plain version). The kernel aligns q
    to the end of the kv sequence, so the cache is cut to ``kv_len`` and q
    must be its last Sq positions (prefill: q_offset 0 and Sq == kv_len;
    decode: kv_len = pos + 1); anything else raises. An int8 cache is
    dequantized on the cut cache, and then q, k and v go in float32."""
    B, Sq, Hq, d = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    if q_offset != kv_len - Sq:
        raise ValueError(f"the flash kernel aligns q to the end of the kv "
                         f"sequence: q_offset {q_offset} != kv_len {kv_len} - Sq {Sq}")
    k, v = k[:, :kv_len], v[:, :kv_len]
    qk = q
    if k_scale is not None:
        k = k.float() * k_scale[:, :kv_len, :, None]
        v = v.float() * v_scale[:, :kv_len, :, None]
        qk = q.float()
    out = flash_attention(qk.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=int(window), softcap=softcap)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, **kw):
    """Dispatch: the flash kernel on the card; on the CPU dense up to
    2048 x 2048 (with at most 8192 kv positions), chunked above."""
    if q.device.type == "cuda":
        return flash_route(q, k, v, **kw)
    if q.shape[1] * k.shape[1] <= 2048 * 2048 and k.shape[1] <= 8192:
        return dense_attention(q, k, v, **kw)
    return chunked_attention(q, k, v, **kw)
