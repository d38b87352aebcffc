"""Flash-attention kernel wrapper: q (B, Hq, Sq, d), k / v (B, Hkv, Skv, d)
-> (B, Hq, Sq, d).

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention/kernel.py:_flash_kernel``); on a CPU tensor
it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPE_CODES, check_launch, load_library, ptr,
                                        stream_ptr)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype or t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} dtype {t.dtype}: q, k and v must share one of "
                         f"{tuple(DTYPE_CODES)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous along the head dim")
    # the kernel reads 16-byte vectors along the head dim
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
        raise ValueError(f"{name} must start on 16 bytes with strides of whole "
                         f"16-byte vectors (strides {t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Attention forward with GQA (query head h reads KV head
    h // (Hq // Hkv)), q aligned to the end of the kv sequence, a sliding
    ``window`` (> 0 keeps kv positions > q position - window) and a tanh
    ``softcap``; scale defaults to d^-0.5. Output in q's dtype. q, k and v
    may be strided views (e.g. (B, S, H, d) transposed) as long as the head
    dim is contiguous; on the card they start on 16 bytes, their other
    strides are whole 16-byte vectors, and d is 32, 64 or 128."""
    B, Hq, Sq, d = q.shape
    Bk, Hkv, Skv, dk = k.shape
    if (Bk, dk) != (B, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} kv heads")
    scale_f = float(d ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale_f)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    err = lib.mint_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Sq, Skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), float(softcap), scale_f, DTYPE_CODES[q.dtype],
        stream_ptr(q.device))
    check_launch(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
