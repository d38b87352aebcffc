"""Flash-attention kernel wrapper: q (B, Hq, Sq, d), k / v (B, Hkv, Skv, d)
-> (B, Hq, Sq, d).

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention/kernel.py:_flash_kernel``); on a CPU tensor
it computes the plain version in ``ref.py``. The C entry point picks one of
three routes by shape and dtype (``mint_flash_route``): split-KV decode
when Sq x group <= 64, tensor cores for bf16 / f16 beyond that, the FP32
kernel for float32. The wrapper plans the split-KV route's splits here
(``split_plan``) and allocates their scratch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (DTYPE_CODES, H100_SMS, cdiv, check_launch,
                                        load_library, ptr, stream_ptr)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
ROUTES = ("split_kv", "tensor_core", "fp32")  # mint_flash_route's codes
SPLIT_MIN_KEYS = 128   # fewest keys a split walks (four 8-key chunks a warp)
SPLIT_BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class SplitPlan:
    """The split-KV route's cut of the kept kv range [kv_begin, kv_end)
    into ``n_splits`` runs of ``chunk`` keys (the last may be shorter)."""
    kv_begin: int
    kv_end: int
    chunk: int
    n_splits: int


def split_plan(B: int, Hkv: int, Sq: int, Skv: int, causal: bool, window: int,
               sm_count: int = H100_SMS) -> SplitPlan:
    """Cut the kv range that some q row keeps (q aligned to the end of the
    cache; the causal and window cuts applied) into enough splits that
    B x Hkv x splits blocks give every SM ``SPLIT_BLOCKS_PER_SM``, with at
    least ``SPLIT_MIN_KEYS`` keys a split and no empty split."""
    qpos_lo, qpos_hi = Skv - Sq, Skv - 1
    kv_end = min(Skv, qpos_hi + 1) if causal else Skv
    kv_begin = max(0, qpos_lo - window + 1) if window > 0 else 0
    n_kv = kv_end - kv_begin
    if n_kv <= 0:
        return SplitPlan(kv_begin, kv_begin, 0, 1)
    splits = max(1, min(SPLIT_BLOCKS_PER_SM * sm_count // (B * Hkv),
                        cdiv(n_kv, SPLIT_MIN_KEYS)))
    chunk = cdiv(n_kv, splits)
    return SplitPlan(kv_begin, kv_end, chunk, cdiv(n_kv, chunk))


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
    route = ROUTES[lib.mint_flash_route(Sq, Hq // Hkv, DTYPE_CODES[q.dtype])]
    plan, parts = SplitPlan(0, 0, 0, 0), (None, None, None)
    if route == "split_kv":
        plan = split_plan(B, Hkv, Sq, Skv, causal, window,
                          torch.cuda.get_device_properties(q.device).multi_processor_count)
        rows = B * Hkv * plan.n_splits * (Hq // Hkv) * Sq
        parts = (torch.empty(rows, dtype=torch.float32, device=q.device),
                 torch.empty(rows, dtype=torch.float32, device=q.device),
                 torch.empty(rows * d, dtype=torch.float32, device=q.device))
    err = lib.mint_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, Sq, Skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), float(softcap), scale_f, DTYPE_CODES[q.dtype],
        plan.kv_begin, plan.kv_end, plan.chunk, plan.n_splits, *map(ptr, parts),
        stream_ptr(q.device))
    check_launch(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.last_route = (route, plan.n_splits)
    return out


flash_attention.launches = 0
# launches by route since the last reset, and the route (and split count)
# of the latest launch
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.last_route = None
