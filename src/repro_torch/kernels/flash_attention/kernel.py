"""Flash-attention kernel wrapper: q (B, Hq, Sq, d), k / v (B, Hkv, Skv, d)
-> (B, Hq, Sq, d), and its gradient.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention/kernel.py:_flash_kernel``); on a CPU tensor
it computes the plain version in ``ref.py``; on a ``meta`` tensor (a
dry-run) it computes nothing and reports its kept pairs' flops to the
counting pass (``meta_counters``). Under autograd the call goes
through ``FlashAttentionFn``: the forward also writes each row's lse, and
the backward launches ``csrc/flash_bwd.cu`` (on the CPU:
``attention_bwd_ref``). The forward's C entry point picks one of
three routes by shape and dtype (``mint_flash_route``): split-KV decode
when Sq x group <= 64, tensor cores for bf16 / f16 beyond that, the FP32
kernel for float32. The wrapper plans the split-KV route's splits here
(``split_plan``) and allocates their scratch. The backward's route is
chosen by dtype alone (``mint_flash_bwd_route``): tensor cores
(``csrc/flash_bwd_tc.cu``) for bf16 / f16, FP32 FMA tiles for float32.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (DTYPE_CODES, H100_SMS, cdiv, check_launch,
                                        load_library, ptr, stream_ptr)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)

HEAD_DIMS = (32, 64, 128)
ROUTES = ("split_kv", "tensor_core", "fp32")  # mint_flash_route's codes
BWD_ROUTES = ("tensor_core", "ffma")  # mint_flash_bwd_route's codes
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


def kept_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs a call's mask keeps, per (batch, q head): its work (q
    aligned to the end of the kv sequence; ``window`` > 0 keeps the kv
    positions > q position - window)."""
    if Sq == 0 or Skv == 0:
        return 0
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# A counting pass over a step on ``meta`` tensors (``launch.cost_count``)
# appends a callable to its thread's ``meta_counters()``; a call on meta
# tensors computes nothing and reports (name, inputs, outputs, flops) to
# each: 4 x d flops a kept pair forward (QK^T and PV), 10 x d backward (S
# again, dV, dP, dQ, dK).
_META = threading.local()


def meta_counters() -> list:
    """The calling thread's counters of calls on meta tensors."""
    if not hasattr(_META, "counters"):
        _META.counters = []
    return _META.counters


def _meta_call(name: str, ins: tuple, outs: tuple, flops: int) -> None:
    for count in meta_counters():
        count(name, ins, outs, flops)


def _meta_forward(q, k, v, causal: bool, window: int, with_lse: bool):
    B, Hq, Sq, d = q.shape
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device="meta")
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device="meta")
           if with_lse else None)
    flops = 4 * d * B * Hq * kept_pairs(Sq, k.shape[2], causal, window)
    _meta_call("flash_attention", (q, k, v), (out,) if lse is None else (out, lse), flops)
    return out, lse


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


def _check_shapes(q, k, v) -> None:
    B, Hq, Sq, d = q.shape
    Bk, Hkv, Skv, dk = k.shape
    if (Bk, dk) != (B, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} kv heads")


def _check_card(d: int, named) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    like = named[0][1]
    for name, t in named:
        _check_operand(name, t, like)


def _forward(q, k, v, causal: bool, window: int, softcap: float, scale: float,
             with_lse: bool):
    """One launch of the forward on the card: (out, lse or None). ``lse``
    (B, Hq, Sq) float32 is the natural-log sum of exp of each row's kept
    scores, written by every route when asked (NEG_INF for a row with no
    kept key); without it the launch is the serving one."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _check_card(d, (("q", q), ("k", k), ("v", v)))
    out = torch.empty((B, Hq, Sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
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
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), B, Hq, Hkv, Sq, Skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), float(softcap), scale, DTYPE_CODES[q.dtype],
        plan.kv_begin, plan.kv_end, plan.chunk, plan.n_splits, *map(ptr, parts),
        stream_ptr(q.device))
    check_launch(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    flash_attention.last_route = (route, plan.n_splits)
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward is the flash kernel writing the
    rows' lse beside the output, the backward the hand-written backward
    kernel (``flash_attention_bwd``); on CPU tensors their plain versions
    (``attention_lse_ref``, ``attention_bwd_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float, scale: float):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Attention forward with GQA (query head h reads KV head
    h // (Hq // Hkv)), q aligned to the end of the kv sequence, a sliding
    ``window`` (> 0 keeps kv positions > q position - window) and a tanh
    ``softcap``; scale defaults to d^-0.5. Output in q's dtype. q, k and v
    may be strided views (e.g. (B, S, H, d) transposed) as long as the head
    dim is contiguous; on the card they start on 16 bytes, their other
    strides are whole 16-byte vectors, and d is 32, 64 or 128. When grad
    mode is on and q, k or v requires grad, the call goes through
    ``FlashAttentionFn`` (the backward kernel gives their gradients)."""
    _check_shapes(q, k, v)
    scale_f = float(q.shape[3] ** -0.5 if scale is None else scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, int(window), float(softcap),
                                      scale_f)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale_f)
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, with_lse=False)[0]
    return _forward(q, k, v, causal, window, softcap, scale_f, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """``flash_attention``'s output and each row's lse (B, Hq, Sq) float32,
    as the backward needs them: one launch of the kernel with its lse
    output on the card, ``attention_lse_ref`` on the CPU. No gradient."""
    _check_shapes(q, k, v)
    scale_f = float(q.shape[3] ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                 scale=scale_f)
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, with_lse=True)
    return _forward(q, k, v, causal, window, softcap, scale_f, with_lse=True)


flash_attention.launches = 0
# launches by route since the last reset, and the route (and split count)
# of the latest launch
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention.last_route = None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0, softcap: float = 0.0,
                        scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention``'s output given ``dout``, from the
    forward's ``out`` and ``lse``; grads in the inputs' dtypes and layouts.
    On the card it launches ``csrc/flash_bwd.cu`` (a pre-pass for
    D = rowsum(dout * out), then a dK / dV kernel and a dQ kernel on the
    dtype's route: ``tensor_core`` for bf16 / f16, ``ffma`` for float32; no
    atomics: two calls on the same inputs give the same bits); on CPU
    tensors it computes ``attention_bwd_ref``."""
    _check_shapes(q, k, v)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale_f = float(d ** -0.5 if scale is None else scale)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                 softcap=softcap, scale=scale_f)
    if q.device.type == "meta":
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (q, k, v))
        _meta_call("flash_attention_bwd", (q, k, v, out, lse, dout), grads,
                   10 * d * B * Hq * kept_pairs(Sq, Skv, causal, window))
        return grads
    # autograd may hand dout over in any layout: the kernel reads it, like
    # out, as contiguous rows of 16-byte vectors
    dout = dout.to(q.dtype).contiguous()
    out = out.contiguous()
    _check_card(d, (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)))
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(B, Hq, Sq)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = load_library()
    route = BWD_ROUTES[lib.mint_flash_bwd_route(DTYPE_CODES[q.dtype])]
    err = lib.mint_flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse), ptr(dq), ptr(dk),
        ptr(dv), ptr(delta), B, Hq, Hkv, Sq, Skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        int(causal), int(window), float(softcap), scale_f, DTYPE_CODES[q.dtype],
        stream_ptr(q.device))
    check_launch(lib, err, f"flash_attention_bwd ({route})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[route] += 1
    flash_attention_bwd.last_route = route
    return dq, dk, dv


flash_attention_bwd.launches = 0
# launches by route since the last reset, and the route of the latest launch
flash_attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
flash_attention_bwd.last_route = None
