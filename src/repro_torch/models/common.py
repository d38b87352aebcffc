"""Shared model components: norms, rotary embeddings (incl. M-RoPE), init."""
from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) weights of ``shape`` on the generator's device, drawn
    straight into ``dtype`` (no float32 copy of a bf16 tensor is made);
    fan_in = ``shape[in_axis]``."""
    fan_in = shape[in_axis]
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(0.0, fan_in ** -0.5, generator=generator)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32, cast back."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotary embedding over halves (not interleaved pairs). x: (B, S, H, d).
    positions: (B, S) or (B, S, 3) for M-RoPE (Qwen2-VL), where ``sections``
    splits the d/2 frequency pairs into (t, h, w) groups, each rotated by its
    own position stream."""
    B, S, H, d = x.shape
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    if positions.ndim == 2:
        ang = positions[:, :, None].float() * freqs[None, None, :]
    else:
        n_pairs = d // 2
        sec = torch.zeros(n_pairs, dtype=torch.int64, device=x.device)
        start = 0
        for si, width in enumerate(sections):
            sec[start:start + width] = si
            start += width
        pos_sel = torch.gather(positions.float(), 2,
                               sec[None, None, :].expand(B, S, n_pairs))
        ang = pos_sel * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)
