"""Gated MLPs (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, layers: tuple[int, ...] = ()) -> dict:
    """Gate, up and down projections; ``layers`` = (L,) stacks L layers
    along a leading axis."""
    return {
        "w_gate": dense_init(generator, (*layers, d_model, d_ff), len(layers), dtype),
        "w_up": dense_init(generator, (*layers, d_model, d_ff), len(layers), dtype),
        "w_down": dense_init(generator, (*layers, d_ff, d_model), len(layers), dtype),
    }


def mlp(params, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's default is exact
    h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    return h @ params["w_down"].to(dt)
