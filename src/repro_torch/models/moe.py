"""Top-k token-choice MoE with two interchangeable dispatch strategies, as in
``repro.models.moe``.

``dense``  — all-experts einsum combined by router weights. O(E/topk) FLOP
             waste but branch-free; the correctness oracle.
``sorted`` — production path: a stable sort of the routed (token, expert)
             pairs by expert, packed into (E, capacity, d) buffers, batched
             expert matmuls, each token's pairs gathered back and summed in
             a fixed order (``_combine``).
Tokens over capacity are dropped (their MoE output is 0 — the residual
carries them), the standard capacity-factor behaviour. The stable sort
keeps token order inside an expert, so an overflowing expert drops its
latest tokens; ``dropped`` says which pairs were dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_moe(generator: torch.Generator, d_model: int, n_experts: int,
             expert_dff: int, top_k: int, dtype=torch.float32,
             layers: tuple[int, ...] = ()) -> dict:
    """Router and expert weights; ``layers`` stacks them along leading axes.
    Each leaf's fan-in is its first unstacked axis, as in the reference
    (so the experts' is E)."""
    n = len(layers)
    return {
        "router": dense_init(generator, (*layers, d_model, n_experts), n, dtype),
        # w_up fused into w_gate's activation: experts are plain SiLU MLPs
        "w_gate": dense_init(generator, (*layers, n_experts, d_model, expert_dff), n,
                             dtype),
        "w_down": dense_init(generator, (*layers, n_experts, expert_dff, d_model), n,
                             dtype),
    }


def _router(params, x2d: torch.Tensor, top_k: int):
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower expert first among equal probabilities;
    # torch.topk promises no order, a stable descending sort does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :top_k], idx[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    E = probs.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return weights, experts, aux


def _capacity(T: int, E: int, top_k: int, capacity_factor: float) -> int:
    """The per-expert capacity; floored at min(T, 128) so decode steps (tiny
    T) never drop while large prompts keep the capacity-factor behaviour."""
    return int(max(round(capacity_factor * top_k * T / E), min(T, 128), 1))


def _dispatch(experts: torch.Tensor, E: int, capacity_factor: float):
    """Sort the (T, K) routed pairs by expert (stable: token order inside an
    expert). Returns (order, expert, token, slot within the expert, keep,
    capacity), all but the capacity over the sorted pairs."""
    T, K = experts.shape
    dev = experts.device
    flat_expert = experts.reshape(-1)
    flat_token = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order]
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_expert = torch.arange(T * K, device=dev) - seg_start[e_sorted]
    cap = _capacity(T, E, K, capacity_factor)
    return order, e_sorted, flat_token[order], pos_in_expert, pos_in_expert < cap, cap


def moe_dense(params, x: torch.Tensor, top_k: int):
    """Oracle: compute every expert for every token, combine by routing."""
    B, S, D = x.shape
    x2 = x.reshape(-1, D)
    weights, experts, aux = _router(params, x2, top_k)
    dt = x.dtype
    h = F.silu(torch.einsum("td,edf->tef", x2, params["w_gate"].to(dt)))
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"].to(dt))  # (T, E, D)
    comb = torch.zeros((x2.shape[0], params["router"].shape[-1]), dtype=torch.float32,
                       device=x.device).scatter_add_(1, experts, weights)
    y = torch.einsum("te,ted->td", comb.to(dt), y_all)
    return y.reshape(B, S, D), aux


def moe_sorted(params, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25):
    """Production path: sort-and-pack dispatch with per-expert capacity."""
    B, S, D = x.shape
    E = params["router"].shape[-1]
    x2 = x.reshape(B * S, D)
    weights, experts, aux = _router(params, x2, top_k)
    order, e_sorted, t_sorted, pos, keep, cap = _dispatch(experts, E, capacity_factor)
    w_sorted = weights.reshape(-1)[order]
    dt = x.dtype
    # a dropped pair writes slot ``cap``, which no expert reads: every kept
    # (expert, slot) is written once
    buf = torch.zeros((E, cap + 1, D), dtype=dt, device=x.device)
    buf[e_sorted, torch.where(keep, pos, cap)] = x2[t_sorted]
    buf = buf[:, :cap]
    h = F.silu(torch.bmm(buf, params["w_gate"].to(dt)))
    y_buf = torch.bmm(h, params["w_down"].to(dt))                 # (E, cap, D)
    y_pairs = y_buf[e_sorted, pos.clamp(max=cap - 1)]
    y_pairs = torch.where(keep[:, None], y_pairs, 0.0) * w_sorted[:, None].to(dt)
    return _combine(y_pairs, order, B * S).reshape(B, S, D), aux


def _combine(y_pairs: torch.Tensor, order: torch.Tensor, T: int) -> torch.Tensor:
    """Sum each token's K weighted expert outputs (given in the sorted pair
    order ``order``) in float32 in the order of its experts' ids, then round
    once to the activation dtype: the bits of the CPU's ``index_add_`` of
    the sorted pairs, with no atomics on the card, so a training step
    repeats bit for bit."""
    K = order.numel() // T
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    # a token's pairs sit in the sorted order by expert id, lowest first
    parts = y_pairs[at.reshape(T, K).sort(dim=1).values].float()    # (T, K, D)
    y = torch.zeros_like(parts[:, 0])
    for j in range(K):
        y = y + parts[:, j]
    return y.to(y_pairs.dtype)


def dropped(experts: torch.Tensor, n_experts: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """(T, top_k) bool on the experts' device: True where ``moe_sorted``
    drops the token's k-th routed expert (``experts``, the router's (T, K)
    choice) over its capacity. No host sync."""
    order, _, _, _, keep, _ = _dispatch(experts, n_experts, capacity_factor)
    out = torch.empty_like(keep)
    out[order] = ~keep
    return out.reshape(experts.shape)


def moe(params, x: torch.Tensor, top_k: int, impl: str = "sorted"):
    if impl == "dense":
        return moe_dense(params, x, top_k)
    return moe_sorted(params, x, top_k)
