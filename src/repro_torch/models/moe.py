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

CAPACITY_FACTOR = 1.25  # routed pairs an expert takes, over its even share


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


def _route(router: torch.Tensor, x2d: torch.Tensor, top_k: int):
    """(normalised weights (T, K), experts (T, K), probs (T, E)) of ``x2d``."""
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower expert first among equal probabilities;
    # torch.topk promises no order, a stable descending sort does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :top_k], idx[:, :top_k]
    return weights / weights.sum(-1, keepdim=True).clamp(min=1e-9), experts, probs


def _router(params, x2d: torch.Tensor, top_k: int):
    weights, experts, probs = _route(params["router"], x2d, top_k)
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
    comb = _comb(weights, experts, params["router"].shape[-1])
    y = _dense_experts(x2, comb, params["w_gate"], params["w_down"], x.dtype)
    return y.reshape(B, S, D), aux


def _comb(weights: torch.Tensor, experts: torch.Tensor, E: int) -> torch.Tensor:
    """(T, E) float32: each token's routing weights at its chosen experts."""
    return torch.zeros((weights.shape[0], E), dtype=torch.float32,
                       device=weights.device).scatter_add_(1, experts, weights)


def _dense_experts(x2: torch.Tensor, comb: torch.Tensor, w_gate: torch.Tensor,
                   w_down: torch.Tensor, dt) -> torch.Tensor:
    """Every expert of ``w_gate`` / ``w_down`` on every token of x2 (T, D),
    combined by ``comb`` (T, E), in ``dt``: (T, D)."""
    h = F.silu(torch.einsum("td,edf->tef", x2, w_gate.to(dt)))
    y_all = torch.einsum("tef,efd->ted", h, w_down.to(dt))  # (T, E, D)
    return torch.einsum("te,ted->td", comb.to(dt), y_all)


def moe_sorted(params, x: torch.Tensor, top_k: int,
               capacity_factor: float = CAPACITY_FACTOR):
    """Production path: sort-and-pack dispatch with per-expert capacity."""
    B, S, D = x.shape
    E = params["router"].shape[-1]
    x2 = x.reshape(B * S, D)
    weights, experts, aux = _router(params, x2, top_k)
    order, e_sorted, t_sorted, pos, keep, cap = _dispatch(experts, E, capacity_factor)
    w_sorted = weights.reshape(-1)[order]
    buf = _pack(x2, e_sorted, t_sorted, torch.where(keep, pos, cap), E, cap)
    y_buf = _experts(buf, params["w_gate"], params["w_down"])     # (E, cap, D)
    rows = _pair_rows(order, B * S)
    return _combine(y_buf, e_sorted, pos, keep, w_sorted, rows).reshape(B, S, D), aux


def _pack(x2: torch.Tensor, e_sorted, t_sorted, slot, E: int, cap: int) -> torch.Tensor:
    """The (E, cap, D) buffer of the sorted pairs' tokens at their slots. A
    pair whose slot is ``cap`` (dropped, or another rank's) writes a spare
    slot that no expert reads: every kept (expert, slot) is written once."""
    buf = torch.zeros((E, cap + 1, x2.shape[-1]), dtype=x2.dtype, device=x2.device)
    buf[e_sorted, slot] = x2[t_sorted]
    return buf[:, :cap]


def _experts(buf: torch.Tensor, w_gate, w_down) -> torch.Tensor:
    """Each expert's SiLU MLP over its slots (batched by expert)."""
    h = F.silu(torch.bmm(buf, w_gate.to(buf.dtype)))
    return torch.bmm(h, w_down.to(buf.dtype))


def _pair_rows(order: torch.Tensor, T: int) -> torch.Tensor:
    """(T, K): where each token's K routed pairs sit in the sorted order
    ``order``, by expert id, lowest first."""
    K = order.numel() // T
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    return at.reshape(T, K).sort(dim=1).values


def _combine(y_buf: torch.Tensor, e_sorted, pos, keep, w_sorted,
             rows: torch.Tensor) -> torch.Tensor:
    """(T, D): the weighted expert outputs of the tokens whose pairs sit at
    ``rows`` (``_pair_rows``) summed in float32 in the order of their
    experts' ids, then rounded once to the activation dtype: the bits of
    the CPU's ``index_add_`` of the sorted pairs, with no atomics on the
    card, so a training step repeats bit for bit."""
    cap, dt = y_buf.shape[1], y_buf.dtype
    y_pairs = y_buf[e_sorted[rows], pos[rows].clamp(max=cap - 1)]       # (T, K, D)
    parts = (torch.where(keep[rows][..., None], y_pairs, 0.0)
             * w_sorted[rows][..., None].to(dt)).float()
    y = torch.zeros_like(parts[:, 0])
    for j in range(rows.shape[1]):
        y = y + parts[:, j]
    return y.to(dt)


def dropped(experts: torch.Tensor, n_experts: int,
            capacity_factor: float = CAPACITY_FACTOR) -> torch.Tensor:
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


def moe_tp(ctx, views: list, xds: list, top_k: int):
    """``moe_sorted`` over the mesh's data ranks (``distributed.
    tensor_parallel``): ``views[d]`` holds data rank d's compute ranks'
    blocks (router replicated, expert d_ff split over ``model``), ``xds[d]``
    its activation. Returns (per data rank outputs in its activation's
    layout, aux loss).

    Routing and capacity are global, as on one device: each data rank
    routes its own tokens, the (T, K) choices and weights and the tokens
    are all-gathered over the data axes, and one dispatch over all T tokens
    gives every routed pair its expert slot; so the drops are one device's.
    The capacity axis of the (E, cap, D) buffer is split over the data
    ranks (the reference's ``moe_ecd`` layout): each data rank fills its
    slots, runs the experts on them with its model ranks' d_ff blocks (a
    psum over ``model``), and the filled buffer is all-gathered over the
    data axes; each data rank then combines its own tokens' pairs. The
    load-balancing loss is the global mean: psums of the ranks'
    probability and first-choice sums.

    The controller computes the all-gathered routing and the dispatch once,
    on data rank 0's device, and each data rank reads its copy of them:
    what every rank of a multi-process mesh would compute alike. On a mesh
    of several devices, data rank 0's device thus holds the global batch's
    tokens once more (a debug mesh's ranks share one device)."""
    n_dp = ctx.n_dp
    xs = [ctx.seq_full(xd, d) for d, xd in enumerate(xds)]
    B, S, D = xs[0].shape
    x2 = [x.reshape(B * S, D) for x in xs]
    T = n_dp * B * S
    E = views[0]["router"][0].shape[-1]
    def route(d):
        w, e, probs = _route(views[d]["router"][0], x2[d], top_k)
        return w, e, probs.sum(dim=0), F.one_hot(e[:, 0], E).float().sum(dim=0)
    routed = ctx.each(route)
    p_sums, c_sums = [r[2] for r in routed], [r[3] for r in routed]
    me = ctx.psum_data(p_sums) / T
    ce = ctx.psum_data(c_sums) / T
    aux = E * torch.sum(me * ce)
    weights = ctx.gather_data([r[0] for r in routed], 0)
    experts = ctx.gather_data([r[1] for r in routed], 0)
    X = ctx.gather_data(x2, 0)
    order, e_sorted, t_sorted, pos, keep, cap = _dispatch(experts, E, CAPACITY_FACTOR)
    w_sorted = weights.reshape(-1)[order]
    rows = _pair_rows(order, T).reshape(n_dp, B * S, -1)
    cb = -(-cap // n_dp)  # each data rank's capacity slots
    def experts(d):
        dev = ctx.dev(d)
        mine = keep & (torch.div(pos, cb, rounding_mode="floor") == d)
        buf = _pack(ctx.to_rank(X, d), e_sorted.to(dev), t_sorted.to(dev),
                    torch.where(mine, pos - d * cb, cb).to(dev), E, cb)
        parts = [_experts(buf.to(wg.device), wg, wd)
                 for wg, wd in zip(views[d]["w_gate"], views[d]["w_down"])]
        return ctx.row_end(parts, d, False)
    y_bufs = ctx.each(experts)

    def combine(d):
        dev = ctx.dev(d)
        y_buf = y_bufs[0] if n_dp == 1 else ctx.gather_data(y_bufs, 1, d)[:, :cap]
        y = _combine(y_buf, e_sorted.to(dev), pos.to(dev), keep.to(dev), w_sorted.to(dev),
                     ctx.to_rank(rows[d], d))
        return ctx.like(y.reshape(B, S, D), xds[d], d)
    return ctx.each(combine), aux


def moe_dense_tp(ctx, views: list, xds: list, top_k: int):
    """``moe_dense`` (the oracle) over the mesh: each data rank routes its
    own tokens and runs every expert on them, each expert's d_ff split over
    ``model`` as ``ffn.mlp_tp`` splits an MLP's (``w_gate`` column-parallel,
    ``w_down`` row-parallel: each model rank's combined output is a partial
    sum that ``row_end`` adds up; a padded d_ff column gives 0). The
    load-balancing loss is the global one, as ``moe_tp``'s: psums of the
    data ranks' probability and first-choice sums over every token."""
    xs = [ctx.seq_full(xd, d) for d, xd in enumerate(xds)]
    B, S, D = xs[0].shape
    T = ctx.n_dp * B * S
    E = views[0]["router"][0].shape[-1]

    def route(d):
        w, e, probs = _route(views[d]["router"][0], xs[d].reshape(-1, D), top_k)
        return _comb(w, e, E), probs.sum(dim=0), F.one_hot(e[:, 0], E).float().sum(dim=0)
    routed = ctx.each(route)
    me = ctx.psum_data([r[1] for r in routed]) / T
    ce = ctx.psum_data([r[2] for r in routed]) / T
    aux = E * torch.sum(me * ce)

    def experts(d):
        x2, dt = xs[d].reshape(-1, D), xs[d].dtype
        parts = [_dense_experts(x2.to(wg.device), routed[d][0].to(wg.device), wg, wd, dt)
                 .reshape(B, S, D) for wg, wd in zip(views[d]["w_gate"], views[d]["w_down"])]
        return ctx.row_end(parts, d, isinstance(xds[d], tuple))
    return ctx.each(experts), aux
