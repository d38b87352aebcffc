"""AdamW with global-norm clipping, as ``repro.train.optimizer``: hand-rolled
over the parameter tree with ``torch._foreach_*`` (one kernel a step per
operation over all leaves), float32 moments, weight decay added into the
update, bias correction by ``step + 1``, and the cosine schedule."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar: the updates taken
    m: dict
    v: dict


def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of a tree of dicts in the reference's order (``jax.tree``
    sorts dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s shape whose leaves are ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device) for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                      m=zeros(), v=zeros())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling, a float32 scalar)."""
    leaves = [g.float() for g in tree_leaves(grads)]
    gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_unflatten(grads, [g * scale.to(g.dtype) for g in tree_leaves(grads)]), gn


def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0):
    """(new params in their dtypes, new state, the gradients' global norm).
    ``lr`` is a float or a float32 scalar tensor."""
    grads, gnorm = clip_by_global_norm(
        tree_unflatten(grads, [g.float() for g in tree_leaves(grads)]), max_grad_norm)
    step = state.step + 1
    new, m, v = adamw_apply(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                            tree_leaves(state.v), step, lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay)
    state = AdamWState(step=step, m=tree_unflatten(state.m, m), v=tree_unflatten(state.v, v))
    return tree_unflatten(params, new), state, gnorm


def adamw_apply(p: list, g: list, m: list, v: list, step, lr, *, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """The elementwise AdamW update of lists of params (any dtype), their
    clipped float32 gradients and moments, at the new ``step`` (1 on the
    first update): (new params in their dtypes, new m, new v). Each element
    is computed alone, so a block of a sharded tensor updates as the whole
    tensor's slice."""
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    m = torch._foreach_mul(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_mul(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
    del g
    p32 = [x.float() for x in p]
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, denom)
    del denom
    torch._foreach_add_(delta, torch._foreach_mul(p32, weight_decay))
    torch._foreach_mul_(delta, lr)
    return [(a - b).to(x.dtype) for a, b, x in zip(p32, delta, p)], m, v


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up from 0 at step 0 to ``peak_lr`` at ``warmup``, then a
    cosine down to ``floor * peak_lr`` at ``total``; a float32 scalar on
    ``step``'s device."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def zero1_shardings(param_shardings, params, mesh):
    """Shard optimizer moments additionally over the data axis (ZeRO-1):
    pick the first un-sharded axis divisible by the data-parallel size. A
    tree of ``NamedSharding``s of the port (``distributed.sharding``), each
    moment's spec the reference's."""
    from repro_torch.distributed.sharding import NamedSharding, P, tree_map
    data = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)

    def widen(sh, leaf):
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        used = set()
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                used.add(a)
        if used & {"data", "pod"}:
            return sh  # already data-sharded (FSDP mode)
        for ax in range(leaf.ndim):
            if spec[ax] is None and leaf.shape[ax] % max(data, 1) == 0 \
                    and leaf.shape[ax] >= data > 1:
                axes = [a for a in ("pod", "data") if a in mesh.axis_names]
                spec[ax] = tuple(axes) if len(axes) > 1 else axes[0]
                break
        return NamedSharding(mesh, P(*spec), getattr(sh, "mode", "tp"))

    return tree_map(widen, param_shardings, params)
