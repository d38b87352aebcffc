"""The train and serve steps of the model substrate, as in
``repro.train.step``.

The training step's knobs are the reference's: ``bf16_grads`` takes the
gradient with respect to a bf16 copy of the parameters (the grads are bf16,
as JAX's are; the f32 master params and Adam moments absorb the rounding),
``microbatch`` accumulates the gradients of equal slices of the batch in
float32, and remat comes from ``ArchConfig.remat`` (per-block
recomputation in ``models.model``). The serve steps cast the parameters to
bf16 first; under ``use_mesh`` they take placed parameters and caches (trees
of ``Blocks``) and serve on the mesh (``models.model._prefill_tp`` /
``_decode_step_tp``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import Blocks, NamedSharding, tree_map, use_mesh
from repro_torch.distributed.tensor_parallel import ShardCtx
from repro_torch.models import model as M
from repro_torch.train.optimizer import (AdamWState, adamw_apply, adamw_update,
                                         cosine_schedule, tree_leaves, tree_unflatten)


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; a leaf already in it is returned
    as it is (no copy), so a bf16 tree costs no memory. A placed leaf
    (``Blocks``) casts its blocks."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, Blocks):
        return tree.astype(dtype) if tree.dtype.is_floating_point else tree
    return tree.to(dtype) if tree.is_floating_point() else tree


def _slice(batch: dict, i: int, n: int) -> dict:
    """The i-th of n equal slices of every batch entry along its first axis."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {k!r} of {b} rows does not split into {n} microbatches")
        out[k] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def loss_and_grads(cfg: ArchConfig, params, batch: dict, *, bf16_grads: bool = True):
    """(loss, gradients in ``tree_leaves`` order) of ``models.model.train_loss``
    with respect to a leaf copy of ``params``: bf16 under ``bf16_grads`` (the
    grads are bf16), else the params' own dtype."""
    leaves = [p.detach().to(torch.bfloat16) if bf16_grads else p.detach()
              for p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = M.train_loss(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read gets a zero gradient, as in JAX
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def make_train_step(cfg: ArchConfig, *, bf16_grads: bool = True, microbatch: int = 1,
                    peak_lr: float = 3e-4, total_steps: int = 10000):
    """(params, opt_state, batch) -> (params, opt_state, {"loss", "gnorm",
    "lr"}): the gradient of ``models.model.train_loss``, AdamW at the
    cosine schedule's rate for ``opt_state.step`` (0 at step 0). The params
    and state given are not written."""
    def train_step(params, opt_state: AdamWState, batch: dict):
        if microbatch > 1:
            loss, grads = 0.0, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                for p in tree_leaves(params)]
            for i in range(microbatch):
                mb_loss, mb_grads = loss_and_grads(cfg, params, _slice(batch, i, microbatch),
                                                   bf16_grads=bf16_grads)
                loss = loss + mb_loss
                torch._foreach_add_(grads, [g.float() for g in mb_grads])
            loss = loss / microbatch
            grads = torch._foreach_div(grads, microbatch)
        else:
            loss, grads = loss_and_grads(cfg, params, batch, bf16_grads=bf16_grads)
        lr = cosine_schedule(opt_state.step.float(), peak_lr=peak_lr, total=total_steps)
        new_params, new_state, gnorm = adamw_update(
            params, tree_unflatten(params, grads), opt_state, lr)
        return new_params, new_state, {"loss": loss.float(), "gnorm": gnorm, "lr": lr}

    return train_step


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, cache, tokens (B, 1), pos) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, cast_tree(params, torch.bfloat16), cache, tokens,
                             pos)
    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """(params, {"tokens": (B, S)[, "frames" | "vision_embeds"]}) -> (last
    logits, cache); whisper's frames and qwen2-vl's vision embeddings go
    through as given, and ``prefill`` casts them to bf16, as the reference's
    does."""
    def prefill_step(params, batch):
        return M.prefill(cfg, cast_tree(params, torch.bfloat16), batch)
    return prefill_step


# --------------------------------------------------------------------------
# training on a mesh (parameters placed by distributed.sharding)
# --------------------------------------------------------------------------


def _leaf_blocks(b: Blocks, dtype, ctx: ShardCtx) -> Blocks:
    """``b``'s blocks as new autograd leaves (cast to ``dtype`` when given):
    one per distinct block and, for a leaf not split over the data axes,
    one per data rank: its data-parallel replica, whose gradient the step
    sums over the data ranks by an explicit collective."""
    data_split = any(a != "model" for _, axes in b.sharding.split(b.ndim) for a in axes)
    src = b.grid.reshape(ctx.n_dp, ctx.n_model)
    out = np.empty(src.shape, dtype=object)
    made: dict = {}
    for d in range(ctx.n_dp):
        for m in range(ctx.n_model):
            t = src[d, m]
            key = id(t) if data_split else (d, id(t))
            if key not in made:
                made[key] = (t.detach().to(dtype) if dtype else t.detach()).requires_grad_(True)
            out[d, m] = made[key]
    return Blocks(b.sharding, b.shape, out.reshape(b.grid.shape))


def sharded_loss_and_grads(cfg: ArchConfig, params, batch: dict, *, bf16_grads: bool = True):
    """(loss, the leaves' ``Blocks`` tree, {id(leaf): gradient}) of
    ``models.model.train_loss`` on the mesh of ``params`` (a tree of
    ``Blocks``), with respect to leaf copies of the blocks (bf16 under
    ``bf16_grads``; ``_leaf_blocks``)."""
    mesh = params["embed"].sharding.mesh
    ctx = ShardCtx.for_params(mesh, params)
    leaf_tree = tree_map(lambda b: _leaf_blocks(b, torch.bfloat16 if bf16_grads else None,
                                                ctx), params)
    flat, seen = [], set()
    for b in tree_leaves(leaf_tree):
        for _, t in b.distinct():
            if id(t) not in seen:
                seen.add(id(t))
                flat.append(t)
    with use_mesh(mesh):
        loss = M.train_loss(cfg, leaf_tree, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), leaf_tree, {id(t): torch.zeros_like(t) if g is None else g
                                      for t, g in zip(flat, grads)}


def _region(block: torch.Tensor, big: NamedSharding, small: NamedSharding, coord: tuple,
            shape: tuple) -> torch.Tensor:
    """The part of rank ``coord``'s ``big``-sharded block that its
    ``small``-sharded block covers (a moment block inside its parameter
    block, under ZeRO-1)."""
    def origin(sh):
        o, bs = [0] * len(shape), sh.block_shape(shape)
        for (k, _), i in zip(sh.split(len(shape)), sh.block_index(coord, len(shape))):
            o[k] = i * bs[k]
        return o, bs
    (ob, _), (os_, bs) = origin(big), origin(small)
    out = block
    for k in range(len(shape)):
        if bs[k] != block.shape[k]:
            out = out.narrow(k, os_[k] - ob[k], bs[k])
    return out


def _reduced_grads(ctx: ShardCtx, p: Blocks, leaf: Blocks, mom: NamedSharding, grads: dict):
    """{moment block index: (coord, gradient block in float32)}: the
    gradient of parameter ``p`` in the moments' layout. A leaf replicated
    over the data axes has one gradient per data rank: summed by a psum
    over them or, when the moments are split over data (ZeRO-1), a
    reduce-scatter along the split dim (each recorded once, in the grads'
    dtype); a data-split leaf's blocks already hold the whole sum."""
    mesh, nd = ctx.mesh, len(p.shape)
    data_split = any(a != "model" for _, axes in p.sharding.split(nd) for a in axes)
    src = leaf.grid.reshape(ctx.n_dp, ctx.n_model)
    out: dict = {}
    logged = False
    zero = [k for (k, axes) in mom.split(nd) if k not in dict(p.sharding.split(nd))]
    for coord in np.ndindex(*p.grid.shape):
        key = mom.block_index(coord, nd)
        if key in out:
            continue
        flat = int(np.ravel_multi_index(coord, p.grid.shape))
        d, m = divmod(flat, ctx.n_model)
        if data_split or ctx.n_dp == 1:
            g = grads[id(src[d, m])]
        else:
            per = [grads[id(src[r, m])] for r in range(ctx.n_dp)]
            devs = [ctx.dev(r, m) for r in range(ctx.n_dp)]
            if zero:
                g = C.reduce_scatter(per, mesh, ctx.dp_axis, zero[0], devs, record=not logged)[d]
            else:
                g = C.psum(per, mesh, ctx.dp_axis, ctx.dev(d, m), record=not logged)
            logged = True
        if not zero:
            g = _region(g, p.sharding, mom, coord, p.shape)
        out[key] = (coord, g.float())
    return out


def sharded_adamw_init(params, moment_shardings) -> AdamWState:
    """Zero AdamW moments of a ``Blocks`` parameter tree, placed by
    ``moment_shardings`` (``zero1_shardings`` for ZeRO-1)."""
    def zeros(b, sh):
        return sh.shard(torch.zeros(b.shape, dtype=torch.float32,
                                    device=sh.mesh.home))
    sh = moment_shardings
    home = params["embed"].sharding.mesh.home
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=home),
                      m=tree_map(zeros, params, sh), v=tree_map(zeros, params, sh))


def make_sharded_train_step(cfg: ArchConfig, *, bf16_grads: bool = True,
                            peak_lr: float = 3e-4, total_steps: int = 10000,
                            max_grad_norm: float = 1.0):
    """``make_train_step`` on a mesh: (params, opt_state, batch) with the
    params a tree of ``Blocks`` (``param_shardings``, tp or fsdp) and the
    moments placed like them or, for ZeRO-1, by ``zero1_shardings``
    (``sharded_adamw_init``). The gradients of each rank's blocks are
    summed over the data axes (all-reduced, or reduce-scattered onto the
    moments' blocks under ZeRO-1), the global gradient norm comes from a
    psum of the blocks' squared norms, and each rank updates its own block
    (under ZeRO-1 its moments' slice, all-gathered over data after). Returns
    the new params and state, placed as given, and the metrics."""
    def train_step(params, opt_state: AdamWState, batch: dict):
        mesh = params["embed"].sharding.mesh
        ctx = ShardCtx.for_params(mesh, params)
        loss, leaf_tree, grads = sharded_loss_and_grads(cfg, params, batch,
                                                        bf16_grads=bf16_grads)
        P, L = tree_leaves(params), tree_leaves(leaf_tree)
        Mm, Vv = tree_leaves(opt_state.m), tree_leaves(opt_state.v)
        red = [_reduced_grads(ctx, p, lf, mb.sharding, grads) for p, lf, mb in zip(P, L, Mm)]
        del grads, leaf_tree, L
        sq = [torch.sum(g * g) for r in red for _, g in r.values()]
        gn = torch.sqrt(torch.stack([s.to(mesh.home) for s in sq]).sum())
        mesh.record("all-reduce", 4)
        scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-9), max=1.0)
        lr = cosine_schedule(opt_state.step.float(), peak_lr=peak_lr, total=total_steps)
        step = opt_state.step + 1
        new_p, new_m, new_v = [], [], []
        for p, mb, vb, r in zip(P, Mm, Vv, red):
            nd = len(p.shape)
            coords = [c for c, _ in r.values()]
            ps = [_region(p.grid[c], p.sharding, mb.sharding, c, p.shape) for c in coords]
            gs = [g * scale.to(g.device) for _, g in r.values()]
            np_, nm, nv = adamw_apply(ps, gs, [mb.grid[c] for c in coords],
                                      [vb.grid[c] for c in coords], step.to(ps[0].device),
                                      lr.to(ps[0].device))
            new_m.append(_placed_like(mb, coords, nm))
            new_v.append(_placed_like(vb, coords, nv))
            new_p.append(_params_from_slices(ctx, p, mb.sharding, coords, np_, nd))
        unflat = tree_unflatten
        state = AdamWState(step=step, m=unflat(opt_state.m, new_m), v=unflat(opt_state.v, new_v))
        return unflat(params, new_p), state, {"loss": loss.float(), "gnorm": gn, "lr": lr}

    return train_step


def _placed_like(b: Blocks, coords: list, blocks: list) -> Blocks:
    """``b``'s placement with the block of each rank replaced: ranks holding
    the block at ``coords[i]``'s index get ``blocks[i]``."""
    nd = len(b.shape)
    by = {b.sharding.block_index(c, nd): t for c, t in zip(coords, blocks)}
    grid = np.empty(b.grid.shape, dtype=object)
    for coord in np.ndindex(*grid.shape):
        t = by[b.sharding.block_index(coord, nd)]
        grid[coord] = t if t.device == b.grid[coord].device else t.to(b.grid[coord].device)
    return Blocks(b.sharding, b.shape, grid)


def _params_from_slices(ctx: ShardCtx, p: Blocks, mom: NamedSharding, coords: list,
                        slices: list, nd: int) -> Blocks:
    """New parameter blocks from the updated moment-layout slices: the
    slices themselves when the layouts agree, else (ZeRO-1) each parameter
    block all-gathered over the data ranks from their slices (recorded
    once)."""
    zero = [k for (k, _) in mom.split(nd) if k not in dict(p.sharding.split(nd))]
    if not zero:
        return _placed_like(p, coords, slices)
    by = {mom.block_index(c, nd): t for c, t in zip(coords, slices)}
    blocks, logged = {}, False
    for coord in np.ndindex(*p.grid.shape):
        key = p.sharding.block_index(coord, nd)
        if key in blocks:
            continue
        flat = int(np.ravel_multi_index(coord, p.grid.shape))
        _, m = divmod(flat, ctx.n_model)
        per = []
        for r in range(ctx.n_dp):
            c = np.unravel_index(r * ctx.n_model + m, p.grid.shape)
            per.append(by[mom.block_index(c, nd)])
        blocks[key] = C.all_gather_dim(per, ctx.mesh, ctx.dp_axis, zero[0], p.grid[coord].device,
                                       record=not logged)
        logged = True
    return _placed_like(p, [c for c in np.ndindex(*p.grid.shape)],
                        [blocks[p.sharding.block_index(c, nd)] for c in np.ndindex(*p.grid.shape)])


def full_grads(params, leaf_tree, grads: dict):
    """The whole gradient of each parameter (a tree of full float32
    tensors on the mesh's home) from ``sharded_loss_and_grads``' per-rank
    gradients: the data ranks' replicas summed, the blocks gathered. For
    checks; the step itself never gathers them."""
    def one(p: Blocks, leaf: Blocks):
        mesh = p.sharding.mesh
        ctx = ShardCtx.for_params(mesh, params)
        src = leaf.grid.reshape(ctx.n_dp, ctx.n_model)
        data_split = any(a != "model" for _, axes in p.sharding.split(len(p.shape)) for a in axes)
        grid = np.empty(src.shape, dtype=object)
        for d in range(ctx.n_dp):
            for m in range(ctx.n_model):
                if data_split:
                    grid[d, m] = grads[id(src[d, m])].float()
                else:
                    grid[d, m] = sum(grads[id(src[r, m])].float().to(ctx.dev(0, m))
                                     for r in range(ctx.n_dp))
        return Blocks(p.sharding, p.shape, grid.reshape(p.grid.shape)).gather()
    return tree_map(one, params, leaf_tree)
