"""The train and serve steps of the model substrate, as in
``repro.train.step``.

The training step's knobs are the reference's: ``bf16_grads`` takes the
gradient with respect to a bf16 copy of the parameters (the grads are bf16,
as JAX's are; the f32 master params and Adam moments absorb the rounding),
``microbatch`` accumulates the gradients of equal slices of the batch in
float32, and remat comes from ``ArchConfig.remat`` (per-block
recomputation in ``models.model``). The serve steps cast the parameters to
bf16 first.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import (AdamWState, adamw_update, cosine_schedule,
                                         tree_leaves, tree_unflatten)


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; a leaf already in it is returned
    as it is (no copy), so a bf16 tree costs no memory."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
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
