"""Serve steps of the model substrate, as in ``repro.train.step``: the
prefill and decode steps cast the parameters to bf16 first. The training
step waits for the training slice (ROADMAP.md, Queue 1, item 12)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; a leaf already in it is returned
    as it is (no copy), so a bf16 tree costs no memory."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, cache, tokens (B, 1), pos) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, cast_tree(params, torch.bfloat16), cache, tokens,
                             pos)
    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """(params, {"tokens": (B, S)}) -> (last logits, cache)."""
    def prefill_step(params, batch):
        return M.prefill(cfg, cast_tree(params, torch.bfloat16), batch)
    return prefill_step
