"""Checkpointing, as ``repro.train.checkpoint``: atomic (write a tmp dir,
then rename), keep-last-k, an optional async writer.

Layout (the reference's, file for file): ``<dir>/step_<n:08d>/`` with one
``.npy`` per leaf, named ``<index:04d>_<leaf name>.npy``, and a
``manifest.json`` of the step and each leaf's file, name, shape and dtype;
bf16 leaves are stored as float32 with the tag ``bfloat16``. Leaves and
their names follow the reference's ``_leaf_paths`` for the same tree
(dict keys sorted, a tuple's items by index, a NamedTuple's fields as
``.field``), so each package restores the other's checkpoints. Restores
check every leaf's shape against the tree they restore into.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch


def _leaf_paths(tree, path=()) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) pairs in the reference's order and naming."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k], path + (str(k),))]
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        keys = [f".{f}" for f in fields] if fields else [str(i) for i in range(len(tree))]
        return [x for k, t in zip(keys, tree) for x in _leaf_paths(t, path + (k,))]
    return [(re.sub(r"[^A-Za-z0-9_.-]", "_", "/".join(path)) or "leaf", tree)]


def _to_savable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array npy can hold, and its dtype tag: bf16 as
    float32 (lossless)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy(), "bfloat16"
    # a host copy: the caller may change the tensor while an async write runs
    arr = (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    async_write: bool = False) -> str:
    """Atomic checkpoint save; returns the final directory path. The leaves
    are copied to the host before this returns, so an async write may run
    while the caller goes on changing its tensors."""
    leaves = [(name, *_to_savable(t)) for name, t in _leaf_paths(tree)]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr, dtype_tag) in enumerate(leaves):
            fname = f"{i:04d}_{name[:120]}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"file": fname, "name": name,
                                       "shape": list(arr.shape), "dtype": dtype_tag})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
        return final

    if async_write:
        threading.Thread(target=_write, daemon=True).start()
        return os.path.join(ckpt_dir, f"step_{step:08d}")
    return _write()


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def load_arrays(ckpt_dir: str, step: int) -> tuple[list[np.ndarray], dict]:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return [np.load(os.path.join(d, leaf["file"])) for leaf in manifest["leaves"]], manifest


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple):
        items = [_rebuild(t, it) for t in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    return next(it)


def restore_checkpoint(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of ``tree_like``: each leaf in the dtype
    and on the device of ``tree_like``'s (shape-checked)."""
    arrays, manifest = load_arrays(ckpt_dir, step)
    leaves = [t for _, t in _leaf_paths(tree_like)]
    if len(arrays) != len(leaves):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, expected {len(leaves)}")
    for arr, leaf, meta in zip(arrays, leaves, manifest["leaves"]):
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {meta['name']}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}: the tree is not the one saved")
    restored = [torch.as_tensor(a).to(device=leaf.device, dtype=leaf.dtype)
                for a, leaf in zip(arrays, leaves)]
    return _rebuild(tree_like, iter(restored))
