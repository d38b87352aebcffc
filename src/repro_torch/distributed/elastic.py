"""Elastic scaling: reshard a checkpoint onto a different mesh, as
``repro.distributed.elastic``.

Checkpoints store full (unsharded) arrays (``train.checkpoint``), so
resharding is a placement problem, not a data problem: ``reshard_tree``
lays the same global tensors out in the blocks of the NEW mesh (a tree
already placed on another mesh is gathered first). Batch-dependent state
(none in params/optimizer) never blocks a topology change; training resumes
on any mesh whose axes divide the tensor dims — verified by
``check_mesh_fits`` (the port also places dims that do not divide, as
zero-padded blocks, but reports them as the reference does).
"""
from __future__ import annotations

from repro_torch.distributed.sharding import (Blocks, leaves_with_path, param_shardings,
                                              param_spec, shard_tree, tree_map)


def check_mesh_fits(params_abs, mesh) -> list[str]:
    """Return a list of (path, problem) strings; empty == mesh is usable.
    Leaves in the reference's order, paths printed as its key paths."""
    problems = []
    for path, leaf in leaves_with_path(params_abs):
        spec = param_spec(path, leaf)
        for ax, name in enumerate(spec):
            if name is None:
                continue
            size = 1
            for n in (name if isinstance(name, tuple) else (name,)):
                size *= mesh.shape[n]
            if leaf.shape[ax] % size != 0:
                problems.append(f"{_key_path(path)}: dim {ax} ({leaf.shape[ax]}) "
                                f"% {name}({size}) != 0")
    return problems


def _key_path(path) -> str:
    """A leaf path as JAX prints a key path (a tuple of ``DictKey`` /
    ``GetAttrKey`` / ``SequenceKey``)."""
    def key(p):
        if isinstance(p, int):
            return f"SequenceKey(idx={p})"
        if type(p) is not str:  # a NamedTuple field (``sharding._Field``)
            return f"GetAttrKey(name={p[1:]!r})"
        return f"DictKey(key={p!r})"
    keys = [key(p) for p in path]
    return "(" + ", ".join(keys) + ("," if len(keys) == 1 else "") + ")"


def reshard_tree(tree, mesh):
    """Place a tree of full tensors (or host arrays, or ``Blocks`` of another
    mesh, gathered first) onto ``mesh`` with the standard (tp) rules."""
    full = tree_map(lambda x: x.gather() if isinstance(x, Blocks) else x, tree)
    return shard_tree(full, param_shardings(full, mesh))


def resize_data_parallel(batch_arrays: dict, old_dp: int, new_dp: int) -> dict:
    """Deterministic re-bucketing of per-host data-loader state when the
    data-parallel world changes (elastic scale up/down): shard i of old_dp
    maps to shards [i*new/old, ...) of new_dp."""
    assert old_dp > 0 and new_dp > 0
    mapping = {}
    for i in range(new_dp):
        mapping[i] = int(i * old_dp / new_dp)
    return mapping
