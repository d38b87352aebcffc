"""Logical-axis sharding of the port: the serving part.

``row_sharding(mesh, axis)`` is the row-shard layout the column store and
the distributed tournament scan agree on: over ``S = mesh.shape[axis]``
ranks, the rows of rank r are ``[r * n_local, (r + 1) * n_local)`` and live
on the device of rank r along ``axis`` (rank 0 of the other axes; the
reference replicates each shard over them, which changes no result).

``shard_act`` mirrors the reference's entry point for models: outside a
mesh (``use_mesh``) it is the identity. Inside one it raises, because model
sharding (``PARAM_RULES``, ``param_shardings``, ``cache_shardings``,
sequence parallelism, ``elastic.py``, ``zero1_shardings``, the activation
layouts) is a slice of its own (ROADMAP.md, Queue 1 item 6b: model
sharding); training runs on one card.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

_STATE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


def shard_act(x: torch.Tensor, layout: str) -> torch.Tensor:
    """The identity outside a mesh, as in the reference; ``layout`` names
    the activation layout its models pass."""
    if current_mesh() is None:
        return x
    raise NotImplementedError(
        "model sharding inside a mesh is not ported yet (ROADMAP.md, Queue 1 item 6b: "
        "model sharding); serving shards database rows only (row_sharding) and "
        "training runs on one card")


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclass(frozen=True)
class RowSharding:
    """Rows split into equal contiguous blocks over ``mesh.shape[axis]``."""

    mesh: object
    axis: str = "data"

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def devices(self) -> list[torch.device]:
        return [self.mesh.device_at(self.axis, r) for r in range(self.n_shards)]

    def shard(self, x) -> list[torch.Tensor]:
        """Per-rank row blocks of ``x`` (a tensor or a host array), each on
        its rank's device. Rows are zero-padded to a multiple of the shard
        count first (a copy, only when they do not divide); callers mask the
        padding through their ``valid_n``. Where every rank shares the
        tensor's device the blocks are views of it: no extra bytes."""
        devs = self.devices()
        if not isinstance(x, torch.Tensor):  # one upload when one device holds all
            x = torch.as_tensor(np.ascontiguousarray(x),
                                device=devs[0] if len(set(devs)) == 1 else "cpu")
        S = len(devs)
        pad = _round_up(x.shape[0], S) - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        n_local = x.shape[0] // S
        return [x[r * n_local:(r + 1) * n_local].to(d) for r, d in enumerate(devs)]


def row_sharding(mesh, axis: str = "data") -> RowSharding:
    """Row-sharded (N, d) placement for database matrices: the layout the
    serving column store and the distributed tournament scan agree on."""
    return RowSharding(mesh, axis)
