"""Collectives over a single-controller mesh: the port's counterparts of
``jax.lax.all_gather`` and ``jax.lax.psum`` inside ``shard_map``.

Each takes one tensor per rank along ``axis`` (rank r's on its device) and
delivers the result to ``home``. Each call adds its bytes to ``mesh.log``
(``Mesh.record``) in the reference's unit (its ``launch/roofline.py:
collective_bytes`` counts each collective op's per-device RESULT shape):
an all-gather of S blocks of shape s delivers S * |s| elements, an
all-reduce |s|. ``launch.roofline.collective_bytes`` reports the log.

``take_rows`` reads whole rows of a row-sharded matrix from the shards
that own them (what GSPMD does for a gather from a row-sharded array in
the reference); it is not one of the reference's counted collectives and
records nothing.
"""
from __future__ import annotations

import torch


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


def all_gather(per_rank: list[torch.Tensor], mesh, axis: str,
               home: torch.device) -> torch.Tensor:
    """(S, *shape) on ``home``: rank r's tensor at index r."""
    if len(per_rank) != mesh.shape[axis]:
        raise ValueError(f"{len(per_rank)} tensors for {mesh.shape[axis]} ranks of {axis!r}")
    out = torch.stack([t.to(home) for t in per_rank])
    mesh.record("all-gather", _nbytes(out))
    return out


def psum(per_rank: list[torch.Tensor], mesh, axis: str,
         home: torch.device) -> torch.Tensor:
    """The elementwise sum of the ranks' tensors on ``home``, in rank order."""
    if len(per_rank) != mesh.shape[axis]:
        raise ValueError(f"{len(per_rank)} tensors for {mesh.shape[axis]} ranks of {axis!r}")
    out = per_rank[0].to(home)
    for t in per_rank[1:]:
        out = out + t.to(home)
    mesh.record("all-reduce", _nbytes(out))
    return out


def take_rows(shards: list[torch.Tensor], ids: torch.Tensor,
              home: torch.device) -> torch.Tensor:
    """Rows ``ids`` (any shape, global row numbers) of the matrix whose
    equal row blocks are ``shards`` -> (*ids.shape, d) on ``home``; each row
    is read from the shard that owns it."""
    n_local, d = shards[0].shape
    flat = ids.reshape(-1).to(home)
    out = torch.empty((flat.shape[0], d), dtype=shards[0].dtype, device=home)
    owner = torch.div(flat, n_local, rounding_mode="floor")
    taken = 0
    for r, x in enumerate(shards):
        pos = torch.nonzero(owner == r).squeeze(1)
        if pos.numel():
            out[pos] = x[(flat[pos] - r * n_local).to(x.device)].to(home)
            taken += pos.numel()
    if taken != flat.shape[0]:
        raise IndexError(f"{flat.shape[0] - taken} row ids outside the "
                         f"{len(shards) * n_local} sharded rows")
    return out.reshape(*ids.shape, d)
