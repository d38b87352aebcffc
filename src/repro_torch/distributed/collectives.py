"""Collectives over a single-controller mesh: the port's counterparts of
``jax.lax.all_gather``, ``psum``, ``psum_scatter``, ``pmax`` and
``all_to_all`` inside ``shard_map``, and of the collectives GSPMD inserts
for the model's shardings.

Each takes one tensor per rank along ``axis`` (a mesh axis name or a tuple
of them; rank r's tensor on its device) and delivers the result to ``home``
or, for the scattering ones, block r to ``devices[r]``. Each call adds its
bytes to ``mesh.log`` (``Mesh.record``) in the reference's unit (its
``launch/roofline.py: collective_bytes`` counts each collective op's
per-device RESULT shape): an all-gather of S blocks of shape s delivers
S * |s| elements, an all-reduce |s|, a reduce-scatter |s| / S, an all-to-all
one rank's new block. ``launch.roofline.collective_bytes`` reports the log.
``record=False`` runs a collective without logging it: the model code logs
an op that every data rank's group runs at once only once, as one op of
the per-device program.

All are plain torch operations across the ranks' tensors (moves, cat,
sums, slices), so autograd differentiates through them: an all-gather's
gradient is the reduce-scatter of the blocks' gradients, a psum's the
gradient delivered to every rank, a reduce-scatter's an all-gather.

``take_rows`` reads whole rows of a row-sharded matrix from the shards
that own them (what GSPMD does for a gather from a row-sharded array in
the reference); it is not one of the reference's counted collectives and
records nothing.
"""
from __future__ import annotations

import contextlib
import threading

import torch


class _NoTrace:
    """The hooks a counting pass (``launch.cost_count``) fills in: ``quiet``
    wraps a collective's own data movement (not compute), ``deliver`` tells
    it which ranks hold each result, ``place`` which rank holds each block
    of a placed tensor made inside a step, and ``rank`` returns a tensor
    (``t`` itself, or an alias the pass marks) that it attributes to data
    rank ``d`` or model rank ``m``: one the controller made for that rank
    alone. Off by default; ``tracing`` sets a hook for the calling thread
    only, as a ``TorchDispatchMode`` is, so other threads' work is not
    counted."""

    def quiet(self):
        return contextlib.nullcontext()

    def deliver(self, outs, ins, mesh, axis, scattered: bool = False) -> None:
        pass

    def place(self, blocks) -> None:
        pass

    def rank(self, t, d: int | None = None, m: int | None = None):
        return t


_NO_TRACE = _NoTrace()
_LOCAL = threading.local()


def trace():
    """The calling thread's hook (``_NoTrace`` unless ``tracing`` set one)."""
    return getattr(_LOCAL, "hook", _NO_TRACE)


@contextlib.contextmanager
def tracing(hook):
    """``hook`` as the calling thread's ``trace()`` inside the block."""
    prev = trace()
    _LOCAL.hook = hook
    try:
        yield hook
    finally:
        _LOCAL.hook = prev


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


def _check(per_rank: list, mesh, axis) -> None:
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= mesh.shape[a]
    if len(per_rank) != n:
        raise ValueError(f"{len(per_rank)} tensors for {n} ranks of {axis!r}")


def all_gather(per_rank: list[torch.Tensor], mesh, axis,
               home: torch.device) -> torch.Tensor:
    """(S, *shape) on ``home``: rank r's tensor at index r."""
    _check(per_rank, mesh, axis)
    with trace().quiet():
        out = torch.stack([t.to(home) for t in per_rank])
    trace().deliver([out], per_rank, mesh, axis)
    mesh.record("all-gather", _nbytes(out))
    return out


def all_gather_dim(per_rank: list[torch.Tensor], mesh, axis, dim: int,
                   home: torch.device, size: int | None = None, *,
                   record: bool = True) -> torch.Tensor:
    """The ranks' blocks joined along ``dim`` on ``home`` (``jax.lax.
    all_gather(..., tiled=True)``), cut to ``size`` along it when the last
    block carries padding."""
    _check(per_rank, mesh, axis)
    with trace().quiet():
        out = torch.cat([t.to(home) for t in per_rank], dim=dim)
        if size is not None and out.shape[dim] != size:
            out = out.narrow(dim, 0, size)
    trace().deliver([out], per_rank, mesh, axis)
    if record:
        mesh.record("all-gather", _nbytes(out))
    return out


def psum(per_rank: list[torch.Tensor], mesh, axis,
         home: torch.device, *, record: bool = True) -> torch.Tensor:
    """The elementwise sum of the ranks' tensors on ``home``, in rank order
    (a rank that holds None adds nothing: one without a part to sum)."""
    _check(per_rank, mesh, axis)
    live = [t for t in per_rank if t is not None]
    with trace().quiet():
        out = live[0].to(home)
        for t in live[1:]:
            out = out + t.to(home)
    trace().deliver([out], live, mesh, axis)
    if record:
        mesh.record("all-reduce", _nbytes(out))
    return out


def pmax(per_rank: list[torch.Tensor], mesh, axis,
         home: torch.device, *, record: bool = True) -> torch.Tensor:
    """The elementwise max of the ranks' tensors on ``home`` (an all-reduce)."""
    _check(per_rank, mesh, axis)
    with trace().quiet():
        out = per_rank[0].to(home)
        for t in per_rank[1:]:
            out = torch.maximum(out, t.to(home))
    trace().deliver([out], per_rank, mesh, axis)
    if record:
        mesh.record("all-reduce", _nbytes(out))
    return out


def _blocks(t: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    """``t`` cut into n ceil-sized blocks along ``dim``, the last zero-padded."""
    b = -(-t.shape[dim] // n)
    pad = b * n - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    return list(torch.split(t, b, dim=dim))


def reduce_scatter(per_rank: list[torch.Tensor], mesh, axis, dim: int,
                   devices: list, *, record: bool = True) -> list[torch.Tensor]:
    """The ranks' elementwise sum (in rank order), cut along ``dim`` into one
    block per rank (ceil-sized, the last zero-padded); block r on
    ``devices[r]`` (``jax.lax.psum_scatter(..., tiled=True)``). A rank that
    holds None adds nothing."""
    _check(per_rank, mesh, axis)
    home = devices[0]
    live = [t for t in per_rank if t is not None]
    with trace().quiet():
        total = live[0].to(home)
        for t in live[1:]:
            total = total + t.to(home)
        out = [b.to(d) for b, d in zip(_blocks(total, len(per_rank), dim), devices)]
    trace().deliver(out, live, mesh, axis, scattered=True)
    if record:
        mesh.record("reduce-scatter", _nbytes(out[0]))
    return out


def all_to_all(per_rank: list[torch.Tensor], mesh, axis, split_dim: int,
               concat_dim: int, devices: list, *, record: bool = True) -> list[torch.Tensor]:
    """Rank r cuts its tensor along ``split_dim`` into one block per rank
    (ceil-sized, the last zero-padded) and sends block s to rank s; rank s
    joins the blocks it gets along ``concat_dim`` in rank order, on
    ``devices[s]`` (``jax.lax.all_to_all``, tiled)."""
    _check(per_rank, mesh, axis)
    n = len(per_rank)
    with trace().quiet():
        cut = [_blocks(t, n, split_dim) for t in per_rank]
        out = [torch.cat([cut[r][s].to(devices[s]) for r in range(n)], dim=concat_dim)
               for s in range(n)]
    trace().deliver(out, per_rank, mesh, axis, scattered=True)
    if record:
        mesh.record("all-to-all", _nbytes(out[0]))
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
