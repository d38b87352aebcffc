"""Device meshes of the port: a named-axis grid of torch devices driven by
one process (the single-controller model of the reference's
``jax.make_mesh``; FAISS's ``IndexShards`` serves one index from several
GPUs the same way).

A ``Mesh`` carries ``axis_names``, ``shape`` (axis -> size, as
``mesh.shape[axis]`` is read throughout) and ``devices`` (an object ndarray
of ``torch.device`` in the grid's shape). The collectives of
``distributed.collectives`` add the bytes they deliver to ``log`` (bounded:
one (calls, bytes) total per collective kind).

``make_debug_mesh`` repeats one device over the grid (the card by default,
``"cpu"`` in the tests): every shard runs the same per-shard code a mesh of
cards runs. ``make_production_mesh`` maps the reference's (16, 16) and
(2, 16, 16) grids onto ``cuda:0..n-1`` and raises on a host with fewer
cards; ``device="meta"`` gives the dry-run's shape-only mesh.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclass(eq=False)  # meshes are compared by identity
class Mesh:
    axis_names: tuple[str, ...]
    devices: np.ndarray  # object ndarray of torch.device, one per grid point
    log: dict = field(default_factory=dict)  # collective kind -> (calls, bytes)

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")
        self._log_lock = threading.Lock()

    def record(self, kind: str, nbytes: int) -> None:
        """Adds one collective call delivering ``nbytes`` to ``log``."""
        with self._log_lock:
            calls, total = self.log.get(kind, (0, 0))
            self.log[kind] = (calls + 1, total + int(nbytes))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The device the controller keeps replicated operands and results
        on: the grid's first device (rank 0 of every axis)."""
        return self.devices.flat[0]

    def device_at(self, axis: str, rank: int) -> torch.device:
        """The device of ``rank`` along ``axis`` (rank 0 of the other axes)."""
        idx = tuple(rank if a == axis else 0 for a in self.axis_names)
        return self.devices[idx]


def _grid(shape: tuple[int, ...], devs: list[torch.device]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device=None) -> Mesh:
    """An (n_data, n_model) grid over ONE device repeated (the card unless
    ``device`` says otherwise)."""
    dev = resolve_device(device)
    return Mesh(("data", "model"), _grid((n_data, n_model), [dev] * (n_data * n_model)))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's (16, 16) ("data", "model") grid, or (2, 16, 16) with a
    "pod" axis. On the card each grid point is its own card and a host with
    fewer raises; ``"meta"`` (and ``"cpu"``) repeat that device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh(axes, _grid(shape, [dev] * n))
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} cards; "
                           f"this host has {have}")
    return Mesh(axes, _grid(shape, [torch.device("cuda", i) for i in range(n)]))


def mesh_chip_count(mesh: Mesh) -> int:
    n = 1
    for s in mesh.devices.shape:
        n *= s
    return n
