"""Device-resident column store.

Materializes each vid's concatenated matrix exactly once:

  - ``host(vid)``   — the numpy concat, cached (planner / CPU harness);
  - ``device(vid)`` — the same matrix padded to the kernel block shapes
    (rows → ``block_rows``, feature dim → ``block_dim``) and resident on the
    store's device, so repeated scans skip the transfer and the per-call pad.

Padding policy: pad rows/dims with zeros; zero feature padding is exact for
dot scores, and padded rows are masked inside the scans via their
``valid_n`` argument (they must never win a top-k slot). The padded
footprint arithmetic is the reference's, so device-byte accounting matches.

Under a mesh (``launch.mesh.Mesh``) the row count is additionally rounded up
to a multiple of the data-axis size and each column is held as its per-rank
row blocks in the layout of ``distributed.sharding.row_sharding``, which the
distributed tournament scan consumes directly. Where every rank shares one
device (a debug mesh) the blocks are views of one padded tensor: no extra
bytes. A sharded column has no whole-column tensor (``data`` is None).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.types import Vid, norm_vid
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.distributed.sharding import row_sharding
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import Mesh


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def padded_device_bytes(n_rows: int, dim: int, block_rows: int = 128,
                        block_dim: int = 128, row_mult: int = 1,
                        itemsize: int = 4) -> int:
    """Device footprint of one resident column AFTER kernel-block padding —
    what a column actually pins on device, not its logical nbytes.
    ``row_mult`` is the mesh data-axis size when row-sharded."""
    rm = _round_up(block_rows, row_mult) if row_mult > 1 else block_rows
    return _round_up(n_rows, rm) * _round_up(dim, block_dim) * itemsize


@dataclass
class DeviceColumn:
    """One vid's device-resident concat, padded to kernel block shapes:
    one tensor (``data``), or under a mesh its per-rank row blocks
    (``shards``, ``data`` None)."""

    vid: Vid
    data: torch.Tensor | None  # (n_padded, dim_padded), zero-padded
    n_rows: int                # valid rows (the scans' valid_n)
    dim: int                   # valid feature dim
    shards: list[torch.Tensor] | None = None  # per-rank (n_local, dim_padded)
    # layout -> per-rank blocks of ``data`` (a single-device column scanned
    # under a mesh); not charged to ``device_bytes``
    _cuts: dict = field(default_factory=dict, repr=False, compare=False)

    def _blocks(self) -> list[torch.Tensor]:
        return self.shards if self.data is None else [self.data]

    def cut(self, layout) -> list[torch.Tensor]:
        """``data`` in ``layout``'s per-rank row blocks, cut on first use."""
        if layout not in self._cuts:
            self._cuts[layout] = layout.shard(self.data)
        return self._cuts[layout]

    @property
    def padded_rows(self) -> int:
        return sum(int(b.shape[0]) for b in self._blocks())

    @property
    def padded_dim(self) -> int:
        return int(self._blocks()[0].shape[1])

    @property
    def device(self) -> torch.device:
        """Where queries go: the tensor's device, or rank 0's."""
        return self._blocks()[0].device

    @property
    def device_bytes(self) -> int:
        """PADDED device footprint (the governor's accounting unit); row
        blocks partition the padded rows, so views of one tensor count it
        once."""
        return sum(int(b.numel()) * int(b.element_size()) for b in self._blocks())

    def pad_host(self, qmat: np.ndarray) -> np.ndarray:
        """(B, dim) host queries -> (B, padded_dim) contiguous host float32."""
        qmat = np.asarray(qmat, dtype=np.float32)
        if qmat.shape[1] != self.dim:
            raise ValueError(f"query dim {qmat.shape[1]} != column dim {self.dim}")
        if self.padded_dim != self.dim:
            qmat = np.pad(qmat, ((0, 0), (0, self.padded_dim - self.dim)))
        return np.ascontiguousarray(qmat)

    def pad_queries(self, qmat: np.ndarray) -> torch.Tensor:
        """(B, dim) host queries -> (B, padded_dim) tensor on the column's device."""
        return torch.as_tensor(self.pad_host(qmat), device=self.device)


class ColumnStore:
    """Per-vid concat cache over one MultiVectorDatabase (host + device)."""

    def __init__(self, db: MultiVectorDatabase, mesh=None, axis: str = "data",
                 block_rows: int = 128, block_dim: int = 128, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.db = db
        self.mesh = mesh
        self.axis = axis
        self.block_rows = block_rows
        self.block_dim = block_dim
        # ``device`` names the method below, so the target is ``torch_device``:
        # under a mesh, the mesh's home device (queries and results live there)
        if mesh is None:
            self.torch_device = resolve_device(device)
        else:
            self.torch_device = mesh.home
            if device is not None and resolve_device(device) != mesh.home:
                raise ValueError(f"device {device} is not the mesh's home {mesh.home}")
        self._host: dict[Vid, np.ndarray] = {}
        self._device: dict[Vid, DeviceColumn] = {}

    @property
    def n_rows(self) -> int:
        return self.db.n_rows

    def host(self, vid: Vid) -> np.ndarray:
        """Cached ``db.concat(vid)`` (single columns alias the db storage)."""
        vid = norm_vid(vid)
        if vid not in self._host:
            self._host[vid] = self.db.concat(vid)
        return self._host[vid]

    def device(self, vid: Vid) -> DeviceColumn:
        vid = norm_vid(vid)
        if vid not in self._device:
            self._device[vid] = self.upload(vid)
        return self._device[vid]

    def upload(self, vid: Vid) -> DeviceColumn:
        """Column ``vid`` padded on the host and put on the device (or the
        mesh's row blocks); the store does not hold it yet."""
        mat = self.host(vid)
        n, d = mat.shape
        np_pad = _round_up(n, self._row_mult()) - n
        nd_pad = _round_up(d, self.block_dim) - d
        if np_pad or nd_pad:
            mat = np.pad(mat, ((0, np_pad), (0, nd_pad)))
        mat = np.ascontiguousarray(mat)
        if self.mesh is None:
            return DeviceColumn(vid=vid, data=torch.as_tensor(mat, device=self.torch_device),
                                n_rows=n, dim=d)
        return DeviceColumn(vid=vid, data=None, n_rows=n, dim=d,
                            shards=row_sharding(self.mesh, self.axis).shard(mat))

    def _row_mult(self) -> int:
        if self.mesh is None:
            return self.block_rows
        return _round_up(self.block_rows, int(self.mesh.shape[self.axis]))

    def device_bytes(self, vid: Vid) -> int:
        """Padded device bytes ``device(vid)`` would pin — computable BEFORE
        materialization, and equal to ``device(vid).device_bytes`` after."""
        row_mult = 1 if self.mesh is None else int(self.mesh.shape[self.axis])
        return padded_device_bytes(self.db.n_rows, self.db.dim(norm_vid(vid)),
                                   block_rows=self.block_rows,
                                   block_dim=self.block_dim, row_mult=row_mult)

    def total_device_bytes(self) -> int:
        return sum(col.device_bytes for col in self._device.values())

    def evict_device(self, vid: Vid) -> bool:
        """Release one resident column (the host concat stays cached, so a
        later ``device()`` re-pads and re-uploads bit-identically)."""
        return self._device.pop(norm_vid(vid), None) is not None

    def resident(self) -> list[Vid]:
        return sorted(self._device)

    def materialized(self) -> list[Vid]:
        return sorted(set(self._host) | set(self._device))
