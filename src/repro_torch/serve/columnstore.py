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
Single device only: a mesh raises until the distributed slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.types import Vid, norm_vid
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.kernels.common import resolve_device


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
    """One vid's device-resident concat, padded to kernel block shapes."""

    vid: Vid
    data: torch.Tensor  # (n_padded, dim_padded), zero-padded
    n_rows: int         # valid rows (the scans' valid_n)
    dim: int            # valid feature dim

    @property
    def padded_dim(self) -> int:
        return int(self.data.shape[1])

    @property
    def device_bytes(self) -> int:
        """PADDED device footprint (the governor's accounting unit)."""
        return int(self.data.numel()) * int(self.data.element_size())

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
        return torch.as_tensor(self.pad_host(qmat), device=self.data.device)


class ColumnStore:
    """Per-vid concat cache over one MultiVectorDatabase (host + device)."""

    def __init__(self, db: MultiVectorDatabase, mesh=None, axis: str = "data",
                 block_rows: int = 128, block_dim: int = 128, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded columns are the distributed slice (ROADMAP.md, "
                "Queue 1); the port serves from one device")
        self.db = db
        self.axis = axis
        self.block_rows = block_rows
        self.block_dim = block_dim
        # ``device`` names the method below, so the target is ``torch_device``
        self.torch_device = resolve_device(device)
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
            mat = self.host(vid)
            n, d = mat.shape
            np_pad = _round_up(n, self.block_rows) - n
            nd_pad = _round_up(d, self.block_dim) - d
            if np_pad or nd_pad:
                mat = np.pad(mat, ((0, np_pad), (0, nd_pad)))
            arr = torch.as_tensor(np.ascontiguousarray(mat), device=self.torch_device)
            self._device[vid] = DeviceColumn(vid=vid, data=arr, n_rows=n, dim=d)
        return self._device[vid]

    def device_bytes(self, vid: Vid) -> int:
        """Padded device bytes ``device(vid)`` would pin — computable BEFORE
        materialization, and equal to ``device(vid).device_bytes`` after."""
        return padded_device_bytes(self.db.n_rows, self.db.dim(norm_vid(vid)),
                                   block_rows=self.block_rows,
                                   block_dim=self.block_dim)

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
