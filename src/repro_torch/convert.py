"""State carried across from the reference package, as plain arrays.

The copied ``data.vectors.make_database`` gives identical data from the same
seed, so data needs no carrying. What float reductions may legitimately
change in the last bits — k-means centroids and assignments, the fitted
estimator numbers — can be carried over from the reference's numpy state,
so that everything downstream can be held to exact equality. Model weights
are carried the same way, so that the port and the reference compute the
same model. These functions take numpy arrays and numbers, never objects of
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estimators import (ColumnStats, EstimatorBundle, LinearFit,
                                         LogFit)
from repro_torch.core.types import IndexSpec
from repro_torch.data.vectors import MultiVectorDatabase
from repro_torch.index.base import VectorIndex
from repro_torch.index.ivf import IVFFlatIndex
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device


def ivf_from_arrays(data: np.ndarray, centroids: np.ndarray, row_ids: np.ndarray,
                    offsets: np.ndarray, n_lists: int, device=None) -> IVFFlatIndex:
    """The port's ``IVFFlatIndex`` over ``data`` with a built index's
    centroid table and inverted lists (no k-means is run)."""
    idx = IVFFlatIndex.__new__(IVFFlatIndex)
    VectorIndex.__init__(idx, data)
    idx.device = resolve_device(device)
    idx.centroids = np.asarray(centroids, dtype=np.float32)
    idx.row_ids = np.asarray(row_ids, dtype=np.int64)
    idx.offsets = np.asarray(offsets)
    idx.n_lists = int(n_lists)
    return idx


def index_store_from_arrays(db: MultiVectorDatabase,
                            ivf_states: dict[tuple, dict], seed: int = 0,
                            device=None) -> IndexStore:
    """An ``IndexStore`` holding IVF indexes rebuilt from arrays:
    ``ivf_states`` maps a vid to ``dict(centroids=, row_ids=, offsets=,
    n_lists=)``. Specs not given are built as usual on first use."""
    store = IndexStore(db, seed=seed, device=device)
    for vid, st in ivf_states.items():
        spec = IndexSpec(vid=tuple(vid), kind="ivf")
        store._cache[spec] = ivf_from_arrays(db.concat(spec.vid), st["centroids"],
                                             st["row_ids"], st["offsets"],
                                             st["n_lists"], device=store.device)
    return store


def estimators_from_arrays(stats: dict, dims: list[int], n_rows: int,
                           sample_rate: float, train_seconds: float = 0.0,
                           theta_hit: float = 0.95) -> EstimatorBundle:
    """An ``EstimatorBundle`` from fitted numbers: ``stats`` maps a
    (column or "__all__", kind) key to ``dict(cost=(slope, intercept),
    recall=(alpha, beta, lo, hi), rec_eks=array, rec_vals=array)``."""
    out = {}
    for key, st in stats.items():
        out[key] = ColumnStats(
            cost=LinearFit(*map(float, st["cost"])),
            recall=LogFit(*map(float, st["recall"])),
            rec_eks=np.asarray(st["rec_eks"], dtype=np.float64),
            rec_vals=np.asarray(st["rec_vals"], dtype=np.float64))
    return EstimatorBundle(stats=out, dims=list(dims), n_rows=int(n_rows),
                           sample_rate=float(sample_rate),
                           train_seconds=float(train_seconds),
                           theta_hit=float(theta_hit))


def model_params_from_jax(params: dict, device=None) -> dict:
    """The port's parameter tree from the reference's ``init_params`` tree
    with every leaf as a numpy array (``jax.tree.map(np.asarray, params)``):
    the same nesting, keys, stacked (L, ...) layer axis and dtypes, on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    if isinstance(params, dict):
        return {k: model_params_from_jax(v, device) for k, v in params.items()}
    return torch.as_tensor(np.array(params), device=device)
