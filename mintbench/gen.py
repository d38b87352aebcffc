"""Seeded inputs of a cell, made on the device with torch.

The semantics are those of the paper's semi-synthetic data (MINT, arXiv
2504.20018, Sec. 5.1), as ``repro_torch/data/vectors.py`` writes them in numpy:

- a database: each row has a latent cluster shared by its columns; with
  probability ``correlation`` a column draws around that shared cluster's
  (column-specific) centroid, else around a cluster of its own; a row is its
  unit centroid plus noise of norm ``spread``, normalised;
- query templates: each column joins a template with probability ``p`` (at
  least one column), probabilities uniform on [lo, hi], normalised;
- queries: a template in those shares (a block of queries holds each
  template's share), a random row, and per column that row plus noise of
  norm ``noise``, normalised.

Every random stream is keyed by a seed and a tag: the table and the tuner's
template queries by the configuration's ``data_seed`` (the deployment, the
same in every run), the served queries by the run's ``--seed``: each one a
fresh row and fresh noise, its template from a block that holds every
template's share. So the same seed gives the same inputs, every seed sends
the same mix of templates, and no query of a stream repeats another.
Imports nothing of the program.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for stream ``tags`` of run ``seed``."""
    key = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def clusters_for(cfg: dict) -> int:
    """The configuration's cluster count; ``null`` is the generator's
    default, max(16, floor(sqrt(rows)))."""
    n = cfg.get("clusters")
    return int(n) if n is not None else max(16, int(np.sqrt(cfg["rows"])))


def make_columns(cfg: dict, seed: int, device) -> list[torch.Tensor]:
    """The database's columns, (rows, d) float32 unit rows each, on ``device``."""
    n, n_cl = int(cfg["rows"]), clusters_for(cfg)
    shared = torch.randint(0, n_cl, (n,), generator=generator(device, seed, "shared"),
                           device=device)
    cols = []
    for i, (_, d) in enumerate(cfg["columns"]):
        g = generator(device, seed, "column", i)
        cent = unit(torch.randn(n_cl, d, generator=g, device=device))
        own = torch.randint(0, n_cl, (n,), generator=g, device=device)
        use_shared = torch.rand(n, generator=g, device=device) < cfg["correlation"]
        x = unit(torch.randn(n, d, generator=g, device=device)).mul_(cfg["spread"])
        x += cent[torch.where(use_shared, shared, own)]
        cols.append(unit(x))
    return cols


def templates(n_cols: int, spec: dict) -> tuple[list[tuple[int, ...]], np.ndarray]:
    """The mix's query templates (column subsets) and their normalised
    probabilities, drawn with numpy from the mix's own template seed exactly
    as the paper's generator does (``binomial_vids``, then ``uniform``)."""
    rng = np.random.default_rng(spec["seed"])
    vids: list[tuple[int, ...]] = []
    while len(vids) < spec["n"]:
        mask = rng.random(n_cols) < spec["p"]
        if not mask.any():
            mask[rng.integers(0, n_cols)] = True
        vids.append(tuple(int(i) for i in np.nonzero(mask)[0]))
    probs = np.random.default_rng(spec["seed"] + 17).uniform(
        spec["prob_low"], spec["prob_high"], size=len(vids))
    return vids, probs / probs.sum()


def query_vectors(cols: list[torch.Tensor], rows: torch.Tensor, noise: float,
                  g: torch.Generator) -> torch.Tensor:
    """(len(rows), sum of dims) float32: per column, the row plus noise of
    norm ``noise``, normalised, the columns side by side."""
    parts = []
    for col in cols:
        x = col[rows]
        x += unit(torch.randn(x.shape, generator=g, device=x.device)).mul_(noise)
        parts.append(unit(x))
    return torch.cat(parts, dim=1)


def template_stream(probs: np.ndarray, count: int, block: int,
                    g: torch.Generator) -> torch.Tensor:
    """(count,) template indices: blocks of ``block`` queries, each holding
    every template's share of the block (largest remainders, the same in
    every block), shuffled by ``g``. So every seed sends the same mix in
    another order, and any run of whole blocks has the stated shares."""
    share = probs * block
    quota = np.floor(share).astype(np.int64)
    quota[np.argsort(-(share - quota), kind="stable")[:block - quota.sum()]] += 1
    base = torch.as_tensor(np.repeat(np.arange(len(probs)), quota), device=g.device)
    n = -(-count // block)
    order = torch.stack([torch.randperm(block, generator=g, device=g.device)
                         for _ in range(n)])
    return base[order].reshape(-1)[:count]


def draw_queries(cols: list[torch.Tensor], probs: np.ndarray, count: int, block: int,
                 noise: float, seed: int, tag: str) -> tuple[np.ndarray, np.ndarray]:
    """``count`` queries of stream ``tag``: (template index (count,) int64,
    host vectors (count, sum of dims) float32)."""
    device = cols[0].device
    g = generator(device, seed, "queries", tag)
    which = template_stream(probs, count, block, g)
    rows = torch.randint(0, cols[0].shape[0], (count,), generator=g, device=device)
    vecs = query_vectors(cols, rows, noise, g)
    return which.cpu().numpy().astype(np.int64), vecs.cpu().numpy()


def template_vectors(cols: list[torch.Tensor], n: int, noise: float,
                     seed: int) -> np.ndarray:
    """One query per template for the tuner: (n, sum of dims) float32, rows
    drawn at random as the paper's ``make_queries`` does."""
    device = cols[0].device
    g = generator(device, seed, "templates")
    rows = torch.randint(0, cols[0].shape[0], (n,), generator=g, device=device)
    return query_vectors(cols, rows, noise, g).cpu().numpy()
