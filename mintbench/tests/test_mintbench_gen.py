"""The torch generator against the paper's generator in numpy
(``repro_torch/data/vectors.py``) at a tiny size."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mintbench import gen
from repro_torch.data.vectors import (binomial_vids, make_database, make_queries,
                                       make_workload)

ROOT = Path(__file__).resolve().parents[2]
CFG = dict(rows=2000, columns=[["a", 25], ["b", 50], ["c", 96]], clusters=None,
           spread=0.8, correlation=0.7)


def nn_cos(x: np.ndarray) -> float:
    """Mean cosine of each row to its nearest other row."""
    s = x @ x.T
    np.fill_diagonal(s, -2.0)
    return float(s.max(1).mean())


def test_columns_are_unit_rows_of_the_stated_shapes():
    cols = gen.make_columns(CFG, 2**31 + 7, "cpu")
    assert [tuple(c.shape) for c in cols] == [(2000, 25), (2000, 50), (2000, 96)]
    for c in cols:
        assert c.dtype == torch.float32
        assert torch.allclose(c.norm(dim=1), torch.ones(2000), atol=1e-5)


def test_same_seed_same_inputs_other_seed_others():
    a = gen.make_columns(CFG, 11, "cpu")
    b = gen.make_columns(CFG, 11, "cpu")
    c = gen.make_columns(CFG, 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_cluster_structure_matches_the_numpy_generator():
    ours = gen.make_columns(CFG, 3, "cpu")
    theirs = make_database(2000, [tuple(c) for c in CFG["columns"]], seed=3)
    for x, y in zip(ours, theirs.columns):
        assert abs(nn_cos(x.numpy()) - nn_cos(y)) < 0.03
    # the shared latent cluster: rows whose nearest row in column a is also
    # their nearest in column b, as often as in the numpy generator
    def agree(cols):
        nn = []
        for c in cols[:2]:
            s = c @ c.T
            np.fill_diagonal(s, -2.0)
            nn.append(s.argmax(1))
        return float((nn[0] == nn[1]).mean())
    assert abs(agree([c.numpy() for c in ours]) - agree(theirs.columns)) < 0.05


MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [(w["traffic"], c["file"]) for w in MAN["workloads"] for c in MAN["configs"]
         if c["name"] == w["config"]]
PAPER = {(12, 0.3): "bisimple", (12, 0.5): "bicomplex", (6, 0.5): "news"}


@pytest.mark.parametrize("mix, cfg", CELLS, ids=[m for m, _ in CELLS])
def test_templates_are_the_papers_draws(mix, cfg):
    spec = json.loads((ROOT / "mintbench" / "traffic" / f"{mix}.json").read_text())["templates"]
    n_cols = len(json.loads((ROOT / cfg).read_text())["columns"])
    vids, probs = gen.templates(n_cols, spec)
    assert vids == binomial_vids(n_cols, spec["n"], spec["p"], seed=spec["seed"])
    name = PAPER.get((spec["n"], spec["p"]))
    if name is not None and (spec["prob_low"], spec["prob_high"]) == (0.5, 1.5):
        db = make_database(64, [(f"c{i}", 4) for i in range(n_cols)], seed=0)
        wl = make_workload(db, name, k=100, seed=spec["seed"])
        assert vids == [q.vid for q in wl.queries]
        np.testing.assert_allclose(probs, wl.probs, rtol=1e-12)


def test_queries_lie_near_a_row_as_the_papers_do():
    cols = gen.make_columns(CFG, 5, "cpu")
    probs = np.array([0.5, 0.5])
    which, vecs = gen.draw_queries(cols, probs, 4000, 64, 0.5, 5, "t")
    assert vecs.shape == (4000, 171) and which.min() >= 0 and which.max() <= 1
    assert (which[:3968] == 0).sum() == 3968 // 2
    db = make_database(2000, [tuple(c) for c in CFG["columns"]], seed=5)
    ref = make_queries(db, [(0,)] * 500, seed=5)
    # cosine of a query to its nearest row: the row it was drawn from
    ours = (vecs[:500, :25] @ cols[0].numpy().T).max(1).mean()
    theirs = np.mean([(q.vectors[0] @ db.columns[0].T).max() for q in ref])
    assert abs(ours - theirs) < 0.02
    norms = np.linalg.norm(vecs[:, :25], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_derived_seeds_take_large_seeds():
    s = gen.derive(2**33 + 5, "column", 3)
    assert 0 <= s < 2**63 and s != gen.derive(2**33 + 6, "column", 3)


def test_every_block_of_the_stream_holds_the_same_mix():
    probs = np.array([0.1, 0.25, 0.4, 0.25])
    g = torch.Generator().manual_seed(1)
    a = gen.template_stream(probs, 640, 64, g).numpy()
    want = np.bincount(a[:64], minlength=4)
    assert want.sum() == 64 and abs(want - probs * 64).max() < 1
    for b in range(10):
        assert (np.bincount(a[64 * b:64 * (b + 1)], minlength=4) == want).all()
    other = gen.template_stream(probs, 640, 64, torch.Generator().manual_seed(2)).numpy()
    assert not (a == other).all()


def test_every_seed_sends_fresh_queries_in_the_same_mix():
    cols = gen.make_columns(CFG, 5, "cpu")
    probs = np.array([0.3, 0.7])
    a_which, a = gen.draw_queries(cols, probs, 256, 64, 0.5, 2**31 + 1, "served")
    b_which, b = gen.draw_queries(cols, probs, 256, 64, 0.5, 2**31 + 2, "served")
    again = gen.draw_queries(cols, probs, 256, 64, 0.5, 2**31 + 1, "served")[1]
    assert (again == a).all()
    # no query of a stream repeats another, and no seed repeats another's
    assert np.unique(np.round(a, 5), axis=0).shape[0] == 256
    assert not np.isclose(a[:, None, :25], b[None, :, :25]).all(-1).any()
    for blk in range(4):
        sl = slice(64 * blk, 64 * (blk + 1))
        assert (np.bincount(a_which[sl], minlength=2) ==
                np.bincount(b_which[sl], minlength=2)).all()
