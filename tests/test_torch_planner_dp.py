"""Port parity of the vectorized Algorithm 2 (``core/planner_jax.py``, a
torch DP in the port) against the JAX DP and the Python DP, on the fixture
of tests/test_planner_jax.py (2,500 rows, 4 columns, hnsw estimators).

Tolerances: the pair tables are held equal. ``dp_solve`` runs in float32 in
both packages and sums the same terms, so its best cost is held within a
relative 1e-6 of the JAX solve and its eks equal. With the reference's
estimators carried over, ``plan_dp_jax`` and the planner's
``use_jax_dp=True`` plans are held equal (indexes, eks, cost, recall); no
tie between equal-cost covers resolved differently on this fixture. Against
the Python DP, the test of tests/test_planner_jax.py: coverage >= theta and
costs within 2x of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.planner import WhatIfContext as JaxContext
from repro.core.planner_jax import dp_solve as jax_dp_solve
from repro.core.planner_jax import plan_dp_jax as jax_plan_dp
from repro.core.planner_jax import submask_tables as jax_submask_tables
from repro.core.tuner import Mint as JaxMint
from repro.core.types import IndexSpec as JSpec
from repro.data.vectors import make_database as jax_make_database
from repro.data.vectors import make_queries as jax_make_queries
from repro_torch import convert
from repro_torch.core.planner import QueryPlanner, WhatIfContext, algorithm2_dp
from repro_torch.core.planner_jax import dp_solve, plan_dp_jax, submask_tables
from repro_torch.core.types import IndexSpec
from repro_torch.data.vectors import make_database, make_queries

COLS = [("a", 32), ("b", 48), ("c", 24), ("d", 40)]
COST_RTOL = 1e-6


@pytest.mark.parametrize("k_prime", [1, 2, 3, 4, 5])
def test_submask_tables_equal_jax(k_prime):
    for a, b in zip(submask_tables(k_prime), jax_submask_tables(k_prime)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    covers, subs, _ = submask_tables(k_prime)
    assert covers.shape[0] == 3 ** k_prime and ((subs & ~covers) == 0).all()


def _dp_inputs(seed, n_idx, kp):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 400, size=(n_idx, kp)).astype(np.float32)
    req[rng.random((n_idx, kp)) < 0.2] = 0.0  # items an index cannot cover
    return dict(ek_req=req,
                idx_dims=rng.integers(16, 160, n_idx).astype(np.float32),
                slopes=rng.uniform(1.0, 30.0, n_idx).astype(np.float32),
                intercepts=rng.uniform(0.0, 300.0, n_idx).astype(np.float32),
                q_dim=144.0, n_rows=2500.0)


@pytest.mark.parametrize("seed,n_idx,kp,target", [(0, 1, 3, 2), (1, 3, 5, 4),
                                                   (2, 6, 5, 5), (3, 4, 4, 3),
                                                   (4, 8, 5, 3)])
def test_dp_solve_equals_jax(seed, n_idx, kp, target):
    x = _dp_inputs(seed, n_idx, kp)
    jcost, jeks = jax_dp_solve(jnp.asarray(x["ek_req"]), jnp.asarray(x["idx_dims"]),
                               jnp.asarray(x["slopes"]), jnp.asarray(x["intercepts"]),
                               jnp.asarray(x["q_dim"]), jnp.asarray(x["n_rows"]),
                               jnp.asarray(float(target)), kp)
    cost, eks = dp_solve(torch.as_tensor(x["ek_req"]), x["idx_dims"], x["slopes"],
                         x["intercepts"], x["q_dim"], x["n_rows"], float(target), kp)
    assert cost.dtype == torch.float32
    np.testing.assert_allclose(cost.item(), float(jcost), rtol=COST_RTOL)
    np.testing.assert_array_equal(eks.numpy(), np.asarray(jeks))


def test_dp_solve_batches_samples():
    xs = [_dp_inputs(s, 5, 5) for s in range(4)]
    base = {k: v for k, v in xs[0].items() if k != "ek_req"}
    reqs = torch.as_tensor(np.stack([x["ek_req"] for x in xs]))
    costs, eks = dp_solve(reqs, base["idx_dims"], base["slopes"], base["intercepts"],
                          base["q_dim"], base["n_rows"], 4.0, 5)
    assert costs.shape == (4,) and eks.shape == (4, 5)
    for s in range(4):
        c, e = dp_solve(reqs[s], base["idx_dims"], base["slopes"], base["intercepts"],
                        base["q_dim"], base["n_rows"], 4.0, 5)
        assert c.item() == costs[s].item()
        assert torch.equal(e, eks[s])


def _carried_estimators(est):
    stats = {key: dict(cost=(st.cost.slope, st.cost.intercept),
                       recall=(st.recall.alpha, st.recall.beta, st.recall.lo,
                               st.recall.hi),
                       rec_eks=st.rec_eks, rec_vals=st.rec_vals)
             for key, st in est.stats.items()}
    return convert.estimators_from_arrays(stats, est.dims, est.n_rows,
                                          est.sample_rate, est.train_seconds,
                                          est.theta_hit)


SPECS = [((0,),), ((1,),), ((2,),), ((3,),), ((0, 1),), ((2, 3),)]


@pytest.fixture(scope="module")
def setup():
    db, jdb = make_database(2500, COLS, seed=2), jax_make_database(2500, COLS, seed=2)
    jmint = JaxMint(jdb, index_kind="hnsw", seed=0, min_sample_rows=800)
    jmint.train()
    est = _carried_estimators(jmint.estimators)
    vids = [(0, 1, 2, 3), (0, 1, 2), (1, 2, 3), (0, 2, 3)]
    qs = make_queries(db, vids, k=20, seed=9)
    jqs = jax_make_queries(jdb, vids, k=20, seed=9)
    return dict(db=db, jdb=jdb, est=est, jest=jmint.estimators, qs=qs, jqs=jqs)


def _specs(q, Spec):
    return [Spec(v, "hnsw") for (v,) in SPECS if set(v) <= set(q.vid)]


def _key(p):
    return None if p is None else ([s.name for s in p.indexes], list(p.eks),
                                   p.est_cost, p.est_recall)


@pytest.mark.parametrize("n_samples", [3, 8])
@pytest.mark.parametrize("qi", range(4))
def test_plan_dp_equals_jax_with_carried_estimators(setup, qi, n_samples):
    q, jq = setup["qs"][qi], setup["jqs"][qi]
    ctx = WhatIfContext(q, setup["db"], setup["est"])
    jctx = JaxContext(jq, setup["jdb"], setup["jest"])
    specs, jspecs = _specs(q, IndexSpec), _specs(jq, JSpec)
    assert len(specs) >= 4
    got = plan_dp_jax(ctx, specs, 0.9, seed=0, n_samples=n_samples, device="cpu")
    want = jax_plan_dp(jctx, jspecs, 0.9, seed=0, n_samples=n_samples)
    assert _key(got) == _key(want)


def test_plan_dp_quality_against_the_python_dp(setup):
    q = setup["qs"][0]
    ctx = WhatIfContext(q, setup["db"], setup["est"])
    specs = _specs(q, IndexSpec)
    p_py = algorithm2_dp(ctx, specs, 0.9, seed=0)
    p_dp = plan_dp_jax(ctx, specs, 0.9, seed=0, device="cpu")
    assert p_py is not None and p_dp is not None
    assert p_dp.est_recall >= 0.9 - 1e-9
    assert p_dp.est_cost <= 2.0 * p_py.est_cost + 1e-6
    assert p_py.est_cost <= 2.0 * p_dp.est_cost + 1e-6


def test_planner_use_jax_dp_equals_jax_planner(setup):
    from repro.core.planner import QueryPlanner as JaxPlanner
    planner = QueryPlanner(setup["est"], setup["db"], use_jax_dp=True, dp_device="cpu")
    jplanner = JaxPlanner(setup["jest"], setup["jdb"], use_jax_dp=True)
    config = frozenset(IndexSpec(v, "hnsw") for (v,) in SPECS)
    jconfig = frozenset(JSpec(v, "hnsw") for (v,) in SPECS)
    for q, jq in zip(setup["qs"], setup["jqs"]):
        assert _key(planner.plan(q, config)) == _key(jplanner.plan(jq, jconfig))


def test_dp_device_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    q = setup["qs"][0]
    ctx = WhatIfContext(q, setup["db"], setup["est"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_dp_jax(ctx, _specs(q, IndexSpec), 0.9)
