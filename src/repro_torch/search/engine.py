"""DEPRECATED shim — plan execution moved to ``repro_torch.serve.engine``.

``execute_plan_fused`` used to dispatch one ``fused_scan`` per query per
index and unconditionally added the rerank term (diverging from
``planner._plan_cost`` and ``core.tuner.execute_plan`` on single
exact-vid plans). It now delegates to the batched serving engine
(``serve.engine.BatchEngine``) as a batch of one, which applies the
single-exact-vid no-rerank fast path and the ek==0 filtering
consistently with the planner's cost model. New code should construct a
``BatchEngine`` and serve whole batches — that is the single execution
path for plans.
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.types import Query, QueryPlan
from repro_torch.data.vectors import MultiVectorDatabase


def execute_plan_fused(db: MultiVectorDatabase, query: Query, plan: QueryPlan,
                       device=None):
    """Run one plan with the fused kernels (flat scans at each index's ek).

    Deprecated: one-query convenience over ``BatchEngine`` on ``device``
    (None: the CUDA card); batch your (query, plan) pairs through
    ``BatchEngine.search_batch`` instead.
    """
    warnings.warn(
        "repro_torch.search.engine.execute_plan_fused is deprecated; use "
        "repro_torch.serve.engine.BatchEngine (batched plan-group execution)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.serve.engine import BatchEngine
    eng = BatchEngine(db, store=None, device=device)
    ids, cost = eng.execute_plan_single(query, plan)
    return np.asarray(ids), cost
