"""Milliseconds a served query spends in the engine's ``rerank_order`` stage
(``serve/engine.py: _rerank``): each query's scores looked up in the
group's union and ordered to its top k (``searchsorted``, ``argsort``), on
the host."""
from mintbench import stages

LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms/query"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return stages.ms_per_query(rec, "rerank_order")
