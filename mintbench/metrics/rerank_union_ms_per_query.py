"""Milliseconds a served query spends in the engine's ``rerank_union`` stage
(``serve/engine.py: _rerank``): each query's candidate union over its
indexes (``np.unique``) and the group's union, on the host."""
from mintbench import stages

LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms/query"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return stages.ms_per_query(rec, "rerank_union")
