"""Milliseconds a served query spends in the engine's ``ivf_select`` stage
(``serve/engine.py: _ivf_scan``): each query's top ek of its probed rows
(``argpartition``, then ``argsort``), on the host."""
from mintbench import stages

LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms/query"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return stages.ms_per_query(rec, "ivf_select")
