"""Milliseconds a served query spends in the engine's ``ivf_probe`` stage
(``serve/engine.py: _ivf_scan``): each query's probe lists (its centroid
order, the lists' row ids concatenated) and the padded (queries, rows) id
matrix, on the host."""
from mintbench import stages

LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms/query"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return stages.ms_per_query(rec, "ivf_probe")
