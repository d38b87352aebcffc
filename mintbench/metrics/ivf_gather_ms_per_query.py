"""Milliseconds a served query spends in the engine's ``ivf_gather`` stage
(``serve/engine.py: _ivf_scan``): the probed row ids' upload, the gathered
rows' scores and their copy back to the host."""
from mintbench import stages

LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms/query"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return stages.ms_per_query(rec, "ivf_gather")
