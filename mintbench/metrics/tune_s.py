"""Seconds of ``Mint.tune`` on the cell's templates, card synchronised."""
LAYER = "Tuner (core/tuner.py, core/planner.py, core/estimators.py)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.tune_s
