"""Seconds to build the tuned configuration's indexes, card synchronised."""
LAYER = "Index build (index/ivf.py, index/registry.py)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.index_build_s
