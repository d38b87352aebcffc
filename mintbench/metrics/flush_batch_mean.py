"""Queries a flush serves: the micro-batcher's own counts over the window."""
LAYER = "Online runtime (online/runtime.py, online/scheduler.py, online/plancache.py)"
UNIT = "queries"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "qps"


def read(rec):
    return rec.flushed_queries / rec.flushes if rec.flushes else None
