"""Mean length of the engine's ``plan_group`` spans (a group's probes,
gathers, rerank and copy back to the host)."""
LAYER = "Engine (serve/engine.py, serve/columnstore.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return sum(g["ms"] for g in rec.groups) / len(rec.groups) if rec.groups else None
