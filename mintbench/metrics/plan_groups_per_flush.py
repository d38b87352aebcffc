"""Plan groups a flush compiles into: ``plan_group`` spans over ``dispatch``
spans of the window's flushes."""
LAYER = "Compiler (serve/compiler.py)"
UNIT = "groups"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return len(rec.groups) / rec.dispatches if rec.dispatches else None
