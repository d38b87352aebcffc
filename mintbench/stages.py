"""The engine's stage spans as the per-layer readers see them: each stage
of a plan group (``serve/engine.py``) is a ``span:<stage>`` entry of a
traced run's host events, mapped onto the profiler's clock."""


def ms_per_query(rec, stage: str):
    """Milliseconds the window's plan groups spent in ``stage``, summed and
    divided by the queries served; None when no such span was recorded or
    no query was served (a program without the stage spans reads nothing)."""
    name = f"span:{stage}"
    spans = [end - start for n, start, end in rec.host_ops if n == name]
    if not spans or not rec.served:
        return None
    return 1e3 * sum(spans) / rec.served
