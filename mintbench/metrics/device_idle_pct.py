"""Share of the traced window in which no operation ran on the card."""
LAYER = "Device (one H100)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "qps"


def read(rec):
    if rec.busy_s is None or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
