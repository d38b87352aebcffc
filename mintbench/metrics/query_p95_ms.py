"""95th percentile of a query's latency, submit to completion on the
harness's clock, over every query completed in the traced window. The host's
speed drifts by some 15% over tens of seconds on a shared machine, more than
a bound can hold in a tail of a few hundred queries, so this tail is read
here and ``qps`` is the end-to-end rate: with one closed-loop client, a
query's latency is the time the runtime takes to serve it."""
from mintbench import yardstick

LAYER = "Online runtime (online/runtime.py, online/scheduler.py, online/plancache.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "qps"


def read(rec):
    return yardstick.percentile(rec.lat_ms, 95) if rec.lat_ms else None
