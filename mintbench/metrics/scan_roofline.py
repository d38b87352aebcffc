"""The flat scans' share of their roofline: the least time their work needs
on the card over the device time of the scan kernels.

The work is the benchmark's own count from the served plans (the engine's
``plan_group`` spans), whatever kernel does it: 2 N d float32 operations for
each query a group sends through a flat scan of a column set of d dims, the
columns' bytes once per flush, and each group's queries and its k best
(score, id) pairs once. The least time is the larger of the operations at
the card's float32 peak and the bytes at its memory rate."""
from mintbench import yardstick

LAYER = "Kernels: scan (kernels/streaming, csrc/streaming.cu, csrc/select.cu)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "qps"
KERNELS = ("scan_kernel", "merge_rank_kernel", "finalize_kernel")


def work(rec) -> tuple[float, float]:
    """(operations, bytes) of the flat scans the window's groups made."""
    flops, nbytes, columns = 0.0, 0.0, set()
    for g in rec.groups:
        for kind, vid, k in g["plan_sig"]:
            if kind != "flat":
                continue
            d = rec.vid_dim(vid)
            flops += 2.0 * g["batch"] * rec.rows * d
            nbytes += 4.0 * g["batch"] * d + 8.0 * g["batch"] * k
            columns.add((g["flush"], tuple(vid)))
    nbytes += sum(4.0 * rec.rows * rec.vid_dim(vid) for _, vid in columns)
    return flops, nbytes


def read(rec):
    device_s = sum(e - s for name, s, e in rec.device_ops
                   if any(k in name for k in KERNELS))
    flops, nbytes = work(rec)
    if rec.peaks is None or device_s <= 0 or flops <= 0:
        return None
    least, _ = yardstick.least_time_s(flops, nbytes, rec.peaks)
    return 100.0 * least / device_s
