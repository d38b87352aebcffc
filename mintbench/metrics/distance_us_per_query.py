"""Device time of the distance kernel (IVF centroids, gathered rows, rerank)
per query served in the traced window."""
LAYER = "Kernels: distance (kernels/distance, csrc/distance.cu)"
UNIT = "us/query"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "qps"
KERNELS = ("distance_kernel",)


def read(rec):
    device_s = sum(e - s for name, s, e in rec.device_ops
                   if any(k in name for k in KERNELS))
    return 1e6 * device_s / rec.served if device_s > 0 and rec.served else None
