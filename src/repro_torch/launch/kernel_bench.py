"""Device times of the MINT kernels at the main path's shapes, on seeded
random inputs, on one CUDA card.

    python3 src/repro_torch/launch/kernel_bench.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so the kernels of two trees can be compared on one
card in one call: run it for the parent, the change, the change, the parent.
Each line is a JSON object: the card with its power limit, then one line per
call timed (``cuda_ms``: the median device time of 20 calls). The shapes are
those ``chip_smoke.py`` notes on the 1,000,000-row main path: the
distance kernel's IVF centroids, rerank union and two-pass flat scan, its two
nominal shapes, top-k over the flat scan's scores (k = 100) and over scores
rising along each row (the threshold's worst case), the streaming scan at
B = 64 and B = 1, and the two-pass scan at B = 64. Nothing here is imported
by the port; ``chip_smoke.py`` takes ``cuda_ms`` from it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# torch.cuda._sleep spins for a count of SM clock cycles; 2e9 a second is at
# or above the card's clock, so a sleep lasts at least the time asked for
SLEEP_CYCLES_PER_S = 2e9


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The device time of one call of ``fn`` (ms): the median over ``reps``
    calls, each between two CUDA events. The stream is first held busy
    (``torch.cuda._sleep``) for longer than the host takes to enqueue the
    call, so the events time the device's work and not the Python around
    the launches (a call's host time exceeds a decode-size kernel's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(SLEEP_CYCLES_PER_S * (3 * host_s + 1e-3))
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# (label, B, N, d) of the distance dispatches chip_smoke.py notes on the
# 1,000,000-row main path, and its two nominal shapes
DISTANCE_SHAPES = (("centroids", 64, 1000, 128), ("rerank", 64, 999_996, 384),
                   ("flat_two_pass", 64, 1_000_064, 384),
                   ("nominal_1000x384", 64, 1000, 384),
                   ("nominal_4096x1024", 64, 4096, 1024))
SCAN_N, SCAN_D, K = 1_000_064, 384, 100


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for this tree in every line")
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import common
    from repro_torch.kernels.distance.kernel import batched_scores
    from repro_torch.kernels.distance.ops import fused_scan
    from repro_torch.kernels.streaming.ops import streaming_fused_scan
    from repro_torch.kernels.topk.kernel import topk_scores

    dev = torch.device("cuda")
    common.strict_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    common.load_library()
    print(json.dumps(dict(label=args.label, src=args.src, card=card,
                          build_s=time.perf_counter() - t0)), flush=True)

    only = set(filter(None, args.only.split(",")))

    def out(kernel, call, shape, fn, library=None):
        if only and kernel not in only:
            return
        line = dict(label=args.label, kernel=kernel, call=call, shape=shape, ms=cuda_ms(fn))
        if library is not None:
            line["library_ms"] = cuda_ms(library)
        print(json.dumps(line), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    for call, B, N, d in DISTANCE_SHAPES:
        q = torch.randn(B, d, generator=g, device=dev)
        x = torch.randn(N, d, generator=g, device=dev)
        out("batched_scores", call, [B, N, d], lambda: batched_scores(q, x),
            lambda: q @ x.T)
        del x
    x = torch.randn(SCAN_N, SCAN_D, generator=g, device=dev)
    q = torch.randn(64, SCAN_D, generator=g, device=dev)
    scores = q @ x.T
    out("topk_scores", "flat_two_pass", [64, SCAN_N, K], lambda: topk_scores(scores, K),
        lambda: torch.topk(scores, K, dim=1))
    rising = torch.arange(SCAN_N, device=dev, dtype=torch.float32).expand(64, SCAN_N)
    rising = rising.contiguous()
    out("topk_scores", "ascending_worst_case", [64, SCAN_N, K],
        lambda: topk_scores(rising, K), lambda: torch.topk(rising, K, dim=1))
    del scores, rising
    for B in (64, 1):
        qb = q[:B].contiguous()
        out("streaming_fused_scan", f"B{B}", [B, SCAN_N, SCAN_D, K],
            lambda: streaming_fused_scan(qb, x, k=K))
    out("fused_scan", "two_pass_B64", [64, SCAN_N, SCAN_D, K], lambda: fused_scan(q, x, k=K))
    return 0


if __name__ == "__main__":
    sys.exit(main())
