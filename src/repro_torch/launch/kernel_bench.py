"""Device times of the MINT kernels at the main path's shapes, and of the
flash-attention backward at the training path's call, on seeded random
inputs, on one CUDA card.

    python3 src/repro_torch/launch/kernel_bench.py [--src DIR] [--label NAME] [--only K,...]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so the kernels of two trees can be compared on one
card in one call: run it for the parent, the change, the change, the parent.
Each line is a JSON object: the card with its power limit, then one line per
call timed (``cuda_ms``: the median device time of 20 calls). The shapes are
those ``chip_smoke.py`` notes on the 1,000,000-row main path: the
distance kernel's IVF centroids, rerank union and two-pass flat scan, its two
nominal shapes, top-k over the flat scan's scores (k = 100) and over scores
rising along each row (the threshold's worst case), the streaming scan at
B = 64 and B = 1, and the two-pass scan at B = 64. ``--only
flash_attention_bwd`` times the backward (``flash_attention_bwd``, with its
route and each of its kernels' share by torch.profiler) and the forward
that writes its lse (``flash_attention_lse``) at
granite-moe-1b-a400m's training call (``TRAIN_CALL``: q (8, 16, 2048, 64)
in the model's strided layout, 8 KV heads, causal, bf16), each beside one
SDPA call of the same function; ``--only flash_attention`` times the
forward at two serving decode calls (``DECODE_CALLS``). Nothing here is
imported by the port;
``chip_smoke.py`` takes ``cuda_ms`` from it.
"""
from __future__ import annotations

import argparse
import json
import re
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
# (B, Hq, Hkv, S, d) of granite-moe-1b-a400m's attention in chip_smoke.py's
# training path
TRAIN_CALL = (8, 16, 8, 2048, 64)


def kernel_split(fn, calls: int = 5) -> dict[str, float]:
    """Device ms of one call of ``fn`` per kernel it launches (torch.profiler
    over ``calls`` calls), keyed by the kernel's function name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"::(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key[:60]
            split[name] = split.get(name, 0.0) + e.self_device_time_total / calls / 1e3
    return split


def flash_train_call(out, dev, g) -> None:
    """The backward and its lse-writing forward at ``TRAIN_CALL``, beside
    SDPA's backward and forward (GQA, causal: the same function)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_lse)
    B, Hq, Hkv, S, d = TRAIN_CALL

    def heads(h):  # the model's (B, S, H, d) tensor seen as (B, H, S, d)
        return torch.randn((B, S, h, d), generator=g, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = heads(Hq), heads(Hkv), heads(Hkv)
    dout = torch.randn((B, Hq, S, d), generator=g, device=dev, dtype=torch.bfloat16)
    o, lse = flash_attention_lse(q, k, v)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ref = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    shape = [B, Hq, Hkv, S, d]
    out("flash_attention_bwd", "granite_training_forward_lse", shape,
        lambda: flash_attention_lse(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        kernel="flash_attention_lse")
    bwd = lambda: flash_attention_bwd(q, k, v, o, lse, dout)  # noqa: E731
    bwd()
    out("flash_attention_bwd", "granite_training", shape, bwd,
        lambda: torch.autograd.grad(ref, (qg, kg, vg), dout, retain_graph=True),
        route=flash_attention_bwd.last_route, split_ms=kernel_split(bwd))


# (label, B, Hq, Hkv, Skv, d, causal, softcap) of two serving decode calls
# chip_smoke.py times: Gemma-2-27B's global layer at its 8,193-key cache and
# whisper-medium's cross attention over 1,500 encoder positions (Sq = 1)
DECODE_CALLS = (("gemma2_decode_global", 2, 32, 16, 8193, 128, True, 50.0),
                ("whisper_cross_decode", 2, 16, 16, 1500, 64, False, 0.0))


def flash_decode_calls(out, dev, g) -> None:
    """The forward's split-KV route at ``DECODE_CALLS``, q / k / v in the
    models' (B, S, H, d) layout seen as (B, H, S, d)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    for call, B, Hq, Hkv, Skv, d, causal, softcap in DECODE_CALLS:
        def heads(h, s):
            return torch.randn((B, s, h, d), generator=g, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
        q, k, v = heads(Hq, 1), heads(Hkv, Skv), heads(Hkv, Skv)
        out("flash_attention", call, [B, Hq, Hkv, 1, Skv, d],
            lambda: flash_attention(q, k, v, causal=causal, softcap=softcap))


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

    def wanted(group):
        return not only or group in only

    def out(group, call, shape, fn, library=None, **extra):
        """One line for ``fn`` under ``group`` (what ``--only`` names)."""
        if not wanted(group):
            return
        line = dict(label=args.label, kernel=group, call=call, shape=shape, ms=cuda_ms(fn))
        if library is not None:
            line["library_ms"] = cuda_ms(library)
        print(json.dumps(dict(line, **extra)), flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    if wanted("flash_attention_bwd"):
        flash_train_call(out, dev, g)
    if wanted("flash_attention"):
        flash_decode_calls(out, dev, g)
    if only and only <= {"flash_attention_bwd", "flash_attention"}:
        return 0
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
