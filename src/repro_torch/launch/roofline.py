"""Roofline terms of the port's dry-run (``launch.dryrun``), the modeled
HBM traffic of one scan dispatch (the engine's plan-group attribution seam;
a copy of the reference's ``modeled_scan_bytes``) and its measured sweep,
the collective bytes of a mesh step, and ``HW``: the card's rates.

Terms, per card (NVIDIA H100 80GB HBM3):
  compute    = FLOPs / peak_FLOPs            (989 TFLOP/s bf16)
  memory     = bytes accessed / HBM_bw       (3.35 TB/s)
  collective = collective bytes / link_bw    (450 GB/s NVLink, one way)

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of
the compiled per-device program, its memory from ``memory_analysis`` and
its collective bytes from the HLO text. The port compiles nothing: one
counting pass over the step on ``meta`` tensors (``launch.cost_count``)
gives rank 0's FLOPs, bytes and peak of live intermediates
(``extract_cost`` / ``extract_memory`` read its record), and its
collectives (``distributed.collectives``) add the same per-device result
bytes to ``mesh.log`` as they run, which ``collective_bytes`` reports.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 80GB HBM3 (SXM5), NVIDIA's data sheet at its 700 W limit,
# dense rates without sparsity. ``link_bw`` is one card's NVLink 4 rate in
# one direction (18 links, 900 GB/s both ways), the unit of the roofline's
# per-card collective bytes.
HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "peak_flops": 989e12,   # bf16 tensor-core FLOP/s per card
    "hbm_bw": 3.35e12,      # HBM3 bytes/s per card
    "link_bw": 450e9,       # NVLink bytes/s per card, one direction
}

# The on-chip capacity a two-pass scan's f32 (B, N) score block must fit in
# for the distance kernel's write and the top-k kernel's read to skip the
# device memory round trip: the H100's L2 cache, 50 MB (NVIDIA H100 Tensor
# Core GPU Architecture whitepaper, "50 MB L2 cache"). It plays the part of
# the reference's ``VMEM_BYTES`` (the TPU core's 16 MiB VMEM, the old
# single-dispatch cap); the sweep's keys keep the reference's names.
L2_BYTES = 50 * 2 ** 20

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(log) -> dict:
    """``{"by_kind": {kind: {"count", "bytes"}}, "total_bytes"}`` from a
    mesh's ``log`` (kind -> (calls, bytes)), in the shape of the
    reference's ``collective_bytes``."""
    by_kind: dict[str, dict] = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, (calls, nbytes) in log.items():
        by_kind[kind] = {"count": calls, "bytes": nbytes}
    return {"by_kind": by_kind, "total_bytes": sum(v["bytes"] for v in by_kind.values())}


def modeled_scan_bytes(B: int, N: int, d: int, k: int, masked: bool = True,
                       dtype_bytes: int = 4, selectivity: float | None = None,
                       attr_bytes: int = 4,
                       gather_amplification: float = 2.0) -> dict:
    """Modeled device-memory traffic for one (B, N, d) -> top-k scan.

    Both paths read the queries and rows once and write the (vals, ids)
    pair. The two-pass path additionally round-trips the f32 (B, N) score
    matrix: one write by the distance kernel + one read by top-k, plus a
    read + write for the mask pass when padding / tombstones apply
    (``masked``). The streaming path replaces all of that with one (1, N)
    row-mask read. ``selectivity`` adds the filtered terms
    (``masked_filtered_bytes``, ``prefilter_bytes``)."""
    io = (B * d + N * d) * dtype_bytes + 2 * B * k * 4
    score_passes = 4 if masked else 2
    score_block = B * N * 4
    out = {
        "twopass_bytes": io + score_passes * score_block,
        "streaming_bytes": io + N * 4,
        "score_block_bytes": score_block,
    }
    if selectivity is not None:
        sel = min(max(float(selectivity), 0.0), 1.0)
        bitmap = N * attr_bytes + N  # column pass + packed bool bitmap out
        rows_kept = sel * N
        gathered_io = (B * d + gather_amplification * rows_kept * d
                       ) * dtype_bytes + 2 * B * k * 4
        out["selectivity"] = sel
        out["bitmap_bytes"] = bitmap
        out["masked_filtered_bytes"] = out["streaming_bytes"] + N + bitmap
        out["prefilter_bytes"] = gathered_io + bitmap
    return out


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops: float          # 6·N·D (train) or 2·N·D (decode), per chip
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / HW["peak_flops"]

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful compute time / total bound time (the perf score)."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.model_flops / HW["peak_flops"]) / max(bound, 1e-12)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def streaming_vs_twopass(ns=(2048, 8192, 32768, 65536, 131072, 262144), B: int = 128,
                         d: int = 128, k: int = 16, masked: bool = True,
                         measure: bool = False, measure_n_cap: int = 4096,
                         device=None, seed: int = 0) -> dict:
    """Sweep table size N from a score block that fits the L2 cache
    (``L2_BYTES``) to beyond it, reporting modeled device-memory bytes for
    the two-pass vs streaming scan plus (optionally) measured time per
    dispatch (``_measure_scan_pair``).

    The reference's sweep ends at N = 65,536, whose (128, N) f32 block (32
    MiB) exceeds the TPU's 16 MiB VMEM; it fits the H100's 50 MB L2, so the
    port's sweep goes on to 131,072 and 262,144 rows and its ``acceptance``
    (the largest N's block exceeds the capacity, and the two-pass scan
    moves at least twice the streaming scan's bytes there) means what the
    reference's does. The capacity keeps the reference's key names
    (``vmem_bytes``, ``exceeds_vmem``). ``device``: where to measure (None:
    the card); on the CPU the plain versions run at ``measure_n_cap`` rows,
    and their times say nothing about the card."""
    rows = []
    for n in ns:
        m = modeled_scan_bytes(B, n, d, k, masked=masked)
        row = {
            "n": int(n),
            **m,
            "hbm_ratio": m["twopass_bytes"] / m["streaming_bytes"],
            "t_memory_twopass_s": m["twopass_bytes"] / HW["hbm_bw"],
            "t_memory_streaming_s": m["streaming_bytes"] / HW["hbm_bw"],
            "exceeds_vmem": m["score_block_bytes"] > L2_BYTES,
        }
        if measure:
            row["measured"] = _measure_scan_pair(B, n, d, k, masked, measure_n_cap, device,
                                                 seed)
        rows.append(row)
    largest = rows[-1]
    return {
        "B": B, "d": d, "k": k, "masked": masked,
        "vmem_bytes": L2_BYTES,
        "sweep": rows,
        "acceptance": {
            "largest_n": largest["n"],
            "hbm_ratio_at_largest_n": largest["hbm_ratio"],
            "largest_n_exceeds_vmem": largest["exceeds_vmem"],
            "ok": largest["hbm_ratio"] >= 2.0 and largest["exceeds_vmem"],
        },
    }


def _measure_scan_pair(B, n, d, k, masked, n_cap, device, seed, reps: int = 3) -> dict:
    """Median time (ms) per dispatch of the streaming scan
    (``streaming_fused_scan``: the streaming kernel) and the two-pass scan
    (``fused_scan``: the distance kernel, the mask pass, the top-k kernel)
    on the same seeded rows (every 64th dead when ``masked``). On the card:
    device time between CUDA events (``kernel_bench.cuda_ms``) at n rows,
    and both results are checked equal; on the CPU: wall clock of the
    plain versions at min(n, n_cap) rows."""
    import time

    import numpy as np
    import torch

    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels.distance.ops import fused_scan
    from repro_torch.kernels.streaming.ops import streaming_fused_scan

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_run = n if on_card else min(n, n_cap)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, d)).astype(np.float32), device=dev)
    db = torch.as_tensor(rng.standard_normal((n_run, d)).astype(np.float32), device=dev)
    kw = {}
    if masked:
        dead = np.zeros(n_run, dtype=bool)
        dead[:: max(n_run // 64, 1)] = True
        kw = dict(valid_n=n_run - 1, dead_mask=torch.as_tensor(dead, device=dev))

    def streaming():
        return streaming_fused_scan(q, db, k=k, **kw)

    def twopass():
        return fused_scan(q, db, k=k, **kw)

    def wall(fn):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    if on_card:
        from repro_torch.launch.kernel_bench import cuda_ms
        s_vals, s_ids = streaming()
        t_vals, t_ids = twopass()
        return {"n_measured": int(n_run), "device": str(dev),
                "streaming_ms": cuda_ms(streaming, reps=max(reps, 5)),
                "twopass_ms": cuda_ms(twopass, reps=max(reps, 5)),
                "equal": bool(torch.equal(s_vals, t_vals) and torch.equal(s_ids, t_ids))}
    return {"n_measured": int(n_run), "device": str(dev),
            "streaming_ms": wall(streaming), "twopass_ms": wall(twopass)}


def extract_cost(record: dict) -> dict:
    """FLOPs and bytes of a counting pass's record (``cost_count.CostCount.
    record``): rank 0's per-device program, the reference's keys. ``bytes``
    is every unfused op's operands plus results, an upper bound."""
    return {"flops": float(record.get("flops", 0.0)),
            "bytes": float(record.get("bytes", 0.0)),
            "raw_keys": sorted(record)[:40]}


def extract_memory(record: dict) -> dict:
    """Rank 0's device memory of a step, in the reference's keys:
    ``argument_size_in_bytes`` (its blocks of every input),
    ``output_size_in_bytes`` (of every result), ``temp_size_in_bytes`` (the
    counting pass's peak of live intermediates), ``alias_size_in_bytes``
    (the donated inputs: a training step's params and optimizer state, a
    decode step's cache) and ``total_device_bytes`` as the reference sums
    them. ``record``: the counting pass's record plus the dry-run's
    ``argument_bytes`` / ``output_bytes`` / ``alias_bytes``."""
    out = {"argument_size_in_bytes": int(record.get("argument_bytes", 0)),
           "output_size_in_bytes": int(record.get("output_bytes", 0)),
           "temp_size_in_bytes": int(record.get("temp_peak", 0)),
           "alias_size_in_bytes": int(record.get("alias_bytes", 0))}
    out["total_device_bytes"] = (out["argument_size_in_bytes"]
                                 + out["output_size_in_bytes"]
                                 + out["temp_size_in_bytes"]
                                 - out["alias_size_in_bytes"])
    return out
