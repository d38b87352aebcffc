"""Modeled HBM traffic of one scan dispatch (the engine's plan-group
attribution seam; a copy of the reference's ``modeled_scan_bytes``), the
collective bytes of a mesh step, and ``HW``: the card's rates that the
analytic roofline (``launch.report``) divides by.

The reference parses collective bytes out of compiled HLO: the RESULT
buffer of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute of the per-device program. The port has no HLO: its
collectives (``distributed.collectives``) add the same per-device result
bytes to ``mesh.log`` as they run, and ``collective_bytes`` reports them.
"""
from __future__ import annotations

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
