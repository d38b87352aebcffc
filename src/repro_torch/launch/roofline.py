"""Modeled HBM traffic of one scan dispatch (the engine's plan-group
attribution seam); a copy of the reference's ``modeled_scan_bytes``."""
from __future__ import annotations


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
