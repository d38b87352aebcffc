"""Decode caches on the single-controller mesh, and attention over them in
the flash-decoding style.

``cache_shardings`` (the reference's rule) places a KV cache (L, B, S, Hkv,
hd) with its batch over the data axes when they divide it and its SEQUENCE
over ``model`` (with ``shard_seq``, or a batch the data axes do not divide,
over every axis): each rank owns a slice of the positions, with every kv
head. Attention's q heads are split over ``model`` (``models.model.
_attn_tp``: ``head_range``'s ceil(Hq / n) a rank, none past the last, a
rank's heads straddling kv groups where they fall so), so the two meet
here:

- a prefill's k / v come out of the column-parallel projections split by
  head; an all-to-all over ``model`` turns each rank's heads of the whole
  sequence into every head of its own slice (``write``);
- a decode step's new k / v are all-gathered over ``model`` by head and the
  rank that owns slot ``pos`` writes them;
- a decode step's q is all-gathered over ``model`` by head (B x Hq x hd,
  small); each rank that owns a slice attends over the keys of it that are
  valid through the flash kernel with its lse
  (``kernels/flash_attention: flash_attention_lse``; a slice without a
  valid key launches nothing and gives lse -inf, output 0), and the ranks'
  partial results are combined by a ``pmax`` of the lse and ``psum``s of
  the rescaled outputs and of their weights (``attend``). Each model rank
  then keeps its own q heads' part for ``wo``'s row-parallel product (a
  rank without q heads keeps nothing).

A cache whose sequence is not split (its length does not divide
``model``) holds every position on each model rank: each attends over its
own heads as one device does, one flash call per uniform GQA group of
them (``tensor_parallel.per_call``).

All collectives are recorded in ``mesh.log`` once per op of the per-device
program (the caller passes data rank 0's ``record``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import Blocks, _axes_of, write_box
from repro_torch.distributed.tensor_parallel import head_range, kv_heads_for, per_call
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.flash_attention.kernel import flash_attention_lse
from repro_torch.models import attention as A


@dataclass
class LayerKV:
    """One layer's cache entries: k / v (B, S, Hkv, hd) and, for an int8
    cache, their scales (B, S, Hkv); each a ``Blocks``."""

    k: Blocks
    v: Blocks
    k_scale: Blocks | None = None
    v_scale: Blocks | None = None


def layers(cache: dict, k: str = "k", v: str = "v") -> list[LayerKV]:
    """The per-layer ``LayerKV`` views of a placed cache's stacked k / v
    (and their scales, for ``k`` / ``v`` of an int8 cache)."""
    ks, vs = cache[k].unbind(), cache[v].unbind()
    if k == "k" and "k_scale" in cache:
        return [LayerKV(*x) for x in zip(ks, vs, cache["k_scale"].unbind(),
                                         cache["v_scale"].unbind())]
    return [LayerKV(a, b) for a, b in zip(ks, vs)]


def rep_heads(n: int, Hq: int, Hkv: int) -> list[tuple[int, int]]:
    """Per model rank, the [lo, hi) of its kv heads (relative to its first,
    ``kv_heads_for``) that no earlier rank holds: the heads it contributes
    when the ranks' heads are put together, each kv head once, from the
    first rank that holds it (ranks share a kv head when there are fewer kv
    heads than ranks, or when their q heads straddle a group); (0, 0) for a
    rank without heads."""
    out, end = [], 0
    for m in range(n):
        first, cnt = kv_heads_for(m, n, Hq, Hkv)
        lo = min(max(first, end), first + cnt)
        hi = first + cnt
        out.append((lo - first, hi - first))
        end = max(end, hi)
    return out


def _seq_entry(b: Blocks):
    """The spec entry of a (B, S, ...) layer's sequence dim."""
    spec = tuple(b.spec) + (None,) * (b.ndim - len(b.spec))
    return spec[1]


def seq_axes(k: Blocks) -> tuple:
    """The mesh axes a placed (L, B, S, H, hd) k cache spreads its
    sequence over (none, ``("model",)``, or the data axes and ``model``)."""
    spec = tuple(k.spec) + (None,) * (k.ndim - len(k.spec))
    return _axes_of(spec[2])


def _coords_row_first(mesh, d: int, n_model: int) -> list[tuple]:
    """The mesh's grid coordinates, data row ``d``'s first, each part in
    row-major order."""
    coords = list(np.ndindex(*mesh.devices.shape))
    flat = [int(np.ravel_multi_index(c, mesh.devices.shape)) for c in coords]
    return [c for f, c in sorted(zip(flat, coords), key=lambda fc: (fc[0] // n_model != d,
                                                                   fc[0]))]


def owners(ctx, b: Blocks, d: int) -> list[tuple[tuple, int, int]]:
    """(grid coordinate, lo, hi) of each slice of the sequence that data rank
    d's batch rows are cut into, in order: the ranks that hold them, of data
    row d where it has one."""
    r0, r1 = ctx.rows(b.shape[0], d)
    by_lo: dict = {}
    for coord in _coords_row_first(ctx.mesh, d, ctx.n_model):
        box = b.box(coord)
        if box[0][0] <= r0 and r1 <= box[0][1]:
            by_lo.setdefault(box[1], coord)
    return [(coord, lo, hi) for (lo, hi), coord in sorted(by_lo.items())]


def _rank_coord(ctx, d: int, m: int) -> tuple:
    return tuple(np.unravel_index(d * ctx.n_model + m, ctx.mesh.devices.shape))


def _local(b: Blocks, coord: tuple, r0: int, r1: int, lo: int, hi: int) -> torch.Tensor:
    """Rows [r0, r1) and positions [lo, hi) of the full tensor, read from
    rank ``coord``'s own block (which must hold them)."""
    box = b.box(coord)
    if not (box[0][0] <= r0 and r1 <= box[0][1] and box[1][0] <= lo and hi <= box[1][1]):
        raise ValueError(f"rank {coord} holds {box[:2]}, not rows {r0}..{r1} "
                         f"positions {lo}..{hi}")
    return b.grid[coord][r0 - box[0][0]:r1 - box[0][0], lo - box[1][0]:hi - box[1][0]]


def write(ctx, kv: LayerKV, d: int, ks: list, vs: list, pos: int, heads: tuple,
          quantize) -> None:
    """Writes data rank d's new k / v at slots ``pos``.. of ``kv``.

    ``ks`` / ``vs``: per compute rank (B_d, S_new, cnt, hd), the rank's kv
    heads (``kv_heads_for``; zero-width for a rank without q heads), roped;
    each kv head is sent once, by the first rank that holds it
    (``rep_heads``). A prefill (the whole cache at once, pos
    0) into a sequence-split cache goes by an all-to-all over ``model``
    from head shards to sequence slices, each rank writing its slice; any
    other write all-gathers the heads over ``model`` first (a decode
    token: the owner of ``pos`` writes it; an unsplit cache: every rank).
    ``quantize``: (int8 values, f32 scales) of a tensor, for an int8 cache.
    """
    mesh, n = ctx.mesh, len(ks)
    B, S = kv.k.shape[:2]
    S_new = ks[0].shape[1]
    if pos < 0 or pos + S_new > S:
        raise ValueError(f"cache write at {pos}..{pos + S_new} runs past its {S} slots")
    r0, _ = ctx.rows(B, d)
    rec = d == 0
    rep = rep_heads(n, *heads)

    def put(k, v, at):
        if kv.k_scale is not None:
            (k, k_s), (v, v_s) = quantize(k), quantize(v)
            write_box(kv.k_scale, k_s, (r0, at, 0))
            write_box(kv.v_scale, v_s, (r0, at, 0))
        write_box(kv.k, k, (r0, at, 0, 0))
        write_box(kv.v, v, (r0, at, 0, 0))

    pieces = [[t[:, :, lo:hi] for t, (lo, hi) in zip(ts, rep)] for ts in (ks, vs)]
    seq = _axes_of(_seq_entry(kv.k))
    if n == 1:
        put(ks[0], vs[0], pos)
        return
    if not seq or S_new < S or seq[-1] != "model" or kv.k_scale is not None:
        k, v = (C.all_gather_dim(p, mesh, "model", 2, ctx.dev(d), record=rec) for p in pieces)
        put(k, v, pos)
        return
    # the slices data rank d's rows are cut into, in order, and their
    # owners: one run of n_model slices (its own data row's model ranks) per
    # grid row the sequence spreads over
    own = owners(ctx, kv.k, d)
    n = ctx.n_model
    run = S // (len(own) // n)  # the positions each run of owners holds
    for j in range(len(own) // n):
        group = own[j * n:(j + 1) * n]
        devs = [mesh.devices[coord] for coord, _, _ in group]
        got = [C.all_to_all([t[:, j * run:(j + 1) * run] for t in p], mesh, "model", 1, 2, devs,
                            record=rec and j == 0) for p in pieces]
        for (_, lo, _), k, v in zip(group, *got):
            put(k, v, lo)


def attend(ctx, kv: LayerKV, d: int, qs: list, *, kv_len: int, causal: bool, window: int,
           softcap: float, heads: tuple) -> list:
    """Data rank d's attention of one new position per row over ``kv``:
    per compute rank, its q heads' output (B_d, 1, heads, hd) in q's dtype
    (its ``head_range``; None for a rank without heads).

    ``qs``: per compute rank (B_d, 1, heads, hd), roped, or None. The q
    heads are all-gathered by head (a rank without heads sends nothing) for
    a sequence-split cache and cut back by ``head_range``; an unsplit cache
    is read per rank over its kv heads, one flash call per uniform GQA
    group (``per_call``). The keys are the
    positions [0, kv_len) (a causal step: q sits at kv_len - 1, and
    ``window`` keeps the last ``window`` of them); without ``causal`` every
    one of them (cross attention)."""
    mesh, n = ctx.mesh, len(qs)
    Hq, Hkv = heads
    B = kv.k.shape[0]
    r0, r1 = ctx.rows(B, d)
    rec = d == 0
    dt = next(q for q in qs if q is not None).dtype
    scales = kv.k_scale is not None
    seq = _seq_entry(kv.k)
    lo_valid = max(0, kv_len - window) if causal else 0
    if seq is None:  # each model rank holds every position: its own heads, as one device
        names = ("k", "v") + (("k_scale", "v_scale") if scales else ())

        def one(q, k, v, *sc):
            return A.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=kv_len - 1 if causal else 0, kv_len=kv_len,
                               **dict(zip(names[2:], sc))).to(dt)
        out = []
        for m, q in enumerate(qs):
            if q is None:  # a rank without q heads attends nothing
                out.append(None)
                continue
            coord = _rank_coord(ctx, d, m)
            first, cnt = kv_heads_for(m, n, Hq, Hkv)
            out.append(per_call(one, m, n, Hq, Hkv, q, tuple(
                _local(getattr(kv, name), coord, r0, r1, 0, kv.k.shape[1])
                [:, :, first:first + cnt] for name in names)))
        return out
    heads = [head_range(Hq, n, m) for m in range(n)]
    live = next(q for q in qs if q is not None)
    q = qs[0] if n == 1 else C.all_gather_dim(
        [live.new_zeros((*live.shape[:2], 0, live.shape[3])) if q is None else q for q in qs],
        mesh, "model", 2, ctx.dev(d), record=rec)
    b, hd = r1 - r0, q.shape[-1]
    outs, lses = [], []
    for coord, lo, hi in owners(ctx, kv.k, d):
        a, e = max(lo, lo_valid), min(hi, kv_len)
        dev = mesh.devices[coord]
        if e <= a:  # no valid key in this slice: nothing to launch
            outs.append(torch.zeros((b, Hq, 1, hd), dtype=torch.float32, device=dev))
            lses.append(torch.full((b, Hq, 1), float("-inf"), device=dev))
            continue
        k, v = (_local(t, coord, r0, r1, a, e) for t in (kv.k, kv.v))
        qq = q.to(dev)
        if scales:
            k = k.float() * _local(kv.k_scale, coord, r0, r1, a, e)[..., None]
            v = v.float() * _local(kv.v_scale, coord, r0, r1, a, e)[..., None]
            qq = qq.float()
        o, lse = flash_attention_lse(qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal=False, window=0, softcap=softcap)
        outs.append(o.float())
        lses.append(lse)
    full = combine(mesh, seq, outs, lses, ctx.dev(d), rec).transpose(1, 2).to(dt)
    return [None if hi == lo else full[:, :, lo:hi].to(ctx.dev(d, m)) for m, (lo, hi) in
            enumerate(heads)]


def combine(mesh, axis, outs: list, lses: list, home, record: bool) -> torch.Tensor:
    """The attention over all the slices from each slice's normalized output
    (B, Hq, Sq, hd) float32 and its lse (B, Hq, Sq): a pmax of the lse, then
    psums of the outputs weighted by exp(lse - max) and of those weights
    (each recorded), on ``home``. A slice with lse -inf weighs 0."""
    mx = C.pmax(lses, mesh, axis, home, record=record).clamp(min=NEG_INF)
    ws = [torch.exp(lse - mx.to(lse.device)) for lse in lses]
    den = C.psum(ws, mesh, axis, home, record=record)
    num = C.psum([o * w[..., None] for o, w in zip(outs, ws)], mesh, axis, home, record=record)
    return num / den.clamp(min=1e-30)[..., None]
