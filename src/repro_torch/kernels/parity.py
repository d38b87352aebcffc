"""The case grids and the tolerance rules that hold each hand-written kernel
against its plain PyTorch version.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run this grid on the card;
the CPU tests feed the same seeded numpy inputs to the JAX package and to the
plain versions.

Tolerance: a kernel and its plain version sum the same d float32 products in
another order, so a score may differ from the plain one by ``tolerance(d)`` =
1e-5 * sqrt(d) relative to max(|plain score|, 1). Top-k ids may differ only at
a near tie: where the plain score of the kernel's id lies within that
tolerance of the plain score at that slot.

Flash attention has its own grid (``FLASH_CASES``, the cases of
tests/test_kernels.py plus d = 128, a ragged S, decode's Sq = 1, rows that
causality masks entirely, cases for each of the kernel's routes and
cross attention's unmasked Sq < Skv), each
run in float32, bf16 and f16, and the JAX tests' own rule: the output within
rtol = atol = 2e-3 of the plain version in float32, 5e-2 in bf16 and f16.

The flash backward has its grid too (``FLASH_BWD_CASES``: causal or not,
window, softcap 50, GQA groups 1, 2 and 6, d = 32 / 64 / 128, Sq < Skv
aligned to the end, unmasked cross attention, lengths that are not a
multiple of the 64-row tile, and a small Sq whose forward takes the
split-KV route), held on the same (q, k, v, out, lse, dout) to
``attention_bwd_ref``: each gradient's max abs error within
``FLASH_BWD_TOL`` x its plain max |grad| (2e-2 in bf16 and f16, whose
gradients are rounded once to 8 or 11 bits; 1e-4 in float32, another
summation order). The forward's lse is held to ``attention_lse_ref`` at the
forward's rule for the input dtype, two backward calls must give the same
bits, and the serving forward (no lse) the lse-writing one's bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.common import NEG_INF, neg_inf_for, pad_to
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ops import fused_scan
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.flash_attention.kernel import (flash_attention, flash_attention_bwd,
                                                        flash_attention_lse)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.streaming.ops import streaming_fused_scan
from repro_torch.kernels.streaming.ref import _masked_scores, streaming_fused_scan_ref
from repro_torch.kernels.topk.kernel import topk_scores
from repro_torch.kernels.topk.ref import topk_ref

# the streaming parity grid of tests/test_streaming.py (CASES): ragged N,
# pad + dead, k > live rows, all dead, B=1 with delta, B=128 with delta
CASES = {
    "ragged_n": dict(B=4, N=300, d=48, k=20),
    "pad_and_dead": dict(B=17, N=384, d=100, k=25, valid_n=260, n_dead=30),
    "k_gt_live": dict(B=3, N=130, d=32, k=200, valid_n=100, n_dead=95),
    "all_dead": dict(B=2, N=200, d=16, k=10, n_dead=200),
    "b1_delta": dict(B=1, N=520, d=64, k=50, valid_n=500, n_dead=10,
                     delta=dict(N=70, valid_n=60, n_dead=5)),
    "maxbatch_delta": dict(B=128, N=256, d=64, k=10,
                           delta=dict(N=40, n_dead=0)),
}
# on the card the grid adds a deep k (the estimators search a 10k-row sample
# at ek up to n_sample / 4, so k runs into the thousands) and the scan's own
# cuts (kernels/streaming/kernel.py: scan_grid): 64 queries over many row
# blocks with a ragged tail, B = 65 across two query tiles, B = 1 with a
# 2048-key list per block, and a k that shrinks the 64-query tile to 16
CARD_CASES = {**CASES,
              "deep_k": dict(B=2, N=5000, d=64, k=2048),
              "b64_row_blocks": dict(B=64, N=50_003, d=96, k=100, valid_n=49_990,
                                     n_dead=500),
              "b65_two_tiles": dict(B=65, N=3000, d=40, k=30, n_dead=20),
              "b1_k2048": dict(B=1, N=300_000, d=32, k=2048),
              "b64_k300": dict(B=64, N=100_000, d=64, k=300),
              # the filtered and mutated serving paths' operands: a predicate
              # keep bitmap (``keep`` = the share of rows it keeps) with
              # tombstones, on the base alone and on base + delta in one
              # launch; a keep bitmap sparser than k (empty tail slots); and
              # the semantic-cache probe's shape (k = 1 over a 256-row
              # ring buffer filled to 200)
              "keep_masked": dict(B=64, N=20_000, d=96, k=100, valid_n=19_990,
                                  n_dead=200, keep=0.1),
              "delta_keep": dict(B=64, N=10_112, d=64, k=100, n_dead=100, keep=0.5,
                                 delta=dict(N=300, valid_n=290, n_dead=20, keep=0.5)),
              "sparse_keep": dict(B=8, N=50_000, d=32, k=64, keep=0.001),
              "cache_probe_k1": dict(B=64, N=256, d=96, k=1, valid_n=200)}

TOL_REL = 1e-5


class ParityError(AssertionError):
    """A kernel disagrees with its plain version beyond the tolerance."""


def tolerance(d: int) -> float:
    """Relative score tolerance at width ``d``."""
    return TOL_REL * math.sqrt(d)


def case_arrays(case: dict, seed: int = 0):
    """numpy inputs of one grid case: (q, db, kwargs with numpy masks)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case["B"], case["d"])).astype(np.float32)
    db = rng.standard_normal((case["N"], case["d"])).astype(np.float32)

    def dead(n, n_dead):
        if n_dead is None:
            return None
        m = np.zeros(n, dtype=bool)
        if n_dead:
            m[rng.choice(n, size=n_dead, replace=False)] = True
        return m

    def keep(n, share):
        return None if share is None else rng.random(n) < share

    kw = dict(valid_n=case.get("valid_n"),
              dead_mask=dead(case["N"], case.get("n_dead")))
    dl = case.get("delta")
    if dl:
        kw.update(delta=rng.standard_normal((dl["N"], case["d"])).astype(np.float32),
                  delta_valid_n=dl.get("valid_n"),
                  delta_dead_mask=dead(dl["N"], dl.get("n_dead")))
    if "keep" in case:
        kw["keep_mask"] = keep(case["N"], case["keep"])
        if dl:
            kw["delta_keep_mask"] = keep(dl["N"], dl.get("keep"))
    return q, db, kw


def to_torch(x, dtype, device="cpu"):
    """A case array as a tensor: float inputs in ``dtype``, masks as bool."""
    if x is None or isinstance(x, int):
        return x
    t = torch.as_tensor(x, device=device)
    return t.to(dtype) if x.dtype == np.float32 else t


def case_tensors(name: str, dtype, device):
    """(q, db, kwargs) of case ``name`` as tensors; the seed is the case's
    position in ``sorted(CASES)``, as in the CPU tests, so both hold the
    same inputs."""
    seed = sorted(CASES).index(name) if name in CASES else len(CASES)
    q, db, kw = case_arrays(CARD_CASES[name], seed=seed)
    return (to_torch(q, dtype, device), to_torch(db, dtype, device),
            {n: to_torch(v, dtype, device) for n, v in kw.items()})


def combined_plain_scores(q, db, metric, kw, bn=128):
    """Masked plain scores over the combined id space (delta after the base
    rows padded to ``bn``), as the streaming scan numbers its ids."""
    s = _masked_scores(q, db, metric, kw.get("valid_n"), kw.get("dead_mask"),
                       kw.get("keep_mask"))
    if kw.get("delta") is not None:
        ds = _masked_scores(q, kw["delta"], metric, kw.get("delta_valid_n"),
                            kw.get("delta_dead_mask"), kw.get("delta_keep_mask"))
        s = torch.cat([pad_to(s, 1, bn, value=NEG_INF), ds], dim=1)
    return s


def check_scores(got, want, d: int, what: str) -> float:
    """Max abs error of ``got`` against the plain ``want``; raises beyond
    ``tolerance(d)``."""
    diff = (got - want).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not bool((diff <= tolerance(d) * want.abs().clamp(min=1.0)).all()):
        raise ParityError(f"{what}: scores differ beyond {tolerance(d):.3g} "
                          f"relative (max abs err {err:.3g})")
    return err


def check_topk(vals, ids, rvals, rids, plain_full, d: int, what: str
               ) -> tuple[float, int]:
    """(max abs value error, near-tie id swaps) of a kernel's top-k against
    the plain version's; ``plain_full`` holds the plain scores of every id."""
    err = check_scores(vals, rvals, d, what)
    diff = ids != rids
    swaps = int(diff.sum().item())
    if swaps:
        b, i = diff.nonzero(as_tuple=True)
        got = plain_full[b, ids[b, i].long()]
        want = rvals[b, i]
        if not bool(((got - want).abs()
                     <= tolerance(d) * want.abs().clamp(min=1.0)).all()):
            raise ParityError(f"{what}: {swaps} ids differ beyond a near tie")
        if any(len(set(r)) != len(r) for r in ids.tolist()):
            raise ParityError(f"{what}: duplicate ids")
    return err, swaps


def two_pass_scan(q, db, k: int, metric: str, kw: dict, bn: int = 128):
    """The two-pass scan (distance kernel -> mask -> top-k kernel,
    ``fused_scan``) over the streaming scan's combined id space: the base
    rows padded to ``bn``, then the delta rows; padding, rows past each
    source's valid count, dead rows and rows outside the keep bitmap masked.
    ``k`` is the streaming scan's (already clamped), so both return the same
    slots."""
    def dead(n, valid, mask, keep):
        bad = torch.arange(n, device=q.device) >= (n if valid is None else valid)
        bad = bad if mask is None else bad | mask
        return bad if keep is None else bad | ~keep

    rows = db
    bad = dead(db.shape[0], kw.get("valid_n"), kw.get("dead_mask"), kw.get("keep_mask"))
    if kw.get("delta") is not None:
        delta = kw["delta"]
        rows = torch.cat([pad_to(db, 0, bn), delta])
        bad = torch.cat([pad_to(bad, 0, bn, value=True),
                         dead(delta.shape[0], kw.get("delta_valid_n"),
                              kw.get("delta_dead_mask"), kw.get("delta_keep_mask"))])
    return fused_scan(q, rows, k=k, metric=metric, dead_mask=bad)


def check_case(name: str, metric: str, dtype, device) -> dict:
    """Every kernel against its plain version on grid case ``name``: the
    streaming scan, the distance kernel, and top-k over the plain scores
    (exact: both select from identical scores by the same rule). Then the
    contract between the scans: the two-pass scan (distance -> mask ->
    top-k) gives the streaming scan's ids and values bit for bit."""
    case = CARD_CASES[name]
    d, k = case["d"], case["k"]
    what = f"{name}/{metric}/{str(dtype).removeprefix('torch.')}"
    q, db, kw = case_tensors(name, dtype, device)
    vals, ids = streaming_fused_scan(q, db, k=k, metric=metric, **kw)
    n_tot = db.shape[0] + (0 if kw.get("delta") is None else kw["delta"].shape[0])
    rvals, rids = streaming_fused_scan_ref(q, db, min(k, n_tot), metric=metric, **kw)
    full = combined_plain_scores(q, db, metric, kw)
    scan_err, swaps = check_topk(vals, ids, rvals, rids, full, d, f"streaming {what}")
    rs = batched_scores_ref(q, db, metric=metric)
    dist_err = check_scores(batched_scores(q, db, metric=metric), rs, d,
                            f"distance {what}")
    tv, ti = topk_scores(rs.to(dtype), k)
    tr, tri = topk_ref(rs.to(dtype), k)
    if not (torch.equal(tv, tr) and torch.equal(ti, tri)):
        raise ParityError(f"topk {what} differs from its plain version")
    v2, i2 = two_pass_scan(q, db, min(k, n_tot), metric, kw)
    if not (torch.equal(v2, vals) and torch.equal(i2, ids)):
        raise ParityError(f"two-pass scan {what} differs from the streaming scan")
    return dict(streaming_max_abs_err=scan_err, near_tie_swaps=swaps,
                distance_max_abs_err=dist_err, topk_equal=True,
                two_pass_equals_streaming=True, tol_rel=tolerance(d))


# ---- top-k -------------------------------------------------------------------------

# the top-k kernel's own cases, each held equal (torch.equal) to topk_ref:
# scores rising along the row (every key beats the threshold: the worst
# case), all scores equal (ties broken by id across blocks), a tail of
# NEG_INF columns, k beyond the live columns, a single row of 1e6, a deep
# k = 2048, and f16 / bf16 / f32 rows of odd N (2- and 4-byte loads)
TOPK_CASES = {
    "ascending": dict(B=4, N=300_000, k=100, kind="ascending"),
    "all_equal": dict(B=3, N=100_000, k=100, kind="equal"),
    "neg_inf_tail": dict(B=5, N=50_000, k=100, kind="tail", live=20_000),
    "k_gt_live": dict(B=3, N=20_000, k=100, kind="tail", live=50),
    "b1_1m": dict(B=1, N=1_000_000, k=100),
    "deep_k": dict(B=2, N=300_000, k=2048),
    "odd_n_bf16": dict(B=3, N=100_001, k=64, dtype="bf16"),
    "odd_n_f16": dict(B=3, N=100_001, k=64, dtype="f16"),
    "odd_n_f32": dict(B=3, N=100_001, k=64),
}
TOPK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def topk_case_scores(name: str, device="cpu") -> torch.Tensor:
    """(B, N) scores of top-k case ``name`` in its dtype; random ones come
    from numpy seeded with the case's position in ``sorted(TOPK_CASES)``."""
    c = TOPK_CASES[name]
    B, N = c["B"], c["N"]
    dtype = TOPK_DTYPES[c.get("dtype", "f32")]
    kind = c.get("kind", "random")
    if kind == "ascending":
        s = np.broadcast_to(np.arange(N, dtype=np.float32) / N, (B, N))
    elif kind == "equal":
        s = np.ones((B, N), dtype=np.float32)
    else:
        rng = np.random.default_rng(sorted(TOPK_CASES).index(name))
        s = rng.standard_normal((B, N)).astype(np.float32)
    t = torch.as_tensor(np.ascontiguousarray(s), device=device).to(dtype)
    if kind == "tail":
        t[:, c["live"]:] = neg_inf_for(dtype)
    return t


def check_topk_case(name: str, device) -> int:
    """The top-k kernel equal to its plain version on case ``name``;
    returns the number of slots compared."""
    s = topk_case_scores(name, device)
    k = TOPK_CASES[name]["k"]
    vals, ids = topk_scores(s, k)
    rvals, rids = topk_ref(s, k)
    if not (torch.equal(vals, rvals) and torch.equal(ids, rids)):
        raise ParityError(f"topk {name} differs from its plain version")
    return ids.numel()


# ---- flash attention -----------------------------------------------------------


def _flash(B, Hq, Hkv, Sq, Skv, d, causal=True, window=0, softcap=0.0):
    return dict(B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, d=d, causal=causal,
                window=window, softcap=softcap)


FLASH_CASES = {
    # tests/test_kernels.py: MHA square, GQA with Sq < Skv, MQA; causal or not
    **{f"{name}_{'causal' if c else 'full'}": _flash(*shape, causal=c)
       for name, shape in (("mha", (1, 2, 2, 64, 64, 32)),
                           ("gqa", (2, 4, 2, 32, 96, 64)),
                           ("mqa", (1, 8, 1, 128, 128, 64)))
       for c in (True, False)},
    # window x softcap, causal
    **{f"window{w}_cap{int(cap)}": _flash(1, 2, 2, 96, 96, 32, window=w, softcap=cap)
       for w in (0, 16) for cap in (0.0, 20.0)},
    # the model's head dim on a ragged S, with Gemma-2's softcap and a window
    "d128_ragged": _flash(2, 4, 2, 200, 200, 128, window=64, softcap=50.0),
    # decode: one query row at the end of the cache
    "decode_sq1": _flash(2, 4, 2, 1, 300, 128, window=128, softcap=50.0),
    # Sq > Skv under causal: the first rows see no kv position and give 0
    "masked_rows": _flash(1, 2, 1, 80, 40, 64),
    # the split-KV route (Sq x group <= 64): a cache long enough for many
    # splits, with and without a window; GQA group 4; MQA; Sq = 4
    "split_long": _flash(2, 4, 2, 1, 5000, 128, softcap=50.0),
    "split_long_window": _flash(2, 4, 2, 1, 5000, 128, window=1000, softcap=50.0),
    "split_gqa4": _flash(1, 8, 2, 1, 2000, 64, window=700),
    "split_mqa": _flash(1, 8, 1, 1, 1500, 64),
    "split_sq4": _flash(1, 4, 2, 4, 700, 128, window=256, softcap=50.0),
    # the tensor-core route (bf16 / f16 beyond 64 rows): >= 3 q tiles of 128
    # with a window and Gemma-2's softcap
    "tc_window_cap_d64": _flash(1, 2, 1, 400, 400, 64, window=160, softcap=50.0),
    "tc_window_cap_d128": _flash(1, 2, 2, 300, 330, 128, window=100, softcap=50.0),
    # whisper's cross attention: decoder queries over the encoder's 1,500 keys,
    # not causal (q's position changes nothing): decode (split_kv) and a
    # prompt of 384 (tensor_core in bf16 / f16); named to sort after the
    # cases above, whose seeds are their places in the sorted names
    "xattn_sq1": _flash(2, 4, 4, 1, 1500, 64, causal=False),
    "xattn_sq384": _flash(1, 2, 2, 384, 1500, 64, causal=False),
}
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2, torch.float16: 5e-2}
FLASH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def flash_case_arrays(name: str):
    """float32 numpy (q, k, v) of flash case ``name`` in the kernel's
    (B, H, S, d) layout; the seed is the case's position in
    ``sorted(FLASH_CASES)``."""
    c = FLASH_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(name))
    q = rng.standard_normal((c["B"], c["Hq"], c["Sq"], c["d"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["Hkv"], c["Skv"], c["d"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["Hkv"], c["Skv"], c["d"])).astype(np.float32)
    return q, k, v


def flash_kwargs(name: str) -> dict:
    c = FLASH_CASES[name]
    return dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])


def check_flash(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Max abs error of the kernel's output against the plain version's;
    raises beyond the dtype's rtol = atol."""
    tol = FLASH_TOL[want.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not bool((diff <= tol + tol * w.abs()).all()):
        raise ParityError(f"{what}: flash attention differs beyond {tol} "
                          f"(max abs err {err:.3g})")
    return err


def check_flash_case(name: str, dtype, device) -> float:
    """The flash kernel against its plain version on case ``name`` in
    ``dtype``; returns the max abs error."""
    q, k, v = (torch.as_tensor(x, device=device).to(dtype)
               for x in flash_case_arrays(name))
    kw = flash_kwargs(name)
    return check_flash(flash_attention(q, k, v, **kw), attention_ref(q, k, v, **kw),
                       f"flash {name}/{str(dtype).removeprefix('torch.')}")


# ---- flash attention backward ---------------------------------------------------

FLASH_BWD_CASES = {
    "causal_g1_d32": _flash(1, 2, 2, 96, 96, 32),
    "full_g2_d64": _flash(2, 4, 2, 80, 80, 64, causal=False),
    "window_g2_d64": _flash(1, 4, 2, 130, 130, 64, window=40),
    "cap50_g1_d128": _flash(1, 2, 2, 100, 100, 128, softcap=50.0),
    # qwen2-vl's group of 6, with a window and Gemma-2's softcap
    "window_cap_g6_d128": _flash(1, 12, 2, 70, 70, 128, window=33, softcap=50.0),
    # granite-moe-1b-a400m's heads (16 over 8, d = 64) on a ragged length
    "granite_heads": _flash(1, 16, 8, 150, 150, 64),
    # q aligned to the end of a longer kv sequence, causal and windowed
    "sq_lt_skv": _flash(2, 4, 2, 50, 150, 64),
    "sq_lt_skv_window_cap": _flash(1, 6, 1, 60, 140, 32, window=25, softcap=50.0),
    # whisper's cross attention: no positional mask, Sq != Skv
    "cross": _flash(1, 4, 4, 40, 100, 64, causal=False),
    # a small Sq: the forward's lse comes from the split-KV route's combine
    "split_sq4": _flash(1, 4, 2, 4, 300, 64, softcap=50.0),
}
# cases that span several 64-row tiles each way, so that interior tiles (no
# compares), diagonal tiles and window-edge tiles all occur
FLASH_BWD_TILE_CASES = {
    "tiles_causal_g2_d64": _flash(1, 4, 2, 320, 320, 64),
    # q shifted 64 into the kv sequence
    "tiles_window_cap_d128": _flash(1, 2, 1, 200, 264, 128, window=100, softcap=50.0),
    "tiles_full_d32": _flash(2, 2, 2, 192, 256, 32, causal=False),
}
# each case's seed: 1000 + its position among the first cases sorted, then
# the tile cases in order
_BWD_SEEDS = {name: 1000 + i
              for i, name in enumerate([*sorted(FLASH_BWD_CASES), *FLASH_BWD_TILE_CASES])}
FLASH_BWD_CASES.update(FLASH_BWD_TILE_CASES)
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def flash_bwd_case_arrays(name: str):
    """float32 numpy (q, k, v, dout) of backward case ``name``, drawn from
    the case's seed (``_BWD_SEEDS``)."""
    c = FLASH_BWD_CASES[name]
    rng = np.random.default_rng(_BWD_SEEDS[name])
    q = rng.standard_normal((c["B"], c["Hq"], c["Sq"], c["d"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["Hkv"], c["Skv"], c["d"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["Hkv"], c["Skv"], c["d"])).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, dout


def flash_bwd_kwargs(name: str) -> dict:
    c = FLASH_BWD_CASES[name]
    return dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])


def check_grad(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    """Max abs error of a kernel gradient against the plain one; raises
    beyond ``FLASH_BWD_TOL[dtype]`` x the plain max |grad|."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if w.numel() else 0.0
    if not err <= FLASH_BWD_TOL[dtype] * w.abs().max().item():
        raise ParityError(f"{what}: gradient differs by {err:.3g} (max |plain| "
                          f"{w.abs().max().item():.3g}, tol {FLASH_BWD_TOL[dtype]})")
    return err


def check_flash_bwd(q, k, v, dout, kw: dict, what: str) -> dict:
    """The forward's out and lse (the kernel with its lse output) against
    ``attention_lse_ref``, the serving forward's bits against them, then the
    backward kernel against ``attention_bwd_ref`` on the same (q, k, v, out,
    lse, dout), and a second backward call bit for bit. Returns the errors."""
    dtype = q.dtype
    out, lse = flash_attention_lse(q, k, v, **kw)
    want_out, want_lse = attention_lse_ref(q, k, v, **kw)
    out_err = check_flash(out, want_out, f"{what}: forward out")
    tol = FLASH_TOL[dtype]
    lse_err = (lse - want_lse).abs().max().item()
    if not bool(((lse - want_lse).abs() <= tol + tol * want_lse.abs()).all()):
        raise ParityError(f"{what}: lse differs by {lse_err:.3g} (tol {tol})")
    if not torch.equal(flash_attention(q, k, v, **kw), out):
        raise ParityError(f"{what}: the serving forward's bits differ from the lse one's")
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise ParityError(f"{what}: two backward calls gave different bits")
    want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    errs = {f"{n}_max_abs_err": check_grad(g, w, dtype, f"{what}: {n}")
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return dict(errs, max_abs_err=max(errs.values()), out_max_abs_err=out_err,
                lse_max_abs_err=lse_err, grad_max_abs=max(w.float().abs().max().item()
                                                          for w in want))


def check_flash_bwd_case(name: str, dtype, device) -> dict:
    """``check_flash_bwd`` on grid case ``name`` in ``dtype``."""
    q, k, v, dout = (torch.as_tensor(x, device=device).to(dtype)
                     for x in flash_bwd_case_arrays(name))
    return check_flash_bwd(q, k, v, dout, flash_bwd_kwargs(name),
                           f"flash bwd {name}/{str(dtype).removeprefix('torch.')}")
