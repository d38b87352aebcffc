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
causality masks entirely, and cases for each of the kernel's routes), each
run in float32, bf16 and f16, and the JAX tests' own rule: the output within
rtol = atol = 2e-3 of the plain version in float32, 5e-2 in bf16 and f16.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.common import NEG_INF, pad_to
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ref import batched_scores_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
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
              "b64_k300": dict(B=64, N=100_000, d=64, k=300)}

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

    kw = dict(valid_n=case.get("valid_n"),
              dead_mask=dead(case["N"], case.get("n_dead")))
    dl = case.get("delta")
    if dl:
        kw.update(delta=rng.standard_normal((dl["N"], case["d"])).astype(np.float32),
                  delta_valid_n=dl.get("valid_n"),
                  delta_dead_mask=dead(dl["N"], dl.get("n_dead")))
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
    s = _masked_scores(q, db, metric, kw.get("valid_n"), kw.get("dead_mask"), None)
    if kw.get("delta") is not None:
        ds = _masked_scores(q, kw["delta"], metric, kw.get("delta_valid_n"),
                            kw.get("delta_dead_mask"), None)
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


def check_case(name: str, metric: str, dtype, device) -> dict:
    """Every kernel against its plain version on grid case ``name``: the
    streaming scan, the distance kernel, and top-k over the plain scores
    (exact: both select from identical scores by the same rule)."""
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
    return dict(streaming_max_abs_err=scan_err, near_tie_swaps=swaps,
                distance_max_abs_err=dist_err, topk_equal=True,
                tol_rel=tolerance(d))


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
