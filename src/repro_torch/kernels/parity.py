"""The case grid and the tolerance rule that hold each hand-written kernel
against its plain PyTorch version.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run this grid on the card;
the CPU tests feed the same seeded numpy inputs to the JAX package and to the
plain versions.

Tolerance: a kernel and its plain version sum the same d float32 products in
another order, so a score may differ from the plain one by ``tolerance(d)`` =
1e-5 * sqrt(d) relative to max(|plain score|, 1). Top-k ids may differ only at
a near tie: where the plain score of the kernel's id lies within that
tolerance of the plain score at that slot.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.common import NEG_INF, pad_to
from repro_torch.kernels.distance.kernel import batched_scores
from repro_torch.kernels.distance.ref import batched_scores_ref
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
# on the card the grid adds a deep k: the estimators search a 10k-row sample
# at ek up to n_sample / 4, so k runs into the thousands
CARD_CASES = {**CASES, "deep_k": dict(B=2, N=5000, d=64, k=2048)}

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
