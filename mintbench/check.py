"""The comparison that decides ``correct``.

Every query the window sent is an answer to check: its top-k ids. The check
judges a sample of them, drawn from the run's seed, against the plain
reference (``reference.py``) on the raw generated columns:

- ``unanswered``: queries sent in the window that got no ids, even after
  the runtime was drained. Limit 0.
- ``malformed``: answers that are not k distinct ids of rows of the table.
  Limit 0.
- ``recall_mean``: mean share of the exact top-k that the answers hold.
  The configuration states its recall target (``theta_recall``), and that
  is the limit.
- ``order_gap``: the answers come best first. Over every pair of
  neighbours in an answer, the most by which the later id's exact float32
  score exceeds the earlier one's. Scoring in float32 misorders ties only by
  rounding; scoring in bfloat16 (the control) or an altered id misorders by
  far more. The limit sits between the two readings (PERF.md, section 2).
"""
from __future__ import annotations

import numpy as np
import torch

from mintbench import gen, reference

# answers judged a run; the reference scores them in blocks of BLOCK queries
SAMPLE = 8192
BLOCK = 256
# PERF.md section 2 gives the readings this limit was set from
ORDER_GAP_LIMIT = 1e-3


def well_formed(ids, k: int, n_rows: int) -> bool:
    ids = np.asarray(ids)
    return (ids.shape == (k,) and int(ids.min()) >= 0 and int(ids.max()) < n_rows
            and np.unique(ids).shape[0] == k)


def pick(answers: list, k: int, n_rows: int, seed: int) -> list[int]:
    """The answers to judge: every well-formed one, or SAMPLE of them drawn
    from the seed, in order."""
    good = [i for i, a in enumerate(answers) if a is not None and well_formed(a, k, n_rows)]
    if len(good) <= SAMPLE:
        return good
    rng = np.random.default_rng(gen.derive(seed, "sample"))
    return [good[j] for j in np.sort(rng.choice(len(good), size=SAMPLE, replace=False))]


def judge(answers: list, vids: list, vecs: np.ndarray, pos: np.ndarray,
          cols: list[torch.Tensor], dims: list[int], k: int, theta_recall: float,
          seed: int) -> dict:
    """``answers[i]``: the ids query i got (None when it got none);
    ``vids[i]``: its columns; ``vecs[pos[i]]``: its full-width vectors.
    Returns each compared number with its limit and whether it holds."""
    reference.strict_fp32()
    n_rows = int(cols[0].shape[0])
    unanswered = sum(a is None for a in answers)
    malformed = sum(a is not None and not well_formed(a, k, n_rows) for a in answers)
    picked = pick(answers, k, n_rows, seed)
    hits, gap = 0, 0.0
    by_vid: dict[tuple, list[int]] = {}
    for i in picked:
        by_vid.setdefault(tuple(vids[i]), []).append(i)
    device = cols[0].device
    for vid, idx in sorted(by_vid.items()):
        for b in range(0, len(idx), BLOCK):
            blk = idx[b:b + BLOCK]
            q = torch.as_tensor(vecs[pos[blk]], device=device)
            parts = reference.split(q, dims, vid)
            got = torch.as_tensor(np.stack([np.asarray(answers[i], dtype=np.int64)
                                            for i in blk]), device=device)
            exact = reference.topk(cols, vid, parts, k)
            hits += int((got[:, :, None] == exact[:, None, :]).any(-1).sum())
            s = reference.scores_of(cols, vid, parts, got)
            gap = max(gap, float((s[:, 1:] - s[:, :-1]).clamp_min(0).max()))
    recall = hits / (k * len(picked)) if picked else 0.0
    numbers = {
        "unanswered": (unanswered, "<=", 0),
        "malformed": (malformed, "<=", 0),
        "recall_mean": (recall, ">=", theta_recall),
        "order_gap": (gap, "<=", ORDER_GAP_LIMIT),
    }
    out = {name: {"value": v, "need": op, "limit": lim,
                  "ok": bool(v <= lim if op == "<=" else v >= lim)}
           for name, (v, op, lim) in numbers.items()}
    out["judged"] = {"value": len(picked)}
    return out


def passed(checks: dict) -> bool:
    return bool(checks["judged"]["value"]) and all(
        c["ok"] for name, c in checks.items() if name != "judged")


def control_answers(vids: list, vecs: np.ndarray, pos: np.ndarray,
                    cols: list[torch.Tensor], dims: list[int], k: int,
                    dtype=torch.bfloat16) -> list:
    """The control: the reference put in the program's place, scoring in
    ``dtype`` (bfloat16, the precision below the configuration's float32)."""
    low = [c.to(dtype) for c in cols]
    out: list = [None] * len(vids)
    by_vid: dict[tuple, list[int]] = {}
    for i, vid in enumerate(vids):
        by_vid.setdefault(tuple(vid), []).append(i)
    for vid, idx in sorted(by_vid.items()):
        for b in range(0, len(idx), BLOCK):
            blk = idx[b:b + BLOCK]
            q = torch.as_tensor(vecs[pos[blk]], device=cols[0].device)
            ids = reference.topk(low, vid, reference.split(q, dims, vid), k, dtype=dtype)
            for i, row in zip(blk, ids.cpu().numpy()):
                out[i] = row
    return out
