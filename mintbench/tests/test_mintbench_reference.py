"""The plain reference against brute force in numpy, and the control's
lower precision against it."""
import numpy as np
import torch

from mintbench import check, reference

DIMS = [8, 16, 24]


def setup(n=600, b=20, seed=0):
    rng = np.random.default_rng(seed)
    cols = []
    for d in DIMS:
        x = rng.standard_normal((n, d)).astype(np.float32)
        cols.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    q = rng.standard_normal((b, sum(DIMS))).astype(np.float32)
    return cols, q


def test_topk_is_the_brute_force_top_k():
    cols, q = setup()
    vid = (0, 2)
    t = [torch.from_numpy(c) for c in cols]
    got = reference.topk(t, vid, reference.split(torch.from_numpy(q), DIMS, vid), 10).numpy()
    full = np.concatenate([cols[0], cols[2]], axis=1)
    qq = np.concatenate([q[:, :8], q[:, 24:48]], axis=1)
    want = np.argsort(-(qq.astype(np.float64) @ full.T.astype(np.float64)), axis=1)[:, :10]
    np.testing.assert_array_equal(got, want)


def test_scores_of_are_the_rows_scores():
    cols, q = setup()
    vid = (1,)
    t = [torch.from_numpy(c) for c in cols]
    parts = reference.split(torch.from_numpy(q), DIMS, vid)
    ids = torch.arange(20 * 5).reshape(20, 5) % 600
    s = reference.scores_of(t, vid, parts, ids).numpy()
    want = np.einsum("bkd,bd->bk", cols[1][ids.numpy()], q[:, 8:24])
    np.testing.assert_allclose(s, want, rtol=1e-5, atol=1e-6)


def test_judge_passes_the_exact_answers_and_fails_altered_ones():
    cols, q = setup(n=2000, b=64)
    t = [torch.from_numpy(c) for c in cols]
    vids = [(0, 1, 2)] * 64
    pos = np.arange(64)
    exact = reference.topk(t, (0, 1, 2), reference.split(torch.from_numpy(q), DIMS,
                                                         (0, 1, 2)), 50).numpy()
    answers = list(exact)
    ok = check.judge(answers, vids, q, pos, t, DIMS, 50, 0.9, 1)
    assert check.passed(ok) and ok["recall_mean"]["value"] == 1.0
    assert ok["order_gap"]["value"] <= 1e-6
    bad = [a.copy() for a in answers]
    for a in bad:
        a[25] = (a[25] + 977) % 2000 if (a[25] + 977) % 2000 not in a else a[25]
    got = check.judge(bad, vids, q, pos, t, DIMS, 50, 0.9, 1)
    assert not check.passed(got) and not got["order_gap"]["ok"]
    short = answers[:63] + [exact[0][:40]]
    got = check.judge(short, vids, q, pos, t, DIMS, 50, 0.9, 1)
    assert got["malformed"]["value"] == 1 and not check.passed(got)


def test_the_bfloat16_control_misorders_far_past_the_limit():
    cols, q = setup(n=4000, b=64, seed=3)
    t = [torch.from_numpy(c) for c in cols]
    vids = [(0, 1, 2)] * 64
    pos = np.arange(64)
    low = check.control_answers(vids, q, pos, t, DIMS, 50)
    got = check.judge(low, vids, q, pos, t, DIMS, 50, 0.9, 1)
    assert got["order_gap"]["value"] > 10 * check.ORDER_GAP_LIMIT
    assert not check.passed(got)
