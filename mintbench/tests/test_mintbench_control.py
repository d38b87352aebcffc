"""The check has to fail the control and every fault a serving cell can have.

The control is the reference put in the program's place, scoring in
bfloat16; the faults break the timed path under a whole run: a flush that
hands back the last flush's answers (state unchanged), half of the batch
left unanswered, and an answer altered where it is produced. Each is read
with the cell's own clients and batch and with flushes of 32."""
import time

import numpy as np
import pytest
import torch

from mintbench import check, control, harness, reference
from mintbench.tests.small import CELLS, ROOT, small


def bf16_reference(rt):
    cols = [torch.from_numpy(c).to(torch.bfloat16) for c in rt.db.columns]

    def search(pairs, staged=None):
        out = []
        for q, _ in pairs:
            parts = [torch.from_numpy(np.asarray(q.vectors[c]))[None] for c in q.vid]
            out.append(reference.topk(cols, q.vid, parts, q.k, dtype=torch.bfloat16)[0]
                       .numpy())
        return out
    rt.engine.search_batch = search


def stale(rt):
    """Each flush hands back the answers of the flush before it (the first,
    its own answers one place along)."""
    search, last = rt.engine.search_batch, []

    def broken(pairs, staged=None):
        got = search(pairs, staged)
        out = (last * len(got))[:len(got)] if last else got[1:] + got[:1]
        last[:] = got
        return out
    rt.engine.search_batch = broken


def half_dropped(rt):
    """Every other query comes back with no ids: half of each flush, or with
    one query a flush, every other flush's."""
    search, n = rt.engine.search_batch, [0]

    def broken(pairs, staged=None):
        out = []
        for ids in search(pairs, staged):
            out.append(ids if n[0] % 2 == 0 else None)
            n[0] += 1
        return out
    rt.engine.search_batch = broken


def altered(rt):
    search, n = rt.engine.search_batch, rt.db.n_rows

    def broken(pairs, staged=None):
        out = []
        for ids in search(pairs, staged):
            ids = np.array(ids)
            j = len(ids) // 2
            for step in range(1, n):
                if (ids[j] + step * 7919) % n not in ids:
                    ids[j] = (ids[j] + step * 7919) % n
                    break
            out.append(ids)
        return out
    rt.engine.search_batch = broken


@pytest.mark.parametrize("clients", [None, 32], ids=["cell_clients", "clients32"])
@pytest.mark.parametrize("fault, fails", [(bf16_reference, "order_gap"),
                                          (stale, "recall_mean"),
                                          (half_dropped, "unanswered"),
                                          (altered, "order_gap")],
                         ids=["control_bf16", "state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_the_check_fails_it(fault, fails, clients):
    cell = small(harness.load_cell(ROOT, CELLS[0]), clients=clients)
    res = harness.run(cell, 2**31 + 5, 0.5, False, torch.device("cpu"),
                      time.perf_counter(), fault=fault)
    assert not res["correct"]
    assert not res["checks"][fails]["ok"], res["checks"]


def test_the_control_path_of_a_run_judges_the_control_apart():
    cell = small(harness.load_cell(ROOT, CELLS[0]), clients=None)
    got = control.control_checks(cell, 2**31 + 6, 200, torch.device("cpu"))
    assert got["judged"]["value"] == 200
    assert not check.passed(got) and not got["order_gap"]["ok"]
    assert got["unanswered"]["ok"] and got["malformed"]["ok"]
