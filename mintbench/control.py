"""The control of the check, on the card at a cell's own size.

    python3 mintbench/control.py --workload <cell> --queries <n> --seeds <n> [<n> ...]

For each seed: the cell's inputs as ``run.py`` makes them, and the control's
answers to the ``n`` queries the window sends first (a window's worth): the
reference put in the program's place, scoring in bfloat16, judged by the
check as the program's answers are. The control has to come out not
correct. One JSON line a seed. Not part of the benchmark's runs.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_checks(cell, seed: int, queries: int, device) -> dict:
    """The check's numbers for the control on ``queries`` of the stream of
    run ``seed`` of ``cell``, from the first query after warm-up on."""
    import numpy as np
    import torch

    from mintbench import check, harness
    db, _, stream = harness.build_inputs(cell, seed, device)
    start = harness.warmup_queries(cell)
    pos = (start + np.arange(queries)) % len(stream)
    vids = [stream.vids[i] for i in pos]
    cols = [torch.as_tensor(c, device=device) for c in db.columns]
    k = int(cell.mix["k"])
    low = check.control_answers(vids, stream.vecs, pos, cols, db.dims, k)
    return check.judge(low, vids, stream.vecs, pos, cols, db.dims, k,
                       float(cell.config["theta_recall"]), seed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--queries", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from mintbench import check, harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        got = control_checks(cell, seed, args.queries, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "control": got, "correct": check.passed(got)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
