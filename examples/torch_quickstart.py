"""Quickstart on the PyTorch/CUDA port: tune a multi-vector database with
MINT and execute the plans over graph (HNSW) indexes.

    PYTHONPATH=src python examples/torch_quickstart.py [--rows 12000]
        [--kind hnsw] [--device cuda|cpu]

The default device is the CUDA card (the sample and full index builds run
their exact kNN blocks in the streaming-scan kernel and their k-means on the
card; graph walks run on the host); ``--device cpu`` runs the plain
versions.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

from repro_torch.core.tuner import Mint, execute_workload, ground_truth_cache
from repro_torch.core.types import Constraints, IndexSpec, config_name
from repro_torch.data.vectors import make_database, make_workload
from repro_torch.index.registry import IndexStore
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.engine import BatchEngine

# a 4-column multi-modal database (e.g. image/title/description/content)
COLUMNS = [("image", 128), ("title", 96), ("description", 160), ("content", 192)]
CONSTRAINTS = Constraints(theta_recall=0.9, theta_storage=4)


def with_kind(result, kind: str):
    """The same configuration and plans (eks included) over ``kind`` indexes."""
    def swap(specs):
        return [IndexSpec(vid=s.vid, kind=kind) for s in specs]
    plans = {qid: replace(p, indexes=swap(p.indexes)) for qid, p in result.plans.items()}
    return replace(result, configuration=frozenset(swap(result.configuration)),
                   plans=plans)


def run(rows: int = 12000, kind: str = "hnsw", device=None, seed: int = 0) -> dict:
    """tune -> build -> execute MINT and the one-index-per-column baseline;
    returns the results, metrics, store and wall times (seconds)."""
    device = resolve_device(device)
    db = make_database(rows, COLUMNS, seed=seed)
    workload = make_workload(db, "news", n_queries=6, k=50, seed=seed)
    out = dict(db=db, workload=workload)
    t0 = time.perf_counter()
    mint = Mint(db, index_kind=kind, seed=seed, device=device)
    out["result"] = mint.tune(workload, CONSTRAINTS)
    out["pc"] = mint.per_column(workload, CONSTRAINTS)
    out["tune_s"] = time.perf_counter() - t0
    store = IndexStore(db, seed=seed, device=device)
    t0 = time.perf_counter()
    for cfg in (out["result"].configuration, out["pc"].configuration):
        for spec in sorted(cfg, key=lambda s: s.name):
            store.get(spec)
    out["build_s"] = time.perf_counter() - t0
    gt = ground_truth_cache(db, workload)
    engine = BatchEngine(db, store=store)
    t0 = time.perf_counter()
    out["mint"] = execute_workload(db, store, workload, out["result"], gt, engine=engine)
    out["per_column"] = execute_workload(db, store, workload, out["pc"], gt, engine=engine)
    out["walk_s"] = time.perf_counter() - t0
    out.update(store=store, gt=gt, counters=engine.counters.as_dict())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=12000)
    ap.add_argument("--kind", default="hnsw", choices=("hnsw", "diskann", "ivf"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    r = run(args.rows, args.kind, args.device)
    print("workload:", [q.name for q in r["workload"].queries])
    print("\nrecommended configuration:", config_name(r["result"].configuration))
    for qid in sorted(r["result"].plans):
        print("  ", r["result"].plans[qid].describe())
    mint_m, pc_m = r["mint"], r["per_column"]
    print(f"\nMINT      cost={mint_m.weighted_cost/1e6:.2f}M  "
          f"recall={mint_m.mean_recall:.3f}  storage={mint_m.storage:.0f}")
    print(f"PerColumn cost={pc_m.weighted_cost/1e6:.2f}M  "
          f"recall={pc_m.mean_recall:.3f}  storage={pc_m.storage:.0f}")
    print(f"speedup:  {pc_m.weighted_cost/max(mint_m.weighted_cost,1):.2f}x")
    print(f"tune {r['tune_s']:.1f} s, index build {r['build_s']:.1f} s, "
          f"execution {r['walk_s']:.1f} s")


if __name__ == "__main__":
    main()
