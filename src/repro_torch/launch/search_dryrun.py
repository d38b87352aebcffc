"""Dry-run of the distributed vector-search serving plane (MINT's runtime).

Runs the serving step on the production mesh and counts its collective
bytes, the pair most representative of the technique:

  baseline  : gather-scores merge — every shard all-gathers its full local
              score matrix (Q, N_local) before the global top-k (the naive
              distributed top-k).
  optimized : tournament merge — per-shard top-k first; only (Q, k)
              candidates (values and ids) cross devices.

The predicted ratio of the two is about N_local / k. The dry-run is
shapes only: on the default ``--device meta`` (a production-shaped mesh
that repeats the meta device) nothing is computed, tensors carry shapes,
and the collectives record the bytes they would deliver, in the
reference's unit (``launch.roofline.collective_bytes``). ``--device cpu``
runs the same steps on seeded data over the one CPU device repeated, which
checks the counts against real tensors. No host holds the 256 or 512 cards
of a production mesh in one process, so the dry-run takes no card.

    PYTHONPATH=src python -m repro_torch.launch.search_dryrun
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import row_sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import collective_bytes
from repro_torch.search.distributed import make_search_step
from repro_torch.serve.columnstore import padded_device_bytes
from repro_torch.serve.compiler import compile_batch, dispatch_plan


def make_naive_search_step(mesh, k: int, axis: str = "data"):
    """The gather-scores baseline: every shard's (Q, N_local) scores are
    all-gathered, then one top-k over the (Q, S * N_local) matrix."""
    def step(db_shards, qvecs):
        home = qvecs.device
        scores = [qvecs.to(x.device) @ x.T for x in db_shards]  # (Q, N_local) each
        all_scores = all_gather(scores, mesh, axis, home)       # (S, Q, N_local)
        S, Q, NL = all_scores.shape
        flat = all_scores.transpose(0, 1).reshape(Q, S * NL)
        best = torch.sort(flat, dim=1, descending=True, stable=True)
        return best.values[:, :k], best.indices[:, :k]
    return step


def run_variant(name, step_fn, mesh, n_rows, dim, n_queries, seed: int = 0) -> dict:
    """One step over an (n_rows, dim) row-sharded database and replicated
    queries; its collective bytes and its scoring flops (2 Q N d)."""
    layout = row_sharding(mesh, "data")
    S = layout.n_shards
    n_local = -(-n_rows // S)
    if mesh.home.type == "meta":
        shards = [torch.empty((n_local, dim), device=d) for d in layout.devices()]
        q = torch.empty((n_queries, dim), device=mesh.home)
    else:
        g = torch.Generator().manual_seed(seed)
        shards = [torch.randn(n_local, dim, generator=g).to(d) for d in layout.devices()]
        q = torch.randn(n_queries, dim, generator=g).to(mesh.home)
    mesh.log.clear()
    step_fn(shards, q)
    flops = 2.0 * n_queries * n_rows * dim
    return {"variant": name, "collectives": collective_bytes(mesh.log),
            "cost": {"flops": flops, "flops_per_shard": flops / S}}


def plan_group_stats(n_queries: int, k: int, seed: int = 0) -> dict:
    """Dispatch accounting for a synthetic serving batch: how many kernel
    dispatches the plan-group compiler saves vs query-at-a-time serving.
    Uses hypothetical plans over a small schema — no data is touched."""
    from repro_torch.core.types import IndexSpec, Query, QueryPlan

    rng = np.random.default_rng(seed)
    specs = [IndexSpec(vid=(c,), kind="ivf") for c in range(3)]
    pairs = []
    for qid in range(n_queries):
        vid = tuple(sorted(rng.choice(3, size=int(rng.integers(1, 4)),
                                      replace=False).tolist()))
        q = Query(qid=qid, vid=vid,
                  vectors={c: np.zeros(8, np.float32) for c in vid}, k=k)
        used = [s for s in specs if s.vid[0] in vid]
        eks = [int(rng.choice([k, 2 * k, 3 * k]))] * len(used)
        pairs.append((q, QueryPlan(qid, used, eks, 0.0, 1.0)))
    return dispatch_plan(compile_batch(pairs))


def run(rows: int = 1 << 24, dim: int = 256, queries: int = 1024, k: int = 100,
        multi_pod: bool = False, device: str = "meta") -> list[dict]:
    if device not in ("meta", "cpu"):
        raise ValueError(f"the dry-run runs on meta (shapes only) or cpu, not {device!r}")
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    # what the serving column store actually pins: kernel-block padding plus
    # the mesh row-rounding (the memory governor's accounting unit)
    resident = padded_device_bytes(rows, dim, row_mult=int(mesh.shape["data"]))
    logical = rows * dim * 4
    print(f"column store residency: {resident / 2**30:.3f} GiB padded "
          f"({resident / logical:.4f}x logical)")
    out = []
    for name, fn in [("naive_gather_scores", make_naive_search_step(mesh, k)),
                     ("tournament_topk", make_search_step(mesh, k)),
                     # the serving engine's path: column-store padding masked
                     # via valid_n — the same collectives (the mask is local)
                     ("columnstore_tournament",
                      make_search_step(mesh, k, valid_n=rows - rows // 100))]:
        rec = run_variant(name, fn, mesh, rows, dim, queries)
        rec.update(rows=rows, dim=dim, queries=queries, k=k,
                   mesh="2x16x16" if multi_pod else "16x16",
                   device=str(mesh.home), padded_device_bytes=resident,
                   logical_device_bytes=logical)
        out.append(rec)
        tb = rec["collectives"]["total_bytes"]
        print(f"{name}: collective_bytes={tb / 2**30:.3f} GiB "
              f"flops={rec['cost']['flops']:.3e}")
    naive, tour = (out[0]["collectives"]["total_bytes"],
                   out[1]["collectives"]["total_bytes"])
    n_local = -(-rows // int(mesh.shape["data"]))
    out[1].update(naive_over_tournament_bytes=naive / tour,
                  predicted_ratio_n_local_over_k=n_local / k)
    print(f"naive / tournament collective bytes: {naive / tour:.1f} "
          f"(N_local / k = {n_local / k:.1f})")
    groups = plan_group_stats(queries, k)
    groups["variant"] = "plan_group_compiler"
    out.append(groups)
    print(f"plan_group_compiler: {groups['queries']} queries -> "
          f"{groups['batched_scan_dispatches']} scan dispatches "
          f"(vs {groups['per_query_scan_dispatches']} per-query)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--out", default="experiments/torch_search_dryrun.json")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="meta", choices=("meta", "cpu"),
                    help="the mesh's device: meta (shapes only, the default) or "
                         "cpu (seeded data)")
    args = ap.parse_args(argv)
    out = run(args.rows, args.dim, args.queries, args.k, args.multi_pod, args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
