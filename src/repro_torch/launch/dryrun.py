"""Multi-pod dry-run of the port: run every (arch x shape x mesh) cell's step
once on ``meta`` tensors under a count, as the reference's
``repro.launch.dryrun`` lowers and compiles it.

The production meshes are ``make_production_mesh(device="meta")``: the
reference's (16, 16) and (2, 16, 16) grids, every rank a ``meta`` device,
so nothing is allocated and no card is needed. The port's mesh is
single-controller, so the whole grid runs in this one process (the
reference forces 512 host devices into a subprocess). Each cell places
the abstract parameters (``abstract_params``: ``init_params(device=
"meta")``, float32 as the reference's) by ``param_shardings``, the batch
by ``batch_shardings`` and, for a decode cell, the cache by
``cache_shardings``; then it runs the step of its kind:

- train: ``make_sharded_train_step`` with ``sharded_adamw_init`` moments
  placed by ``zero1_shardings``;
- prefill: ``make_prefill_step`` (``prefill`` on the mesh: ``_prefill_tp``);
- decode: ``make_serve_step`` (``decode_step`` on the mesh: flash-decoding
  per sequence shard) at ``pos`` = the cache's last slot, so every key is
  valid: the work the reference's compiled step (a dense attention over the
  whole cache) is counted for.

"Lower + compile" becomes "place + count": ``lower_s`` is the seconds to
build the mesh and place the inputs, ``count_s`` (where the reference has
``compile_s``) the seconds of the one counting pass over the step
(``launch.cost_count``). The record keeps the reference's other keys:
``status``, ``reason``, ``n_params``, ``n_active_params``, ``memory``,
``cost``, ``collectives``, ``roofline``. Everything is rank 0's, as XLA's
per-device program: ``cost`` and the temp memory from the counting pass
over rank 0's ops, arguments / outputs from rank 0's blocks, collectives
from ``mesh.log`` (one op of the per-device program once). Q heads that
do not divide the model ranks split as GSPMD pads them
(``tensor_parallel.head_range``: qwen2-7b's 28 on 16 ranks, 2 a rank, none
on the last two), so rank 0's count is the reference's per-device program
with its heads padded. A step that raises anyway gives an ``error`` record
naming the raise.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh both --out experiments/torch_dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, get_arch, input_specs, list_archs
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (NamedSharding, P, _dp_axes, cache_shardings,
                                              param_shardings, shard_tree, tree_map,
                                              use_mesh)
from repro_torch.launch.cost_count import CostCount, rank0_bytes, tag_tree
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.launch.roofline import (Roofline, collective_bytes, extract_cost,
                                         extract_memory)
from repro_torch.models import model as M
from repro_torch.train.optimizer import zero1_shardings
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_sharded_train_step, sharded_adamw_init)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg`` on ``meta`` (the reference's
    ``jax.eval_shape`` of ``init_params``): float32 shapes, nothing
    allocated."""
    return M.init_params(cfg, 0, device="meta")


def _dp_total(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def batch_shardings(mesh, specs: dict, *, long_context: bool) -> dict:
    """The reference's input layout: ``pos`` replicated, a leaf whose first
    dim the data axes divide split over them, else replicated; the cache
    by ``cache_shardings`` (``shard_seq`` for a long context)."""
    dp = _dp_axes(mesh)
    total = _dp_total(mesh)

    def spec_of(name, leaf):
        if name == "pos":
            return NamedSharding(mesh, P())
        if leaf.shape and leaf.shape[0] % total == 0:
            return NamedSharding(mesh, P(*((dp,) + (None,) * (leaf.ndim - 1))))
        return NamedSharding(mesh, P(*((None,) * leaf.ndim)))

    return {k: (cache_shardings(v, mesh, shard_seq=long_context)
                if k == "cache" else
                tree_map(lambda leaf, kk=k: spec_of(kk, leaf), v))
            for k, v in specs.items()}


def _block_bytes(t: torch.Tensor, sh: NamedSharding) -> int:
    n = 1
    for s in sh.block_shape(tuple(t.shape)):
        n *= s
    return n * t.element_size()


def count_step(step, args: tuple, mesh=None, *, grad: bool = False):
    """(the step's results, the counting pass's record) of one run of
    ``step(*args)`` on meta tensors (``cost_count.CostCount``): on
    ``mesh`` (its placed inputs tagged by rank, data rank 0's part computed
    and mirrored, ``tensor_parallel.mirrored``) or on one device (None).
    Autograd runs only with ``grad`` (a training step)."""
    for a in args:
        tag_tree(a)
    if mesh is not None:
        mesh.log.clear()
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(use_mesh(mesh))
            stack.enter_context(TP.mirrored())
        if not grad:
            stack.enter_context(torch.no_grad())
        cc = stack.enter_context(CostCount(mesh))
        out = step(*args)
    return out, cc.record()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             bf16_grads: bool = True, sharding_mode: str = "tp",
             moe_impl: str | None = None, kv_dtype: str | None = None) -> dict:
    cfg = get_arch(arch)
    if moe_impl and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "sharding": sharding_mode, "bf16_grads": bf16_grads,
                 "moe_impl": moe_impl or (cfg.moe_impl if cfg.n_experts else None),
                 "kv_dtype": kv_dtype or "bf16"}
    if not cfg.supports(shape_name):
        rec["status"] = "skipped"
        rec["reason"] = cfg.skip_reason(shape_name)
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = mesh_chip_count(mesh)
    params_abs = abstract_params(cfg)
    rec["n_params"] = M.param_count(params_abs)
    rec["n_active_params"] = n_active = M.active_param_count(cfg, params_abs)
    specs = input_specs(cfg, shape, kv_dtype=kv_dtype)
    long_context = shape_name == "long_500k"
    p_sh = param_shardings(params_abs, mesh, mode=sharding_mode)
    b_sh = batch_shardings(mesh, specs, long_context=long_context)
    params = shard_tree(params_abs, p_sh)
    batch_bytes = sum(_block_bytes(specs[k], b_sh[k]) for k in specs if k != "cache")
    if shape.kind == "train":
        opt = sharded_adamw_init(params, zero1_shardings(p_sh, params_abs, mesh))
        step = make_sharded_train_step(cfg, bf16_grads=bf16_grads)
        args = (params, opt, {k: v for k, v in specs.items()})
        donated = rank0_bytes(params) + rank0_bytes(opt)
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        args = (params, dict(specs))
        donated = 0
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:  # decode
        cache = shard_tree(specs["cache"], b_sh["cache"])
        step = make_serve_step(cfg)
        args = (params, cache, specs["tokens"], shape.seq_len - 1)
        donated = rank0_bytes(cache)
        tokens = shape.global_batch  # one token per sequence
        model_flops = 2.0 * n_active * tokens
    arg_bytes = rank0_bytes(args[0]) + batch_bytes + (
        rank0_bytes(args[1]) if shape.kind in ("train", "decode") else 0)
    rec["lower_s"] = round(time.time() - t0, 1)

    t1 = time.time()
    out, count = count_step(step, args, mesh, grad=shape.kind == "train")
    rec["count_s"] = round(time.time() - t1, 1)
    if shape.kind == "train":
        made = rank0_bytes(out[0]) + rank0_bytes(out[1]._asdict()) + 12  # 3 f32 metrics
        out_bytes = made
    else:
        logits, cache_out = out
        made = rank0_bytes(logits)  # a prefill's cache blocks are made outside the count
        out_bytes = rank0_bytes(logits) + rank0_bytes(cache_out)
    count.update(argument_bytes=arg_bytes, output_bytes=out_bytes, alias_bytes=donated,
                 temp_peak=max(count["temp_peak"] - made, 0))
    mem = extract_memory(count)
    cost = extract_cost(count)
    colls = collective_bytes(mesh.log)
    rl = Roofline(flops=cost["flops"], hbm_bytes=cost["bytes"],
                  coll_bytes=colls["total_bytes"], model_flops=model_flops / chips,
                  chips=chips)
    rec.update(status="ok", chips=chips, memory=mem,
               cost={"flops": cost["flops"], "bytes": cost["bytes"],
                     "flash_flops": count["flash_flops"], "ops": count["ops"]},
               collectives=colls, roofline=rl.as_dict())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/torch_dryrun.json")
    ap.add_argument("--no-bf16-grads", action="store_true")
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--moe-impl", default=None, choices=[None, "dense", "sorted"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    args = ap.parse_args(argv)

    if args.seq_parallel:
        from repro_torch.distributed.sharding import set_sequence_parallel
        set_sequence_parallel(True)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                key = (arch, shape, "2x16x16" if multi else "16x16")
                if key in done:
                    print(f"[skip-done] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi,
                                   bf16_grads=not args.no_bf16_grads,
                                   sharding_mode=args.sharding,
                                   moe_impl=args.moe_impl,
                                   kv_dtype="int8" if args.kv_int8 else None)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": key[2],
                           "status": "error", "error": f"{type(e).__name__}: {e}"[:2000],
                           "trace": traceback.format_exc()[-2000:]}
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = rec.get("status")
                if status == "ok":
                    rl = rec["roofline"]
                    print(f"  ok: count={rec['count_s']}s "
                          f"dominant={rl['dominant']} "
                          f"frac={rl['roofline_fraction']:.3f} "
                          f"mem={rec['memory'].get('total_device_bytes', 0)/2**30:.2f}GiB",
                          flush=True)
                else:
                    print(f"  {status}: {rec.get('reason', rec.get('error', ''))[:200]}",
                          flush=True)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {args.out}")


if __name__ == "__main__":
    main()
