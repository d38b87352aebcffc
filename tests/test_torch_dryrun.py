"""The port's dry-run (``repro_torch.launch.dryrun``) and the rest of its
``launch/roofline.py`` against the reference's.

- ``abstract_params``: the tree's shapes and dtypes equal the reference's
  ``jax.eval_shape`` leaf by leaf for the ten archs; ``n_params`` and
  ``n_active_params`` are equal.
- ``batch_shardings``: the specs equal the reference's on its
  ``AbstractMesh`` (in one process, as tests/test_torch_sharding.py does).
- A skipped cell's record equals the reference's.
- ``Roofline.as_dict`` equals the reference's under one ``HW``.
- The counting pass (``launch.cost_count``): its FLOPs equal XLA's
  ``cost_analysis`` exactly for a plain matmul chain; for one ``reduced()``
  prefill step on one device they equal the closed form (every product
  plus each flash call's kept pairs), and its argument / output bytes
  equal the reference's ``memory_analysis`` on one CPU device (XLA's output
  also holds its result tuple's table: one 8-byte pointer a leaf). Temp
  bytes are not compared: XLA's is its buffer assignment of a fused
  program, the port's the peak of its unfused intermediates; and XLA's
  FLOPs of the reference's step count its layer scan's body once.
- ``streaming_vs_twopass(measure=False)`` equals the reference's row for
  row over the reference's table sizes, but for the on-chip capacity
  (``L2_BYTES`` for the TPU's VMEM); the port's sweep goes on past the L2;
  ``measure=True`` runs the plain versions on the CPU at the cap.
- The counting pass's hooks are the calling thread's: another thread's
  collectives and flash calls are not counted; ``mirrored()`` (data rank
  0's part standing in for every data rank's) refuses a mesh of values.
- One ``run_cell`` on meta (granite-moe-1b-a400m decode_32k on 16x16)
  finishes within 120 s with the reference's record keys, its flash FLOPs
  per rank equal the closed form, and ``launch.report`` makes both tables
  of its records.
"""
import dataclasses
import functools
import importlib
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import input_specs as jax_input_specs
from repro.distributed import sharding as JS
from repro.launch import roofline as JRL
from repro.models import model as JM
from repro_torch.configs.base import SHAPES, get_arch, input_specs, list_archs
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as R
from repro_torch.launch import roofline as RL
from repro_torch.launch.cost_count import CostCount, rank0_bytes
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import model as M
from repro_torch.train.step import make_prefill_step


@pytest.fixture(scope="module")
def jdry():
    """The reference's ``launch.dryrun``; it sets ``XLA_FLAGS`` to 512 host
    devices at import (for its own subprocess): restored here, this
    process's backend being up already."""
    before = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def _meta_mesh(shape, axes):
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("meta")] * grid.size
    return AbstractMesh(shape, axes), Mesh(axes, grid.reshape(shape))


def _leaf_dtype(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_equal_reference(arch, jdry):
    jp = jdry.abstract_params(jax_get_arch(arch))
    p = D.abstract_params(get_arch(arch))
    jl = [(JS._path_str(k), tuple(x.shape), str(x.dtype))
          for k, x in jax.tree_util.tree_leaves_with_path(jp)]
    pl = [(S._path_str(k), tuple(x.shape), _leaf_dtype(x)) for k, x in S.leaves_with_path(p)]
    assert pl == jl
    assert all(x.device.type == "meta" for _, x in S.leaves_with_path(p))
    n = int(sum(x.size for x in jax.tree.leaves(jp)))
    expert = sum(x.size for k, x in jax.tree_util.tree_leaves_with_path(jp)
                 if "w_gate" in str(k) or "w_down" in str(k))
    cfg = get_arch(arch)
    n_active = int(n - expert * (1 - cfg.moe_top_k / cfg.n_experts)) if cfg.n_experts else n
    assert M.param_count(p) == n and M.active_param_count(cfg, p) == n_active


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-medium", "qwen2-vl-2b", "zamba2-1.2b"])
def test_batch_shardings_equal_reference(arch, multi, jdry):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    jmesh, mesh = _meta_mesh(shape, axes)
    for name in SHAPES:
        for kv in (None, "int8"):
            long = name == "long_500k"
            js = jax_input_specs(jax_get_arch(arch), JSHAPES[name], kv_dtype=kv)
            ps = input_specs(get_arch(arch), SHAPES[name], kv_dtype=kv)
            want = jdry.batch_shardings(jmesh, js, long_context=long)
            got = D.batch_shardings(mesh, ps, long_context=long)
            assert [(JS._path_str(k), tuple(s.spec)) for k, s in
                    jax.tree_util.tree_leaves_with_path(want)] == \
                [(S._path_str(k), tuple(s.spec)) for k, s in S.leaves_with_path(got)], (name, kv)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-27b", "whisper-medium"])
def test_skipped_cells_equal_reference(arch, jdry):
    for multi in (False, True):
        assert D.run_cell(arch, "long_500k", multi) == jdry.run_cell(arch, "long_500k", multi)


def test_roofline_equals_reference(monkeypatch):
    monkeypatch.setattr(RL, "HW", dict(JRL.HW))
    for args in [(1e15, 3e12, 4e9, 2e14, 256), (5e12, 8e9, 0.0, 4e12, 512),
                 (0.0, 1.0, 1e9, 0.0, 1)]:
        assert RL.Roofline(*args).as_dict() == JRL.Roofline(*args).as_dict()


def test_counted_flops_equal_xla_for_a_matmul_chain():
    shapes = [(8, 16), (16, 32), (32, 4)]
    f = jax.jit(lambda x, a, b: (x @ a) @ b)
    ca = f.lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()\
        .cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    with CostCount() as cc:
        x, a, b = (torch.empty(s, device="meta") for s in shapes)
        (x @ a) @ b
    assert cc.flops == int(ca["flops"]) == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4


def test_the_counting_hooks_are_the_calling_threads():
    seen = {}

    def other():
        seen["trace"], seen["counters"] = C.trace(), list(FK.meta_counters())
        q = torch.empty(1, 2, 8, 16, device="meta")
        FK.flash_attention(q, q, q, causal=True)
    with CostCount() as cc:
        assert C.trace() is cc and FK.meta_counters() == [cc.flash]
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["trace"] is not cc and seen["counters"] == []
    assert cc.flash_calls == 0 and cc.flops == 0
    assert C.trace() is not cc and FK.meta_counters() == []


def test_mirrored_refuses_a_mesh_of_values():
    with TP.mirrored():
        TP.ShardCtx(make_debug_mesh(2, 2, device="meta"))
        with pytest.raises(ValueError, match="meta"):
            TP.ShardCtx(make_debug_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="meta"):
        TP._alias(torch.zeros(2), 1)


def test_prefill_count_equals_closed_form_and_reference_memory():
    name, B, Sq = "yi-9b", 2, 64
    cfg, jcfg = get_arch(name).reduced(), jax_get_arch(name).reduced()
    params = D.abstract_params(cfg)
    batch = {"tokens": torch.empty((B, Sq), dtype=torch.int32, device="meta")}
    (logits, cache), rec = D.count_step(make_prefill_step(cfg), (params, batch))
    T, Dm, F, V, L = B * Sq, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    q_cols, kv_cols = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    per_layer = 2 * T * Dm * (2 * q_cols + 2 * kv_cols) + 3 * 2 * T * Dm * F
    flash = 4 * cfg.hd * B * cfg.n_heads * (Sq * (Sq + 1) // 2)
    assert rec["flash_flops"] == L * flash
    assert rec["flops"] == L * (per_layer + flash) + 2 * B * Dm * V
    jp = jax.eval_shape(functools.partial(JM.init_params, jcfg), jax.random.PRNGKey(0))
    from repro.train.step import make_prefill_step as jax_prefill_step
    ma = jax.jit(jax_prefill_step(jcfg)).lower(
        jp, {"tokens": jax.ShapeDtypeStruct((B, Sq), jnp.int32)}).compile().memory_analysis()
    assert rank0_bytes(params) + rank0_bytes(batch) == ma.argument_size_in_bytes
    leaves = 1 + len(cache)
    assert rank0_bytes(logits) + rank0_bytes(cache) + 8 * leaves == ma.output_size_in_bytes


@pytest.mark.parametrize("arch,shape", [("xlstm-350m", (2, 8)), ("zamba2-1.2b", (2, 4))],
                         ids=["xlstm-2x8", "zamba2-2x4"])
def test_ssm_step_count_gathers_no_whole_weight(arch, shape, monkeypatch):
    """A ``reduced()`` training step counted on meta with the Mamba-2 /
    xLSTM blocks split by head: xlstm's 4 mLSTM heads over 8 model ranks
    (4 of them own none), zamba2 on 4 (its 4 attention q heads do not split
    over 8). No tensor a collective over ``model`` delivers
    (``all_gather_dim``, ``tensor_parallel.take``, ``ShardCtx.full``) is a
    whole split weight of those blocks (ZeRO-1's all-gathers over the data
    axis return the model blocks of the updated parameters); pieces of
    columns move (collective-permutes are logged) and the counted FLOPs are
    rank 0's: the model ranks that share the meta device run one batched
    scan (``tensor_parallel.grouped``), and the count equals each rank's
    scan run alone."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.train.optimizer import zero1_shardings
    from repro_torch.train.step import make_sharded_train_step, sharded_adamw_init
    cfg = get_arch(arch).reduced()
    _, mesh = _meta_mesh(shape, ("data", "model"))
    seen = []

    def spy(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if fn is not gather or a[2] == "model":
                seen.extend(t for t in (out if isinstance(out, list) else [out]) if t is not None)
            return out
        return run
    gather = C.all_gather_dim
    monkeypatch.setattr(C, "all_gather_dim", spy(gather))
    monkeypatch.setattr(TP, "take", spy(TP.take))
    full = TP.ShardCtx.full
    monkeypatch.setattr(TP.ShardCtx, "full", lambda self, leaf, d: spy(full)(self, leaf, d))
    params_abs = D.abstract_params(cfg)
    p_sh = param_shardings(params_abs, mesh)

    def count():
        params = shard_tree(params_abs, p_sh)
        opt = sharded_adamw_init(params, zero1_shardings(p_sh, params_abs, mesh))
        batch = {"tokens": torch.empty((4, 64), dtype=torch.int32, device="meta")}
        return D.count_step(make_sharded_train_step(cfg), (params, opt, batch), mesh,
                            grad=True)[1]
    rec = count()
    batched = TP.grouped
    monkeypatch.setattr(TP, "grouped", lambda ctx, args, *rest: {
        k: batched(ctx, {k: a}, *rest)[k] for k, a in args.items()})
    assert count()["flops"] == rec["flops"]
    split = ("in_proj", "out_proj", "up_proj", "q", "k", "v", "down_proj", "w_in")
    whole = {tuple(t.shape[-2:]) for path, t in M._leaves(params_abs)
             if path[-1] in split and path[0] != "shared_attn"}
    assert not {tuple(t.shape[-2:]) for t in seen if t.ndim >= 2} & whole
    assert mesh.log["collective-permute"][0] > 0
    assert rec["flops"] > 0 and rec["ops"] > 0


def test_scan_sweep_equals_reference_but_for_the_capacity(monkeypatch):
    monkeypatch.setattr(RL, "HW", dict(JRL.HW))
    ns = (2048, 8192, 32768, 65536)
    got, want = RL.streaming_vs_twopass(ns=ns), JRL.streaming_vs_twopass(ns=ns)
    for g, w in zip(got["sweep"], want["sweep"]):
        assert {k: v for k, v in g.items() if k != "exceeds_vmem"} == \
            {k: v for k, v in w.items() if k != "exceeds_vmem"}
        assert g["exceeds_vmem"] == (g["score_block_bytes"] > RL.L2_BYTES)
    assert got["vmem_bytes"] == RL.L2_BYTES == 50 * 2 ** 20
    # the reference's largest table exceeds its VMEM but fits the L2: the
    # port's default sweep goes on until it does not
    assert want["acceptance"]["ok"] and not got["acceptance"]["largest_n_exceeds_vmem"]
    full = RL.streaming_vs_twopass()
    assert full["acceptance"]["ok"] and full["sweep"][-1]["exceeds_vmem"]
    assert [r["n"] for r in full["sweep"]][:4] == list(ns)


def test_scan_sweep_measures_the_plain_versions_on_the_cpu():
    out = RL.streaming_vs_twopass(ns=(2048, 8192), B=8, d=32, k=4, measure=True,
                                  measure_n_cap=1024, device="cpu")
    for row in out["sweep"]:
        m = row["measured"]
        assert m["n_measured"] == 1024 and m["device"] == "cpu"
        assert m["streaming_ms"] > 0 and m["twopass_ms"] > 0


def test_one_cell_on_meta_and_the_report(tmp_path):
    import time
    t0 = time.time()
    rec = D.run_cell("granite-moe-1b-a400m", "decode_32k", False)
    assert time.time() - t0 < 120
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("n_params", "n_active_params", "memory", "cost", "collectives", "roofline",
                "lower_s", "count_s"):
        assert key in rec, key
    cfg, shape = get_arch("granite-moe-1b-a400m"), SHAPES["decode_32k"]
    rows, keys = shape.global_batch // 16, shape.seq_len // 16  # batch / data, seq / model
    assert rec["cost"]["flash_flops"] == cfg.n_layers * 4 * cfg.hd * rows * cfg.n_heads * keys
    assert rec["memory"]["alias_size_in_bytes"] > 0 and rec["collectives"]["total_bytes"] > 0
    assert rec["roofline"]["flops"] == rec["cost"]["flops"]
    skipped = D.run_cell("granite-moe-1b-a400m", "long_500k", False)
    path = tmp_path / "torch_dryrun.json"
    path.write_text(json.dumps([rec, skipped]))
    recs = R.load_and_annotate(str(path))
    table = R.dryrun_table(recs)
    assert "granite-moe-1b-a400m | decode_32k | 16x16 | ok" in table
    assert "long_500k | 16x16 | skipped" in table
    assert "granite-moe-1b-a400m | decode_32k |" in R.roofline_table(recs)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_uneven_q_heads_cell_counts_rank_zeros_two_heads(kind, monkeypatch):
    """qwen2-7b's head layout (28 q / 4 kv heads; ``reduced()``'s d_model
    and head_dim) on a meta (1, 16) mesh, the production mesh's 16 model
    ranks, which the port used to record as ``error``: the cell is ``ok``,
    and rank 0's flash FLOPs are the closed form of its ``head_range``, 2
    heads (forward 4 x d a kept pair, backward 10 x d); a decode's, every
    q head (gathered) over rank 0's 1/16 of the cache."""
    from repro_torch.configs.base import ShapeSpec
    cfg = dataclasses.replace(get_arch("qwen2-7b").reduced(), n_heads=28, n_kv_heads=4)
    B, Sq = 2, 256
    shape = ShapeSpec(f"{kind}_uneven", kind, Sq, B)
    monkeypatch.setattr(D, "get_arch", lambda name: cfg)
    monkeypatch.setitem(D.SHAPES, shape.name, shape)
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod, device: make_debug_mesh(1, 16, device=device))
    rec = D.run_cell("qwen2-7b", shape.name, False)
    assert rec["status"] == "ok" and rec["chips"] == 16
    assert TP.head_range(28, 16, 0) == (0, 2)
    pairs, hd, L = Sq * (Sq + 1) // 2, cfg.hd, cfg.n_layers
    want = {"train": L * (4 + 10) * hd * B * 2 * pairs,
            "prefill": L * 4 * hd * B * 2 * pairs,
            "decode": L * 4 * hd * B * cfg.n_heads * (Sq // 16)}[kind]
    assert rec["cost"]["flash_flops"] == want
    assert rec["collectives"]["total_bytes"] > 0
