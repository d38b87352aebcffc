"""Port parity of the model-sharding rules (``repro_torch.distributed.
sharding``, ``elastic``, ``train.optimizer.zero1_shardings``) against the
reference's, leaf for leaf, on all ten architectures x the meshes (16, 16),
(2, 16, 16), (4, 2) and (2, 4).

The reference side runs on ``jax.sharding.AbstractMesh``, which its
functions accept in one process (no devices), over ``jax.eval_shape`` of its
``init_params`` and its ``cache_specs``; the port's on a mesh of ``meta``
devices over ``init_params(device="meta")`` and ``cache_specs``. Specs are
compared as tuples. Also: the activation layouts, ``shard_act`` of the
per-rank form under sequence parallelism, uneven (zero-padded) blocks, and
the collectives' bytes in the reference's unit.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_arch as jax_get_arch
from repro.distributed import elastic as JE
from repro.distributed import sharding as JS
from repro.launch.roofline import collective_bytes as jax_collective_bytes
from repro.models import model as JM
from repro.train.optimizer import zero1_shardings as jax_zero1_shardings
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.elastic import check_mesh_fits, resize_data_parallel
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models import model as M
from repro_torch.train.optimizer import zero1_shardings

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
GRID = [(a, m) for a in list_archs() for m in MESHES]
CACHES = [(128, 32768), (1, 4096)]  # batch split over data / not divisible


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    cfg = jax_get_arch(name)
    return jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return M.init_params(get_arch(name), 0, device="meta")


def _meshes(key):
    shape, axes = MESHES[key]
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("meta")] * n
    return AbstractMesh(shape, axes), Mesh(axes, grid.reshape(shape))


def _jax_specs(tree):
    return [(JS._path_str(p), tuple(s.spec)) for p, s in jax.tree_util.tree_leaves_with_path(tree)]


def _port_specs(tree):
    return [(S._path_str(p), tuple(s.spec)) for p, s in S.leaves_with_path(tree)]


@pytest.mark.parametrize("arch,mesh_key", GRID)
def test_specs_equal_reference(arch, mesh_key):
    """param_spec / param_spec_fsdp (through param_shardings tp / fsdp),
    zero1_shardings of both, cache_shardings (shard_seq off / on, bf16 and
    int8 caches, batch divisible or not) and check_mesh_fits."""
    jmesh, mesh = _meshes(mesh_key)
    jp, p = _jax_params(arch), _port_params(arch)
    assert [JS._path_str(k) for k, _ in jax.tree_util.tree_leaves_with_path(jp)] == \
        [S._path_str(k) for k, _ in S.leaves_with_path(p)]
    for mode in ("tp", "fsdp"):
        jsh = JS.param_shardings(jp, jmesh, mode=mode)
        sh = S.param_shardings(p, mesh, mode=mode)
        assert _port_specs(sh) == _jax_specs(jsh), mode
        assert _port_specs(zero1_shardings(sh, p, mesh)) == \
            _jax_specs(jax_zero1_shardings(jsh, jp, jmesh)), mode
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for B, L in CACHES:
        for kv in (None, "int8"):
            jc = JM.cache_specs(jcfg, B, L, kv_dtype=kv)
            c = M.cache_specs(cfg, B, L, kv_dtype=kv)
            for seq in (False, True):
                assert _port_specs(S.cache_shardings(c, mesh, shard_seq=seq)) == \
                    _jax_specs(JS.cache_shardings(jc, jmesh, shard_seq=seq)), (B, L, kv, seq)
    assert check_mesh_fits(p, mesh) == JE.check_mesh_fits(jp, jmesh)


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m", "zamba2-1.2b",
                                  "xlstm-350m"])
def test_check_mesh_fits_lists_the_reference_problems(arch):
    """A (2, 3) mesh misfits the reduced widths: the same strings, in order."""
    jmesh = AbstractMesh((2, 3), ("data", "model"))
    jp = jax.eval_shape(lambda: JM.init_params(jax_get_arch(arch).reduced(),
                                               jax.random.PRNGKey(0)))
    p = M.init_params(get_arch(arch).reduced(), 0, device="meta")
    want = JE.check_mesh_fits(jp, jmesh)
    assert want and check_mesh_fits(p, make_debug_mesh(2, 3, device="cpu")) == want


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_activation_layouts_equal_reference(mesh_key):
    jmesh, mesh = _meshes(mesh_key)
    dp = JS._dp_axes(jmesh)
    assert S._dp_axes(mesh) == dp
    assert set(S.ACT_RULES) == set(JS.ACT_RULES)
    for name, rule in JS.ACT_RULES.items():
        assert tuple(S.ACT_RULES[name](dp)) == tuple(rule(dp)), name
    assert tuple(S.act_spec("btv", 3, mesh)) == tuple(JS.ACT_RULES["btv"](dp))
    assert tuple(S.act_spec("btd", 4, mesh)) == tuple(JS.ACT_RULES["btd"](dp)) + (None,)
    S.set_sequence_parallel(True)
    try:
        assert tuple(S.act_spec("btd", 3, mesh, seq_len=32)) == tuple(JS.ACT_RULES["btd_sp"](dp))
        assert tuple(S.act_spec("btd", 3, mesh, seq_len=33)) == tuple(JS.ACT_RULES["btd"](dp))
    finally:
        S.set_sequence_parallel(False)


def test_shard_act_lays_out_the_per_rank_form():
    """``btd`` of an ``Act``: cut into the model ranks' sequence blocks under
    sequence parallelism, joined again (one recorded all-gather) without."""
    mesh = make_debug_mesh(2, 2, device="cpu")
    x = [torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(d)) for d in range(2)]
    with S.use_mesh(mesh):
        S.set_sequence_parallel(True)
        try:
            sp = S.shard_act(S.Act(x), "btd")
        finally:
            S.set_sequence_parallel(False)
        assert all(isinstance(p, tuple) and len(p) == 2 for p in sp.parts)
        assert torch.equal(sp.parts[1][1], x[1][:, 4:])
        assert not mesh.log
        back = S.shard_act(sp, "btd")
        assert all(torch.equal(a, b) for a, b in zip(back.parts, x))
        assert mesh.log == {"all-gather": (1, 8 * 4 * 4)}  # data rank 0's op, logged once
        assert S.shard_act(back, "btv") is back


def test_uneven_dims_split_into_padded_blocks():
    """granite's vocab of 49,155 over 4 model ranks: blocks of 12,289 rows,
    the last padded with 1 zero row; gather crops it."""
    mesh = make_debug_mesh(2, 4, device="cpu")
    x = torch.randn(49155, 8)
    b = S.NamedSharding(mesh, S.P("model", None)).shard(x)
    assert b.grid[0, 3].shape == (12289, 8) and not b.grid[0, 3][-1].any()
    assert b.grid[0, 1] is b.grid[1, 1]
    assert torch.equal(b.grid[1, 2], x[2 * 12289:3 * 12289])
    assert torch.equal(b.gather(), x)
    two = S.NamedSharding(mesh, S.P(("data", "model"), None)).shard(torch.arange(10.0)[:, None])
    assert [float(two.grid[i, j][0, 0]) for i in range(2) for j in range(4)] == \
        [0.0, 2.0, 4.0, 6.0, 8.0, 0.0, 0.0, 0.0]  # ceil(10 / 8) = 2 rows a rank
    assert torch.equal(two.gather()[:, 0], torch.arange(10.0))


def test_collective_bytes_in_the_reference_unit():
    """Each collective logs its per-device RESULT bytes, which is what the
    reference's ``collective_bytes`` reads off an HLO op's result shape."""
    mesh = make_debug_mesh(1, 4, device="cpu")
    blocks = [torch.ones(2, 3) * r for r in range(4)]
    ag = C.all_gather_dim(blocks, mesh, "model", 1, torch.device("cpu"))
    ar = C.psum(blocks, mesh, "model", torch.device("cpu"))
    rs = C.reduce_scatter([torch.ones(8, 3)] * 4, mesh, "model", 0, [torch.device("cpu")] * 4)
    a2a = C.all_to_all([torch.ones(8, 2)] * 4, mesh, "model", 0, 1, [torch.device("cpu")] * 4)
    assert ag.shape == (2, 12) and float(ar[0, 0]) == 6.0
    assert [tuple(t.shape) for t in rs] == [(2, 3)] * 4 and float(rs[0][0, 0]) == 4.0
    assert [tuple(t.shape) for t in a2a] == [(2, 8)] * 4
    hlo = "\n".join([
        "  %ag = f32[2,12]{1,0} all-gather(f32[2,3]{1,0} %p), dimensions={1}",
        "  %ar = f32[2,3]{1,0} all-reduce(f32[2,3]{1,0} %p), to_apply=%add",
        "  %rs = f32[2,3]{1,0} reduce-scatter(f32[8,3]{1,0} %p), dimensions={0}",
        "  %aa = f32[2,8]{1,0} all-to-all(f32[8,2]{1,0} %p), dimensions={0}",
    ])
    assert collective_bytes(mesh.log) == jax_collective_bytes(hlo)


@pytest.mark.parametrize("old,new", [(4, 2), (2, 4), (3, 5), (8, 1)])
def test_resize_data_parallel_equals_reference(old, new):
    assert resize_data_parallel({}, old, new) == JE.resize_data_parallel({}, old, new)
