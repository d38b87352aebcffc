"""Port parity of distributed serving (the tournament search step, the
distributed rerank, the column store and the batch engine under a mesh, the
search dry-run's accounting) against the JAX package.

The reference runs once, in a subprocess with 8 host devices (the pattern of
tests/test_distributed.py: the main test process keeps one JAX device), on
``make_debug_mesh(4, 2)``, and writes its results to an ``.npz``. The port
runs the same seeded inputs in process on ``make_debug_mesh(4, 2,
device="cpu")``: one CPU device repeated over the grid, every shard running
the per-shard code a mesh of cards runs.

Tolerances: ids are held equal (both sides return the canonical order,
score descending, then id ascending); scores within rtol = atol = 1e-5
(the reference scores with XLA's dot, the port with the scan's plain
version); dispatch counters, numDist, costs, recall, residency bytes, plan
group statistics and collective bytes exactly equal.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.types import IndexSpec, Query, QueryPlan
from repro_torch.data.vectors import MultiVectorDatabase, make_database, make_queries
from repro_torch.distributed import row_sharding, shard_act, use_mesh
from repro_torch.distributed.sharding import current_mesh
from repro_torch.filter import Range
from repro_torch.filter.attributes import synth_attributes
from repro_torch.index.registry import IndexStore
from repro_torch.ingest import DeleteBatch, InsertBatch, MutableTable, MutationView
from repro_torch.launch import search_dryrun
from repro_torch.launch.mesh import (Mesh, make_debug_mesh, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.launch.roofline import collective_bytes
from repro_torch.search.distributed import distributed_rerank, make_search_step
from repro_torch.serve.columnstore import ColumnStore, padded_device_bytes
from repro_torch.serve.engine import BatchEngine

ROOT = Path(__file__).resolve().parents[1]
K = 10
N_ROWS = 500
COLS = [("a", 24), ("b", 32)]
VIDS = [(0, 1), (0,), (1,), (0, 1)]
SPECS_VIDS = ((0,), (1,), (0, 1))
PRED = (0.2, 0.5)                # Range("score", lo, hi): ~30% of the rows kept
CHURN = (40, 60)                 # inserted, deleted
STEP_CASES = {                   # name -> (valid_n, masked)
    "plain": (None, False),
    "valid_n": (500, False),
    "masked": (500, True),
    "all_padding_shard": (200, False),   # shards 2 and 3 hold padding only
    "fewer_live_than_k": (6, True),
}
ENGINE_CASES = ("one_group", "flat", "ivf", "masked", "mutated", "masked_mutated",
                "ivf_mutated")
RESIDENCY_CASES = [(500, 4, 128), (1000, 8, 128), (333, 8, 100), (77, 4, 128)]

# the inputs both sides build: the same numpy draws, each package's own API
# (their source is also pasted into the reference's script)


def step_inputs():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((512, 32)).astype(np.float32)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    bad = rng.random(512) < 0.3
    cand = np.sort(rng.choice(512, 64, replace=False))
    return db, q, bad, cand


def plans(q, kind, ek, QP, Spec, filtered=False):
    """Flat fallback, single exact index, the per-column union (rerank);
    filtered: masked / post, and the pre-filter gather."""
    def kw(access):
        return dict(access_path=access, selectivity=0.3) if filtered else {}
    out = [QP(q.qid, [], [], 1.0, 1.0, **kw("masked")),
           QP(q.qid, [Spec(q.vid, kind)], [ek], 1.0, 1.0, **kw("post"))]
    if len(q.vid) > 1:
        out.append(QP(q.qid, [Spec((c,), kind) for c in q.vid], [ek] * len(q.vid),
                      1.0, 1.0, **kw("post")))
    if filtered:
        out.append(QP(q.qid, [], [], 1.0, 1.0, **kw("pre")))
    return out


def churn(table, attrs, make_database, InsertBatch, DeleteBatch):
    fresh = make_database(CHURN[0], COLS, seed=77)
    _, ids = table.apply(InsertBatch(fresh.columns))
    rng = np.random.default_rng(78)
    if attrs is not None:
        attrs.put(ids, {"score": rng.random(CHURN[0]).astype(np.float32),
                        "category": [f"cat{i % 5}" for i in range(CHURN[0])]})
    table.apply(DeleteBatch(rng.choice(table.live_ids(), size=CHURN[1], replace=False)))


INPUTS = "\n\n".join(inspect.getsource(f) for f in (step_inputs, plans, churn))

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    from dataclasses import replace
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core.types import IndexSpec, Query, QueryPlan
    from repro.data.vectors import MultiVectorDatabase, make_database, make_queries
    from repro.filter import Range
    from repro.filter.attributes import synth_attributes
    from repro.index.registry import IndexStore
    from repro.ingest import DeleteBatch, InsertBatch, MutableTable, MutationView
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.roofline import collective_bytes
    from repro.search.distributed import distributed_rerank, make_search_step
    from repro.serve.columnstore import ColumnStore, padded_device_bytes
    from repro.serve.engine import BatchEngine
    import repro.search.distributed as dist

    # the engine calls its cached step eagerly, and an eager shard_map traces
    # and compiles again on every call (minutes over this grid); the same
    # step jitted computes the same values and compiles once per shape
    _make_search_step = dist.make_search_step
    dist.make_search_step = lambda *a, **kw: jax.jit(_make_search_step(*a, **kw))
""") + "\n".join(f"{name} = {value!r}" for name, value in [
    ("K", K), ("N_ROWS", N_ROWS), ("COLS", COLS), ("VIDS", VIDS), ("SPECS_VIDS", SPECS_VIDS),
    ("PRED", PRED), ("CHURN", CHURN), ("STEP_CASES", STEP_CASES),
    ("ENGINE_CASES", ENGINE_CASES), ("RESIDENCY_CASES", RESIDENCY_CASES)]) + \
    "\n" + INPUTS + textwrap.dedent("""
    mesh = make_debug_mesh(4, 2)
    rows = NamedSharding(mesh, P("data", None))
    arrays, meta = {}, {"steps": {}, "engine": {}, "residency": {}, "collectives": {}}

    db, q, bad, cand = step_inputs()
    db_j, q_j = jax.device_put(jnp.asarray(db), rows), jnp.asarray(q)
    bad_j = jax.device_put(jnp.asarray(bad.astype(np.float32)), NamedSharding(mesh, P("data")))
    for name, (valid_n, masked) in STEP_CASES.items():
        step = make_search_step(mesh, K, valid_n=valid_n, masked=masked)
        args = (db_j, q_j, bad_j) if masked else (db_j, q_j)
        v, i = jax.jit(step)(*args)
        arrays[f"step_{name}_vals"], arrays[f"step_{name}_ids"] = np.asarray(v), np.asarray(i)
        hlo = jax.jit(step).lower(*args).compile().as_text()
        meta["collectives"][f"step_{name}"] = collective_bytes(hlo)
    rr = lambda d, c, qq: distributed_rerank(mesh, d, c, qq, 5)
    rv, ri = jax.jit(rr)(db_j, jnp.asarray(cand), q_j[0])
    arrays["rerank_vals"], arrays["rerank_ids"] = np.asarray(rv), np.asarray(ri)
    meta["collectives"]["rerank"] = collective_bytes(
        jax.jit(rr).lower(db_j, jnp.asarray(cand), q_j[0]).compile().as_text())
    from repro.launch.search_dryrun import make_naive_search_step, plan_group_stats
    meta["collectives"]["naive"] = collective_bytes(
        jax.jit(make_naive_search_step(mesh, K)).lower(db_j, q_j).compile().as_text())
    meta["plan_group_stats"] = {f"{n}_{k}": plan_group_stats(n, k)
                                for n, k in ((64, 10), (1024, 100))}

    for n_rows, n_data, block_rows in RESIDENCY_CASES:
        m = make_debug_mesh(n_data, 8 // n_data)
        rdb = make_database(n_rows, [("a", 24), ("b", 40)], seed=0)
        cs = ColumnStore(rdb, mesh=m, block_rows=block_rows)
        meta["residency"][f"{n_rows}_{n_data}_{block_rows}"] = dict(
            before=cs.device_bytes((0, 1)), after=cs.device((0, 1)).device_bytes,
            single=cs.device((0,)).device_bytes, total=cs.total_device_bytes(),
            formula=padded_device_bytes(n_rows, 64, block_rows=block_rows, row_mult=n_data))

    mdb = make_database(N_ROWS, COLS, seed=0)
    qs = make_queries(mdb, VIDS, k=K, seed=13)
    # make_debug_mesh's axes are Explicit under this JAX, and the engine's
    # whole-row reads (rerank, IVF probe, pre-filter gathers) then raise
    # (ROADMAP.md, Queue 3); the engine runs on the same grid with Auto
    # axes, the GSPMD mode its gathers were written for
    try:
        union = [IndexSpec((0,), "flat"), IndexSpec((1,), "flat")]
        BatchEngine(mdb, mesh=mesh).execute_batch(
            [(qs[0], QueryPlan(qs[0].qid, union, [40, 40], 1.0, 1.0))])
        meta["debug_mesh_rerank"] = "served"
    except Exception as exc:
        meta["debug_mesh_rerank"] = type(exc).__name__
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ivf_store = IndexStore(mdb, seed=0)
    for v in SPECS_VIDS:
        idx = ivf_store.get(IndexSpec(v, "ivf"))
        name = "_".join(map(str, v))
        arrays[f"ivf_{name}_centroids"] = np.asarray(idx.centroids)
        arrays[f"ivf_{name}_row_ids"] = np.asarray(idx.row_ids)
        arrays[f"ivf_{name}_offsets"] = np.asarray(idx.offsets)
        meta[f"ivf_{name}_n_lists"] = int(idx.n_lists)
    for case in ENGINE_CASES:
        if case == "one_group":  # tests/test_distributed.py's serving check
            two = MultiVectorDatabase([np.ascontiguousarray(db[:, :16]),
                                       np.ascontiguousarray(db[:, 16:])], ["a", "b"])
            eng = BatchEngine(two, store=None, mesh=mesh, axis="data")
            one = [Query(qid=i, vid=(0, 1), vectors={0: q[i, :16], 1: q[i, 16:]}, k=K)
                   for i in range(3)]
            pairs = [(qq, QueryPlan(qq.qid, [], [], 0.0, 1.0)) for qq in one]
        else:
            kind = "ivf" if case.startswith("ivf") else "flat"
            eng = BatchEngine(mdb, store=ivf_store if kind == "ivf" else None, mesh=mesh)
            attrs = None
            if "masked" in case:
                attrs = synth_attributes(N_ROWS, seed=3)
                eng.attach_filters(attrs)
            n_live = N_ROWS
            if "mutated" in case:
                table = MutableTable(mdb)
                churn(table, attrs, make_database, InsertBatch, DeleteBatch)
                eng.attach_mutations(MutationView(table))
                n_live = table.n_live
            ek = 40 if kind == "flat" else n_live
            filtered = "masked" in case
            pairs = []
            for qq in qs:
                if filtered:
                    qq = replace(qq, predicate=Range("score", lo=PRED[0], hi=PRED[1]))
                pairs += [(qq, p) for p in plans(qq, kind, ek, QueryPlan, IndexSpec, filtered)]
        ms = eng.execute_batch(pairs)
        meta["engine"][case] = dict(
            metrics=[dict(ids=np.asarray(m.ids).tolist(), cost=m.cost, num_dist=m.num_dist,
                          recall=m.recall, eks=m.eks) for m in ms],
            counters=eng.counters.as_dict())
    np.savez(sys.argv[1], meta=np.array(json.dumps(meta)), **arrays)
    """)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = np.load(out)
    return {**{k: data[k] for k in data.files if k != "meta"},
            "meta": json.loads(str(data["meta"]))}



@pytest.fixture
def mesh():
    return make_debug_mesh(4, 2, device="cpu")


def _port_step(mesh, name):
    db, q, bad, _ = step_inputs()
    valid_n, masked = STEP_CASES[name]
    step = make_search_step(mesh, K, valid_n=valid_n, masked=masked)
    shards = row_sharding(mesh).shard(torch.as_tensor(db))
    args = (shards, torch.as_tensor(q)) + ((torch.as_tensor(bad),) if masked else ())
    return step(*args)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_search_step_equals_reference(ref, mesh, name):
    vals, ids = _port_step(mesh, name)
    np.testing.assert_array_equal(ids.numpy(), ref[f"step_{name}_ids"])
    np.testing.assert_allclose(vals.numpy(), ref[f"step_{name}_vals"], rtol=1e-5, atol=1e-5)
    got = collective_bytes(mesh.log)
    want = ref["meta"]["collectives"][f"step_{name}"]
    # the merge all-gathers the values and the ids: two ops on both sides
    assert got == want, (got, want)


def test_reference_debug_mesh_engine_raises_on_a_rerank_the_port_serves(ref, mesh):
    """ROADMAP.md, Queue 3: under the installed JAX the reference's
    ``make_debug_mesh`` has Explicit axes, and its mesh engine's whole-row
    reads raise ``ShardingTypeError``; the port reads each row from its
    owning shard."""
    assert ref["meta"]["debug_mesh_rerank"] == "ShardingTypeError"
    mdb = make_database(N_ROWS, COLS, seed=0)
    q = make_queries(mdb, VIDS, k=K, seed=13)[0]
    union = [IndexSpec((0,), "flat"), IndexSpec((1,), "flat")]
    ids = BatchEngine(mdb, mesh=mesh).search_batch(
        [(q, QueryPlan(q.qid, union, [40, 40], 1.0, 1.0))])[0]
    single = BatchEngine(mdb, device="cpu").search_batch(
        [(q, QueryPlan(q.qid, union, [40, 40], 1.0, 1.0))])[0]
    np.testing.assert_array_equal(ids, single)


def test_search_step_masks_empty_slots_to_id_zero(mesh):
    vals, ids = _port_step(mesh, "fewer_live_than_k")
    empty = vals.numpy() <= -1e38
    assert empty.any() and not ids.numpy()[empty].any()
    vals, ids = _port_step(mesh, "all_padding_shard")
    assert (ids.numpy() < 200).all()


def test_distributed_rerank_equals_reference(ref, mesh):
    db, q, _, cand = step_inputs()
    shards = row_sharding(mesh).shard(torch.as_tensor(db))
    vals, ids = distributed_rerank(mesh, shards, torch.as_tensor(cand), torch.as_tensor(q[0]), 5)
    np.testing.assert_array_equal(ids.numpy(), ref["rerank_ids"])
    np.testing.assert_allclose(vals.numpy(), ref["rerank_vals"], rtol=1e-5, atol=1e-5)
    got, want = collective_bytes(mesh.log), ref["meta"]["collectives"]["rerank"]
    assert got["total_bytes"] == want["total_bytes"] == 64 * 4
    assert got["by_kind"]["all-reduce"] == want["by_kind"]["all-reduce"]


def test_naive_step_collective_bytes_equal_reference(ref, mesh):
    db, q, _, _ = step_inputs()
    step = search_dryrun.make_naive_search_step(mesh, K)
    vals, ids = step(row_sharding(mesh).shard(torch.as_tensor(db)), torch.as_tensor(q))
    assert collective_bytes(mesh.log) == ref["meta"]["collectives"]["naive"]
    full = q @ db.T
    np.testing.assert_array_equal(ids.numpy(), np.argsort(-full, axis=1, kind="stable")[:, :K])


def _carried_ivf(db, ref):
    store = IndexStore(db, seed=0, device="cpu")
    for v in SPECS_VIDS:
        name = "_".join(map(str, v))
        store._cache[IndexSpec(v, "ivf")] = convert.ivf_from_arrays(
            db.concat(v), ref[f"ivf_{name}_centroids"], ref[f"ivf_{name}_row_ids"],
            ref[f"ivf_{name}_offsets"], ref["meta"][f"ivf_{name}_n_lists"], device="cpu")
    return store


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_mesh_engine_equals_reference(ref, mesh, case):
    if case == "one_group":
        db, q, _, _ = step_inputs()
        two = MultiVectorDatabase([np.ascontiguousarray(db[:, :16]),
                                   np.ascontiguousarray(db[:, 16:])], ["a", "b"])
        eng = BatchEngine(two, store=None, mesh=mesh, axis="data")
        one = [Query(qid=i, vid=(0, 1), vectors={0: q[i, :16], 1: q[i, 16:]}, k=K)
               for i in range(3)]
        pairs = [(qq, QueryPlan(qq.qid, [], [], 0.0, 1.0)) for qq in one]
    else:
        mdb = make_database(N_ROWS, COLS, seed=0)
        kind = "ivf" if case.startswith("ivf") else "flat"
        eng = BatchEngine(mdb, store=_carried_ivf(mdb, ref) if kind == "ivf" else None,
                          mesh=mesh)
        attrs = None
        if "masked" in case:
            attrs = synth_attributes(N_ROWS, seed=3, device="cpu")
            eng.attach_filters(attrs)
        n_live = N_ROWS
        if "mutated" in case:
            table = MutableTable(mdb)
            churn(table, attrs, make_database, InsertBatch, DeleteBatch)
            eng.attach_mutations(MutationView(table, device="cpu"))
            n_live = table.n_live
        ek = 40 if kind == "flat" else n_live
        filtered = "masked" in case
        pairs = []
        for qq in make_queries(mdb, VIDS, k=K, seed=13):
            if filtered:
                qq = replace(qq, predicate=Range("score", lo=PRED[0], hi=PRED[1]))
            pairs += [(qq, p) for p in plans(qq, kind, ek, QueryPlan, IndexSpec, filtered)]
    want = ref["meta"]["engine"][case]
    got = eng.execute_batch(pairs)
    for (qq, p), m, jm in zip(pairs, got, want["metrics"]):
        what = f"{case}: q{qq.qid} {p.describe()}"
        np.testing.assert_array_equal(m.ids, jm["ids"], err_msg=what)
        assert (m.cost, m.num_dist, m.recall, m.eks) == (
            jm["cost"], jm["num_dist"], jm["recall"], jm["eks"]), what
    assert eng.counters.as_dict() == want["counters"]
    if case == "one_group":  # one group, one dispatch over four shards
        assert eng.counters.scan == 1
    if "mutated" in case and kind == "flat":  # base + delta: two dispatches
        assert eng.counters.delta > 0


@pytest.mark.parametrize("n_rows,n_data,block_rows", RESIDENCY_CASES)
def test_columnstore_residency_equals_reference(ref, n_rows, n_data, block_rows):
    m = make_debug_mesh(n_data, 8 // n_data, device="cpu")
    cs = ColumnStore(make_database(n_rows, [("a", 24), ("b", 40)], seed=0), mesh=m,
                     block_rows=block_rows)
    before = cs.device_bytes((0, 1))
    col = cs.device((0, 1))
    got = dict(before=before, after=col.device_bytes, single=cs.device((0,)).device_bytes,
               total=cs.total_device_bytes(),
               formula=padded_device_bytes(n_rows, 64, block_rows=block_rows,
                                           row_mult=n_data))
    assert got == ref["meta"]["residency"][f"{n_rows}_{n_data}_{block_rows}"]
    # the shards partition one padded tensor: views, no extra bytes
    assert col.data is None and len(col.shards) == n_data
    base = col.shards[0].untyped_storage().data_ptr()
    assert all(s.untyped_storage().data_ptr() == base for s in col.shards)
    assert col.shards[0].untyped_storage().nbytes() == col.device_bytes


@pytest.mark.parametrize("n,k", [(64, 10), (1024, 100)])
def test_plan_group_stats_equal_reference(ref, n, k):
    assert search_dryrun.plan_group_stats(n, k) == ref["meta"]["plan_group_stats"][f"{n}_{k}"]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_search_dryrun_counts_the_tournament(tmp_path, device):
    """Shapes only on meta; on the CPU the steps run on seeded data over a
    16 x 16 grid of the one CPU device. The counts are the same."""
    out = tmp_path / "dry.json"
    search_dryrun.main(["--rows", "65536", "--dim", "128", "--queries", "64", "--k", "10",
                        "--device", device, "--out", str(out)])
    recs = {r["variant"]: r for r in json.loads(out.read_text())}
    S, Q, k, n_local = 16, 64, 10, 65536 // 16
    naive = recs["naive_gather_scores"]["collectives"]
    tour = recs["tournament_topk"]["collectives"]
    assert naive["total_bytes"] == S * Q * n_local * 4
    assert tour["total_bytes"] == 2 * S * Q * k * 4      # values and ids
    assert recs["columnstore_tournament"]["collectives"] == tour
    assert recs["tournament_topk"]["naive_over_tournament_bytes"] == n_local / (2 * k)
    assert recs["tournament_topk"]["cost"]["flops"] == 2.0 * Q * 65536 * 128
    assert recs["tournament_topk"]["padded_device_bytes"] == padded_device_bytes(
        65536, 128, row_mult=16)
    assert recs["plan_group_compiler"]["queries"] == Q


def test_search_dryrun_is_shapes_only_by_default():
    """The dry-run defaults to the meta mesh and takes no card: no host
    holds a production mesh's 256 cards in one process."""
    recs = search_dryrun.run(rows=64, dim=8, queries=2, k=2)
    assert {r["device"] for r in recs if "device" in r} == {"meta"}
    with pytest.raises(ValueError, match="meta"):
        search_dryrun.run(rows=64, dim=8, queries=2, k=2, device="cuda")


def test_meshes_and_their_devices():
    m = make_debug_mesh(4, 2, device="cpu")
    assert m.shape == {"data": 4, "model": 2} and mesh_chip_count(m) == 8
    assert m.devices.shape == (4, 2) and m.home == torch.device("cpu")
    p = make_production_mesh(device="meta")
    assert p.shape == {"data": 16, "model": 16} and mesh_chip_count(p) == 256
    pp = make_production_mesh(multi_pod=True, device="meta")
    assert pp.axis_names == ("pod", "data", "model") and mesh_chip_count(pp) == 512
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match="needs 256 cards"):
            make_production_mesh(device="cuda")


def test_shard_act_is_the_identity_outside_a_mesh_only(mesh):
    """Outside a mesh the identity; inside one a full tensor is placed by
    its layout's spec (batch over "data"), and with sequence parallelism
    ``btd`` becomes ``btd_sp`` (sequence over "model")."""
    from repro_torch.distributed.sharding import set_sequence_parallel
    x = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 4, 3)
    assert shard_act(x, "btd") is x and current_mesh() is None
    mesh = make_debug_mesh(2, 2, device="cpu")
    with use_mesh(mesh):
        assert current_mesh() is mesh
        placed = shard_act(x, "btd")
        assert tuple(placed.spec) == ("data", None, None)
        assert placed.grid[1, 0] is placed.grid[1, 1]  # replicated over model
        assert torch.equal(placed.grid[1, 0], x[2:]) and torch.equal(placed.gather(), x)
        set_sequence_parallel(True)
        try:
            sp = shard_act(x, "btd")
        finally:
            set_sequence_parallel(False)
        assert tuple(sp.spec) == ("data", "model", None)
        assert torch.equal(sp.grid[1, 1], x[2:, 2:]) and torch.equal(sp.gather(), x)
    assert current_mesh() is None


def test_row_sharding_pads_rows_that_do_not_divide(mesh):
    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    shards = row_sharding(mesh).shard(x)
    assert [tuple(s.shape) for s in shards] == [(3, 3)] * 4
    assert torch.equal(torch.cat(shards)[:10], x) and not torch.cat(shards)[10:].any()


def test_mesh_engine_equals_single_device_engine(mesh):
    """The one-device-mesh engine against the port's own single-device
    engine on the IVF + flat grid with churn: ids, numDist, costs equal;
    counters equal but for the separate delta dispatch."""
    mdb = make_database(N_ROWS, COLS, seed=0)
    store = IndexStore(mdb, seed=0, device="cpu")
    engines = [BatchEngine(mdb, store=store, mesh=mesh),
               BatchEngine(mdb, store=store, device="cpu")]
    table = MutableTable(mdb)
    churn(table, None, make_database, InsertBatch, DeleteBatch)
    view = MutationView(table, device="cpu")
    qs = make_queries(mdb, VIDS, k=K, seed=13)
    pairs = [(q, p) for q in qs for kind, ek in (("flat", 40), ("ivf", 200))
             for p in plans(q, kind, ek, QueryPlan, IndexSpec)]
    for mutated in (False, True):
        for e in engines:
            e.counters.reset()
            if mutated:
                e.attach_mutations(view)
        a, b = (e.execute_batch(pairs) for e in engines)
        for m1, m2 in zip(a, b):
            np.testing.assert_array_equal(m1.ids, m2.ids)
            assert (m1.cost, m1.num_dist) == (m2.cost, m2.num_dist)
        ca, cb = engines[0].counters.as_dict(), engines[1].counters.as_dict()
        assert ca["scan"] == cb["scan"] and ca["rerank"] == cb["rerank"]
        assert ca["delta"] >= cb["delta"] and (ca["delta"] > cb["delta"]) == mutated


def test_mesh_cuts_a_delta_segment_once_a_version(mesh):
    """A delta segment is one single-device column: the mesh engine cuts it
    into row shards on first use and keeps them with the column, so later
    scans reuse them; a new table version brings a new column and a new
    cut."""
    mdb = make_database(N_ROWS, COLS, seed=0)
    eng = BatchEngine(mdb, mesh=mesh)
    table = MutableTable(mdb)
    churn(table, None, make_database, InsertBatch, DeleteBatch)
    view = MutationView(table, device="cpu")
    eng.attach_mutations(view)
    pairs = [(q, QueryPlan(q.qid, [], [], 1.0, 1.0))
             for q in make_queries(mdb, [(0,)] * 2, k=K, seed=13)]
    first = eng.search_batch(pairs)
    dcol = view.delta((0,)).col
    (shards,) = dcol._cuts.values()
    assert [tuple(x.shape) for x in shards] == [(dcol.padded_rows // 4, dcol.padded_dim)] * 4
    again = eng.search_batch(pairs)
    assert view.delta((0,)).col is dcol and dcol._cuts[row_sharding(mesh)] is shards
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    table.apply(InsertBatch(make_database(3, COLS, seed=79).columns))
    eng.search_batch(pairs)
    fresh = view.delta((0,)).col
    assert fresh is not dcol and len(fresh._cuts) == 1


def test_mesh_is_type_checked_and_a_store_keeps_its_mesh(mesh):
    db = make_database(64, [("a", 8)], seed=0)
    with pytest.raises(TypeError):
        ColumnStore(db, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        BatchEngine(db, cstore=ColumnStore(db, device="cpu"), mesh=mesh)
    eng = BatchEngine(db, mesh=mesh)
    assert isinstance(eng.mesh, Mesh) and eng.cstore.mesh is mesh
    assert eng.device == torch.device("cpu")
