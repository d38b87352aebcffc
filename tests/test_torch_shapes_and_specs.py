"""Port parity of the shape specs and the analytic report, over the 10 x 4
grid of (arch, shape), mirroring tests/test_shapes_and_specs.py: the input
specs (meta tensors here, ShapeDtypeStructs there) and the int8 cache specs
leaf for leaf against the reference's, ``launch.report.analytic_cell`` with
the reference's ``HW`` monkeypatched in field by field against the
reference's, the geometry counts, and the tables read from a dry-run record
file. The port's own ``HW`` holds the card's data-sheet rates."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import input_specs as jax_input_specs
from repro.launch import report as JR
from repro.launch import roofline as JRL
from repro_torch.configs.base import SHAPES, get_arch, input_specs, list_archs
from repro_torch.distributed.sharding import _path_str, leaves_with_path
from repro_torch.launch import report as R
from repro_torch.launch import roofline as RL

GRID = [(a, s) for a in list_archs() for s in SHAPES]
JAX_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.int8): torch.int8,
              jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


def _same_specs(got: dict, want: dict):
    from repro.distributed.sharding import _path_str as jpath
    w = [(jpath(p), tuple(x.shape), JAX_DTYPES[jnp.dtype(x.dtype)])
         for p, x in jax.tree_util.tree_leaves_with_path(want)]
    g = [(_path_str(p), tuple(x.shape), x.dtype) for p, x in leaves_with_path(got)]
    assert g == w
    assert all(x.device.type == "meta" for _, x in leaves_with_path(got))


@pytest.mark.parametrize("arch,shape", GRID)
def test_input_specs_shapes(arch, shape):
    cfg = get_arch(arch)
    if not cfg.supports(shape):
        assert cfg.skip_reason(shape)
        return
    sp = SHAPES[shape]
    specs = input_specs(cfg, sp)
    _same_specs(specs, jax_input_specs(jax_get_arch(arch), JSHAPES[shape]))
    if sp.kind in ("train", "prefill"):
        toks = specs["tokens"]
        assert toks.dtype == torch.int32 and toks.shape[0] == sp.global_batch
        if cfg.family == "vlm":
            assert toks.shape[1] + cfg.n_vision_tokens == sp.seq_len
            assert specs["vision_embeds"].shape == (sp.global_batch, cfg.n_vision_tokens,
                                                    cfg.d_model)
        else:
            assert toks.shape[1] == sp.seq_len
        if cfg.family == "encdec":
            assert specs["frames"].shape == (sp.global_batch, sp.seq_len, cfg.d_model)
    else:
        assert specs["tokens"].shape == (sp.global_batch, 1)
        cache = specs["cache"]
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            assert cache["k"].shape[2] == sp.seq_len
            assert cache["k"].shape[1] == sp.global_batch


@pytest.mark.parametrize("arch,shape", GRID)
def test_int8_cache_specs(arch, shape):
    cfg = get_arch(arch)
    sp = SHAPES[shape]
    if sp.kind != "decode" or not cfg.supports(shape):
        return
    specs = input_specs(cfg, sp, kv_dtype="int8")
    _same_specs(specs, jax_input_specs(jax_get_arch(arch), JSHAPES[shape], kv_dtype="int8"))
    cache = specs["cache"]
    if cfg.family in ("dense", "moe", "vlm"):
        assert cache["k"].dtype == torch.int8
        assert cache["k_scale"].shape == cache["k"].shape[:-1]


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_roofline_sane(arch, monkeypatch):
    """With the reference's HW in both: every number and the dominant term
    equal the reference's; the hint names the card's tensor cores where the
    reference's names the TPU's MXU."""
    monkeypatch.setattr(R, "HW", dict(JRL.HW))
    cfg = get_arch(arch)
    for shape in SHAPES:
        if not cfg.supports(shape):
            continue
        for mesh in ("16x16", "2x16x16"):
            a = R.analytic_cell(arch, shape, mesh, n_params=10 ** 9, n_active=8 * 10 ** 8)
            want = JR.analytic_cell(arch, shape, mesh, n_params=10 ** 9, n_active=8 * 10 ** 8)
            assert set(a) == set(want)
            for key, value in want.items():
                if key != "hint":
                    assert a[key] == value, (shape, mesh, key)
            assert a["t_compute_s"] >= 0 and a["t_memory_s"] > 0
            assert 0 < a["roofline_fraction"] <= 1.0 + 1e-9
            assert a["dominant"] in ("compute", "memory", "collective")
            assert 0 < a["useful_flops_ratio"] <= 1.0 + 1e-9


def test_geometry_counts():
    assert R.geometry(get_arch("yi-9b"))["L_attn"] == 48
    assert R.geometry(get_arch("zamba2-1.2b"))["L_attn"] == 6  # shared blocks
    assert R.geometry(get_arch("xlstm-350m"))["L_attn"] == 0
    g = R.geometry(get_arch("gemma2-27b"))
    assert g["L_win"] == 23 and g["L_full"] == 23
    assert R.geometry(get_arch("whisper-medium"))["L_attn"] == 24 + 48
    for arch in list_archs():
        assert R.geometry(get_arch(arch)) == JR.geometry(jax_get_arch(arch))


def test_hw_is_the_cards_data_sheet():
    assert RL.HW["name"] == "NVIDIA H100 80GB HBM3"
    assert (RL.HW["peak_flops"], RL.HW["hbm_bw"], RL.HW["link_bw"]) == (989e12, 3.35e12, 450e9)
    a = R.analytic_cell("qwen2-7b", "train_4k", "16x16", 7 * 10 ** 9, 7 * 10 ** 9)
    assert a["t_memory_s"] == a["an_hbm_per_chip"] / 3.35e12


def _records():
    def colls(n):
        return {"by_kind": {k: {"count": n + i, "bytes": 1000 * (n + i)} for i, k in enumerate(
            ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"))}}
    recs = []
    for i, (arch, shape) in enumerate([("qwen2-7b", "train_4k"), ("granite-moe-1b-a400m",
                                                                  "decode_32k"),
                                       ("xlstm-350m", "long_500k"), ("yi-9b", "long_500k")]):
        for mesh in ("16x16", "2x16x16"):
            if arch == "yi-9b":
                recs.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                             "reason": "full quadratic attention — long_500k skipped per spec"})
                continue
            recs.append({"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                         "n_params": 10 ** 9 + i, "n_active_params": 5 * 10 ** 8 + i,
                         "compile_s": 12.0 + i, "collectives": colls(i),
                         "memory": {"total_device_bytes": (i + 1) * 2 ** 30}})
    return recs


def test_tables_read_a_dry_run_record_file(tmp_path, monkeypatch, capsys):
    """load_and_annotate / dryrun_table / roofline_table / main on a
    synthetic record file: the reference's rows (its HW in both), but for
    the hint column and the header's word for the collectives."""
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_records()))
    monkeypatch.setattr(R, "HW", dict(JRL.HW))
    got, want = R.load_and_annotate(str(path)), JR.load_and_annotate(str(path))
    for g, w in zip(got, want):
        assert {k: v for k, v in g.get("analytic", {}).items() if k != "hint"} == \
            {k: v for k, v in w.get("analytic", {}).items() if k != "hint"}
    assert R.dryrun_table(got).splitlines()[2:] == JR.dryrun_table(want).splitlines()[2:]
    for mesh in ("16x16", "2x16x16"):
        rows = [r.split("|")[1:-2] for r in R.roofline_table(got, mesh).splitlines()[2:]]
        wrows = [r.split("|")[1:-2] for r in JR.roofline_table(want, mesh).splitlines()[2:]]
        assert rows == wrows and len(rows) == 3
    assert [R.fmt_seconds(x) for x in (2.5, 0.0123, 4e-5)] == \
        [JR.fmt_seconds(x) for x in (2.5, 0.0123, 4e-5)]
    R.main(["--in", str(path)])
    out = capsys.readouterr().out
    assert "## Dry-run" in out and "qwen2-7b | train_4k | 16x16 | ok" in out
    assert np.isfinite(got[0]["analytic"]["bound_s"])
