"""A configuration, a traffic mix and a per-layer metric are added as new
files plus manifest entries, in a copy of the benchmark, with no file that
is there edited; a run of the new cell reports the new metric."""
import json
import shutil
import time
from pathlib import Path

import torch

from mintbench import harness

ROOT = Path(__file__).resolve().parents[2]

CONFIG = {"name": "tiny3", "source": "a test deployment", "rows": 1500,
          "columns": [["a", 16], ["b", 24], ["c", 40]], "clusters": None,
          "spread": 0.8, "correlation": 0.7, "dtype": "float32", "index_kind": "ivf",
          "data_seed": 0,
          "theta_recall": 0.9, "theta_storage": 2, "storage_mode": "count",
          "min_sample_rows": 500, "tuner_seed": 0, "runtime": {}}
MIX = {"why": "a test mix", "loop": "closed", "clients": 16, "k": 20,
       "templates": {"n": 4, "p": 0.5, "prob_low": 0.5, "prob_high": 1.5, "seed": 1},
       "noise": 0.5, "block": 16, "stream": 1024, "warmup_rounds": 2,
       "runtime": {"max_batch": 16}}
METRIC = '''"""Queries answered per plan group (a test metric)."""
LAYER = "Compiler (serve/compiler.py)"
UNIT = "queries"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "qps"


def read(rec):
    return sum(g["batch"] for g in rec.groups) / len(rec.groups) if rec.groups else None
'''


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mintbench", tmp_path / "mintbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "mintbench").rglob("*") if p.is_file()}
    (tmp_path / "mintbench/configs/tiny3.json").write_text(json.dumps(CONFIG))
    (tmp_path / "mintbench/traffic/tiny-c16.json").write_text(json.dumps(MIX))
    (tmp_path / "mintbench/metrics/group_batch_mean.py").write_text(METRIC)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny3", "source": "a test deployment",
                           "file": "mintbench/configs/tiny3.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "tiny3.tiny-c16", "config": "tiny3",
                             "traffic": "tiny-c16", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "group_batch_mean", "unit": "queries",
                             "better": "higher", "source": "program_span",
                             "layer": "Compiler (serve/compiler.py)", "moves": "qps",
                             "workloads": ["tiny3.tiny-c16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    assert all(p.read_bytes() == b for p, b in before.items())

    cell = harness.load_cell(tmp_path, "tiny3.tiny-c16")
    assert "group_batch_mean" in [m["name"] for m in cell.per_layer]
    res = harness.run(cell, 2**31 + 3, 0.5, True, torch.device("cpu"),
                      time.perf_counter(), root=tmp_path)
    assert res["correct"], res["checks"]
    assert res["metrics"]["group_batch_mean"]["value"] > 0
    old = harness.load_cell(tmp_path, man["workloads"][0]["name"])
    assert "group_batch_mean" not in [m["name"] for m in old.per_layer]
