"""BENCHMARK.json against the benchmark's contract, and against the files
it names."""
import json
import re
from pathlib import Path

import pytest

from mintbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    files = [w for w in MAN["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in MAN["paths"]) for f in files)
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert line(m["layer"])
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(CELLS)
    assert "setup_s" in [m["name"] for m in MAN["end_to_end"]]


def test_every_file_a_cell_names_exists():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and line(cfg["source"])
        assert all(k in cfg for k in c["reduced"])
        assert set(c["reduced"]) <= set(cfg.get("assumed", {}))
    for w in MAN["workloads"]:
        assert (ROOT / "mintbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MAN["per_layer"]:
        assert (ROOT / "mintbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    c = harness.load_cell(ROOT, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_metric_reader_declares_what_the_manifest_says(name):
    entry = {m["name"]: m for m in MAN["per_layer"]}[name]
    mod = harness.load_reader(ROOT, name)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"], entry["moves"])
    assert mod.MOVES in {m["name"] for m in MAN["end_to_end"]}
    for cell in entry.get("workloads", []):
        assert cell in CELLS


def test_layers_name_the_same_layer_alike():
    by_file = {}
    for m in MAN["per_layer"]:
        by_file.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_file.values())
