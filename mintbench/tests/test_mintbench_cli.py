"""The command's refusals, and what a run of the harness loads."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def command(cwd: Path, env=None):
    return subprocess.run([sys.executable, "mintbench/run.py", "--workload", CELL,
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def no_result(out: str) -> bool:
    return not any(line.startswith("{") for line in out.splitlines())


def test_it_refuses_without_a_card_or_outside_a_checkout(tmp_path):
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    else:
        env = dict(os.environ)
    res = command(ROOT, env)
    assert res.returncode != 0 and no_result(res.stdout)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mintbench", tmp_path / "mintbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env.pop("PYTHONPATH", None)
    res = command(tmp_path, env)
    assert res.returncode != 0 and no_result(res.stdout)


PROBE = """
import sys, time, torch
sys.path[:0] = [{root!r}, {src!r}]
from mintbench import harness
cell = harness.load_cell(harness.ROOT, {cell!r})
cell.config["rows"] = 1500
cell.mix.update(stream=256, warmup_rounds=1, clients=16)
cell.mix["runtime"] = dict(max_batch=16)
res = harness.run(cell, 7, 0.3, False, torch.device("cpu"), time.perf_counter())
print(res["correct"], harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), cell=CELL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"
