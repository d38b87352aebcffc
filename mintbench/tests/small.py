"""The cells of BENCHMARK.json cut to a size the CPU tests can run: about
2,000 rows, a stream of 1,024 queries, and 32 clients, or the cell's own
number with ``clients=None``."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(cell, rows=2000, clients=32):
    cell.config["rows"] = rows
    cell.mix.update(stream=1024, warmup_rounds=2)
    if clients is not None:
        cell.mix["clients"] = clients
        cell.mix["runtime"] = dict(cell.mix.get("runtime", {}), max_batch=clients)
    return cell
