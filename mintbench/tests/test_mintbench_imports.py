"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's); the
yardstick imports nothing of the program either."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = {"reference.py", "gen.py", "check.py", "yardstick.py"}
MODULES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(PKG)) for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports(PKG / name)


def test_the_check_reads_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import x\nimport jaxtyping\n")
    assert top_level_imports(probe) == {"repro_torch", "jaxtyping"}
    assert not top_level_imports(probe) & FORBIDDEN
