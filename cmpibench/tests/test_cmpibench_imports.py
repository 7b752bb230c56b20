"""No module of the benchmark imports JAX or the JAX package (``repro``),
comparing top-level names whole (``repro_torch`` is the port); the
reference imports nothing of the program either; nothing reads the JAX
package's benchmarks or the bring-up smoke script."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & (FORBIDDEN | {"benchmarks", "chip_smoke"})
    if not path.name.startswith("test_"):
        text = path.read_text()
        assert "benchmarks/" not in text and "chip_smoke.py" not in text


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not imported(path) & (FORBIDDEN | {"repro_torch",
                                                  "cmpibench"})


def test_the_check_is_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    from cmpibench.launcher import forbidden_modules
    import sys
    sys.modules.setdefault("repro_torchlike_probe", sys)
    try:
        assert "repro" not in forbidden_modules()
    finally:
        sys.modules.pop("repro_torchlike_probe", None)
