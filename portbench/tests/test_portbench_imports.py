"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program, of the tests or of the
rest of the benchmark (top-level names compared whole:
``ocean_bgc_tpu_torch`` begins with ``ocean_bgc_tpu``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((HERE / "reference").glob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}, names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops, _ = top_level_imports(path)
    assert not tops & {"jax", "jaxlib", "flax", "ocean_bgc_tpu"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops, full = top_level_imports(path)
    assert not tops & {"ocean_bgc_tpu_torch", "ocean_bgc_tpu", "tests",
                       "torch", "jax"}
    # within the benchmark, only the reference's own modules
    assert all(n.startswith("portbench.reference") for n in full
               if n.split(".", 1)[0] == "portbench")


def test_the_scan_compares_whole_names():
    tops, _ = top_level_imports(HERE / "program.py")
    assert "ocean_bgc_tpu_torch" in tops and "ocean_bgc_tpu" not in tops
