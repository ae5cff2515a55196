"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program either."""

import ast
import pathlib

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ezkl_tpu"}
PROGRAM = "ezkl_tpu_torch"


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module that `path` imports (absolute)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_are_compared_whole():
    assert "ezkl_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ezkl_tpu.graph".split(".")[0] in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_the_reference_and_the_models_import_nothing_of_the_program():
    for sub in ("reference", "models"):
        for f in (harness.BENCH / sub).rglob("*.py"):
            assert PROGRAM not in _imports(f), f
    assert PROGRAM not in _imports(harness.BENCH / "onnx_writer.py")
    assert PROGRAM not in _imports(harness.BENCH / "work.py")
