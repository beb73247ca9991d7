"""Nothing under ``perfbench/`` imports JAX or the JAX package (top-level
module names compared whole: the port's own name starts with the JAX
package's), and the reference imports nothing of the program."""
from __future__ import annotations

import ast

from perfbench import harness


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _modules(sub=""):
    return sorted((harness.HERE / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    files = _modules()
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in _modules(sub):
            for name in _imports(path):
                assert name.split(".")[0] != "repro_torch", (path, name)


def test_the_harness_reads_no_old_benchmark_records():
    for path in _modules():
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path
