"""Nothing of the benchmark imports JAX or the JAX package, and the run's
own check compares top-level module names whole."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

from perfbench import run as R

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zonos_vibes_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    files = [p for p in HERE.rglob("*.py")]
    assert len(files) > 20
    for p in files:
        assert not imported(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        assert imported(p) <= {"__future__", "math", "numpy", "torch"}, p


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zonos_vibes_tpu_torch_fake", object())
    assert "zonos_vibes_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zonos_vibes_tpu.models", object())
    assert R.forbidden_modules() == ["zonos_vibes_tpu"]


def test_the_harness_reads_nothing_of_the_jax_benchmark():
    for p in HERE.rglob("*.py"):
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        for name in ("bench.py", "BENCH_", "bench/"):
            assert f'"{name}' not in text and f"'{name}" not in text, (p, name)
