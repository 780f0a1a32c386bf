"""Nothing under benchmark/ imports JAX or the JAX package, by top-level
module names compared whole (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "zs3_tpu"}
FILES = sorted(spec.HERE.rglob("*.py"))


def imports(path: Path):
    """The full names of the modules `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def top_level_imports(path: Path):
    return {name.split(".")[0] for name in imports(path)}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    plain = {"__future__", "contextlib", "typing", "statistics", "numpy", "torch"}
    assert all(name.split(".")[0] in plain or name.startswith("benchmark.reference")
               for name in imports(path)), imports(path)


def test_no_file_reads_the_old_tpu_benchmarks():
    for path in FILES:
        text = path.read_text()
        for name in ("bench.py", "bench_train.py", "chip_smoke"):
            assert f"import {name.split('.')[0]}" not in text and f"open({name!r}" not in text


def test_the_run_time_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zs3_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zs3_tpu.models", sys)
    assert harness.forbidden_modules() == ["zs3_tpu.models"]


def test_a_module_the_check_loads_refuses_the_run(tmp_path, monkeypatch):
    """The run-time guard looks after the check against the reference."""
    import time

    from benchmark.loops import train
    from benchmark.tests import tiny

    root = spec.Spec(tiny.make_root(tmp_path))
    check = train.Loop.check

    def loading_check(self):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return check(self)

    monkeypatch.setattr(train.Loop, "check", loading_check)
    with pytest.raises(harness.Refused, match="jax"):
        harness.run_cell(root, "tiny-r101-train", 2**31 + 7, 1.0, False, "cpu",
                         time.perf_counter())
