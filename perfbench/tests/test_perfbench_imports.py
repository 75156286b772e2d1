"""Nothing of the benchmark imports JAX or fbpic_tpu; the plain
reference imports nothing of fbpic_tpu_torch.  Top-level module names
are compared whole: fbpic_tpu_torch begins with fbpic_tpu's name."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.registry import HERE, ROOT


def imported_tops(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_fbpic_tpu(path):
    tops = set(imported_tops(path))
    assert not tops & {"jax", "jaxlib", "flax", "fbpic_tpu"}
    if "reference" in path.relative_to(HERE).parts:
        assert "fbpic_tpu_torch" not in tops


@pytest.mark.parametrize("name,forbidden", [
    ("fbpic_tpu_torch", False), ("fbpic_tpu_torch.core.step", False),
    ("fbpic_tpu", True), ("fbpic_tpu.core", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("jaxtyping", False), ("fbpic_tpu_x", False)])
def test_forbidden_modules_compares_whole_top_level_names(
        monkeypatch, name, forbidden):
    monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert (name in harness.forbidden_modules()) == forbidden


def test_reference_and_program_load_no_forbidden_module():
    code = ("import sys; import perfbench.reference.plain_pic; "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'fbpic_tpu_torch'], 'program'; "
            "from perfbench import harness, program; program.api(); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
