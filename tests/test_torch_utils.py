"""fbpic_tpu_torch's remaining utils and import surface (CPU).

- ``utils.random_seed.set_random_seed`` seeds numpy as fbpic_tpu's does;
- ``utils.profiling.section`` times a block on the CPU without touching
  CUDA, and ``trace`` writes a Chrome / Perfetto trace file;
- the top-level exports (``BinomialSmoother``, ``BoostConverter``,
  ``Simulation``) and the ``fbpic.main`` alias;
- no module of fbpic_tpu_torch, and not chip_smoke.py, imports ``jax``
  or ``fbpic_tpu`` (an AST walk over every file).
"""
import ast
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_set_random_seed_matches_fbpic_tpu():
    from fbpic_tpu.utils.random_seed import set_random_seed as s0
    from fbpic_tpu_torch.utils.random_seed import set_random_seed as s1
    draws = []
    for set_seed in (s0, s1):
        set_seed(5, rank=2)
        draws.append(np.random.rand(8))
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[1], np.random.RandomState(7).rand(8))


def test_section_on_the_cpu():
    from fbpic_tpu_torch.utils.profiling import section
    said = []
    with section("matmul", sink=said.append):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (line,) = said
    assert line.startswith("[fbpic_tpu_torch] matmul: ")
    assert line.endswith(" ms") and float(line.split()[-2]) >= 0
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()


def test_trace_writes_a_trace_file(tmp_path):
    from fbpic_tpu_torch.utils.profiling import trace
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.fft.fft(torch.ones(256, dtype=torch.complex64))
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("fft" in str(ev.get("name", "")) for ev in events)


def test_top_level_exports():
    import fbpic_tpu_torch
    import fbpic_tpu_torch.main
    from fbpic_tpu_torch.fields.smoothing import BinomialSmoother
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter
    assert fbpic_tpu_torch.BinomialSmoother is BinomialSmoother
    assert fbpic_tpu_torch.BoostConverter is BoostConverter
    assert fbpic_tpu_torch.main.Simulation is fbpic_tpu_torch.Simulation
    assert {"BinomialSmoother", "BoostConverter", "Simulation"} \
        <= set(fbpic_tpu_torch.__all__)
    import fbpic_tpu
    from fbpic_tpu import picmi as p0
    from fbpic_tpu_torch import picmi as p1
    assert set(fbpic_tpu.__all__) <= set(fbpic_tpu_torch.__all__)
    assert p0.__all__ == p1.__all__ and p1.codename == "fbpic"


def _banned_imports(path):
    """Imports of jax or fbpic_tpu (not fbpic_tpu_torch) in one file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in ("jax", "fbpic_tpu")]


def test_no_module_of_the_port_imports_jax_or_fbpic_tpu():
    files = glob.glob(os.path.join(REPO, "fbpic_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 50
    found = {os.path.relpath(f, REPO): _banned_imports(f) for f in files}
    assert not {f: n for f, n in found.items() if n}
    # the walk sees what it looks for
    assert _banned_imports(os.path.join(REPO, "fbpic_tpu", "main.py")) \
        == [] and _banned_imports(os.path.join(
            REPO, "tests", "test_torch_step.py"))
