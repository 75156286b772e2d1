"""The control of ``correct`` on the card, at a small size: the plain
reference computed in TF32 (the nearest precision below the
configurations' float32) in the program's place comes out not correct.
Needs a card: run on the chip with

    python3 -m pytest perfbench/tests -m cuda
"""
import time

import pytest

from perfbench import harness, registry
from perfbench.tests.small import small_cell

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs TF32 matmuls")
    return "cuda:0"     # a cell's slabs all on this card


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    bench, wl, cfg, traffic = small_cell(name)
    clean = harness.run_cell(bench, wl, 2**31 + 5, 0.5, False,
                             t_start=time.perf_counter(), devices=[card] * wl["chips"],
                             cfg=cfg, traffic=traffic)
    assert clean["correct"], clean["checks"]
    ctl = harness.run_cell(bench, wl, 2**31 + 5, 0.5, False,
                           t_start=time.perf_counter(), devices=[card] * wl["chips"],
                           cfg=cfg, traffic=traffic, control=True)
    assert not ctl["correct"], ctl["checks"]
    # the control fails a compared number, and its own numbers exist
    assert any(c["value"] > c["limit"] for c in ctl["checks"].values())
