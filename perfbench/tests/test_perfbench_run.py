"""A run of the harness on the CPU: the command refuses to report
(no card), and the rest of a run, driven without the look for a card
at a small size, comes out correct, and not correct with the timed path
broken underneath: a step that returns its state unchanged, half of the
particles left out of the deposit (the rest weighted double), a field
altered where the solver produces it, and on slabs the exchange between
them left out (the decomposed LWFA, whose cell waits: PERF.md).  The
boosted-frame LWFA, whose cell waits for a repair of the program
(PERF.md), comes out not correct: the program injects its streaming
plasma with holes.  A waiting cell is held to lwfa_std-1card's
limits."""
import json
import subprocess
import sys
import time
from dataclasses import replace

import pytest
import torch

from perfbench import harness, registry
from perfbench.registry import ROOT
from perfbench.tests.small import WAITING, small_cell

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]] + ["lwfa_long-4card"]
MULTI = [n for n in CELLS if small_cell(n)[1]["chips"] > 1]


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "lwfa_std-1card", "--seed", "2147483701", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def small_run(name, seed=2**31 + 77):
    bench, wl, cfg, traffic = small_cell(name)
    limits = (registry.checks("lwfa_std-1card") if name in WAITING
              else None)
    return harness.run_cell(bench, wl, seed, 0.5, False,
                            t_start=time.perf_counter(),
                            devices=["cpu"] * wl["chips"], cfg=cfg,
                            traffic=traffic, limits=limits)


@pytest.mark.parametrize("name", CELLS)
def test_small_run_is_correct(name):
    res = small_run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    if name not in WAITING:
        assert "ns_per_particle_step" in res["metrics"]
    json.dumps(res)
    assert list(res)[-1] == "checks"


def unchanged_state(monkeypatch):
    from fbpic_tpu_torch.core import graph
    from fbpic_tpu_torch.parallel import domain
    for cls in (graph.MultiStep, domain.SlabMultiStep):
        def call(self, state, *args, _orig=cls.__call__, **kw):
            _, counts = _orig(self, state, *args, **kw)
            return state, counts
        monkeypatch.setattr(cls, "__call__", call)


def half_the_particles(monkeypatch):
    from fbpic_tpu_torch.core import step
    orig = step.deposit_rho_J_sorted

    def half(t):
        keep = torch.arange(t.numel(), device=t.device).reshape(
            t.shape) % 2 == 0
        return t * keep * 2

    def deposit(sort, x, y, z, w, *args, **kw):
        if "padded" in sort:     # the resident layout's arrays, w 4th
            padded = list(sort["padded"])
            padded[3] = half(padded[3])
            sort = dict(sort, padded=padded)
        return orig(sort, x, y, z, half(w), *args, **kw)
    monkeypatch.setattr(step, "deposit_rho_J_sorted", deposit)


def altered_field(monkeypatch):
    from fbpic_tpu_torch.core import step
    orig = step.push_fields

    def push(config, aux, spect, use_true_rho):
        out = orig(config, aux, spect, use_true_rho)
        Ez = out.Ez.clone()
        i = torch.unravel_index(Ez.abs().argmax(), Ez.shape)
        Ez[i] = Ez[i] * 1.01
        return replace(out, Ez=Ez)
    monkeypatch.setattr(step, "push_fields", push)


def no_exchange(monkeypatch):
    from fbpic_tpu_torch.parallel import domain

    def unchanged(fields, g, comm):
        comm.shift_both([f[:, :1] for f in fields], [f[:, :1]
                                                     for f in fields])
        return [f.clone() for f in fields]
    monkeypatch.setattr(domain, "exchange_guards_replace", unchanged)
    monkeypatch.setattr(domain, "exchange_guards_add", unchanged)


FAULTS = [(name, fault) for name in CELLS
          for fault in (unchanged_state, half_the_particles, altered_field)]
FAULTS += [(name, no_exchange) for name in MULTI]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_small_run_with_a_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = small_run(name)
    assert not res["correct"], res["checks"]


def test_boosted_frame_injection_is_not_correct():
    res = small_run("lwfa_boosted-1card")
    assert not res["correct"]
    # the injected particles differ
    assert res["checks"]["position_gap"]["value"] > 0.1
